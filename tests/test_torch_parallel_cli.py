"""Data parallelism through the port's CLI, on the CPU: gloo ranks as
processes, each with a deadline.

* ``example/MNIST/dist.conf`` (``update_on_server = 1``, ``batch_size =
  100`` global) on the digits idx files of
  ``cxxnet_tpu_torch.tools.make_digits_idx``, 2 rounds, with the
  overrides the digits need (``input_shape = 1,1,64``) and
  ``dev = cpu``: two ranks started by hand through the environment
  (``CXN_PROC_ID``, ``CXN_NUM_PROC``, ``CXN_COORDINATOR``) against one
  process of the same conf without the ``dist_*`` lines.  Each global
  batch holds the one-process batch's rows (``dist_shard = interleave``
  deals rows ``r::2``), so the weights agree within ``ATOL`` (the
  gradient sums run in another order) and both ranks print the one
  process's train error (the metric summed over the ranks).
* The same conf with ``dev = cpu:0-1`` and no ``dist_*`` keys: the CLI
  starts the two ranks, ``test_on_server = 1`` prints a
  ``weight-sync:max_dev=0 ok`` line per rank a round, the ``mesh:`` line
  names the layout and the backend, and rank 0 alone writes the
  checkpoints.
* ``wait_ranks`` returns the first failing rank's code and ends the
  others at once.
* Three ranks, a bit flipped in a live weight on rank 1 only
  (``fault_inject = device.state:bitflip``): the round's vote names rank
  1 on every rank, the run stops with ``INTEGRITY:`` before the round
  is saved (without ``elastic = 1``; with it the named rank quarantines
  itself and the others rebuild: ``tests/test_torch_elastic.py``).
* ``python -m cxxnet_tpu_torch.tools.mesh_parity --ranks 2`` passes.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from cxxnet_tpu_torch.cli import wait_ranks
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.tools.make_digits_idx import write_digits_idx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_CONF = os.path.join(REPO, "example", "MNIST", "dist.conf")
ATOL = 1e-5
DEADLINE_S = 120
DIGITS = ("input_shape=1,1,64", "num_round=2", "dev=cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("CXN_COORDINATOR", "CXN_NUM_PROC", "CXN_PROC_ID", "PS_RANK"):
        env.pop(k, None)
    env.update(extra)
    return env


def _run_all(procs):
    """Each process's (code, output); every one is killed past the
    deadline."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _cli(conf, cwd, args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", conf, *args], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    d = tmp_path_factory.mktemp("digits")
    write_digits_idx(str(d / "data"))
    with open(DIST_CONF) as f:
        text = f.read()
    (d / "one.conf").write_text("\n".join(
        line for line in text.splitlines()
        if not line.startswith("dist_")) + "\n")
    return d


def _params(path):
    _h, params, _aux, _ust = NetTrainer._read_model_file(str(path))
    return {f"{k}/{t}": w for k, tags in params.items()
            for t, w in tags.items()}


def _train_error(out):
    return [line.split("train-error:")[1].split()[0]
            for line in out.splitlines() if "train-error:" in line]


def test_dist_conf_by_hand_matches_one_process(digits):
    port = _free_port()
    ranks = [_cli(DIST_CONF, str(digits),
                  [*DIGITS, "model_dir=m2", "dist_timeout_s=60",
                   f"dist_coordinator=127.0.0.1:{port}"],
                  _env(CXN_PROC_ID=str(r)))
             for r in range(2)]
    one = _cli(str(digits / "one.conf"), str(digits),
               [*DIGITS, "model_dir=m1"], _env())
    (c0, o0), (c1, o1), (c, o) = _run_all(ranks + [one])
    assert c0 == 0 and c1 == 0 and c == 0, (o0[-2000:], o1[-2000:], o[-2000:])
    assert "mesh: data=2 model=1 zero=1 processes=2 backend=gloo" in o0
    assert _train_error(o0) == _train_error(o1)
    assert len(_train_error(o0)) == 2
    np.testing.assert_allclose(
        [float(v) for v in _train_error(o0)],
        [float(v) for v in _train_error(o)], rtol=0, atol=1e-9)
    for r in ("0000", "0001", "0002"):
        a = _params(digits / "m2" / f"{r}.model")
        b = _params(digits / "m1" / f"{r}.model")
        for name in b:
            np.testing.assert_allclose(a[name], b[name], rtol=0, atol=ATOL,
                                       err_msg=f"round {r} {name}")


def test_device_range_launcher(digits, tmp_path):
    p = _cli(str(digits / "one.conf"), str(digits),
             [*DIGITS, "dev=cpu:0-1", "test_on_server=1",
              f"model_dir={tmp_path / 'm'}", "num_round=1",
              f"dist_launch_timeout_s={DEADLINE_S}"], _env())
    ((code, out),) = _run_all([p])
    assert code == 0, out[-3000:]
    assert "2 rank processes" in out
    assert out.count("weight-sync:max_dev=0 ok") == 2
    assert out.count("mesh: data=2 model=1 zero=1 processes=2 "
                     "backend=gloo") == 2
    assert sorted(os.listdir(tmp_path / "m")) == [
        "0000.model", "0000.model.manifest.json", "0001.model",
        "0001.model.manifest.json"]


def test_wait_ranks_ends_the_others():
    slow = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    bad = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    t0 = time.monotonic()
    assert wait_ranks([slow, bad], 30) == 3
    assert time.monotonic() - t0 < 20
    assert slow.poll() is not None
    ok = [subprocess.Popen([sys.executable, "-c", "pass"]) for _ in range(2)]
    assert wait_ranks(ok, 30) == 0
    hung = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    assert wait_ranks([hung], 0.5) == 124
    assert hung.poll() is not None


def test_integrity_vote_names_the_flipped_rank(digits, tmp_path):
    port = _free_port()
    common = [*DIGITS, "num_round=1", "batch_size=99", "integrity_every=1",
              f"model_dir={tmp_path / 'm'}", "dist_num_proc=3",
              "dist_timeout_s=60", f"dist_coordinator=127.0.0.1:{port}"]
    # seed 25 flips the sign bit of a weight of fc2 (a flip of a bit far
    # below a weight's update is rounded away by the round's steps)
    flip = ["fault_seed=25", "fault_inject=device.state:bitflip:1:1"]
    procs = [_cli(str(digits / "one.conf"), str(digits),
                  common + [f"dist_proc_id={r}"] + (flip if r == 1 else []),
                  _env()) for r in range(3)]
    results = _run_all(procs)
    for code, out in results:
        assert code != 0, out[-2000:]
        assert "INTEGRITY: integrity state check failed" in out, out[-2000:]
        assert "(corrupt rank 1)" in out
    assert "bitflip injected" in results[1][1]
    assert sorted(os.listdir(tmp_path / "m")) == [
        "0000.model", "0000.model.manifest.json"]


def test_mesh_parity_tool(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.mesh_parity",
         "--out", str(tmp_path), "--ranks", "2", "--timeout", "90"],
        env=_env(), capture_output=True, text=True, timeout=DEADLINE_S * 2)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert '"verdict": "ok"' in r.stdout
