"""``pred``, ``pred_raw``, ``extract`` and ``serve`` over a device range
of two gloo ranks on the CPU, against the JAX package's ``dev =
cpu:0-1`` and against one process of the port.

* The predicting tasks: a small MLP conf with a ``csv`` pred section of
  70 rows at batch 16 (the last batch 6 rows and 10 of padding), one
  checkpoint; the port's CLI with ``dev = cpu:0-1`` (the launcher starts
  two ranks, each runs its block of every batch, rank 0 writes) against
  the JAX CLI with the same conf (one subprocess, its one-program
  range): ``pred`` byte for byte, ``pred_raw`` and ``extract`` (bin,
  and the ``.meta`` line) within ``TASK_ATOL`` and ``TASK_RTOL``
  (the printed digits); and against the
  port's one-process files within ``RANGE_ATOL``.
* Serving: ``task=serve`` over the range answers JSON requests of 1, 5
  and 16 rows with one process's engine's scores within
  ``RANGE_ATOL``; SIGTERM to the launcher ends both ranks with exit 0
  (the follower prints its ``stopped`` line).  Started by hand (the
  ``dist_*`` keys), a follower that is killed turns rank 0's
  ``/healthz`` to ``degraded`` with ``range_follower_lost``.
* The tasks that still run on one device refuse a range, naming
  themselves.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.nnet.trainer import NetTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI's printed floats ({v:g}: 6 significant digits, so one unit of
# the last digit is up to 1e-5 of the value) across packages
TASK_ATOL = TASK_RTOL = 1e-5
# the port's range against its one process (a GEMM over 8 rows against
# one over 16: the same sums, perhaps blocked otherwise)
RANGE_ATOL = 1e-6
DEADLINE_S = 120
ROWS, BATCH = 70, 16

CONF = """
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 12
  init_sigma = 0.3
layer[1->2] = relu
layer[2->3] = fullc:fc2
  nhidden = 4
  init_sigma = 0.3
layer[3->3] = softmax
netconfig = end
input_shape = 1,1,16
batch_size = {batch}
seed = 11
silent = 1
pred = {out}
  iter = csv
    filename = {csv}
    silent = 1
  iter = end
"""

_JAX_TASKS = """
import contextlib, io, json, sys
from cxxnet_tpu.cli import LearnTask
for argv in json.loads(sys.argv[1]):
    with contextlib.redirect_stdout(io.StringIO()):
        LearnTask().run(argv)
"""

TASKS = (("pred", (), "pred.txt"),
         ("pred_raw", (), "raw.txt"),
         ("extract", ("extract_node_name=1", "output_format=bin"), "f1.bin"))


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def _write(d, out):
    path = os.path.join(d, f"{out}.conf")
    with open(path, "w") as f:
        f.write(CONF.format(batch=BATCH, out=out,
                            csv=os.path.join(d, "rows.csv")))
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("range")
    rng = np.random.RandomState(7)
    rows = np.concatenate([rng.randint(0, 4, (ROWS, 1)),
                           rng.randn(ROWS, 16)], axis=1)
    np.savetxt(root / "rows.csv", rows, delimiter=",", fmt="%.6f")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(CONF.format(
        batch=BATCH, out="x", csv=root / "rows.csv")) + [("dev", "cpu")])
    tr.init_model()
    model = str(root / "m.model")
    tr.save_model(model)
    return root, model, rows[:, 1:].astype(np.float32)


@pytest.fixture(scope="module")
def predicted(setup):
    """Every task of ``TASKS`` in three directories, all started at
    once: the port over ``dev = cpu:0-1`` (a launcher per task), the
    port on one process, and the JAX CLI over ``dev = cpu:0-1``."""
    root, model, _rows = setup
    procs, jax_argvs = [], []
    for side in ("range", "one", "jax"):
        d = root / side
        d.mkdir()
        os.symlink(root / "rows.csv", d / "rows.csv")
        for task, extra, out in TASKS:
            conf = _write(str(d), out)
            argv = [conf, f"task={task}", f"model_in={model}", *extra]
            if side == "jax":
                jax_argvs.append(argv + ["dev=cpu:0-1"])
                continue
            dev = "dev=cpu:0-1" if side == "range" else "dev=cpu"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cxxnet_tpu_torch", *argv, dev],
                cwd=d, env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX_TASKS, json.dumps(jax_argvs)],
        cwd=root / "jax", env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=DEADLINE_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return root


def _floats(path):
    if str(path).endswith(".bin"):
        return np.fromfile(path, "<f4")
    return np.array([float(v) for v in open(path).read().split()])


@pytest.mark.parametrize("task,extra,out", TASKS)
def test_range_task_output_matches_jax_range(predicted, task, extra, out):
    port, jax = predicted / "range", predicted / "jax"
    a, b = (port / out).read_bytes(), (jax / out).read_bytes()
    if task == "pred":
        assert a == b and a.count(b"\n") == ROWS
        return
    ours, ref = _floats(port / out), _floats(jax / out)
    assert ours.shape == ref.shape and ours.size > 0
    np.testing.assert_allclose(ours, ref, atol=TASK_ATOL, rtol=TASK_RTOL)
    if task == "extract":
        meta = (port / (out + ".meta")).read_bytes()
        assert meta == (jax / (out + ".meta")).read_bytes() == \
            f"{ROWS},12,1,1\n".encode()
    else:
        assert a.count(b"\n") == ROWS


@pytest.mark.parametrize("task,extra,out", TASKS)
def test_range_task_output_matches_one_process(predicted, task, extra, out):
    ours, ref = (_floats(predicted / side / out) for side in ("range", "one"))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=RANGE_ATOL, rtol=0)


@pytest.mark.parametrize("argv,what", [
    (["task=summary"], "task=summary"),
    (["task=generate"], "task=generate"),
    (["task=serve", "replicas=2"], "task=serve with replicas=2"),
])
def test_one_device_tasks_refuse_a_range(setup, argv, what):
    root, model, _rows = setup
    conf = _write(str(root), "refuse.txt")
    with pytest.raises(NotImplementedError, match=re.escape(what)):
        LearnTask().run([conf, f"model_in={model}", "dev=cpu:0-1", *argv])


# ----------------------------------------------------------------------
# serving over the range
def _start(argv, cwd, env=None):
    return subprocess.Popen([sys.executable, "-m", "cxxnet_tpu_torch",
                             *argv], cwd=cwd, env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _port_of(proc, lines):
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(r"serving model .* at http://[^:]+:(\d+)", line)
        if m:
            return int(m.group(1))
    raise AssertionError("".join(lines)[-3000:])


def _post(port, rows):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"data": rows.tolist(), "raw": True}).encode(),
        headers={"Content-Type": "application/json"})
    return np.asarray(json.loads(urllib.request.urlopen(
        req, timeout=60).read())["scores"], np.float32)


def _healthz(port):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=30).read())


def test_serving_range_answers_as_one_engine_and_ends_on_sigterm(setup):
    from cxxnet_tpu_torch.serve import Engine

    root, model, rows = setup
    conf = _write(str(root), "serve.txt")
    proc = _start([conf, "task=serve", f"model_in={model}", "serve_port=0",
                   "dev=cpu:0-1", "silent=0"], root)
    lines = []
    try:
        port = _port_of(proc, lines)
        cfg = tcfg.parse_file(conf) + [("dev", "cpu")]
        with Engine(cfg=cfg, model_in=model) as one:
            for n in (1, 5, 16):
                np.testing.assert_allclose(_post(port, rows[:n]),
                                           one.scores(rows[:n]),
                                           atol=RANGE_ATOL, rtol=0)
        assert _healthz(port)["status"] == "ok"
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=DEADLINE_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, "".join(lines) + out
    assert "serving range: rank 1 stopped after 3 forward(s)" in out, out


def test_lost_follower_degrades_healthz(setup):
    root, model, rows = setup
    conf = _write(str(root), "lost.txt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = s.getsockname()[1]
    procs = [_start([conf, "task=serve", f"model_in={model}",
                     "serve_port=0", "dev=cpu", "dist_num_proc=2",
                     f"dist_proc_id={r}",
                     f"dist_coordinator=127.0.0.1:{coord}",
                     "dist_timeout_s=5", "silent=0"], root)
             for r in range(2)]
    lines = []
    try:
        port = _port_of(procs[0], lines)
        _post(port, rows[:3])
        assert _healthz(port)["status"] == "ok"
        procs[1].kill()
        procs[1].communicate()
        deadline = time.time() + 30
        h = _healthz(port)
        while "range_follower_lost" not in h["reasons"] and \
                time.time() < deadline:
            time.sleep(0.5)
            h = _healthz(port)
        assert h["status"] == "degraded", h
        assert "range_follower_lost" in h["reasons"], h
        procs[0].send_signal(signal.SIGTERM)
        procs[0].communicate(timeout=DEADLINE_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
