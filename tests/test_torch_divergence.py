"""The divergence guard of the port's trainer and CLI against the JAX
package's, on the CPU.

The conf of ``tests/test_fault_tolerance.py`` (an MLP over seeded idx
files, 4 updates a round) from one port-written ``0000.model``, through
the JAX CLI (in one subprocess, as ``test_torch_mnist.py`` runs it, so
the JAX obs registry of this process is untouched) and the port's CLI
(in process), in four cases: ``abort`` at ``inject_nan_step = 5``,
``rollback`` at 9 with a back-off of 0.5, the spike gate at ratio 50,
and a NaN-poisoned newest checkpoint that the rollback falls back past.
In each, the same exit code, the same ``DIVERGENCE`` and ``divergence:``
lines (paths aside), the same ``NNNN.model`` files and every checkpoint's
weights within ``WEIGHT_TOL``.  In process: the spike gate's window
against the JAX trainer's on the same losses, the guard's trip on a NaN
input in both packages, the accumulation path (a tripped micro-batch
leaves the summed gradient as it was), and the guard off (no read-back).
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.checkpoint import DivergenceError as JaxDivergence

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils import checkpoint as ckpt
from cxxnet_tpu_torch.utils.checkpoint import DivergenceError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every tensor of every checkpoint, both packages from one 0000.model,
# within this share of the tensor's largest magnitude (f32, up to 16
# SGD steps with momentum; oneDNN and XLA sum in other orders)
WEIGHT_TOL = 1e-5

# (num_round, conf extra, the second run's args or None, poison 0003)
CASES = {
    "abort_nan": (4, "divergence_policy = abort\ninject_nan_step = 5",
                  None),
    "rollback_nan": (4, "divergence_policy = rollback\n"
                        "divergence_lr_backoff = 0.5\ninject_nan_step = 9",
                     None),
    "rollback_spike": (4, "divergence_policy = rollback\n"
                          "divergence_lr_backoff = 0.5\n"
                          "divergence_loss_ratio = 50\n"
                          "inject_spike_step = 9", None),
    "poisoned_newest": (3, "divergence_policy = rollback",
                        ["continue=1", "num_round=4"]),
}

_JAX_RUNS = """
import contextlib, io, json, os, sys, traceback
from cxxnet_tpu.cli import LearnTask
out = []
for cwd, argv, poison in json.loads(sys.argv[1]):
    os.chdir(cwd)
    if poison:
        from test_torch_divergence import poison_weights
        poison_weights(poison)
    so, se = io.StringIO(), io.StringIO()
    rc = 0
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            rc = LearnTask().run(argv)
        except Exception:
            traceback.print_exc()
            rc = 1
    out.append([rc, so.getvalue(), se.getvalue()])
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer registers, which an exposition check later
    in the same process (``tests/test_obs.py``) rejects."""
    from cxxnet_tpu.obs import device as obs_device
    from cxxnet_tpu.obs import registry

    name = "train_step_device_seconds"
    had = any(m.name == name for m in registry().metrics())
    yield
    reg = registry()
    fam = next((m for m in reg.metrics() if m.name == name), None)
    if not had and fam is not None and not fam.samples():
        with reg._lock:
            reg._metrics.pop(name, None)
        obs_device.reset()


def poison_weights(path):
    """Rewrite a checkpoint with NaN in its first weight tensor and a
    matching manifest: CRC-valid, numerically poisoned (the blow-up of
    the round's last update, after its losses were read)."""
    raw = open(path, "rb").read()
    hlen = int.from_bytes(raw[8:12], "little")
    npz = np.load(io.BytesIO(raw[12 + hlen:]))
    flat = {k: npz[k] for k in npz.files}
    k0 = next(k for k in sorted(flat) if not k.startswith("ust:"))
    flat[k0] = np.full_like(flat[k0], np.nan)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    man = ckpt.read_manifest(path)
    ckpt.write_checkpoint(path, raw[:12 + hlen] + buf.getvalue(),
                          round_=man["round"],
                          net_fp=man["net_fingerprint"])


def _run_port(cwd, argv):
    old = os.getcwd()
    os.chdir(cwd)
    so, se = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            try:
                rc = LearnTask().run(argv)
            except DivergenceError as e:
                print(f"DivergenceError: {e}", file=sys.stderr)
                rc = 1
    finally:
        os.chdir(old)
    return rc, so.getvalue(), se.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in both packages, each in a directory of its own, from
    one port-written ``0000.model``; ``{(case, pkg): [(rc, stdout,
    stderr), ...]}`` and the directories."""
    from test_cli import make_conf

    root = tmp_path_factory.mktemp("divergence")
    dirs, jax_jobs, out = {}, [], {}
    for case, (num_round, extra, second) in CASES.items():
        seed_dir = root / case
        seed_dir.mkdir()
        conf = make_conf(seed_dir, num_round=num_round, extra=extra)
        tr = NetTrainer()
        tr.set_params(tcfg.parse_file(str(conf)))
        tr.init_model()
        for pkg in ("port", "jax"):
            d = root / case / pkg
            (d / "models").mkdir(parents=True)
            text = open(conf).read().replace(f"{seed_dir}/models",
                                             f"{d}/models")
            (d / "run.conf").write_text(text)
            tr.save_model(str(d / "models" / "0000.model"), round_=0)
            dirs[(case, pkg)] = d
        argvs = [["run.conf", "continue=1", "silent=1"]]
        if second:
            argvs.append(["run.conf", *second, "silent=1"])
        for pkg in ("port", "jax"):
            d = dirs[(case, pkg)]
            for i, argv in enumerate(argvs):
                poison = (str(d / "models" / "0003.model")
                          if i == 1 else None)
                if pkg == "jax":
                    jax_jobs.append(((case, pkg), [str(d), argv, poison]))
                    continue
                if poison:
                    poison_weights(poison)
                out.setdefault((case, pkg), []).append(_run_port(d, argv))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]))
    r = subprocess.run([sys.executable, "-c", _JAX_RUNS,
                        json.dumps([job for _, job in jax_jobs])],
                       cwd=str(root), env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for (key, _), res in zip(jax_jobs, json.loads(r.stdout.splitlines()[-1])):
        out.setdefault(key, []).append(tuple(res))
    return out, dirs


def _guard_lines(text, d):
    return [line.replace(str(d), "<dir>") for line in text.splitlines()
            if line.startswith(("DIVERGENCE", "divergence:"))]


_SPIKE = re.compile(r"finite loss spike (\S+) > 50 x rolling median (\S+) ")


def _models(d):
    return sorted(f for f in os.listdir(d / "models")
                  if f.endswith(".model"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_guard_matches_jax(runs, case):
    out, dirs = runs
    port, jax = out[(case, "port")], out[(case, "jax")]
    for (rc_t, so_t, se_t), (rc_j, so_j, se_j) in zip(port, jax):
        assert rc_t == rc_j, (se_t[-2000:], se_j[-2000:])
        lt = _guard_lines(so_t, dirs[(case, "port")])
        lj = _guard_lines(so_j, dirs[(case, "jax")])
        assert len(lt) == len(lj), (lt, lj)
        for a, b in zip(lt, lj):
            ma, mb = _SPIKE.search(a), _SPIKE.search(b)
            if ma:  # the spike's value and median, to 6 digits each
                np.testing.assert_allclose(
                    [float(v) for v in ma.groups()],
                    [float(v) for v in mb.groups()], rtol=1e-4)
                a, b = _SPIKE.sub("", a), _SPIKE.sub("", b)
            assert a == b
    files = _models(dirs[(case, "port")])
    assert files == _models(dirs[(case, "jax")])
    for f in files:
        _h, wt, at, _u = NetTrainer._read_model_file(
            str(dirs[(case, "port")] / "models" / f))
        _h, wj, aj, _u = NetTrainer._read_model_file(
            str(dirs[(case, "jax")] / "models" / f))
        for key, tags in wj.items():
            for tag, w in tags.items():
                if not np.isfinite(w).all():  # the poisoned checkpoint
                    assert np.isnan(wt[key][tag]).all()
                    continue
                err = (np.abs(wt[key][tag] - w).max()
                       / max(np.abs(w).max(), 1e-6))  # a bias may be 0
                assert err <= WEIGHT_TOL, (f, key, tag, err)
    text = "\n".join(so for _, so, _ in port)
    assert "DIVERGENCE: divergence guard: " in port[-1][1]
    if case == "abort_nan":
        assert port[0][0] != 0 and "non-finite loss" in text
        assert files == ["0000.model", "0001.model"]
    else:
        assert port[-1][0] == 0 and files[-1] == "0004.model"
        assert "rolled back to round 2" in text
    if case in ("rollback_nan", "rollback_spike"):
        assert "lr scale now 0.5 (retry 1/3)" in text
    if case == "rollback_spike":
        assert "finite loss spike" in text
    if case == "poisoned_newest":
        assert "non-finite weights; falling back past it" in text


# ----------------------------------------------------------------------
# in process

MLP = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1:a1] = relu
layer[a1->out] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 16
dev = cpu
eta = 0.1
momentum = 0.9
seed = 3
"""


def _port_trainer(extra=""):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(MLP + extra))
    tr.init_model()
    return tr


LOSS_RUNS = {
    "spike_after_warmup": [1.0, 1.1, 0.9, 1.2, 1.0, 0.95, 1.05, 1.0, 60.0],
    "early_spike_disarmed": [1.0, 500.0, 1.0, 1.0, 1.1, 1.0, 0.9, 1.0, 1.0,
                             1.2, 1.0],
    "median_follows": [float(2 ** i) for i in range(12)],
    "window_of_32": [1.0] * 40 + [49.0, 51.0],
}


@pytest.mark.parametrize("run", sorted(LOSS_RUNS))
def test_spike_gate_matches_jax(run):
    """The same losses through both packages' ``_guard_loss_ratio`` at
    ratio 50: the same trip (update and message) or none, the same
    window."""
    losses = np.asarray(LOSS_RUNS[run])
    got = []
    for tr in (_port_trainer("divergence_policy = abort\n"
                             "divergence_loss_ratio = 50\n"),
               JaxTrainer()):
        tr.divergence_policy, tr.divergence_loss_ratio = "abort", 50.0
        tr.round = 2
        res = None
        for i, v in enumerate(losses):
            try:
                tr._guard_loss_ratio(np.asarray([v]), i)
            except (DivergenceError, JaxDivergence) as e:
                res = (str(e), e.epoch)
                break
        got.append((res, list(tr._loss_window)))
    assert got[0] == got[1]


def test_guard_trips_on_a_nan_input_in_both_packages():
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    x[3, 2] = np.nan
    y = np.zeros((16, 1), np.float32)
    tr = _port_trainer("divergence_policy = rollback\n")
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(MLP + "divergence_policy = rollback\n"))
    jt.init_model()
    errs = []
    for t, batch in ((tr, DataBatch(data=x, label=y)),
                     (jt, JaxBatch(data=x, label=y))):
        with pytest.raises((DivergenceError, JaxDivergence)) as ei:
            t.update(batch)
        errs.append((str(ei.value), ei.value.epoch, t.epoch_counter))
    assert errs[0] == errs[1]
    assert errs[0][1] == 0 and "non-finite loss" in errs[0][0]
    # the weights a trip leaves behind are the updated (poisoned) ones
    assert not tr.weights_finite()
    tr.scale_learning_rate(0.25)
    assert all(up.param.base_lr == pytest.approx(0.025)
               for up in tr.updaters.values())


def test_accumulation_path_drops_the_tripped_micro_batch():
    """Under ``update_period = 2`` the guard runs before the micro-batch's
    gradient joins the sum: the tripped batch leaves the sum, the
    counters and the weights as they were, and the next clean batch
    applies exactly the update of a run that never saw it."""
    rng = np.random.RandomState(1)
    b1, b2 = (DataBatch(data=rng.randn(16, 8).astype(np.float32),
                        label=rng.randint(0, 4, (16, 1)).astype(np.float32))
              for _ in range(2))
    bad = DataBatch(data=np.full((16, 8), np.nan, np.float32),
                    label=np.zeros((16, 1), np.float32))
    extra = "update_period = 2\ndivergence_policy = abort\n"
    tr, ref = _port_trainer(extra), _port_trainer(extra)
    tr.update(b1)
    ref.update(b1)
    acc = [g.clone() for g in tr._grad_accum]
    with pytest.raises(DivergenceError) as ei:
        tr.update(bad)
    assert ei.value.epoch == 0
    assert (tr.sample_counter, tr.epoch_counter) == (1, 0)
    assert all(torch.equal(a, g) for a, g in zip(acc, tr._grad_accum))
    assert tr.weights_finite()
    tr.update(b2)
    ref.update(b2)
    assert tr.epoch_counter == ref.epoch_counter == 1
    for key, tags in ref.params.items():
        for tag, w in tags.items():
            assert torch.equal(tr.params[key][tag], w), (key, tag)


def test_guard_off_reads_nothing_back(monkeypatch):
    """With no policy the guard never runs (no host read-back of the
    loss), and the fault-injection keys do nothing."""
    def fail(*a, **k):
        raise AssertionError("the guard ran with the policy off")

    monkeypatch.setattr(NetTrainer, "_guard_loss", fail)
    tr = _port_trainer("inject_nan_step = 0\ninject_spike_step = 1\n")
    assert tr.divergence_policy == ""
    rng = np.random.RandomState(2)
    for _ in range(3):
        tr.update(DataBatch(data=rng.randn(16, 8).astype(np.float32),
                            label=rng.randint(0, 4, (16, 1)).astype(
                                np.float32)))
    assert tr.epoch_counter == 3 and torch.isfinite(tr.last_loss)
    assert (tr.inject_nan_step, tr.inject_spike_step) == (0, 1)
    for off in ("", "off"):
        tr.set_param("divergence_policy", off)
        assert tr.divergence_policy == ""
