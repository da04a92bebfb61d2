"""Two gloo ranks on the CPU against the JAX package's two devices and
against one rank of the port.

One job of two rank processes (``tests/torch_dp_rank.py``, ports from
``socket.bind``, a deadline on the processes and on every collective)
runs, from one checkpoint, 3 steps of a 2-conv net with batch norm
(``bn_eval = batch`` and ``running``) and dropout (0.3) on 3 seeded
global batches of 8, as ``zero = 0``, ``1`` and ``3``, and 2 steps of a
net without either under ``det_reduce = 1``, twice.  The random layers'
draws are a function of the draw's shape in both packages
(``shape_draws``: the JAX dropout's ``bernoulli`` is patched to it), so
the global-shape masks are compared too.

* Against the JAX ``NetTrainer`` with ``dev = cpu:0-1`` on the same
  batches: every weight and batch norm's running statistics within
  ``ATOL`` (f32; the gradient sums run in other orders: each rank's
  backward and the all-reduce, against XLA's).
* Against the port's one-rank run of the global batches: the same
  tolerance, and the losses within ``LOSS_RTOL``; the ranks' weights
  equal each other bit for bit.
* ``zero = 1`` and ``3``: bit-equal to ``zero = 0`` (SGD is elementwise
  and the gradients are the same all-reduce); each rank's train-state
  bytes are at most 0.55 (``zero = 3``) or 0.8 (``zero = 1``: whole
  weights, half the momentum) of a whole replica; the ``zero = 3``
  checkpoint holds whole arrays and loads onto one rank.
* ``det_reduce = 1``: two runs give the same bits.
* ``check_weight_sync`` reads 0 on agreeing ranks and raises on both
  ranks once rank 1's first weight moves by 1e-3.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.nnet.trainer import NetTrainer

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_dp_rank import shape_draws  # noqa: E402

ATOL = 1e-6  # weights after 3 steps at eta 0.1 (updates ~1e-2)
LOSS_RTOL = 1e-5
DEADLINE_S = 120  # each rank process

NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  pad = 1
  init_sigma = 0.1
layer[1->1] = batch_norm:bn1
layer[1->1] = relu
layer[1->2] = max_pooling
  kernel_size = 2
  stride = 2
layer[2->3] = conv:c2
  kernel_size = 3
  nchannel = 8
  pad = 1
  init_sigma = 0.1
layer[3->3] = batch_norm:bn2
  bn_eval = running
layer[3->3] = relu
layer[3->4] = flatten
layer[4->4] = dropout
  threshold = 0.3
layer[4->5] = fullc:fc
  nhidden = 4
  init_sigma = 0.1
layer[5->5] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 8
updater = sgd
eta = 0.1
momentum = 0.9
wd = 0.0001
seed = 3
"""
# det_reduce refuses layer state and random layers, as in the JAX package
DET_NET = (NET.replace("layer[3->3] = batch_norm:bn2\n  bn_eval = running\n",
                       "")
           .replace("layer[4->4] = dropout\n  threshold = 0.3\n", ""))
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer's compile listener registers."""
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(spec: dict, tmp, world: int,
              script: str = "torch_dp_rank.py") -> None:
    """``world`` rank processes of ``script`` (``torch_dp_rank.py``)
    over ``spec``; all are killed past ``DEADLINE_S``."""
    path = os.path.join(tmp, f"spec{world}.json")
    spec = dict(spec, world=world, coord=f"127.0.0.1:{_free_port()}",
                timeout_s=60)
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), path,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.RandomState(0)
    batches = os.path.join(tmp, "b.npz")
    np.savez(batches,
             data=rng.randn(STEPS, 8, 8, 8, 3).astype(np.float32),
             label=rng.randint(0, 4, (STEPS, 8, 1)).astype(np.float32))
    pairs = tcfg.parse_pairs(NET + "dev = cpu\n")
    tr = NetTrainer()
    tr.set_params(pairs)
    tr.init_model()
    init = os.path.join(tmp, "init.model")
    tr.save_model(init)
    det = tcfg.parse_pairs(DET_NET + "dev = cpu\ndet_reduce = 1\n")
    runs = [dict(cfg=pairs + extra, init=init, batches=batches,
                 steps=STEPS, out=os.path.join(tmp, name),
                 perturb_rank=1 if name == "z0" else None,
                 save=os.path.join(tmp, "z3.saved") if name == "z3" else None)
            for name, extra in (("z0", []), ("z1", [("zero", "1")]),
                                ("z3", [("zero", "3")]))]
    runs += [dict(cfg=det, batches=batches, steps=2,
                  out=os.path.join(tmp, f"det{i}")) for i in (0, 1)]
    run_ranks({"runs": runs, "patch_draw": True}, tmp, 2)
    out = {name: [dict(np.load(os.path.join(tmp, f"{name}.r{r}.npz")))
                  for r in range(2)]
           for name in ("z0", "z1", "z3", "det0", "det1")}
    return {"tmp": tmp, "init": init, "batches": batches, "out": out}


def _leaves(d):
    return {k: v for k, v in d.items() if k.startswith(("p:", "aux:"))}


def test_two_ranks_match_jax_on_two_devices(job, monkeypatch):
    import jax
    import jax.numpy as jnp

    from cxxnet_tpu.parallel.distributed import fetch_array

    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape:
                        jnp.asarray(shape_draws(shape) < p))
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(NET + "dev = cpu:0-1\n"))
    jt.load_model(job["init"])
    assert jt.mesh_plan.n_data == 2
    b = np.load(job["batches"])
    for k in range(STEPS):
        jt.update(JaxBatch(data=b["data"][k], label=b["label"][k]))
    got = job["out"]["z0"][0]
    n = 0
    for tree, pre in ((jt.params, "p:"), (jt.aux, "aux:")):
        for key, tags in tree.items():
            for tag, w in tags.items():
                np.testing.assert_allclose(got[f"{pre}{key}/{tag}"],
                                           fetch_array(w), rtol=0,
                                           atol=ATOL, err_msg=f"{key}/{tag}")
                n += 1
    assert n == len(_leaves(got)) == 12


def test_two_ranks_match_one_rank(job, monkeypatch):
    import torch

    from cxxnet_tpu_torch.layers import elemwise

    monkeypatch.setattr(elemwise, "draw", lambda shape, gen, device:
                        torch.from_numpy(shape_draws(shape)).to(device))
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET + "dev = cpu\n"))
    tr.load_model(job["init"])
    b = np.load(job["batches"])
    losses = []
    for k in range(STEPS):
        tr.update(DataBatch(data=b["data"][k], label=b["label"][k]))
        losses.append(float(tr.last_loss))
    got = job["out"]["z0"][0]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    one = {f"p:{k}/{t}": w.numpy() for k, tags in tr.params.items()
           for t, w in tags.items()}
    one.update({f"aux:{k}/{t}": w.numpy() for k, tags in tr.aux.items()
                for t, w in tags.items()})
    assert set(one) == set(_leaves(got))
    for name, w in one.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=ATOL,
                                   err_msg=name)


def test_ranks_hold_equal_weights(job):
    a, b = job["out"]["z0"]
    for name, w in _leaves(a).items():
        assert w.tobytes() == b[name].tobytes(), name
    np.testing.assert_array_equal(a["losses"], b["losses"])


@pytest.mark.parametrize("zero", [1, 3])
def test_zero_is_bit_equal_to_zero0(job, zero):
    base = job["out"]["z0"][0]
    for rank in range(2):
        got = job["out"][f"z{zero}"][rank]
        for name, w in _leaves(base).items():
            assert got[name].tobytes() == w.tobytes(), (rank, name)
        np.testing.assert_array_equal(got["losses"], base["losses"])


@pytest.mark.parametrize("zero,limit", [(0, 1.0), (1, 0.8), (3, 0.55)])
def test_zero_shard_bytes(job, zero, limit):
    for got in job["out"][f"z{zero}"]:
        frac = float(got["shard_bytes"]) / float(got["total_bytes"])
        assert frac <= limit, frac
        if zero:
            assert frac < 1.0


def test_zero3_checkpoint_loads_onto_one_rank(job):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET + "dev = cpu\n"))
    tr.load_model(os.path.join(job["tmp"], "z3.model"))
    got = job["out"]["z3"][0]
    for key, tags in tr.params.items():
        for tag, w in tags.items():
            assert w.numpy().tobytes() == got[f"p:{key}/{tag}"].tobytes()


def test_group_save_model_writes_once_and_shares_rank0s_failure(job):
    """``NetTrainer.save_model`` in a group: the ZeRO-3 slices are
    gathered into one checkpoint that rank 0 writes, and a write that
    fails on rank 0 raises on both ranks within the run's deadline."""
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET + "dev = cpu\n"))
    tr.load_model(os.path.join(job["tmp"], "z3.saved"))
    got = job["out"]["z3"]
    for key, tags in tr.params.items():
        for tag, w in tags.items():
            assert w.numpy().tobytes() == got[0][f"p:{key}/{tag}"].tobytes()
    err0, err1 = (str(g["save_error"]) for g in got)
    assert err0 and "failed to write on the primary" not in err0, err0
    assert err1.startswith("CheckpointError: ") and (
        "failed to write on the primary process" in err1), err1


def test_det_reduce_repeats_its_bits(job):
    a, b = job["out"]["det0"], job["out"]["det1"]
    for rank in range(2):
        for name, w in _leaves(a[rank]).items():
            assert w.tobytes() == b[rank][name].tobytes(), (rank, name)
    assert a[0]["losses"].tobytes() == b[0]["losses"].tobytes()


def test_check_weight_sync_catches_a_perturbed_rank(job):
    for got in job["out"]["z0"]:
        assert float(got["sync_dev"]) == 0.0
        msg = str(got["perturb_error"])
        assert msg.startswith("weight-sync check failed"), msg
        assert "across 2 processes" in msg
