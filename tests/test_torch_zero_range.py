"""ZeRO over two gloo ranks on the CPU: the gather at use, the
reduce-scattered gradients and the sharded ``lars``/``lamb`` state,
against the JAX package's two devices.

One job of two rank processes (``tests/torch_zero_rank.py``) first
checks the data-axis collectives (``distributed.reduce_scatter``,
``pack_by_rank``, ``gather_slices``: ``GatherSlice``'s forward and
backward, plain and under ``det``), then runs, from one checkpoint, a
small inception-shaped net (a conv, batch norm, a sibling-1x1 group on
K6's path, two 3x3 convs, a ``fullc``) on 4 seeded global batches of 8
as ``zero = 0``, ``1`` and ``3``, ``zero = 0`` and ``3`` at
``update_period = 2``, and ``lars`` and ``lamb`` at ``zero = 0`` and
``1``.

* ``zero = 3`` gathers each layer (each sibling group, batch norm with
  the conv before it) at use: bit-equal
  to ``zero = 0`` (on two ranks a reduce-scatter's sum is the
  all-reduce's one addition), within ``ATOL`` of the JAX trainer's
  ``zero = 3`` on ``dev = cpu:0-1``, and the most whole-weight bytes a
  rank held at once (``zero_gathered_peak_bytes``) at most twice the
  largest group gathered at once and below the whole net's.
* ``update_period = 2``: each micro-batch's gradient is reduce-scattered
  into the slice's accumulator, so the sums run in another order than
  ``zero = 0``'s: both within ``ACCUM_TOL`` (a share of each tensor's
  largest magnitude) of the JAX trainer's ``zero = 3``.
* The sharded gradients are reduce-scattered: ``zero = 1`` and ``3``
  hand the all-reduce twice the bytes the reduce-scatter takes fewer
  than ``zero = 0`` does (``distributed.STATS['by_op']``).
* ``lars`` and ``lamb`` under ``zero = 1``: each rank holds at most 0.55
  of one replica's updater state, and the weights are within
  ``NORM_TOL`` of the JAX trainer's ``zero = 1`` (the trust ratio's
  squared norms are summed over the ranks' slices) and of the port's
  ``zero = 0``.
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
from cxxnet_tpu_torch.nnet.trainer import NetTrainer

HERE = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 150  # each rank process
ATOL = 1e-6  # weights after 4 steps at eta 0.1 (updates ~1e-2)
# update_period = 2 and the norm updaters: each tensor within this share
# of its largest magnitude (the gradient and norm sums run in other
# orders in the two packages)
ACCUM_TOL = 1e-5
NORM_TOL = 1e-5
ATOL_FLOOR = 1e-7
STEPS = 4

NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 16
  pad = 1
  no_bias = 1
  init_sigma = 0.1
layer[1->1] = batch_norm:bn1
layer[1->1] = relu
layer[1->2] = conv:a
  kernel_size = 1
  nchannel = 16
  init_sigma = 0.1
layer[1->3] = conv:b
  kernel_size = 1
  nchannel = 8
  init_sigma = 0.1
layer[2,3->4] = ch_concat
layer[4->5] = conv:c3
  kernel_size = 3
  nchannel = 16
  pad = 1
  init_sigma = 0.05
layer[5->5] = relu
layer[5->6] = max_pooling
  kernel_size = 2
  stride = 2
layer[6->7] = conv:c4
  kernel_size = 3
  nchannel = 16
  pad = 1
  init_sigma = 0.05
layer[7->7] = relu
layer[7->8] = flatten
layer[8->9] = fullc:fc
  nhidden = 4
  init_sigma = 0.1
layer[9->9] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 8
updater = sgd
eta = 0.1
momentum = 0.9
wd = 0.0001
seed = 5
"""
RUNS = {
    "z0": [],
    "z1": [("zero", "1")],
    "z3": [("zero", "3")],
    "z0p2": [("update_period", "2")],
    "z3p2": [("zero", "3"), ("update_period", "2")],
    "lars0": [("updater", "lars"), ("trust_coeff", "1")],
    "lars1": [("updater", "lars"), ("trust_coeff", "1"), ("zero", "1")],
    "lamb0": [("updater", "lamb"), ("eta", "0.01")],
    "lamb1": [("updater", "lamb"), ("eta", "0.01"), ("zero", "1")],
}


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


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("zero"))
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
    runs = [dict(cfg=pairs + extra, init=init, batches=batches, steps=STEPS,
                 out=os.path.join(tmp, name))
            for name, extra in RUNS.items()]
    spec = {"world": 2, "coord": f"127.0.0.1:{_free_port()}",
            "timeout_s": 60, "ops": os.path.join(tmp, "ops"), "runs": runs}
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_zero_rank.py"), path,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
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
    out = {name: [dict(np.load(os.path.join(tmp, f"{name}.r{r}.npz")))
                  for r in range(2)] for name in RUNS}
    ops = [dict(np.load(os.path.join(tmp, f"ops.r{r}.npz")))
           for r in range(2)]
    return {"tmp": tmp, "init": init, "batches": batches, "out": out,
            "ops": ops}


def _params(d):
    return {k: v for k, v in d.items() if k.startswith(("p:", "aux:"))}


def _jax_run(job, extra, monkeypatch=None):
    """The JAX trainer on ``dev = cpu:0-1`` from the job's checkpoint
    over its batches: ``{p:key/tag, aux:key/tag: ndarray}``."""
    from cxxnet_tpu.parallel.distributed import fetch_array

    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(NET + "dev = cpu:0-1\n") + extra)
    jt.load_model(job["init"])
    assert jt.mesh_plan.n_data == 2
    b = np.load(job["batches"])
    for k in range(STEPS):
        jt.update(JaxBatch(data=b["data"][k], label=b["label"][k]))
    out = {}
    for tree, pre in ((jt.params, "p:"), (jt.aux, "aux:")):
        for key, tags in tree.items():
            for tag, w in tags.items():
                out[f"{pre}{key}/{tag}"] = fetch_array(w)
    return out


def _close(got, ref, rel=None, atol=None):
    assert set(_params(got)) == set(ref)
    for name, w in ref.items():
        # a floor of ATOL_FLOOR for a tensor near 0
        tol = atol if atol is not None else max(
            rel * float(np.abs(w).max()), ATOL_FLOOR)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol,
                                   err_msg=name)


# ----------------------------------------------------------------------
# the collectives
def test_reduce_scatter_and_packing(job):
    ops = job["ops"]
    total = ops[0]["rs_in"] + ops[1]["rs_in"]
    for r in range(2):
        mine = total[r * 6:(r + 1) * 6]
        np.testing.assert_array_equal(ops[r]["rs"], mine)
        # det: the rank-order fold, the same bits on two ranks
        assert ops[r]["rs_det"].tobytes() == mine.tobytes()
        by_op = json.loads(str(ops[r]["by_op"]))
        assert by_op["reduce_scatter"] >= 6 * 4
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    b = np.arange(10, dtype=np.float32).reshape(2, 5)
    want = np.concatenate([a[:, :3].ravel(), b[:1].ravel(),
                           a[:, 3:].ravel(), b[1:].ravel()])
    np.testing.assert_array_equal(ops[0]["packed"], want)
    np.testing.assert_array_equal(ops[0]["unpacked0"], a[:, :3])
    np.testing.assert_array_equal(ops[0]["unpacked1"], b[:1])


@pytest.mark.parametrize("tag", ["plain", "det"])
def test_gather_slice_forward_and_backward(job, tag):
    ops = job["ops"]
    for n, rows in (("1", 3), ("2", 5)):
        whole = np.concatenate([ops[r][f"{tag}_s{n}"] for r in range(2)])
        csum = ops[0][f"{tag}_c{n}"] + ops[1][f"{tag}_c{n}"]
        for r in range(2):
            assert ops[r][f"{tag}_w{n}"].tobytes() == whole.tobytes()
            np.testing.assert_array_equal(
                ops[r][f"{tag}_g{n}"], csum[r * rows:(r + 1) * rows])


# ----------------------------------------------------------------------
# zero = 3: the gather at use
def test_zero3_matches_jax_zero3_on_two_devices(job):
    ref = _jax_run(job, [("zero", "3")])
    for got in job["out"]["z3"]:
        _close(got, ref, atol=ATOL)


@pytest.mark.parametrize("zero", [1, 3])
def test_zero_stays_bit_equal_to_zero0(job, zero):
    base = job["out"]["z0"][0]
    for got in job["out"][f"z{zero}"]:
        for name, w in _params(base).items():
            assert got[name].tobytes() == w.tobytes(), name
        np.testing.assert_array_equal(got["losses"], base["losses"])


def test_zero3_gathered_peak_is_one_group_at_a_time(job):
    for got in job["out"]["z3"]:
        z = json.loads(str(got["zero"]))
        assert 0 < z["zero_gathered_peak_bytes"] <= 2 * z[
            "largest_group_bytes"], z
        assert z["zero_gathered_peak_bytes"] < z["whole_weight_bytes"], z
    assert "zero" not in job["out"]["z1"][0]


def test_zero3_gathers_vectors_with_the_layer_before():
    """Batch norm's gamma and beta come in the all-gather of the conv
    before it (no collective of their own); a group and every other
    layer with a cut matrix gather alone."""
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET + "dev = cpu\n"))
    tr.init_model()
    dims = {k: {t: 0 for t in tags} for k, tags in tr.params.items()}
    vectors = {k for k, tags in tr.params.items()
               if all(w.dim() == 1 for w in tags.values())}
    assert vectors == {"l1_bn1"}
    tr.net.bind_data_slices(None, dims, vectors=vectors)
    assert tr.net.zero_units() == [["l0_c1", "l1_bn1"], ["l3_a", "l4_b"],
                                   ["l6_c3"], ["l9_c4"], ["l12_fc"]]
    tr.net.bind_data_slices(None, dims)
    assert ["l1_bn1"] in tr.net.zero_units()


@pytest.mark.parametrize("zero", [0, 3])
def test_update_period_two_matches_jax_zero3(job, zero):
    ref = _jax_run(job, [("zero", "3"), ("update_period", "2")])
    for got in job["out"][f"z{zero}p2"]:
        _close(got, ref, rel=ACCUM_TOL)


@pytest.mark.parametrize("zero", [1, 3])
def test_sharded_gradients_are_reduce_scattered(job, zero):
    """The sharded tensors' gradients leave the all-reduce for a
    reduce-scatter that takes half their bytes."""
    base = json.loads(str(job["out"]["z0"][0]["by_op"]))
    for got in job["out"][f"z{zero}"]:
        by_op = json.loads(str(got["by_op"]))
        rs = by_op["reduce_scatter"]
        assert rs > 0
        assert base["all_reduce"] - by_op.get("all_reduce", 0) == 2 * rs
    assert "reduce_scatter" not in base


# ----------------------------------------------------------------------
# lars and lamb under zero = 1
def _state_bytes(d, prefix="u:"):
    return sum(v.nbytes for k, v in d.items() if k.startswith(prefix))


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_norm_updater_state_is_cut(job, name):
    whole = _state_bytes(job["out"][f"{name}0"][0])
    for got in job["out"][f"{name}1"]:
        assert _state_bytes(got) <= 0.55 * whole, (_state_bytes(got), whole)


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_norm_updaters_under_zero1_match_jax(job, name):
    extra = dict(RUNS[f"{name}1"])
    ref = _jax_run(job, list(extra.items()))
    for got in job["out"][f"{name}1"]:
        _close(got, ref, rel=NORM_TOL)
        _close(got, _params(job["out"][f"{name}0"][0]), rel=NORM_TOL)
