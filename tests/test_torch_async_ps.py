"""Async data parallelism (``parallel/async_ps``) against the JAX
package, on the CPU.

* ``partition_groups`` (and ``group_param_counts``) equal to the JAX
  function's on several parameter trees and group counts, exactly.
* ``AsyncUpdater`` over a recording apply: ``staleness = 0`` applies
  each push at once, ``staleness = k`` exactly k behind (in push
  order, each aggregate at its own step), ``drain`` applies the rest,
  ``reset_staleness`` drops what is pending and bumps the generation,
  an aggregate of a dead generation is dropped at the apply (counted in
  ``async_stale_dropped_total{reason}``), and ``checkpoint_bytes``
  drains a trainer's buffers first.
* One job of two gloo rank processes (``tests/torch_dp_rank.py``), from
  one checkpoint, 3 steps a round of a 2-conv net with batch norm in
  batch mode: ``det_reduce = 1``; ``async_overlap = 1, staleness = 0``
  over one round, whose checkpoint holds ``det_reduce``'s arrays (the
  same CRC over them); ``staleness = 1`` over two rounds, each drained at
  its end.  Against the JAX trainer on ``dev = cpu:0-1`` (``update``,
  then ``async_round_end``) every weight agrees within ``ATOL`` at
  ``staleness = 0`` and ``1``; the ranks' weights are bit-equal; the
  snapshot counts what the JAX one counts and leaves nothing pending.
  ``model_parallel = 2`` is refused with the JAX message.
* The refusals over two ranks (stochastic layers, ``aux`` state,
  ``update_scan``, ``staleness`` without ``async_overlap``) with the
  JAX messages.
"""

import json
import os
import types
import zlib

import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.parallel.async_ps import groups as jgroups

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.obs.registry import registry as obs_registry
from cxxnet_tpu_torch.parallel import distributed as pdist
from cxxnet_tpu_torch.parallel.async_ps import (AsyncStepper, AsyncUpdater,
                                                group_param_counts,
                                                partition_groups)

from test_torch_parallel_dp import DET_NET, run_ranks  # noqa: E402

ATOL = 1e-6  # weights after 3-6 steps at eta 0.1 (updates ~1e-2)
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


# ----------------------------------------------------------------------
# the partition
_TREES = {
    "one": [("l0", {"w": (5,)})],
    "mlp": [("l0_fc1", {"wmat": (6, 8), "bias": (6,)}),
            ("l2_fc2", {"wmat": (3, 6), "bias": (3,)})],
    "skewed": [("l0_c", {"wmat": (3, 3, 3, 64), "bias": (64,)}),
               ("l3_c", {"wmat": (3, 3, 64, 64), "bias": (64,)}),
               ("l6_fc", {"wmat": (10, 4096), "bias": (10,)}),
               ("l8_s", {"w": ()})],
    "even": [(f"l{i}", {"wmat": (4, 4)}) for i in range(9)],
}


@pytest.mark.parametrize("n_groups", [0, 1, 2, 3, 4, 7, 50])
@pytest.mark.parametrize("tree", sorted(_TREES))
def test_partition_groups_is_jax_s(tree, n_groups):
    shapes = _TREES[tree]
    jtree = {k: {t: np.zeros(s, np.float32) for t, s in tags.items()}
             for k, tags in shapes}
    ttree = {k: {t: torch.zeros(s) for t, s in tags.items()}
             for k, tags in shapes}
    want = jgroups.partition_groups(jtree, n_groups)
    got = partition_groups(ttree, n_groups)
    assert got == [list(map(tuple, g)) for g in want]
    assert group_param_counts(ttree, got) == jgroups.group_param_counts(
        jtree, want)


# ----------------------------------------------------------------------
# the buffers
def _updater(staleness, n_groups=1):
    applied = []
    trainer = types.SimpleNamespace(
        params={"l0": {"w": torch.zeros(2)}})
    up = AsyncUpdater(trainer, [[("l0", "w")]] * n_groups,
                      staleness=staleness,
                      apply_fn=lambda gid, grads, epoch: applied.append(
                          (gid, epoch, float(grads[0][0]))))
    return up, applied


def test_staleness_0_applies_each_push_at_once():
    up, applied = _updater(0)
    for ep in range(3):
        up.push(0, [torch.full((2,), float(ep))], ep)
        assert up.pull_req(0) == 1
        assert applied[-1] == (0, ep, float(ep))
    assert up.snapshot()["pending"] == [0]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_staleness_k_applies_exactly_k_behind(k):
    up, applied = _updater(k)
    for ep in range(6):
        up.push(0, [torch.full((2,), float(ep))], ep)
        up.pull_req(0)
        assert up.pending_depth(0) == min(ep + 1, k)
        assert [a[1] for a in applied] == list(range(max(0, ep + 1 - k)))
    assert up.drain() == k
    assert [a[1] for a in applied] == list(range(6))
    assert [a[2] for a in applied] == [float(e) for e in range(6)]
    snap = up.snapshot()
    assert (snap["pushes"], snap["applies"], snap["pending"]) == (6, 6, [0])


def _dropped(reason):
    fam = obs_registry().counter("async_stale_dropped_total",
                                 labelnames=("reason",))
    return fam.labels(reason=reason).value


def test_reset_and_a_dead_generation_never_apply():
    up, applied = _updater(2)
    up.push(0, [torch.ones(2)], 0)
    before = _dropped("rollback")
    assert up.reset_staleness(reason="rollback") == 1
    assert up.generation == 1 and up.pending_depth(0) == 0
    assert _dropped("rollback") == before + 1
    # an aggregate stamped by generation 1, applied after generation 2
    up.push(0, [torch.ones(2)], 1)
    up.push(0, [torch.ones(2)], 2)
    up.push(0, [torch.ones(2)], 3)
    up.generation = 2
    gen_before = _dropped("generation")
    assert up.pull_req(0) == 0  # the stale one is discarded, not applied
    assert applied == [] and up.pending_depth(0) == 2
    assert _dropped("generation") == gen_before + 1
    assert up.drain() == 0 and applied == []
    assert up.snapshot()["dropped"] == 4


def test_checkpoint_bytes_drains_the_buffers():
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(DET_NET + "dev = cpu\n")
                  + [("async_overlap", "1"), ("staleness", "2")])
    tr.init_model()
    assert not tr._async_active()  # one rank: the documented no-op
    tr._async = AsyncStepper(tr)
    up = tr._async.updater
    gid = len(up.groups) - 1
    names = up.groups[gid]
    grads = [torch.full_like(tr.params[k][t], 0.5) for k, t in names]
    before = [tr.params[k][t].clone() for k, t in names]
    up.push(gid, grads, 0)
    up.pull_req(gid)
    assert up.pending_depth(gid) == 1
    tr.checkpoint_bytes()
    assert up.pending_depth(gid) == 0
    for (k, t), w0 in zip(names, before):
        assert not torch.equal(tr.params[k][t], w0), (k, t)


# ----------------------------------------------------------------------
# two ranks against det_reduce and the JAX package
RUNS = {"det": ([("det_reduce", "1")], 0),
        "a0": ([("async_overlap", "1")], 1),
        "a1": ([("async_overlap", "1"), ("staleness", "1"),
                ("async_resync_period", "1")], 2)}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("async"))
    rng = np.random.RandomState(0)
    batches = os.path.join(tmp, "b.npz")
    np.savez(batches,
             data=rng.randn(STEPS, 8, 8, 8, 3).astype(np.float32),
             label=rng.randint(0, 4, (STEPS, 8, 1)).astype(np.float32))
    pairs = tcfg.parse_pairs(DET_NET + "dev = cpu\n")
    tr = NetTrainer()
    tr.set_params(pairs)
    tr.init_model()
    init = os.path.join(tmp, "init.model")
    tr.save_model(init)
    runs = [dict(cfg=pairs + extra, init=init, batches=batches, steps=STEPS,
                 rounds=rounds, out=os.path.join(tmp, name))
            for name, (extra, rounds) in RUNS.items()]
    runs.append(dict(cfg=pairs + [("async_overlap", "1"),
                                  ("model_parallel", "2")],
                     expect_error=True, out=os.path.join(tmp, "mp")))
    run_ranks({"runs": runs}, tmp, 2)
    out = {name: [dict(np.load(os.path.join(tmp, f"{name}.r{r}.npz")))
                  for r in range(2)] for name in (*RUNS, "mp")}
    return {"tmp": tmp, "init": init, "batches": batches, "out": out}


def _leaves(d):
    return {k: v for k, v in d.items() if k.startswith(("p:", "aux:"))}


def _checkpoint_crc(path):
    """CRC32 of a checkpoint's arrays, in their sorted names' order (the
    file's own bytes carry the npz members' write times)."""
    _h, params, aux, ust = NetTrainer._read_model_file(path)
    crc = 0
    for tree in (params, aux):
        for key in sorted(tree):
            for tag in sorted(tree[key]):
                crc = zlib.crc32(np.ascontiguousarray(tree[key][tag])
                                 .tobytes(), crc)
    return crc


def test_staleness_0_checkpoint_is_det_reduce_s(job):
    def crc(name):
        return _checkpoint_crc(os.path.join(job["tmp"], f"{name}.model"))

    assert crc("a0") == crc("det")
    det, a0 = job["out"]["det"][0], job["out"]["a0"][0]
    for name, w in _leaves(det).items():
        assert a0[name].tobytes() == w.tobytes(), name
    assert a0["losses"].tobytes() == det["losses"].tobytes()


def _jax_async(job, extra, rounds):
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(DET_NET + "dev = cpu:0-1\n") + extra)
    jt.load_model(job["init"])
    assert jt._async_active()
    b = np.load(job["batches"])
    for r in range(rounds):
        for k in range(STEPS):
            jt.update(JaxBatch(data=b["data"][k], label=b["label"][k]))
        jt.async_round_end(r + 1)
    return jt


@pytest.mark.parametrize("name", ["a0", "a1"])
def test_async_matches_jax_on_two_devices(job, name):
    from cxxnet_tpu.parallel.distributed import fetch_array

    extra, rounds = RUNS[name]
    jt = _jax_async(job, extra, rounds)
    got = job["out"][name]
    n = 0
    for key, tags in jt.params.items():
        for tag, w in tags.items():
            np.testing.assert_allclose(got[0][f"p:{key}/{tag}"],
                                       fetch_array(w), rtol=0, atol=ATOL,
                                       err_msg=f"{key}/{tag}")
            n += 1
    assert n == len(_leaves(got[0]))
    for leaf, w in _leaves(got[0]).items():
        assert got[1][leaf].tobytes() == w.tobytes(), leaf
    snap = json.loads(str(got[0]["async"]))
    want = jt.async_snapshot()
    for key in ("groups", "staleness", "generation", "pending", "pushes",
                "applies", "dropped", "resync_period"):
        assert snap[key] == want[key], key
    assert snap["pending"] == [0] * snap["groups"]
    assert 0.0 <= snap["overlap_fraction"] <= 1.0


def test_async_refuses_the_model_axis_as_jax(job):
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(DET_NET + "dev = cpu:0-1\n")
                  + [("async_overlap", "1"), ("model_parallel", "2")])
    with pytest.raises(ValueError) as e:
        jt.init_model()
    for got in job["out"]["mp"]:
        assert str(got["error"]) == f"ValueError: {e.value}"


# ----------------------------------------------------------------------
# the refusals over two ranks, in one process
def _outcome(make, pairs, scan=False):
    tr = make()
    try:
        tr.set_params(pairs)
        tr.init_model()
        if scan:
            tr.update_scan(np.zeros((2, 8, 8, 8, 3), np.float32),
                           np.zeros((2, 8), np.float32))
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return "ok", ""


BN_RUNNING = DET_NET.replace("layer[1->1] = batch_norm:bn1",
                             "layer[1->1] = batch_norm:bn1\n"
                             "  bn_eval = running")
DROPOUT = DET_NET.replace("layer[3->4] = flatten",
                          "layer[3->4] = flatten\nlayer[4->4] = dropout\n"
                          "  threshold = 0.3")


@pytest.mark.parametrize("net,keys,scan", [
    (DROPOUT, [("async_overlap", "1")], False),
    (BN_RUNNING, [("async_overlap", "1")], False),
    (DET_NET, [("async_overlap", "1"), ("update_period", "2")], False),
    (DET_NET, [("async_overlap", "1"), ("zero", "1")], False),
    (DET_NET, [("staleness", "1")], False),
    (DET_NET, [("async_overlap", "1"), ("eval_train", "0")], True),
])
def test_refusals_over_two_ranks_are_jax_s(monkeypatch, net, keys, scan):
    jax_out = _outcome(JaxTrainer,
                       jcfg.parse_pairs(net + "dev = cpu:0-1\n") + keys,
                       scan)
    monkeypatch.setattr(pdist, "process_info", lambda: (0, 2))
    port_out = _outcome(NetTrainer,
                        tcfg.parse_pairs(net + "dev = cpu\n") + keys, scan)
    assert jax_out[0] == "ValueError", jax_out
    assert port_out == jax_out
