"""The elastic pod (``parallel/elastic.py`` and the CLI's rebuild) against
the JAX package, on the CPU.

* The JAX package's unit tests of ``tests/test_elastic.py`` (the
  options, the coordinator's plans, slow against lost, the collective
  deadline, ``classify_failure``, the typed error, ``/healthz`` while a
  rebuild runs), each run on both modules, ``cxxnet_tpu.parallel.
  elastic`` and the port's, with each package's fault sites, trainer
  and engine; and the integrity eviction, once per verdict.
* The wire: a port member against a JAX coordinator and the reverse,
  through a loss, a planned shrink, a grow and an eviction, every
  member of both packages handed the same plans.
* The async step's generation (JAX ``tests/test_elastic.py`` :391-500)
  on each package's async updater: a rebuild drops every pending
  aggregate and moves to the new generation, and an aggregate of a dead
  generation is never applied.
* ``classify_failure`` on the text a 2-rank CPU gloo group really
  raises when its peer is SIGKILLed (a loss), and on a data source's
  plain ``ConnectionError`` (not one); the teardown without a
  collective frees rank 0's store port, and a group a thread is still
  inside is abandoned and a new one joined (``tests/torch_elastic_rank.py``).
* Through the CLI on gloo ranks, all jobs started together:
  ``python -m cxxnet_tpu_torch.tools.elastic_kill --ranks 3 --dev cpu``
  (3 -> 2
  -> 3 after a SIGKILL, a joiner admitted; the same schedule planned:
  every checkpoint's CRC equal, the dropped rank leaving with exit 0 and
  the JAX package's line); the integrity quarantine with ``elastic = 1``
  (exits ``[0, 41, 0]``, the survivors resuming at the last verified
  round + 1 and finishing ``num_round``, every later vote clean);
  ``mesh.replica:ioerror`` on one rank (it gives up, the survivors
  rebuild and finish); ``mesh.replica:hang`` on one rank (the JAX
  package's outcome: the wedged rank keeps beating, so no plan comes;
  gloo's ``dist_timeout_s`` errors the others' collective, the loss is
  presumed, and every rank ends, none hangs); a rank stopped by
  SIGSTOP (its beats stop: the survivors rebuild within
  ``collective_timeout_s`` plus the detection); a device range with
  ``elastic = 1`` (not armed, one line says so); ``elastic_join = 1``
  with ``task=pred`` (the JAX package's ``ValueError``).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from cxxnet_tpu.parallel import elastic as jelastic
from cxxnet_tpu.utils import faults as jfaults
from cxxnet_tpu_torch.parallel import elastic as telastic
from cxxnet_tpu_torch.tools import elastic_kill as lane
from cxxnet_tpu_torch.utils import faults as tfaults

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DEADLINE_S = 150
# the CLI jobs' liveness settings: a replica is lost after T seconds of
# silence; the deadline of a collective with a suspect; gloo's own
HEARTBEAT_S, T = 0.2, 1.5
COLLECTIVE_S = 2.0
# the wedged-rank job's gloo timeout: its collectives' deadline, and its
# rendezvous', which must outlast the ranks' start-up skew on a loaded
# machine (the ranks start with every other job of the file)
HANG_DIST_TIMEOUT_S = 12


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_async_ps.py``: drop the empty device-plane
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


def _pkg(name):
    if name == "jax":
        from cxxnet_tpu.nnet.trainer import NetTrainer
        from cxxnet_tpu.obs.registry import registry

        return types.SimpleNamespace(name=name, E=jelastic, faults=jfaults,
                                     NetTrainer=NetTrainer, registry=registry)
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.obs.registry import registry

    return types.SimpleNamespace(name=name, E=telastic, faults=tfaults,
                                 NetTrainer=NetTrainer, registry=registry)


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    p = _pkg(request.param)
    yield p
    p.faults.reset()


# ----------------------------------------------------------------------
# the options
def test_options_from_cfg_defaults_and_keys(pkg):
    E = pkg.E
    o = E.ElasticOptions.from_cfg([])
    assert not o.elastic and o.min_replicas == 1
    assert o.collective_timeout_s == 30.0
    o = E.ElasticOptions.from_cfg([
        ("elastic", "1"), ("elastic_min_replicas", "2"),
        ("elastic_rejoin_s", "9"), ("elastic_heartbeat_s", "0.1"),
        ("elastic_timeout_s", "0.7"), ("collective_timeout_s", "3"),
        ("elastic_coordinator", "h:1234"), ("elastic_drop_at", "4"),
        ("elastic_join", "1"), ("elastic_join_at", "6"),
    ])
    assert o.elastic and o.join and o.min_replicas == 2
    assert (o.rejoin_s, o.heartbeat_s, o.timeout_s) == (9.0, 0.1, 0.7)
    assert o.collective_timeout_s == 3.0
    assert (o.coordinator, o.drop_at, o.join_at) == ("h:1234", 4, 6)
    with pytest.raises(ValueError, match="elastic_min_replicas"):
        E.ElasticOptions.from_cfg([("elastic_min_replicas", "0")])
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(E.ElasticOptions)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jelastic.ElasticOptions)])


def test_resolve_coordinator_defaults_to_dist_port_plus_one(pkg):
    o = pkg.E.ElasticOptions()
    assert o.resolve_coordinator("node0:9000") == "node0:9001"
    o.coordinator = "other:7"
    assert o.resolve_coordinator("node0:9000") == "other:7"


# ----------------------------------------------------------------------
# the coordinator and the members (real TCP)
def _cluster(E, n=3, min_replicas=1, timeout_s=0.6, member_E=None):
    """A coordinator of ``E`` in rank 0's member, the other members of
    ``member_E`` (default ``E``)."""
    member_E = member_E or E
    opts = E.ElasticOptions(elastic=True, heartbeat_s=0.1,
                            timeout_s=timeout_s, min_replicas=min_replicas)
    mopts = member_E.ElasticOptions(elastic=True, heartbeat_s=0.1,
                                    timeout_s=timeout_s,
                                    min_replicas=min_replicas)
    m0 = E.ElasticMember("localhost:0", 0, opts, host_coordinator=True,
                         num=n, jax_host="localhost")
    members = [m0.start()]
    for r in range(1, n):
        members.append(member_E.ElasticMember(m0.addr, r, mopts).start())
    return opts, members


def _close_all(members):
    for m in members:
        m.close()


def _stop_beats(m):
    m._stop.set()
    m._beat_thread.join()


def test_loss_detected_and_survivors_replanned(pkg):
    """A member that stops beating is LOST within elastic_timeout_s; the
    survivors get a re-ranked plan (their order kept, rank 0 stays 0)
    with a fresh store port."""
    opts, ms = _cluster(pkg.E, 3)
    try:
        time.sleep(0.3)
        _stop_beats(ms[2])
        t0 = time.monotonic()
        assert ms[0].lost_event.wait(5), "loss not detected"
        assert time.monotonic() - t0 < 3.0
        assert ms[1].lost_event.wait(2)
        time.sleep(0.3)
        p0, p1 = ms[0].pending_plan(), ms[1].pending_plan()
        assert p0.reason == "replica_lost" and p0.lost_ranks == [2]
        assert (p0.num, p0.rank) == (2, 0)
        assert (p1.num, p1.rank) == (2, 1)
        assert p0.jax_coordinator == p1.jax_coordinator
        assert p0.generation == p1.generation == 2
        ms[0].ack_generation(p0)
        assert not ms[0].lost_event.is_set()
        snap = pkg.registry().snapshot()
        assert snap["mesh_replicas"]['mesh_replicas{state="lost"}'] >= 1.0
    finally:
        _close_all(ms)


def test_planned_shrink_drops_highest_rank_idempotently(pkg):
    opts, ms = _cluster(pkg.E, 3)
    try:
        plans = [m.plan_shrink(5) for m in ms]  # every rank, one round
        assert {p.generation for p in plans} == {2}
        assert plans[2].rank is None, "the highest rank leaves"
        assert (plans[0].rank, plans[1].rank) == (0, 1)
        assert plans[0].num == 2 and plans[0].at_round == 5
        assert plans[0].reason == "planned_shrink"
    finally:
        _close_all(ms)


def test_grow_admits_waiter_and_survives_round_skew(pkg):
    """A joiner is admitted at the scheduled boundary; a member one round
    late gets the SAME plan (no split rendezvous)."""
    opts, ms = _cluster(pkg.E, 2)
    try:
        waiter = pkg.E.ElasticMember(ms[0].addr, -1, opts)
        box = {}
        t = threading.Thread(
            target=lambda: box.update(plan=waiter.join(timeout_s=10)),
            daemon=True)
        t.start()
        time.sleep(0.3)
        ms[0].poll_now()
        g = ms[0].grow_round()
        assert g is not None
        pa = ms[0].plan_grow(g)
        pb = ms[1].plan_grow(g + 1)
        assert pa.generation == pb.generation
        assert pa.num == 3 and pa.reason == "grow"
        t.join(timeout=5)
        assert box["plan"].rank == 2
    finally:
        _close_all(ms)


def test_abort_below_min_replicas(pkg):
    opts, ms = _cluster(pkg.E, 2, min_replicas=2)
    try:
        _stop_beats(ms[1])
        assert ms[0].lost_event.wait(5)
        time.sleep(0.3)
        ms[0].poll_now()
        assert "elastic_min_replicas" in ms[0].abort_reason
    finally:
        _close_all(ms)


def test_slow_vs_lost_classification(pkg):
    """A member silent for a few beats is only SUSPECT; it recovers by
    beating again; silence past elastic_timeout_s is LOST."""
    opts, ms = _cluster(pkg.E, 2, timeout_s=1.5)
    try:
        _stop_beats(ms[1])
        time.sleep(0.5)
        ms[0].poll_now()
        assert ms[0].suspects() == [1]
        assert not ms[0].lost_event.is_set()
        ms[1]._stop = threading.Event()
        ms[1]._beat_thread = threading.Thread(target=ms[1]._beat_loop,
                                              daemon=True)
        ms[1]._beat_thread.start()
        time.sleep(0.4)
        ms[0].poll_now()
        assert ms[0].suspects() == []
        assert not ms[0].lost_event.is_set()
    finally:
        _close_all(ms)


def test_evict_is_one_generation_per_verdict(pkg):
    """The integrity quarantine: every survivor reports the same (rank,
    round) and gets the same generation; the named rank leaves."""
    opts, ms = _cluster(pkg.E, 3)
    try:
        plans = [ms[r].plan_evict(1, 4) for r in (0, 2, 0)]
        assert {p.generation for p in plans} == {2}
        assert plans[0].reason == "integrity_evict"
        assert (plans[0].rank, plans[1].rank, plans[0].num) == (0, 1, 2)
        assert ms[1].plan_evict(1, 4).rank is None
    finally:
        _close_all(ms)


# ----------------------------------------------------------------------
# the wire between the packages
def _plan_fields(p):
    return (p.generation, p.reason, p.num, p.rank, p.jax_coordinator,
            p.at_round, p.lost_ranks, p.abort)


@pytest.mark.parametrize("coord, member", [("jax", "port"), ("port", "jax")])
def test_members_against_the_other_package_s_coordinator(coord, member):
    """Rank 0 (and the coordinator) of one package, ranks 1-3 and a
    joiner of the other: a loss, a planned shrink, a grow and an
    eviction hand every member the plan it would get from its own
    package's coordinator."""
    C, M = _pkg(coord).E, _pkg(member).E
    opts, ms = _cluster(C, 4, member_E=M)
    try:
        time.sleep(0.3)
        # a loss: rank 3 goes silent
        _stop_beats(ms[3])
        assert ms[1].lost_event.wait(5) and ms[2].lost_event.wait(5)
        time.sleep(0.3)
        lost = [m.pending_plan() for m in ms[:3]]
        assert [(p.generation, p.reason, p.num, p.rank, p.lost_ranks)
                for p in lost] == [(2, "replica_lost", 3, r, [3])
                                   for r in range(3)]
        assert len({p.jax_coordinator for p in lost}) == 1
        for m, p in zip(ms[:3], lost):
            m.ack_generation(p, rank=p.rank)
        # a planned shrink: rank 2 leaves
        shrink = [m.plan_shrink(4) for m in ms[:3]]
        assert [_plan_fields(p)[2:4] for p in shrink] == [(2, 0), (2, 1),
                                                          (2, None)]
        assert len({repr(_plan_fields(p)[:3] + _plan_fields(p)[4:])
                    for p in shrink}) == 1
        for m, p in zip(ms[:2], shrink):
            m.ack_generation(p, rank=p.rank)
        # a grow: a waiter of the member package is admitted
        waiter = M.ElasticMember(ms[0].addr, -1, M.ElasticOptions(
            elastic=True, heartbeat_s=0.1, timeout_s=0.6))
        box = {}
        t = threading.Thread(
            target=lambda: box.update(plan=waiter.join(timeout_s=10)),
            daemon=True)
        t.start()
        time.sleep(0.3)
        for m in ms[:2]:
            m.poll_now()
        g = ms[1].grow_round()
        assert g == ms[0].grow_round() and g is not None
        grow = [m.plan_grow(g) for m in ms[:2]]
        t.join(timeout=5)
        grow.append(box["plan"])
        assert [(p.generation, p.reason, p.num, p.rank) for p in grow] == [
            (4, "grow", 3, 0), (4, "grow", 3, 1), (4, "grow", 3, 2)]
        assert len({p.jax_coordinator for p in grow}) == 1
        for m, p in zip(ms[:2], grow):
            m.ack_generation(p, rank=p.rank)
        waiter.start()
        ms.append(waiter)
        waiter.ack_generation(box["plan"], rank=2)
        # an eviction of rank 1, reported by ranks 0 and 2
        ev = [ms[0].plan_evict(1, 6), waiter.plan_evict(1, 6),
              ms[1].plan_evict(1, 6)]
        assert [(p.generation, p.reason, p.num, p.rank) for p in ev] == [
            (5, "integrity_evict", 2, 0), (5, "integrity_evict", 2, 1),
            (5, "integrity_evict", 2, None)]
        status = ms[1]._rpc({"op": "status"})
        assert status["gen"] == 5 and status["lost_total"] == 1
        assert status["rejoined_total"] == 1
    finally:
        _close_all(ms)


# ----------------------------------------------------------------------
# the collective deadline and classification
class _Stub:
    def __init__(self, lost=False, suspects=()):
        self.lost_event = threading.Event()
        if lost:
            self.lost_event.set()
        self.abort_reason = ""
        self._s = list(suspects)

    def suspects(self):
        return list(self._s)

    def pending_plan(self):
        return None


def test_replica_loss_surfaces_within_collective_timeout(pkg):
    """A dead peer inside a collective surfaces as the typed
    ReplicaLossError within collective_timeout_s, through the
    ``mesh.replica`` fault site of ``NetTrainer.sync``."""
    pkg.faults.install("mesh.replica:hang:1:1")
    tr = pkg.NetTrainer()
    t0 = time.monotonic()
    with pytest.raises(pkg.E.ReplicaLossError) as ei:
        pkg.E.guarded_call(tr.sync, _Stub(suspects=[3]), timeout_s=0.5,
                           what="step fence")
    elapsed = time.monotonic() - t0
    pkg.faults.reset()  # releases the hung worker
    assert elapsed < 5.0, f"the deadline did not bound the hang ({elapsed})"
    assert ei.value.presumed and ei.value.lost == [3]


def test_confirmed_loss_preempts_deadline(pkg):
    pkg.faults.install("mesh.replica:hang:1:1")
    t0 = time.monotonic()
    with pytest.raises(pkg.E.ReplicaLossError) as ei:
        pkg.E.guarded_call(lambda: pkg.faults.fault_point("mesh.replica"),
                           _Stub(lost=True), timeout_s=30.0,
                           what="collective")
    pkg.faults.reset()
    assert time.monotonic() - t0 < 5.0, "a confirmed loss must not wait"
    assert not ei.value.presumed


def test_slow_mesh_keeps_waiting(pkg):
    def slow():
        time.sleep(0.6)
        return 41 + 1

    assert pkg.E.guarded_call(slow, _Stub(), timeout_s=0.2,
                              what="slow") == 42


def test_guarded_call_passthrough_without_member(pkg):
    assert pkg.E.guarded_call(lambda: 7, None) == 7


def test_classify_failure_translates_collective_errors(pkg):
    E = pkg.E
    member = _Stub(lost=True)
    loss = E.classify_failure(
        ValueError("Gloo all-reduce failed: Connection reset by peer"),
        member, confirm_s=0.1)
    assert isinstance(loss, E.ReplicaLossError) and not loss.presumed
    assert E.classify_failure(ValueError("shape mismatch"), member) is None
    assert E.classify_failure(ValueError("Gloo says hi"), None) is None
    orig = E.ReplicaLossError("x", lost=[1])
    assert E.classify_failure(orig, member) is orig
    # the mesh.replica site's injected I/O error reads as a loss
    err = pkg.faults.InjectedFault("injected I/O error at mesh.replica")
    assert isinstance(E.classify_failure(err, member, confirm_s=0.1),
                      E.ReplicaLossError)


def test_replica_loss_error_carries_typed_fields(pkg):
    e = pkg.E.ReplicaLossError("gone", lost=[1, 3], generation=4,
                               presumed=True, fatal=False)
    assert e.lost == [1, 3] and e.generation == 4
    assert e.presumed and not e.fatal


def _engine(name):
    if name == "jax":
        from cxxnet_tpu import serve
        from test_serve import make_trainer

        return serve.Engine(trainer=make_trainer(), max_batch_size=8,
                            batch_timeout_ms=0)
    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch import serve
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from test_serve import MLP_CFG

    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(MLP_CFG))
    tr.init_model()
    return serve.Engine(trainer=tr, max_batch_size=8, batch_timeout_ms=0)


def test_healthz_degrades_while_rebuilding(pkg):
    eng = _engine(pkg.name)
    try:
        assert eng.healthz()["status"] == "ok"
        pkg.E.set_rebuilding(True)
        h = eng.healthz()
        assert h["status"] == "degraded"
        assert h["mesh"] == "rebuilding"
        assert "mesh_rebuilding" in h["reasons"]
    finally:
        pkg.E.set_rebuilding(False)
        eng.close()
    assert not pkg.E.rebuild_in_progress()


def test_fault_site_runs_on_the_cpu_trainer():
    """``NetTrainer.sync`` visits ``mesh.replica`` on the CPU too:
    ``latency`` sleeps, ``ioerror`` raises, as in the JAX package."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    spec = tfaults.install("mesh.replica:latency:1")
    tfaults.injector().latency_s = 0.05
    t0 = time.perf_counter()
    tr.sync()
    assert time.perf_counter() - t0 >= 0.05 and spec.fired == 1
    tfaults.reset()
    tfaults.install("mesh.replica:ioerror:1:1")
    with pytest.raises(tfaults.InjectedFault, match="mesh.replica"):
        tr.sync()
    tr.sync()  # the limit is spent
    tfaults.reset()


# ----------------------------------------------------------------------
# the async step's generation
MLP_CFG = [
    ("batch_size", "16"), ("input_shape", "1,1,16"), ("seed", "7"),
    ("eta", "0.1"), ("momentum", "0.9"),
    ("netconfig", "start"),
    ("layer[0->1]", "fullc:fc1"), ("nhidden", "32"),
    ("layer[1->2]", "sigmoid"),
    ("layer[2->3]", "fullc:fc2"), ("nhidden", "8"),
    ("layer[3->3]", "softmax"),
    ("netconfig", "end"),
]
ASYNC = [("async_overlap", "1"), ("async_resync_period", "1000")]


def _async_trainer(name, staleness):
    """``(trainer, updater, weights before)``: an async updater holding
    one pending aggregate a group (generation 0), the JAX one over
    ``dev = tpu:0-3`` after a step, the port's over its one rank with
    the stepper built and one push a group (a one-rank port run takes
    the plain step)."""
    extra = ASYNC + [("staleness", str(staleness))]
    if name == "jax":
        from cxxnet_tpu.io.data import DataBatch
        from cxxnet_tpu.nnet.trainer import NetTrainer

        tr = NetTrainer()
        tr.set_params([("dev", "tpu:0-3")] + MLP_CFG + extra)
        tr.init_model()
        init = _params_np(tr)
        rng = np.random.RandomState(3)
        tr.update(DataBatch(
            data=rng.randn(16, 16).astype(np.float32),
            label=rng.randint(0, 8, (16, 1)).astype(np.float32)))
        return tr, tr._async.updater, init
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.parallel.async_ps import AsyncStepper

    tr = NetTrainer()
    tr.set_params([("dev", "cpu")] + MLP_CFG + extra)
    tr.init_model()
    init = _params_np(tr)
    tr._async = AsyncStepper(tr)
    up = tr._async.updater
    for gid, names in enumerate(up.groups):
        up.push(gid, [torch.full_like(tr.params[k][t], 0.01)
                      for k, t in names], 0)
        up.pull_req(gid)
    return tr, up, init


def _params_np(tr):
    return {k: {t: np.array(w) for t, w in tags.items()}
            for k, tags in tr.params.items()}


def test_async_rebuild_resets_staleness_buffers(pkg):
    """The rebuild's hook (``NetTrainer.async_abandon``): every pending
    aggregate is dropped, the updater moves to the new generation, and
    the next generation's aggregates apply."""
    tr, up, _init = _async_trainer(pkg.name, 2)
    snap = tr.async_snapshot()
    assert sum(snap["pending"]) > 0 and snap["applies"] == 0
    assert tr.async_abandon(generation=5, reason="rebuild") == sum(
        snap["pending"])
    snap = tr.async_snapshot()
    assert snap["pending"] == [0] * snap["groups"]
    assert snap["generation"] == 5
    reg = pkg.registry().snapshot()
    assert ('async_stale_dropped_total{reason="rebuild"}'
            in reg["async_stale_dropped_total"])
    if pkg.name == "port":
        for gid, names in enumerate(up.groups):
            up.push(gid, [torch.full_like(tr.params[k][t], 0.01)
                          for k, t in names], 1)
    else:
        from cxxnet_tpu.io.data import DataBatch

        rng = np.random.RandomState(4)
        tr.update(DataBatch(
            data=rng.randn(16, 16).astype(np.float32),
            label=rng.randint(0, 8, (16, 1)).astype(np.float32)))
    up.drain()
    assert sum(tr.async_snapshot()["pending"]) == 0
    assert tr.async_snapshot()["applies"] > 0


def test_async_stale_generation_aggregate_is_never_applied(pkg):
    """Even with the buffers not cleared, the apply re-checks the stamp:
    a dead generation's aggregate never reaches the weights."""
    tr, up, init = _async_trainer(pkg.name, 1)
    assert sum(len(dq) for dq in up._pending) == len(up.groups)
    up.generation = 1
    assert up.drain() == 0
    assert up.dropped == len(up.groups)
    for key in init:
        for tag in init[key]:
            np.testing.assert_array_equal(
                init[key][tag], np.array(tr.params[key][tag]),
                err_msg=f"{key}/{tag}: a dead generation's gradient "
                        "reached the weights")
    reg = pkg.registry().snapshot()
    assert ('async_stale_dropped_total{reason="generation"}'
            in reg["async_stale_dropped_total"])


# ----------------------------------------------------------------------
# the jobs: everything below runs in subprocesses started together
_PORTS: list = []


def _ports(n):
    """``n`` distinct free ports: all the fixture's ports are drawn at
    once (bound together, then released), so no two jobs share one."""
    return [_PORTS.pop() for _ in range(n)]


def _draw_ports(n):
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    _PORTS[:] = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()


def _rank_script(mode, out_dir, world, ports):
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_elastic_rank.py"), mode,
         str(r), os.path.join(out_dir, f"{mode}.r{r}.json"),
         *map(str, ports)],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def _scenario(root, name, fault_rank=None, fault=(), extra=()):
    """Three ranks of the lane's conf for ``num_round = 3``, their logs
    and event logs under ``<root>/<name>``."""
    d = os.path.join(root, name)
    dist_port, elastic_port = _ports(2)
    conf = os.path.join(root, "elastic.conf")
    return d, [lane.launch_rank(
        conf, d, os.path.join(d, "models"), r, 3, dist_port, elastic_port,
        extra=["num_round=3", "silent=0", f"collective_timeout_s="
               f"{COLLECTIVE_S:g}", *extra,
               *(fault if r == fault_rank else ())])
        for r in range(3)]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    _draw_ports(13)
    lane.make_data(root)
    lane.make_conf(root, "cpu", HEARTBEAT_S, T)
    t0 = time.time()
    started = {
        "kill": _rank_script("kill", root, 2, _ports(1)),
        "reinit": _rank_script("reinit", root, 2, _ports(4)),
        "lane": [subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch.tools.elastic_kill",
             "--ranks", "3", "--dev", "cpu", "--out",
             os.path.join(root, "lane"),
             "--heartbeat-s", str(HEARTBEAT_S), "--elastic-timeout-s",
             str(T), "--timeout", "120"],
            env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)],
        "range": [subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch",
             os.path.join(root, "elastic.conf"), "dev=cpu:0-1", "num_round=1",
             f"model_dir={os.path.join(root, 'range')}", "silent=0",
             "dist_launch_timeout_s=100"],
            cwd=root, env=dict(os.environ, PYTHONPATH=REPO,
                               OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)],
    }
    dirs = {}
    for name, rank, fault, extra in (
            ("quarantine", 1, ("fault_seed=25",
                               "fault_inject=device.state:bitflip:1:1"),
             ("integrity_every=1",)),
            ("ioerror", 2, ("fault_inject=mesh.replica:ioerror:1:1",), ()),
            ("hang", 2, ("fault_inject=mesh.replica:hang:1:1",),
             (f"dist_timeout_s={HANG_DIST_TIMEOUT_S}",)),
            ("sigstop", None, (), ())):
        dirs[name], started[name] = _scenario(root, name, rank, fault, extra)
    # stop rank 2 of "sigstop" once round 1's checkpoint is durable
    stopped = lane.wait_for_checkpoint(
        os.path.join(dirs["sigstop"], "models"), 1, started["sigstop"], 60)
    if stopped:
        started["sigstop"][2].send_signal(signal.SIGSTOP)
    stop_ts = time.time()
    out = {"root": root, "dirs": dirs, "stopped": stopped,
           "stop_ts": stop_ts}
    deadline = time.time() + DEADLINE_S
    try:
        for name, procs in started.items():
            if name == "sigstop":
                for p in procs[:2]:
                    p.wait(timeout=max(1.0, deadline - time.time()))
                procs[2].send_signal(signal.SIGKILL)
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
                if getattr(p, "_log_file", None) is not None:
                    p._log_file.close()
            out[name] = {"codes": [p.returncode for p in procs],
                         "outs": [p.stdout.read().decode(errors="replace")
                                  if p.stdout else "" for p in procs],
                         "end": time.time()}
    finally:
        for procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out["t0"] = t0
    return out


def _log(jobs, name, rank):
    return lane.rank_log(jobs["dirs"][name], rank)


def _events(jobs, name, rank, kind):
    return [e for e in lane.rank_events(jobs["dirs"][name], rank)
            if e["kind"] == kind]


def test_classify_failure_reads_a_killed_gloo_peer(jobs):
    with open(os.path.join(jobs["root"], "kill.r0.json")) as f:
        seen = json.load(f)
    assert "RuntimeError" in seen["types"] and "gloo" in seen["text"]
    loss = telastic.classify_failure(RuntimeError(seen["text"]),
                                     _Stub(lost=True), confirm_s=0.1)
    assert isinstance(loss, telastic.ReplicaLossError) and not loss.presumed
    # what a data source raises is not a replica's loss
    for e in (ConnectionError("Connection reset by peer"),
              ConnectionResetError(104, "Connection reset by peer"),
              OSError("Timed out waiting for the data service")):
        assert telastic.classify_failure(e, _Stub(lost=True)) is None
    # the group store's own errors are
    assert telastic.classify_failure(
        torch.distributed.DistStoreError("wait timeout"),
        _Stub(lost=True), confirm_s=0.1) is not None


def test_teardown_frees_the_store_and_abandons_a_wedged_group(jobs):
    assert jobs["reinit"]["codes"] == [0, 0], jobs["reinit"]["outs"]
    with open(os.path.join(jobs["root"], "reinit.r0.json")) as f:
        got = json.load(f)
    assert got == {"gen1": 2.0, "gen2": 4.0, "store_port_free": True,
                   "initialized_after": False, "thread_inside": True,
                   "abandoned": 1, "gen4": 4.0, "resilient": True}


def test_churn_crcs_equal_the_planned_run(jobs):
    (code,), (out,) = jobs["lane"]["codes"], jobs["lane"]["outs"]
    assert code == 0, out[-4000:]
    doc = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert doc["verdict"] == "ok" and doc["crc_equal"]
    assert (doc["resume_round"], doc["grow_round"]) == (4, 7)
    assert len(doc["crcs"]) == lane.NUM_ROUND + 1
    churn = os.path.join(jobs["root"], "lane", "churn")
    assert "admitted as rank 2/3" in lane.rank_log(churn, "j")


def test_planned_shrink_leaves_clean(jobs):
    planned = os.path.join(jobs["root"], "lane", "planned")
    log = lane.rank_log(planned, 2)
    assert ("elastic: this rank left the mesh at round 4 (planned shrink); "
            "exiting clean") in log
    assert [e["round"] for e in lane.rank_events(planned, 2)
            if e["kind"] == "mesh.left"] == [4]
    assert "rebuilding the mesh as 2 process(es)" in lane.rank_log(planned, 0)


def test_integrity_quarantine_exits_0_41_0(jobs):
    q = jobs["quarantine"]
    assert q["codes"] == [0, 41, 0], [_log(jobs, "quarantine", r)[-2000:]
                                      for r in range(3)]
    assert "self-quarantining (exit 41)" in _log(jobs, "quarantine", 1)
    for r in (0, 2):
        (ev,) = _events(jobs, "quarantine", r, "integrity.quarantine")
        assert ev["rank"] == 1 and ev["last_clean_round"] == 0
        (done,) = _events(jobs, "quarantine", r, "mesh.rebuild_done")
        assert done["resume_round"] == ev["last_clean_round"] + 1
        assert done["num"] == 2
        # every round after the rebuild voted clean on the two survivors
        clean = [e["round"] for e in _events(jobs, "quarantine", r,
                                             "integrity.clean")]
        assert clean == [0, 1, 2]
        assert "updating end" in _log(jobs, "quarantine", r)
    models = os.path.join(jobs["dirs"]["quarantine"], "models")
    assert sorted(n for n in os.listdir(models) if n.endswith(".model")) == [
        f"{r:04d}.model" for r in range(4)]


def test_mesh_replica_ioerror_survivors_rebuild(jobs):
    j = jobs["ioerror"]
    assert j["codes"][:2] == [0, 0] and j["codes"][2] != 0, [
        _log(jobs, "ioerror", r)[-2000:] for r in range(3)]
    (fired,) = _events(jobs, "ioerror", 2, "fault.injected")
    # the faulting rank waits (T + 2) s for a confirmation and (2 T + 5) s
    # for a plan, gives up; the monitor needs T s of silence
    bound = (T + 2) + (2 * T + 5) + T + COLLECTIVE_S + 10
    for r in (0, 1):
        (start,) = _events(jobs, "ioerror", r, "mesh.rebuild_start")
        assert start["ts"] - fired["ts"] < bound
        assert "resuming at round 1 on 2 process(es)" in _log(
            jobs, "ioerror", r)
        assert "updating end" in _log(jobs, "ioerror", r)
    assert "injected I/O error at mesh.replica" in _log(jobs, "ioerror", 2)


def test_mesh_replica_hang_ends_every_rank(jobs):
    """The JAX package's outcome: no plan comes for a wedged rank that
    still beats, so every rank ends (none hangs), the others after
    gloo's timeout and a presumed loss, the wedged one once the
    coordinator is gone."""
    j = jobs["hang"]
    assert all(c not in (0, None) for c in j["codes"]), j["codes"]
    (fired,) = _events(jobs, "hang", 2, "fault.injected")
    bound = HANG_DIST_TIMEOUT_S + (T + 2) + (2 * T + 5) + 2 * T + 20
    assert j["end"] - fired["ts"] < bound
    for r in (0, 1):
        assert _events(jobs, "hang", r, "mesh.collective_slow")
        assert "Timed out waiting" in _log(jobs, "hang", r)
        assert not _events(jobs, "hang", r, "mesh.rebuild_start")
    assert "elastic: unrecoverable replica loss" in _log(jobs, "hang", 2)


def test_stopped_rank_survivors_rebuild(jobs):
    assert jobs["stopped"]
    j = jobs["sigstop"]
    assert j["codes"][:2] == [0, 0], [_log(jobs, "sigstop", r)[-2000:]
                                      for r in range(2)]
    for r in (0, 1):
        (start,) = _events(jobs, "sigstop", r, "mesh.rebuild_start")
        # suspect within a few beats, presumed past the deadline, the
        # plan once the monitor gives up on it
        assert start["ts"] - jobs["stop_ts"] < COLLECTIVE_S + T + 5
        assert start["num"] == 2
        assert "updating end" in _log(jobs, "sigstop", r)


def test_device_range_does_not_arm_the_pod(jobs):
    (code,), (out,) = jobs["range"]["codes"], jobs["range"]["outs"]
    assert code == 0, out[-3000:]
    assert "elastic: not armed for the device range dev=cpu:0-1" in out
    assert "liveness monitor armed" not in out
    assert "2 rank processes" in out


def test_a_rebuild_retry_keeps_the_rank_s_card(monkeypatch):
    """A second replica lost inside a rebuild's own rendezvous: the
    retry, which has no trainer left, joins on the card the rank
    started on, as the first attempt did (never on the CPU)."""
    from cxxnet_tpu_torch import cli
    from cxxnet_tpu_torch.parallel import distributed

    plans = []

    class Member:
        def pending_plan(self):
            return plans[-1] if plans else None

        def poll_now(self):
            pass

        def ack_generation(self, plan, rank=None):
            pass

    task = cli.LearnTask()
    task.silent = 1
    task.elastic_opts = telastic.ElasticOptions.from_cfg(
        [("elastic", "1"), ("elastic_timeout_s", "0.2")])
    task.elastic_member = Member()
    monkeypatch.setattr(distributed, "group_device",
                        lambda: torch.device("cuda:1"))
    task._keep_elastic_device()
    task.net_trainer = types.SimpleNamespace(
        device=torch.device("cuda:1"),
        async_abandon=lambda generation, reason: None)
    joined = []

    def join(plan, dev=None):
        joined.append(dev)
        if len(joined) == 1:  # rank 1 dies in generation 1's rendezvous
            plans.append(telastic.GenerationPlan(
                2, "replica_lost", 1, 0, "127.0.0.1:1", None, [1]))
            raise telastic.ReplicaLossError("second loss", lost=[1])

    monkeypatch.setattr(distributed, "shutdown_distributed",
                        lambda graceful=True, abandon=False: True)
    monkeypatch.setattr(task, "_join_generation", join)
    monkeypatch.setattr(task, "_sync_latest_model", lambda: True)
    monkeypatch.setattr(task, "_create_iterators", lambda: None)
    plans.append(telastic.GenerationPlan(
        1, "replica_lost", 2, 0, "127.0.0.1:1", None, [2]))
    assert task._elastic_recover(
        telastic.ReplicaLossError("first loss", lost=[2]))
    assert joined == ["gpu:1", "gpu:1"]
    assert task._elastic_rebuilds == 1


def test_elastic_join_only_trains(tmp_path):
    from cxxnet_tpu_torch.cli import LearnTask

    lane.make_conf(str(tmp_path), "cpu", HEARTBEAT_S, T)
    conf = tmp_path / "elastic.conf"
    with pytest.raises(ValueError,
                       match="elastic_join=1 only supports task=train"):
        LearnTask().run([str(conf), "task=pred", "elastic_join=1"])
