"""The port's tuner (``cxxnet_tpu_torch/tune/``) and the live knobs it
turns, against the JAX package, on the CPU.

* Under the same objective sequence, ``KnobController.step_once`` makes
  the same decisions (each returned record equal), emits the same
  ``tune.adjust`` / ``tune.rollback`` events and leaves the same
  ``tune_effective``, ``tune_adjustments_total`` and
  ``tune_rollbacks_total`` values in both packages, for a climb to a
  plateau, a regression, a noisy plateau and two knobs.
* The decode pool resizes live (grow and shrink on a running pool, a
  serial chain growing at the epoch boundary) and every batch stays
  bit-equal to the serial chain's and to the JAX chain's; the knob
  factories find the pool through the chain.
* The batcher's and the engine's setters apply, ``/statsz`` reports them
  with the request histogram, the engine's limit is warmed before it
  applies, and ``prewarm_buckets`` follows the histogram up to the live
  limit, one ``tune.prewarm`` event per warmed bucket.  The bucket cache
  pads to its bucket on the device (the forward gets the request's rows
  and the bucket), bit-equal to a forward of the host-padded bucket, so
  a warm at the bucket leaves the first real batch nothing new to do.
* ``task=serve`` with ``controller = 1`` starts the serving tuner; the
  refusal is gone.

The JAX tuner registers its ``tune_*`` families in the JAX process-wide
registry; they are dropped when the file ends (``_jax_registry``).
"""

import itertools
import os

import numpy as np
import pytest

from cxxnet_tpu import tune as jtune
from cxxnet_tpu.io import data as jdata
from cxxnet_tpu.obs import events as jevents
from cxxnet_tpu.obs.registry import registry as jregistry

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import tune as ttune
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io import data as tdata
from cxxnet_tpu_torch.io import imgbin as timgbin
from cxxnet_tpu_torch.obs import events as tevents
from cxxnet_tpu_torch.obs.registry import registry as tregistry
from cxxnet_tpu_torch.serve import Engine


@pytest.fixture(autouse=True, scope="module")
def _jax_registry():
    """Drop the families the JAX tuner registered in this file, and the
    gauge its ``set_effective`` keeps, so a later user registers them
    anew."""
    from cxxnet_tpu.tune import controller as jcontroller

    reg = jregistry()
    had = {m.name for m in reg.metrics()}
    yield
    with reg._lock:
        new = [n for n in reg._metrics if n.startswith("tune_")
               and n not in had]
        for name in new:
            reg._metrics.pop(name, None)
    if "tune_effective" in new:
        jcontroller._EFFECTIVE_GAUGE = None


def _env(kind):
    """(rate function of the knob state, ticks) of one environment."""
    if kind == "plateau":
        return (lambda s: 100.0 * min(s["w"], 4)), 40
    if kind == "regression":
        return (lambda s: 100.0 / s["w"]), 40
    if kind == "noise":
        noise = itertools.cycle([0.97, 1.04, 1.0, 0.95, 1.05])
        return (lambda s: 400.0 * next(noise)), 60
    return (lambda s: 10.0 * min(s["w"], 8) * min(s["q"], 2)), 60


START = {"plateau": {"w": 1}, "regression": {"w": 4}, "noise": {"w": 4},
         "two": {"w": 1, "q": 1}}


def _run(pkg, kind):
    mod = ttune if pkg == "port" else jtune
    state = dict(START[kind])
    work = [0.0]
    knobs = [mod.Knob(f"{kind}_{name}", (lambda n=name: state[n]),
                      (lambda v, n=name: state.__setitem__(n, v)),
                      lo=1, hi=16) for name in sorted(state)]
    rate, ticks = _env(kind)
    ctrl = mod.KnobController(lambda: work[0], knobs, band=0.1,
                              measure_ticks=2, settle_ticks=1,
                              cooldown_ticks=4, name=f"par_{kind}")
    decisions = []
    t = 0.0
    for _ in range(ticks):
        t += 1.0
        work[0] += rate(state)
        decisions.append(ctrl.step_once(now=t))
    return decisions, dict(state)


def _events(mod, ctrl_name):
    out = []
    for e in mod.recent(500):
        if e.get("kind", "").startswith("tune.") and \
                e.get("controller") == ctrl_name:
            out.append({k: v for k, v in e.items() if k != "ts"})
    return out


def _series(reg, kind):
    snap = reg().snapshot()
    out = {}
    for fam in ("tune_effective", "tune_adjustments_total",
                "tune_rollbacks_total"):
        for k, v in snap.get(fam, {}).items():
            if f'"{kind}_' in k:
                out[k] = v
    return out


@pytest.mark.parametrize("kind", sorted(START))
def test_controller_decides_as_the_jax_one(kind):
    tevents.event_log().reset()
    jevents.event_log().reset()
    t_dec, t_state = _run("port", kind)
    j_dec, j_state = _run("jax", kind)
    assert t_dec == j_dec
    assert t_state == j_state
    assert _events(tevents, f"par_{kind}") == _events(jevents,
                                                      f"par_{kind}")
    assert _series(tregistry, kind) == _series(jregistry, kind)
    actions = {d.get("action") for d in t_dec}
    assert actions & {"adjust", "keep", "revert", "rollback"}


def test_options_band_and_knob_moves_match():
    cfg = [("controller", "1"), ("tune_period_s", "0.25"),
           ("tune_band", "0.2"), ("tune_targets", "batcher")]
    t, j = ttune.options_from_cfg(cfg), jtune.options_from_cfg(cfg)
    assert vars(t) == vars(j)
    for args in ((120, 100, 0.1), (80, 100, 0.1), (105, 100, 0.1),
                 (80, 100, 0.1, True), (50, None, 0.1)):
        assert ttune.band_verdict(*args) == jtune.band_verdict(*args)
    for v in (1, 3, 7, 8, 16):
        tk = ttune.Knob("k", lambda v=v: v, lambda x: None, lo=1, hi=8)
        jk = jtune.Knob("k", lambda v=v: v, lambda x: None, lo=1, hi=8)
        assert [tk.propose(d) for d in (1, -1)] == \
            [jk.propose(d) for d in (1, -1)]


# ----------------------------------------------------------------------
# the decode pool's live resize

def _pages(d, n=40):
    imgs = (np.random.RandomState(5).rand(n, 12, 12, 3) * 255).astype(
        np.float32)
    w = timgbin.BinPageWriter(os.path.join(str(d), "p.bin"),
                              page_size=3000)
    with open(os.path.join(str(d), "p.lst"), "w") as f:
        for i, img in enumerate(imgs):
            w.push(timgbin.encode_raw(img))
            f.write(f"{i}\t{i % 3}\timg{i}.jpg\n")
    w.close()


def _entries(d, workers, depth=0):
    return [("iter", "imgbin"), ("native_decoder", "0"),
            ("image_bin", str(d / "p.bin")), ("image_list", str(d / "p.lst")),
            ("raw_pixels", "1"), ("rand_crop", "1"), ("rand_mirror", "1"),
            ("max_random_contrast", "0.2"), ("num_decode_workers",
                                              str(workers)),
            ("decode_chunk", "3"), ("decode_queue_depth", str(depth)),
            ("silent", "1"), ("iter", "end"), ("input_shape", "3,8,8"),
            ("batch_size", "8")]


def _epoch(it, r):
    it.set_param("augment_epoch_next", str(r))
    it.before_first()
    out = []
    while it.next():
        v = it.value()
        out.append((v.data.copy(), v.label.copy(),
                    np.asarray(v.inst_index).copy()))
    return out


def _same(a, b):
    assert len(a) == len(b) == 5
    for (d, l, i), (d2, l2, i2) in zip(a, b):
        assert np.array_equal(d, d2) and np.array_equal(l, l2)
        assert np.array_equal(i, i2)


def _jax_epochs(d, rounds):
    it = jdata.create_iterator(_entries(d, 1))
    it.init()
    out = []
    try:
        for r in rounds:
            it.before_first()
            it.set_param("augment_epoch", str(r))
            ep = []
            while it.next():
                v = it.value()
                ep.append((v.data.copy(), v.label.copy(),
                           np.asarray(v.inst_index).copy()))
            out.append(ep)
    finally:
        it.close()
    return out


def test_pool_resizes_live_and_batches_stay_bit_equal(tmp_path):
    _pages(tmp_path)
    serial = tdata.create_iterator(_entries(tmp_path, 1))
    serial.init()
    ref = [_epoch(serial, r) for r in (1, 2, 3)]
    serial.close()
    jref = _jax_epochs(tmp_path, (1, 2, 3))
    for a, b in zip(ref, jref):
        _same(a, b)
    it = tdata.create_iterator(_entries(tmp_path, 2, depth=1))
    it.init()
    try:
        pipe = ttune.find_pipeline(it)
        assert pipe is not None and pipe.effective_workers() == 2
        assert pipe.request_workers(4) == 4 and pipe.set_queue_depth(4) == 4
        _same(_epoch(it, 1), ref[0])
        assert pipe.effective_workers() == 4
        pipe.request_workers(1)
        pipe.request_workers(1)  # back to back: never over-retired
        _same(_epoch(it, 2), ref[1])
        assert 1 <= pipe.effective_workers() <= 4
        # a resize in the middle of an epoch
        it.set_param("augment_epoch_next", "3")
        it.before_first()
        got = []
        while it.next():
            v = it.value()
            got.append((v.data.copy(), v.label.copy(),
                        np.asarray(v.inst_index).copy()))
            if len(got) == 2:
                pipe.request_workers(3)
        _same(got, ref[2])
        assert [k.name for k in ttune.pipeline_knobs(pipe)] == [
            "num_decode_workers", "decode_queue_depth"]
    finally:
        it.close()
    assert tregistry().snapshot()["tune_effective"][
        'tune_effective{knob="num_decode_workers"}'] == 3


def test_serial_chain_grows_its_pool_at_the_epoch_boundary(tmp_path):
    _pages(tmp_path)
    it = tdata.create_iterator(_entries(tmp_path, 1))
    it.init()
    try:
        pipe = ttune.find_pipeline(it)
        ref = _epoch(it, 1)
        assert pipe.effective_workers() == 0
        pipe.request_workers(2)
        assert pipe.effective_workers() == 0  # mid-epoch: deferred
        got = _epoch(it, 1)
        assert pipe.effective_workers() == 2
        _same(got, ref)
    finally:
        it.close()


# ----------------------------------------------------------------------
# the batcher's and the engine's knobs

MLP = """
netconfig = start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1:a1] = relu:a1
layer[a1->out] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig = end
input_shape = 1,1,16
batch_size = 32
dev = cpu
eta = 0.1
"""


def _engine():
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(MLP))
    tr.init_model()
    return Engine(trainer=tr, max_batch_size=32, batch_timeout_ms=1.0)


def test_batcher_and_engine_setters_apply():
    eng = _engine()
    try:
        x = np.random.RandomState(0).rand(4, 16).astype(np.float32)
        out1 = eng.scores(x)
        eng.set_max_batch_size(8, prewarm=False)
        assert eng.set_batch_timeout_ms(0.5) == pytest.approx(0.5)
        assert eng.batcher.max_batch_size == 8
        assert eng.batcher.batch_timeout == pytest.approx(0.5e-3)
        assert np.array_equal(eng.scores(x), out1)
        st = eng.snapshot_stats()
        assert st["tune_effective"] == {"max_batch_size": 8,
                                        "batch_timeout_ms": 0.5}
        assert st["request_buckets"] == {"4": 2}
        assert eng.set_max_batch_size(10_000, prewarm=False) == 32
        eff = tregistry().snapshot()["tune_effective"]
        assert eff['tune_effective{knob="max_batch_size"}'] == 32
        knobs = {k.name: k for k in ttune.batcher_knobs(eng)}
        assert knobs["max_batch_size"].hi == 32
        knobs["batch_timeout_ms"].apply(4.0)
        assert eng.batcher.batch_timeout == pytest.approx(4e-3)
        assert eng.batcher.set_max_batch_size(0) == 1
    finally:
        eng.close()


def test_prewarm_follows_the_histogram():
    tevents.event_log().reset()
    eng = _engine()
    try:
        eng.predict(np.zeros((3, 16), np.float32))  # bucket 4, warm now
        assert eng.prewarm_buckets() == []
        with eng._req_lock:
            eng._req_buckets[(16, (16,))] = 5
            eng._req_buckets[(8, (1, 1, 16))] = 2
        assert eng.prewarm_buckets() == [16, 8]
        assert {k[3] for k in eng._cache.keys_snapshot()} >= {4, 8, 16}
        assert eng.prewarm_buckets() == []  # idempotent
        ev = tevents.recent(10, kind="tune.prewarm")
        assert [(e["bucket"], e["row_shape"]) for e in ev] == [
            (16, [16]), (8, [1, 1, 16])]
        eng.set_max_batch_size(4, prewarm=False)
        with eng._req_lock:
            eng._req_buckets[(32, (16,))] = 9
        assert eng.prewarm_buckets() == []  # above the live limit
        assert eng._warm_bucket(2, (16,)) is True
        assert eng._warm_bucket(2, (16,)) is False
        assert eng._dominant_row_shape() == (16,)
        before = {k[3] for k in eng._cache.keys_snapshot()}
        assert 32 not in before
        eng.set_max_batch_size(32)  # warmed before it applies
        assert 32 in {k[3] for k in eng._cache.keys_snapshot()}
    finally:
        eng.close()


@pytest.mark.parametrize("n", [1, 3, 5, 16])
def test_cache_pads_to_its_bucket_on_the_device(n):
    """The bucket cache hands the forward the request's rows and the
    bucket (no padded host array); the answer equals the forward of the
    host-padded bucket, bit for bit."""
    from cxxnet_tpu_torch.serve.cache import ShapeBucketCache, bucket_size

    eng = _engine()
    try:
        tr = eng._trainer
        seen = []
        fn = tr.predict_fn

        def spy(node_id=None):
            f = fn(node_id)

            def g(params, aux, data, extras=(), pad_to=None):
                seen.append((data.shape[0], pad_to))
                return f(params, aux, data, extras, pad_to=pad_to)

            return g

        tr.predict_fn = spy
        x = np.random.RandomState(n).rand(n, 16).astype(np.float32)
        out = ShapeBucketCache(tr).scores(x)
        b = bucket_size(n)
        assert seen == [(n, b)]
        row = tr.net.input_node_shape(1)[1:]
        pad = np.zeros((b,) + tuple(row), np.float32)
        pad[:n] = x.reshape((n,) + tuple(row))
        ref = fn()(tr.params, tr.aux, pad, ()).cpu().numpy()[:n]
        assert out.shape == ref.shape and np.array_equal(out, ref)
    finally:
        eng.close()


def test_serve_controller_starts_under_the_cli(tmp_path):
    t = LearnTask()
    t.set_param("controller", "1")
    t.set_param("tune_period_s", "0.05")
    assert t.controller == 1
    eng = _engine()
    try:
        ctrl = t._start_serve_controller(eng)
        assert ctrl is not None
        assert [k.name for k in ctrl.knobs] == ["max_batch_size",
                                                "batch_timeout_ms"]
        eng.predict(np.zeros((5, 16), np.float32))
        ctrl.stop()
    finally:
        eng.close()
    t2 = LearnTask()
    t2.set_param("tune_targets", "pipeline")
    t2.set_param("controller", "1")
    eng = _engine()
    try:
        assert t2._start_serve_controller(eng) is None
    finally:
        eng.close()
