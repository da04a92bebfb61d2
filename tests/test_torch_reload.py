"""Hot reload, the reload breaker, ``/reloadz`` and the golden canary of
the port's server, against the JAX package's, on the CPU.

One small conv net; its checkpoints are written by the port and read by
both packages' engines.  Held against the JAX engine: the reload past a
corrupt round (scores within ``SCORE_ATOL``), rounds that never move
backward, the breaker's sequence and its ``/statsz`` counts, the
``/reloadz`` reply, the same-round ``.quant.model`` sibling swap with an
artifact exported by each package and served by the other, the canary's
local golden with an injected drift and its recovery, ``CircuitBreaker``
and ``RetryPolicy`` under one fake clock, and ``probe_batch`` /
``scores_crc`` bit for bit.  The port alone: the warmed buckets take no
miss after a swap and the old trainer is released, the golden the port's
own trainer commits binds (``manifest``), a JAX-written probe block
rebases instead of alarming, the poll thread of ``serve_forever`` and the
CLI's ``task=serve`` with ``serve_reload_period``.  Then int8 over a
batch-norm net (ROADMAP A3): a bottleneck net under ``bn_eval =
running`` after three port SGD steps, exported behind the gate by both
packages, each artifact scored by both within ``BN_INT8_ATOL``.
"""

import gc
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest

from cxxnet_tpu import config as jcfg
from cxxnet_tpu import serve as jserve
from cxxnet_tpu.cli import LearnTask as JaxTask
from cxxnet_tpu.integrity import canary as jcanary
from cxxnet_tpu.nnet import quant as jnquant
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils import faults as jfaults

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import serve as tserve
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.integrity import canary
from cxxnet_tpu_torch.nnet import quant as nquant
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils import checkpoint as ckpt
from cxxnet_tpu_torch.utils import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONF = """
netconfig = start
layer[0->c] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 8
  init_sigma = 0.3
layer[c->c] = relu
layer[c->f] = flatten
layer[f->fc1] = fullc:fc1
  nhidden = 6
  init_sigma = 0.3
layer[fc1->fc1] = softmax
netconfig = end
input_shape = 2,4,4
batch_size = 8
dev = cpu
"""
ROW = (4, 4, 2)
# f32 scores of one checkpoint in both packages (oneDNN and XLA sum in
# other orders); the same for an int8 artifact, whose codes are equal
SCORE_ATOL = 1e-6
# int8 over the bottleneck BN net: the scores of one artifact in both
# packages; the reading that set it was 6e-8
BN_INT8_ATOL = 1e-6


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


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, *ROW).astype(np.float32)


def _save_round(mdir, round_, seed, conf=CONF):
    """A port trainer drawn from ``seed``, written as ``NNNN.model``."""
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.set_param("seed", str(seed))
    tr.init_model()
    os.makedirs(mdir, exist_ok=True)
    path = os.path.join(mdir, f"{round_:04d}.model")
    tr.save_model(path, round_=round_)
    return path


PKGS = {"port": (tserve, tcfg), "jax": (jserve, jcfg)}


def _engine(pkg, mdir, extra="", **kw):
    serve, cfgmod = PKGS[pkg]
    return serve.Engine(cfg=cfgmod.parse_pairs(CONF + extra), model_dir=mdir,
                        max_batch_size=8, batch_timeout_ms=0, **kw)


# ----------------------------------------------------------------------
# the pieces, against the JAX package's

@pytest.mark.parametrize("seed,rows,shape", [
    (0xC0FFEE, 8, (4, 4, 2)), (7, 1, (16,)), (0xC0FFEE ^ 5, 3, (3, 5, 5)),
    (2 ** 40 + 3, 2, (1, 1, 64))])
def test_probe_batch_and_crc_match_jax(seed, rows, shape):
    p = canary.probe_batch(seed, rows, shape)
    np.testing.assert_array_equal(p, jcanary.probe_batch(seed, rows, shape))
    assert p.dtype == np.float32 and p.shape == (rows,) + shape
    scores = (p.reshape(rows, -1)[:, :5] * 3 - 1).astype(np.float32)
    assert canary.scores_crc(scores) == jcanary.scores_crc(scores)
    assert canary.scores_crc(scores.T) != canary.scores_crc(scores)
    for crc in (None, 0x1234ABCD):
        blk = canary.make_probe_block(seed, rows, shape, crc, "cpu")
        assert blk == jcanary.make_probe_block(seed, rows, shape, crc, "cpu")
        for backend in ("cpu", "gpu", "tpu"):
            for quant in (False, True):
                assert (canary.block_matches_pipeline(
                    blk, backend=backend, quant=quant)
                    == jcanary.block_matches_pipeline(
                        blk, backend=backend, quant=quant))


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


BREAKER_SCRIPTS = {
    "open_then_recover": (2, 5.0, "f f a t5 a s a"),
    "half_open_trial_fails": (1, 3.0, "f a t3 a a f a t2 a t1 a s s"),
    "successes_reset_the_count": (3, 1.0, "f f s f f a f a t1 a f"),
    "cooldown_zero": (2, 0.0, "f f a f a s a"),
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_circuit_breaker_matches_jax(script):
    """Both packages' ``CircuitBreaker`` under one fake clock: after each
    step (``f`` failure, ``s`` success, ``a`` allow, ``tN`` N seconds),
    the same ``allow`` answers, state and snapshot."""
    threshold, cooldown, ops = BREAKER_SCRIPTS[script]
    clock = _Clock()
    ours = faults.CircuitBreaker(threshold, cooldown, clock=clock)
    ref = jfaults.CircuitBreaker(threshold, cooldown, clock=clock)
    for op in ops.split():
        if op == "f":
            ours.record_failure(), ref.record_failure()
        elif op == "s":
            ours.record_success(), ref.record_success()
        elif op == "a":
            assert ours.allow() == ref.allow(), op
        else:
            clock.t += float(op[1:])
        assert ours.state == ref.state
        assert ours.snapshot() == ref.snapshot()
    with pytest.raises(ValueError):
        faults.CircuitBreaker(0)


@pytest.mark.parametrize("cfg", [
    [], [("retry_attempts", "6"), ("retry_base_delay", "0.01"),
         ("retry_jitter", "0.5")],
    [("retry_attempts", "5"), ("retry_deadline_s", "0.2"),
     ("retry_max_delay", "0.08")]])
def test_retry_policy_matches_jax(cfg):
    """The same delays (deterministic jitter), attempts and deadline cut
    under one fake clock; the last failure propagates in both."""
    runs = []
    for mod in (faults, jfaults):
        pol = mod.RetryPolicy.from_cfg(cfg)
        clock, slept, calls = _Clock(), [], []

        def sleep(d, clock=clock, slept=slept):
            slept.append(d)
            clock.t += d

        def fn(calls=calls):
            calls.append(1)
            raise OSError("transient")

        with pytest.raises(OSError):
            pol.run(fn, what="loading x", silent=True, _sleep=sleep,
                    _clock=clock)
        runs.append((slept, len(calls)))
    assert runs[0] == runs[1]
    assert faults.RetryPolicy().run(lambda: 7) == 7


# ----------------------------------------------------------------------
# reload, both packages

def test_reload_past_corrupt_round_matches_jax(tmp_path):
    """Both engines serve round 1, reload round 2 past a corrupt
    ``0003.model``, score within ``SCORE_ATOL`` of each other and equal
    a fresh engine on round 2, and never move back to round 1."""
    mdir = str(tmp_path / "models")
    _save_round(mdir, 1, seed=1)
    engs = {pkg: _engine(pkg, mdir) for pkg in PKGS}
    x = _rows(5)
    try:
        before = {pkg: e.submit(x, kind="scores") for pkg, e in engs.items()}
        np.testing.assert_allclose(before["port"], before["jax"],
                                   atol=SCORE_ATOL)
        assert not engs["port"].reload_if_newer()  # nothing newer
        _save_round(mdir, 2, seed=2)
        with open(os.path.join(mdir, "0003.model"), "wb") as f:
            f.write(b"garbage not a model")
        for pkg, e in engs.items():
            assert e.reload_if_newer(), pkg
            assert e.round == 2 and e.healthz()["round"] == 2
            assert e.model_path.endswith("0002.model")
        after = {pkg: e.submit(x, kind="scores") for pkg, e in engs.items()}
        assert not np.allclose(after["port"], before["port"])
        np.testing.assert_allclose(after["port"], after["jax"],
                                   atol=SCORE_ATOL)
        fresh = tserve.Engine(cfg=tcfg.parse_pairs(CONF),
                              model_in=os.path.join(mdir, "0002.model"),
                              max_batch_size=8, batch_timeout_ms=0)
        with fresh:
            np.testing.assert_array_equal(fresh.submit(x, kind="scores"),
                                          after["port"])
        # rounds never move backward: round 2 gone, round 1 newest
        os.remove(os.path.join(mdir, "0002.model"))
        for pkg, e in engs.items():
            assert not e.reload_if_newer(), pkg
            assert e.round == 2
            np.testing.assert_array_equal(e.submit(x, kind="scores"),
                                          after[pkg])
    finally:
        for e in engs.values():
            e.close()


def test_reload_warms_buckets_and_releases_the_old_model(tmp_path):
    """After the swap the buckets served before take no miss, and
    nothing keeps the old trainer alive."""
    mdir = str(tmp_path / "models")
    _save_round(mdir, 1, seed=1)
    with _engine("port", mdir) as eng:
        eng.predict(_rows(3))  # bucket 4
        eng.submit(_rows(7), kind="scores")  # bucket 8
        eng.extract(_rows(1), "fc1")  # bucket 1, the extract kind
        old = weakref.ref(eng.trainer)
        _save_round(mdir, 2, seed=2)
        assert eng.reload_if_newer()
        assert eng.last_reload_s is not None and eng.last_reload_s >= 0
        stats = eng.snapshot_stats()["compile_cache"]
        assert stats == {"buckets": 3, "hits": 0, "misses": 3}
        eng.predict(_rows(4))
        eng.submit(_rows(5), kind="scores")
        eng.extract(_rows(1), "fc1")
        assert eng.snapshot_stats()["compile_cache"] == {
            "buckets": 3, "hits": 3, "misses": 3}
        assert old() is None, "the old trainer outlived the swap"
        gc.collect()


def _breaker_trace(eng):
    h, st = eng.healthz(), eng.snapshot_stats()
    return (eng.round, eng.reload_breaker.state, h["status"], h["reasons"],
            st["reload_attempts"], st["reload_failures"], st["reload_swaps"],
            st["last_reload_ok"], st["reload_breaker"]["times_opened"],
            st["reload_breaker"]["consecutive_failures"])


def test_breaker_sequence_matches_jax(tmp_path):
    """A CRC-valid garbage round fails ``reload_breaker_threshold = 2``
    polls; the breaker opens, ``/healthz`` degrades with
    ``reload_breaker_open`` while round 1 keeps answering; open polls are
    skipped; a good round swaps through the half-open trial.  Each
    step's state and ``/statsz`` counts are the JAX engine's."""
    traces, answers = {}, {}
    for pkg in PKGS:
        mdir = str(tmp_path / pkg)
        _save_round(mdir, 1, seed=1)
        eng = _engine(pkg, mdir, reload_breaker_threshold=2,
                      reload_breaker_cooldown_s=30.0)
        x = _rows(4)
        try:
            p1 = eng.submit(x, kind="scores")
            tr = [_breaker_trace(eng)]
            ckpt.write_checkpoint(os.path.join(mdir, "0002.model"),
                                  b"not a model at all", round_=2)
            for _ in range(3):
                tr.append((eng.try_reload(),) + _breaker_trace(eng))
            np.testing.assert_array_equal(eng.submit(x, kind="scores"), p1)
            _save_round(mdir, 3, seed=3)
            tr.append((eng.try_reload(),) + _breaker_trace(eng))  # open
            eng.reload_breaker.cooldown_s = 0.0
            tr.append(("state", eng.reload_breaker.state))
            tr.append((eng.try_reload(),) + _breaker_trace(eng))
            tr.append((eng.try_reload(),) + _breaker_trace(eng))
            answers[pkg] = eng.submit(x, kind="scores")
            assert not np.allclose(answers[pkg], p1)
        finally:
            eng.close()
        traces[pkg] = tr
    assert traces["port"] == traces["jax"]
    t = traces["port"]
    assert t[2][2:5] == ("open", "degraded", ["reload_breaker_open"])
    assert t[6][:3] == (True, 3, "closed") and t[6][3:5] == ("ok", [])
    np.testing.assert_allclose(answers["port"], answers["jax"],
                               atol=SCORE_ATOL)


def _serve_thread(engine, make_server):
    httpd = make_server(engine, port=0)
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    return httpd, t


def _post(port, path, body=b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_reloadz_replies_match_jax(tmp_path):
    """``POST /reloadz`` on both servers: the JAX reply's keys, and the
    same values but the request id, with no body, an empty object and a
    ``{"model": ...}`` body (ignored by a single-engine server)."""
    replies = {}
    for pkg in PKGS:
        mdir = str(tmp_path / pkg)
        _save_round(mdir, 1, seed=1)
        eng = _engine(pkg, mdir)
        httpd, t = _serve_thread(eng, PKGS[pkg][0].make_server)
        try:
            port = httpd.server_port
            got = [_post(port, "/reloadz")]
            _save_round(mdir, 2, seed=2)
            got.append(_post(port, "/reloadz", b"{}"))
            got.append(_post(port, "/reloadz", b'{"model": "m1"}'))
            # the connection stays usable after a drained body
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", "/reloadz", body=b'{"x": 1}')
            conn.getresponse().read()
            conn.request("GET", "/healthz")
            got.append((200, {"round": json.loads(
                conn.getresponse().read())["round"]}))
            conn.close()
            replies[pkg] = got
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=10)
            eng.close()
    for (st_t, r_t), (st_j, r_j) in zip(replies["port"], replies["jax"]):
        assert st_t == st_j == 200
        assert set(r_t) == set(r_j)
        r_t.pop("rid", None), r_j.pop("rid", None)
        assert r_t == r_j
    assert [r for _, r in replies["port"]] == [
        {"ok": True, "swapped": False, "round": 1, "breaker": "closed"},
        {"ok": True, "swapped": True, "round": 2, "breaker": "closed"},
        {"ok": True, "swapped": False, "round": 2, "breaker": "closed"},
        {"round": 2}]


def _export(pkg, path):
    """The gated exporter of ``pkg`` on ``path`` with the gate off (no
    eval data): writes ``NNNN.quant.model`` beside it."""
    if pkg == "port":
        v = nquant.export_quantized(tcfg.parse_pairs(CONF), path, None,
                                    min_agreement=0)
    else:
        v = jnquant.export_quantized(jcfg.parse_pairs(CONF), path, None,
                                     min_agreement=0)
    assert v["ok"] and v["path"] == nquant.quant_artifact_path(path)
    return v["path"]


@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_same_round_sibling_swap_across_packages(tmp_path, exporter):
    """Under ``quant = int8`` both engines serve round 1 quantized on
    load; once ``0001.quant.model`` (exported by ``exporter``) appears,
    the next reload swaps onto it in the same round, in both packages,
    and their scores agree."""
    mdir = str(tmp_path / "models")
    path = _save_round(mdir, 1, seed=1)
    engs = {pkg: _engine(pkg, mdir, "quant = int8\n") for pkg in PKGS}
    x = _rows(6, seed=3)
    try:
        for e in engs.values():
            assert e.model_path == path and e.quant_scheme == "int8"
        qpath = _export(exporter, path)
        got = {}
        for pkg, e in engs.items():
            assert e.reload_if_newer(), pkg
            assert (e.round, e.model_path) == (1, qpath)
            assert e.healthz()["quant"] == "int8"
            assert not e.reload_if_newer()  # nothing newer now
            got[pkg] = e.submit(x, kind="scores")
        np.testing.assert_allclose(got["port"], got["jax"], atol=SCORE_ATOL)
        st = engs["port"].snapshot_stats()
        assert st["reload_swaps"] == 0  # reload_if_newer is not counted
        assert st["weight_bytes_f32"] / st["weight_bytes"] > 3.0
    finally:
        for e in engs.values():
            e.close()


# ----------------------------------------------------------------------
# the golden canary

def test_canary_local_golden_drift_and_recovery_match_jax(tmp_path):
    """No probe block in the manifest: a local golden; an injected drift
    degrades ``/healthz`` with ``integrity_failed`` and the next clean
    run clears it; the same sequence as the JAX engine's."""
    mdir = str(tmp_path / "models")
    _save_round(mdir, 1, seed=1)
    seqs = {}
    for pkg in PKGS:
        with _engine(pkg, mdir, "integrity_probe = 1\n") as eng:
            seq = [eng.snapshot_stats()["integrity"]["golden_src"],
                   eng.check_canary(), eng.healthz()["status"]]
            eng.inject_canary_mismatch = 1
            seq += [eng.check_canary(), eng.healthz()["status"],
                    eng.healthz()["reasons"]]
            assert eng.predict(_rows(2)).shape == (2,)
            seq += [eng.check_canary(), eng.healthz()["status"],
                    eng.snapshot_stats()["integrity"]["runs"],
                    eng.snapshot_stats()["integrity"]["failed"]]
            seqs[pkg] = seq
    assert seqs["port"] == seqs["jax"] == [
        "local", True, "ok", False, "degraded", ["integrity_failed"], True,
        "ok", 3, False]


def _port_train(tmp_path, extra):
    """``task=train`` through the port's CLI on the small MNIST-style
    conf of ``tests/test_cli.py``; returns its model directory."""
    from test_cli import make_conf

    conf = make_conf(tmp_path, num_round=1, extra=extra)
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert LearnTask().run([conf, "silent=1"]) == 0
    finally:
        os.chdir(old)
    return str(conf), str(tmp_path / "models")


def test_canary_binds_the_golden_the_port_trainer_commits(tmp_path):
    """``integrity_probe = 1`` at train time commits the probe block with
    the CRC scored as the engine scores it: an engine on the same backend
    binds it (``src == "manifest"``) and stays clean."""
    conf, mdir = _port_train(tmp_path, "integrity_probe = 1")
    man = ckpt.read_manifest(os.path.join(mdir, "0001.model"))
    blk = man["probe"]
    assert blk["backend"] == "cpu" and blk["crc32"] is not None
    cfg = tcfg.parse_file(conf) + [("integrity_probe", "1"), ("silent", "1")]
    with tserve.Engine(cfg=cfg, model_dir=mdir) as eng:
        assert blk["rows"] == 8
        assert tuple(blk["shape"]) == tuple(eng._row_shapes[0])
        snap = eng.snapshot_stats()["integrity"]
        assert snap["golden_src"] == "manifest"
        assert snap["golden_crc32"] == blk["crc32"]
        assert all(eng.check_canary() for _ in range(3))
        assert eng.healthz()["status"] == "ok"


def test_canary_rebases_a_jax_written_golden(tmp_path):
    """A probe block the JAX CLI commits (scored by XLA) binds in the
    port only where the port reproduces its CRC; otherwise the golden
    rebases to the port's own score, never an alarm.  A block from
    another backend always rebases."""
    mdir = str(tmp_path / "models")
    path = _save_round(mdir, 1, seed=1)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(CONF))
    jt.load_model(path)
    task = JaxTask()
    task.integrity_probe, task.net_trainer = 1, jt
    jblock = task._probe_block()
    assert jblock["backend"] == "cpu" and jblock["crc32"] is not None
    man = ckpt.read_manifest(path)
    probe = canary.probe_batch(jblock["seed"], jblock["rows"],
                               tuple(jblock["shape"]))
    with _engine("port", mdir) as plain:
        ours = canary.scores_crc(plain.submit(probe, kind="scores"))
    for block, want in ((jblock, "manifest" if ours == jblock["crc32"]
                         else "rebased"),
                        (dict(jblock, backend="tpu"), "rebased")):
        ckpt.write_manifest(path, open(path, "rb").read(),
                            round_=man["round"],
                            net_fp=man["net_fingerprint"], probe=block)
        with _engine("port", mdir, "integrity_probe = 1\n") as eng:
            snap = eng.snapshot_stats()["integrity"]
            assert snap["golden_src"] == want
            assert snap["golden_crc32"] == ours
            assert eng.check_canary() and eng.healthz()["status"] == "ok"


def test_serve_forever_polls_reload_and_canary(tmp_path):
    """``serve_forever(reload_period_s)``: the poll thread swaps a new
    round in without a request failing, runs the canary, and stops with
    the server; it returns ``(httpd, reloader)``."""
    mdir = str(tmp_path / "models")
    _save_round(mdir, 1, seed=1)
    eng = _engine("port", mdir, "integrity_probe = 1\n")
    box, errors = {}, []

    def run():
        box["ret"] = tserve.serve_forever(
            eng, port=0, reload_period_s=0.02, drain_timeout_s=2.0,
            ready_fn=lambda h: box.setdefault("httpd", h))

    srv = threading.Thread(target=run, daemon=True)
    srv.start()
    try:
        deadline = time.monotonic() + 20
        while "httpd" not in box and time.monotonic() < deadline:
            time.sleep(0.01)
        port = box["httpd"].server_port
        stop = threading.Event()

        def client():
            body = json.dumps({"data": _rows(2).tolist()}).encode()
            while not stop.is_set():
                try:
                    st, _ = _post(port, "/predict", body)
                    if st != 200:
                        errors.append(st)
                except OSError as e:
                    errors.append(e)

        cl = threading.Thread(target=client, daemon=True)
        cl.start()
        _save_round(mdir, 2, seed=2)
        while eng.round != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        while (eng.snapshot_stats()["integrity"]["runs"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
        stop.set()
        cl.join(timeout=10)
        assert eng.round == 2 and not errors
        st = eng.snapshot_stats()
        assert st["reload_swaps"] == 1 and st["last_reload_ok"] is True
        assert st["integrity"]["runs"] >= 2 and not st["integrity"]["failed"]
    finally:
        box["httpd"].shutdown()
        srv.join(timeout=15)
        eng.close()
    httpd, reloader = box["ret"]
    assert httpd is box["httpd"] and not reloader.is_alive()


def test_cli_serve_hot_reloads(tmp_path):
    """``python -m cxxnet_tpu_torch ... task=serve model_dir=...
    serve_reload_period=...`` with the breaker keys and
    ``integrity_probe = 1``: a round written after start is served
    without a restart, ``/reloadz`` answers, SIGTERM exits 0."""
    mdir = str(tmp_path / "models")
    _save_round(mdir, 1, seed=1)
    conf = tmp_path / "serve.conf"
    conf.write_text(CONF)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", str(conf), "task=serve",
         f"model_dir={mdir}", "serve_port=0", "serve_reload_period=0.05",
         "reload_breaker_threshold=2", "reload_breaker_cooldown_s=1",
         "integrity_probe=1", "silent=1"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving model round 1" in line, line
        port = int(line.rsplit(":", 1)[1])
        _save_round(mdir, 2, seed=2)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", "/healthz")
            h = json.loads(conn.getresponse().read())
            conn.close()
            if h["round"] == 2:
                break
            time.sleep(0.05)
        assert h["round"] == 2 and h["status"] == "ok"
        st, r = _post(port, "/reloadz")
        assert st == 200 and (r["swapped"], r["round"]) == (False, 2)
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out


def test_cli_accepts_the_reload_and_guard_keys():
    task = LearnTask()
    for n, v in (("serve_reload_period", "0.5"),
                 ("reload_breaker_threshold", "2"),
                 ("reload_breaker_cooldown_s", "0"),
                 ("integrity_probe", "1"), ("divergence_policy", "rollback"),
                 ("divergence_lr_backoff", "0.1"),
                 ("divergence_max_retries", "5"),
                 ("divergence_loss_ratio", "50")):
        task.set_param(n, v)
    assert (task.serve_reload_period, task.reload_breaker_threshold,
            task.reload_breaker_cooldown_s, task.integrity_probe) == (
        0.5, 2, 0.0, 1)
    assert (task.divergence_policy, task.divergence_lr_backoff,
            task.divergence_max_retries) == ("rollback", 0.1, 5)
    tr = NetTrainer()
    tr.set_params(task.cfg)
    assert (tr.divergence_policy, tr.divergence_loss_ratio) == (
        "rollback", 50.0)
    with pytest.raises(ValueError):
        tr.set_param("divergence_policy", "retry")
    with pytest.raises(ValueError):
        tr.set_param("divergence_loss_ratio", "0.5")


# ----------------------------------------------------------------------
# int8 over a batch-norm net (ROADMAP A3)

BN_EVAL = """
eval = val
iter = synthetic
  nsample = 32
  input_shape = 3,12,12
  nclass = 5
iter = end
"""


def _eval_iter(pkg, conf):
    mod = __import__(f"{pkg}.io.data", fromlist=["create_iterator"])
    cfgmod = jcfg if pkg == "cxxnet_tpu" else tcfg
    split = cfgmod.split_sections(cfgmod.parse_pairs(conf + BN_EVAL))
    it = mod.create_iterator(split.find("eval")[0].entries)
    for n, v in split.global_entries:
        it.set_param(n, v)
    it.init()
    return it


def test_int8_over_a_bn_net_both_packages(tmp_path):
    """A bottleneck BN net under ``bn_eval = running`` after three port
    SGD steps: both packages' gated exports pass, carry the running
    statistics, and each artifact scores within ``BN_INT8_ATOL`` in both
    packages."""
    from test_torch_resnet import _batch, _bottleneck_conf

    conf = _bottleneck_conf(extra="bn_eval = running\nsilent = 1\n")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.set_param("seed", "4")
    tr.init_model()
    for s in range(3):
        tr.update_all(*_batch(8, seed=10 + s))
    src = str(tmp_path / "0003.model")
    tr.save_model(src, round_=3)
    aux = {k: {t: w.numpy().copy() for t, w in tags.items()}
           for k, tags in tr.aux.items()}
    assert len(aux) == 9
    paths = {}
    for pkg, mod, cfgmod in (("port", nquant, tcfg),
                             ("jax", jnquant, jcfg)):
        out = str(tmp_path / f"{pkg}.quant.model")
        v = mod.export_quantized(
            cfgmod.parse_pairs(conf), src,
            _eval_iter("cxxnet_tpu_torch" if pkg == "port" else "cxxnet_tpu",
                       conf), out_path=out)
        assert v["ok"] and v["agreement"] >= 0.99, (pkg, v)
        assert v["int8_layers"] >= 8 and v["path"] == out
        paths[pkg] = out
    x, _ = _batch(8, seed=20)
    for pkg, path in paths.items():
        ours = NetTrainer()
        ours.set_params(tcfg.parse_pairs(conf))
        ours.load_model(path)
        ref = JaxTrainer()
        ref.set_params(jcfg.parse_pairs(conf))
        ref.load_model(path)
        assert ours.quant_scheme == ref.quant_scheme == "int8"
        for key, tags in aux.items():
            for tag, w in tags.items():
                np.testing.assert_array_equal(ours.aux[key][tag].numpy(), w)
                np.testing.assert_array_equal(np.asarray(ref.aux[key][tag]),
                                              w)
        got = ours.predict_fn()(ours.params, ours.aux, x, ()).numpy()
        want = np.asarray(ref.predict_fn()(ref.params, ref.aux, x, ()))
        assert np.abs(got - want).max() <= BN_INT8_ATOL, pkg
        assert (got.argmax(1) == want.argmax(1)).all()
