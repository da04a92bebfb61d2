"""The data service of the port (``cxxnet_tpu_torch/io/dataservice/``,
``iter = service``, ``task=data_service``) against the JAX package's, on
the CPU.

Held against the JAX package: every ``CXD1`` frame byte for byte and
every malformed frame's reason, ``dataset_fingerprint``, and the streams
across packages in one process (the port's client against a JAX server,
a JAX client against the port's server), each bit-equal to the local
chain over several epochs, on MNIST idx files and on raw imgbin pages
with crop and mirror drawn per epoch.  The port alone: the cache's LRU
accounting, the block deal of rank 0 and rank 1, reconnect and resume
across a server restart, the refusal of a changed fingerprint, the shed
and the batch-size refusal at OPEN, ``close()`` with no thread left,
the health and stats planes, the three ``dataservice.rpc`` faults, and
``task=data_service`` in a subprocess feeding ``task=train``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu.io.data import create_iterator as jcreate
from cxxnet_tpu.io.dataservice import server as jserver
from cxxnet_tpu.io.dataservice import wire as jwire
from cxxnet_tpu.utils import faults as jfaults

from cxxnet_tpu_torch.io import imgbin as timgbin
from cxxnet_tpu_torch.io.augment import ANCHOR_KEY
from cxxnet_tpu_torch.io.data import create_iterator
from cxxnet_tpu_torch.io.dataservice import wire
from cxxnet_tpu_torch.io.dataservice.cache import CachedBlock, ChunkCache
from cxxnet_tpu_torch.io.dataservice.server import (DataServiceServer,
                                                    dataset_fingerprint)
from cxxnet_tpu_torch.io.mnist import write_idx_images, write_idx_labels
from cxxnet_tpu_torch.obs.registry import registry as tregistry
from cxxnet_tpu_torch.utils import checkpoint as tckpt
from cxxnet_tpu_torch.utils import faults as tfaults
from cxxnet_tpu_torch.utils.faults import WatchdogError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVERS = {"port": DataServiceServer, "jax": jserver.DataServiceServer}
CREATE = {"port": create_iterator, "jax": jcreate}


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    yield
    tfaults.reset()


# ----------------------------------------------------------------------
# wire
def _frames(mod):
    rng = np.random.RandomState(0)
    data = rng.rand(4, 2, 2, 3).astype(np.float32)
    label = rng.rand(4, 2).astype(np.float32)
    inst = np.arange(4, dtype=np.uint32)
    return {
        "open": mod.encode_open(32, 1, 4, 2),
        "opened": mod.encode_opened(7, "cafe0123", 4),
        "err": mod.encode_err("overloaded", "full"),
        "get": mod.encode_get(3, 17),
        "eoe": mod.encode_eoe(2, 50),
        "close": mod.encode_close(),
        "batch": b"".join(bytes(p) for p in mod.encode_batch(
            data, label, inst, 1, epoch=5, block=9, cache_hit=True)),
        "batch_noinst": b"".join(bytes(p) for p in mod.encode_batch(
            data[:, 0, 0], label, None, 0, epoch=1, block=2,
            cache_hit=False)),
    }


@pytest.mark.parametrize("kind", ["open", "opened", "err", "get", "eoe",
                                  "close", "batch", "batch_noinst"])
def test_frames_byte_equal_jax(kind):
    body = _frames(wire)[kind]
    assert body == _frames(jwire)[kind]
    for mod in (wire, jwire):
        k, payload = mod.decode_kind(body)
        if kind.startswith("batch"):
            ep, blk, hit, d, lab, inst, padd = mod.decode_batch(payload)
            assert d.dtype == np.float32 and not d.flags.writeable
            assert (inst is None) == (kind == "batch_noinst")
        elif kind in ("get", "eoe"):
            assert getattr(mod, f"decode_{kind}")(payload) == (
                (3, 17) if kind == "get" else (2, 50))
        elif kind != "close":
            assert mod.decode_json(payload) == jwire.decode_json(payload)
    assert (wire.MAGIC, wire.MAX_FRAME_BYTES) == (jwire.MAGIC,
                                                  jwire.MAX_FRAME_BYTES)


def _batch_body(mod):
    return bytearray(b"".join(bytes(p) for p in mod.encode_batch(
        np.zeros((2, 3), np.float32), np.zeros((2, 1), np.float32),
        None, 0, 0, 0, False)))


_MUTATIONS = {
    "bad_magic": lambda b: b"XXXX" + bytes(b[4:]),
    "bad_kind": lambda b: bytes(b[:4]) + b"\x63" + bytes(b[5:]),
    "truncated_body": lambda b: bytes(b[:-4]),
    "trailing_bytes": lambda b: bytes(b) + b"\x00\x00",
    "truncated_header": lambda b: bytes(b[:5]),
    "short_frame": lambda b: bytes(b[:3]),
    # the header is 5 bytes, then flags, epoch, block, nrows, padd,
    # label width, ndim (byte 28), then the dims from byte 29
    "bad_ndim": lambda b: bytes(b[:28]) + b"\x09" + bytes(b[29:]),
    "dim0_mismatch": lambda b: bytes(b[:29]) + b"\x05" + bytes(b[30:]),
    "zero_dim": lambda b: bytes(b[:33]) + b"\x00" + bytes(b[34:]),
}


@pytest.mark.parametrize("name", sorted(_MUTATIONS))
def test_malformed_frames_give_the_jax_reasons(name):
    out = []
    for mod in (wire, jwire):
        body = _MUTATIONS[name](_batch_body(mod))
        try:
            k, payload = mod.decode_kind(body)
            mod.decode_batch(payload)
            out.append(None)
        except mod.WireError as e:
            out.append((e.reason, str(e)))
    assert out[0] == out[1] and out[0] is not None


def test_stream_framing_bounds_and_bad_json():
    for mod in (wire, jwire):
        k, payload = mod.decode_kind(mod._HDR.pack(mod.MAGIC, mod.OPEN)
                                     + b"not json")
        with pytest.raises(mod.WireError) as e:
            mod.decode_json(payload)
        assert e.value.reason == "bad_json"
    a, b = socket.socketpair()
    try:
        a.sendall(wire._LEN.pack(wire.MAX_FRAME_BYTES + 1))
        with pytest.raises(wire.WireError) as e:
            wire.read_frame(b)
        assert e.value.reason == "truncated_frame"
        wire.write_frame(a, [wire.encode_get(1, 2)])
        assert wire.read_frame(b) == jwire.encode_get(1, 2)
        a.close()
        assert wire.read_frame(b) is None  # EOF at a frame boundary
    finally:
        b.close()


# ----------------------------------------------------------------------
# fingerprint and cache
def test_dataset_fingerprint_equal_jax(tmp_path):
    p = tmp_path / "d.bin"
    p.write_bytes(b"x" * 64)
    ent = [("iter", "mnist"), ("path_img", str(p))]
    fp = dataset_fingerprint(ent)
    assert fp == jserver.dataset_fingerprint(ent)
    assert fp != dataset_fingerprint(ent + [("shuffle", "1")])
    p.write_bytes(b"x" * 65)
    assert fp != dataset_fingerprint(ent)
    assert dataset_fingerprint(ent) == jserver.dataset_fingerprint(ent)


def _blk(nrows=4, ncol=8, seed=0):
    rng = np.random.RandomState(seed)
    return CachedBlock(rng.rand(nrows, ncol).astype(np.float32),
                       rng.rand(nrows, 1).astype(np.float32),
                       np.arange(nrows, dtype=np.uint32), 0)


def test_chunk_cache_lru_and_accounting():
    one = _blk().nbytes
    c = ChunkCache(max_bytes=3 * one)
    for i in range(3):
        c.put(("fp", 0, i), _blk(seed=i))
    assert len(c) == 3 and c.bytes == 3 * one
    assert c.get(("fp", 0, 0)) is not None
    c.put(("fp", 0, 3), _blk(seed=3))  # evicts 1, the least recent
    assert c.get(("fp", 0, 1)) is None
    assert c.get(("fp", 0, 2), record=False) is not None
    st = c.stats()
    assert (st["evictions"], st["bytes"], st["hits"], st["misses"]) == (
        1, 3 * one, 1, 1)
    c.note_hit()
    c.note_miss()
    assert c.stats()["hit_rate"] == 0.5
    off = ChunkCache(max_bytes=0)
    off.put(("fp", 0, 0), _blk())
    assert off.get(("fp", 0, 0)) is None
    with pytest.raises(ValueError):
        _blk().data[0, 0] = 1.0


# ----------------------------------------------------------------------
# server and client
def _mnist(tmp_path, n=96, seed=3):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 255, size=(n, 4, 4), dtype=np.uint8)
    labs = (imgs.reshape(n, -1).mean(axis=1) > 127).astype(np.uint8)
    pi, pl = str(tmp_path / "img.idx"), str(tmp_path / "lab.idx")
    write_idx_images(pi, imgs)
    write_idx_labels(pl, labs)
    sec = [("iter", "mnist"), ("path_img", pi), ("path_label", pl),
           ("shuffle", "1"), ("input_flat", "1")]
    return sec, [("batch_size", "16"), ("silent", "1"), ("seed_data", "5")]


def _imgbin(tmp_path, n=40):
    """Raw pages whose crop and mirror are drawn per epoch and record."""
    rng = np.random.RandomState(7)
    path = str(tmp_path / "train")
    w = timgbin.BinPageWriter(path + ".bin", page_size=4000)
    with open(path + ".lst", "w") as f:
        for i in range(n):
            img = rng.randint(0, 255, size=(10, 10, 3)).astype(np.uint8)
            w.push(timgbin.encode_raw(img))
            f.write(f"{i}\t{i % 5}\timg{i}.jpg\n")
    w.close()
    sec = [("iter", "imgbin"), ("native_decoder", "0"),
           ("image_bin", path + ".bin"), ("image_list", path + ".lst"),
           ("raw_pixels", "1"), ("rand_crop", "1"), ("rand_mirror", "1"),
           ("silent", "1")]
    return sec, [("input_shape", "3,8,8"), ("batch_size", "8"),
                 ("silent", "1"), ("seed_data", "2")]


DATASETS = {"mnist": _mnist, "imgbin": _imgbin}


def _server(pkg, sec, glob, **kw):
    kw.setdefault("max_sessions", 8)
    kw.setdefault("cache_bytes", 16 << 20)
    kw.setdefault("silent", True)
    srv = SERVERS[pkg](sec, glob, **kw)
    srv.start()
    return srv


def _client(pkg, port, glob, **params):
    it = CREATE[pkg]([
        ("iter", "service"), ("data_service_addr", f"127.0.0.1:{port}"),
        ("data_service_retry_delay_s", "0.05"), ("watchdog_timeout_s", "20"),
    ] + [(k, str(v)) for k, v in params.items()])
    for n, v in glob:
        it.set_param(n, v)
    it.init()
    return it


def _local(sec, glob):
    it = create_iterator(sec)
    for n, v in glob:
        it.set_param(n, v)
    it.init()
    return it


def _collect(it, epoch, how="anchor"):
    """One epoch: the port's anchor before the rewind, or the JAX
    package's ``augment_epoch`` after it."""
    if how == "anchor":
        it.set_param(ANCHOR_KEY, str(epoch))
        it.before_first()
    else:
        it.before_first()
        it.set_param("augment_epoch", str(epoch))
    out = []
    while it.next():
        b = it.value()
        out.append((np.array(b.data), np.array(b.label), b.num_batch_padd))
    return out


def _same(a, b):
    assert len(a) == len(b) > 0
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert da.tobytes() == db.tobytes()
        assert la.tobytes() == lb.tobytes()
        assert pa == pb


@pytest.mark.parametrize("dataset", sorted(DATASETS))
@pytest.mark.parametrize("client,server", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_streams_across_packages_equal_the_local_chain(tmp_path, dataset,
                                                       client, server):
    sec, glob = DATASETS[dataset](tmp_path)
    srv = _server(server, sec, glob)
    ref = _local(sec, glob)
    it = _client(client, srv.port, glob)
    how = "anchor" if client == "port" else "augment_epoch"
    try:
        streams = {}
        for epoch in (0, 2, 1, 2):  # addressed: any epoch, any order
            got = _collect(it, epoch, how)
            _same(_collect(ref, epoch), got)
            streams.setdefault(epoch, got)
        if dataset == "imgbin":  # the draws do depend on the epoch
            assert streams[1][0][0].tobytes() != streams[2][0][0].tobytes()
    finally:
        it.close()
        ref.close()
        srv.close()


def test_two_clients_share_the_cache_and_agree(tmp_path):
    sec, glob = _mnist(tmp_path)
    srv = _server("port", sec, glob)
    a, b = _client("port", srv.port, glob), _client("port", srv.port, glob)
    try:
        sa = _collect(a, 0)
        sb = _collect(b, 0)
        _same(sa, sb)
        st = srv.plant.cache.stats()
        assert st["hits"] >= len(sb) and st["hit_rate"] > 0
    finally:
        a.close()
        b.close()
        srv.close()


def test_block_deal_matches_the_local_stream(tmp_path):
    sec, glob = _mnist(tmp_path)
    srv = _server("port", sec, glob)
    ref = _local(sec, glob)
    r0 = _client("port", srv.port, glob, dist_num_worker=2,
                 dist_worker_rank=0)
    r1 = _client("port", srv.port, glob, dist_num_worker=2,
                 dist_worker_rank=1)
    try:
        local = _collect(ref, 0)
        s0, s1 = _collect(r0, 0), _collect(r1, 0)
        assert len(s0) == len(s1) == len(local) // 2
        for k in range(len(s0)):
            assert s0[k][0].tobytes() == local[2 * k][0].tobytes()
            assert s1[k][0].tobytes() == local[2 * k + 1][0].tobytes()
    finally:
        for c in (r0, r1, ref):
            c.close()
        srv.close()


def test_reconnect_resumes_the_identical_stream(tmp_path):
    sec, glob = _imgbin(tmp_path)
    ref = _local(sec, glob)
    local = _collect(ref, 3)
    srv = _server("port", sec, glob)
    port = srv.port
    it = _client("port", port, glob)
    try:
        it.set_param(ANCHOR_KEY, "3")
        it.before_first()
        got = []
        for _ in range(2):
            assert it.next()
            b = it.value()
            got.append((np.array(b.data), np.array(b.label),
                        b.num_batch_padd))
        srv.close()  # every connection dropped dead, as a SIGKILL would
        srv = _server("jax", sec, glob, port=port)  # the other package
        while it.next():
            b = it.value()
            got.append((np.array(b.data), np.array(b.label),
                        b.num_batch_padd))
        _same(local, got)
        assert it.reconnects >= 1
    finally:
        it.close()
        ref.close()
        srv.close()


def test_reconnect_refuses_a_changed_fingerprint(tmp_path):
    sec, glob = _mnist(tmp_path)
    srv = _server("port", sec, glob)
    port = srv.port
    it = _client("port", port, glob)
    try:
        it.before_first()
        assert it.next()
        srv.close()
        alt = tmp_path / "alt"
        alt.mkdir()
        srv = _server("port", _mnist(alt, seed=11)[0], glob, port=port)
        with pytest.raises(RuntimeError, match="fingerprint changed"):
            while it.next():
                pass
    finally:
        it.close()
        srv.close()


def _raw_open(port, batch_size=16):
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    wire.write_frame(s, wire.encode_open(batch_size, 0, 1, 2))
    kind, payload = wire.decode_kind(wire.read_frame(s))
    return s, kind, wire.decode_json(payload)


def _wait_sessions(srv, n, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if len(srv._sessions) == n:
            return
        time.sleep(0.02)
    raise AssertionError(f"{len(srv._sessions)} sessions, want {n}")


def test_admission_shed_and_batch_size_refusal(tmp_path):
    sec, glob = _mnist(tmp_path)
    srv = _server("port", sec, glob, max_sessions=1)
    try:
        s1, kind, doc = _raw_open(srv.port)
        assert kind == wire.OPENED
        assert doc["fingerprint"] == srv.plant.fingerprint
        s2, kind2, doc2 = _raw_open(srv.port)
        assert (kind2, doc2["reason"]) == (wire.ERR, "overloaded")
        s2.close()
        shed = tregistry().counter("dataservice_shed_total", "",
                                   labelnames=("reason",))
        assert shed.labels(reason="overloaded").value >= 1
        s1.close()
        _wait_sessions(srv, 0)
        s3, kind3, doc3 = _raw_open(srv.port, batch_size=8)
        assert (kind3, doc3["reason"]) == (wire.ERR, "batch_size_mismatch")
        s3.close()
    finally:
        srv.close()


def test_close_tears_down_sessions_and_threads(tmp_path):
    sec, glob = _mnist(tmp_path)
    srv = _server("port", sec, glob)
    before = set(threading.enumerate())
    it = _client("port", srv.port, glob)
    try:
        it.before_first()
        assert it.next()
        _wait_sessions(srv, 1)
    finally:
        it.close()
    _wait_sessions(srv, 0)
    assert tregistry().gauge("dataservice_sessions", "").get() == 0.0
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive() and t.name == "dataservice-client"]
    it.close()
    srv.close()
    srv.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("dataservice-") and t.is_alive()]


def test_health_and_stats_planes(tmp_path):
    sec, glob = _mnist(tmp_path)
    srv = _server("port", sec, glob)
    it = _client("port", srv.port, glob)

    def get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.http_port}{path}", timeout=5) as r:
            return r.read().decode()

    try:
        _collect(it, 0)
        assert json.loads(get("/healthz"))["status"] == "ok"
        st = json.loads(get("/statsz"))
        assert st["fingerprint"] == srv.plant.fingerprint
        assert (st["blocks_produced"], st["epoch_lens"]) == (6, {"0": 6})
        assert st["cache"]["misses"] >= 6
        text = get("/metricsz")
        assert "dataservice_batches_total" in text
        assert "dataservice_cache_bytes" in text
    finally:
        it.close()
        srv.close()


@pytest.mark.parametrize("spec", ["dataservice.rpc:ioerror:0.3",
                                  "dataservice.rpc:latency:0.5",
                                  "dataservice.rpc:hang:1:1"])
def test_rpc_faults_resume_bit_equal(tmp_path, spec):
    sec, glob = _imgbin(tmp_path)
    ref = _local(sec, glob)
    srv = _server("port", sec, glob)
    it = _client("port", srv.port, glob)
    tfaults.configure([("fault_seed", "6"), ("fault_latency_ms", "5"),
                       ("fault_hang_s", "0.3"), ("fault_inject", spec)])
    try:
        for epoch in (1, 2):
            _same(_collect(ref, epoch), _collect(it, epoch))
        fired = tfaults.injector().fire_counts()
        assert sum(fired.values()) >= 1, fired
        if "ioerror" in spec:
            assert it.reconnects >= 1
    finally:
        tfaults.reset()
        it.close()
        ref.close()
        srv.close()


def test_a_hung_rpc_trips_the_watchdog(tmp_path):
    sec, glob = _mnist(tmp_path)
    srv = _server("port", sec, glob)
    it = _client("port", srv.port, glob, watchdog_timeout_s=0.5)
    tfaults.configure([("fault_hang_s", "30"),
                       ("fault_inject", "dataservice.rpc:hang:1:1")])
    try:
        it.before_first()
        with pytest.raises(WatchdogError, match="data service client"):
            it.next()
    finally:
        tfaults.reset()  # releases the hang
        it.close()
        srv.close()


def test_cli_data_service_feeds_train_bit_equal_to_local(tmp_path):
    """``task=data_service`` in a subprocess; ``task=train`` fed by
    ``iter = service`` writes the checkpoints a local chain writes."""
    sec, glob = _imgbin(tmp_path)
    data = "".join(f"{n} = {v}\n" for n, v in sec)
    net = """
netconfig = start
layer[0->1] = conv:cv1
  kernel_size = 3
  nchannel = 4
  init_sigma = 0.1
layer[1->2] = max_pooling
  kernel_size = 2
  stride = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc1
  nhidden = 5
  init_sigma = 0.1
layer[4->4] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 8
seed_data = 2
dev = cpu
eta = 0.1
silent = 1
num_round = 2
"""
    (tmp_path / "svc.conf").write_text(
        f"data = train\n{data}iter = end\n{net}")
    env = dict(os.environ, PYTHONPATH=REPO)
    ready = tmp_path / "ready.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", "svc.conf",
         "task=data_service", f"data_service_ready_file={ready}"],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    try:
        t0 = time.monotonic()
        while not ready.exists() and time.monotonic() - t0 < 60:
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.05)
        port = json.loads(ready.read_text())["port"]
        (tmp_path / "client.conf").write_text(
            "data = train\niter = service\n"
            f"data_service_addr = 127.0.0.1:{port}\niter = end\n{net}")
        from cxxnet_tpu_torch.cli import LearnTask

        for conf, mdir in (("client.conf", "ms"), ("svc.conf", "ml")):
            LearnTask().run([str(tmp_path / conf), "task=train",
                             f"model_dir={tmp_path / mdir}"])
        for r in (1, 2):
            a, b = (tmp_path / m / f"{r:04d}.model" for m in ("ms", "ml"))
            assert (tckpt.crc32_file(str(a)) == tckpt.crc32_file(str(b)))
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert "data_service: shutdown complete" in out
    jfaults.reset()
