"""The binary wire (``CXB1`` requests, ``CXR1`` replies) across the two
packages, on the CPU.

The codec: every frame either package's encoder writes is the other's
byte for byte and decodes in both; every malformed frame of the JAX
``test_codec_malformed_reasons`` gets the same reason in both.  The
servers: one small net, loaded from one JAX-written checkpoint, served
by the port and by the JAX package; the JAX codec as client of the
port's server and the port's codec as client of the JAX server, for
``predict``, ``scores`` and ``extract``, each binary reply bit-equal to
the same server's JSON reply (and the two servers' scores within
``SCORE_ATOL``); fuzzed frames answered 400 with the JAX server's
reason, never 500; ``wire = json``; JSON, binary and JSON again on one
kept-alive socket; the ``oversize_shape`` refusal of a 128-row
3x224x224 frame; the wire counters; and a frame's read-only rows never
wrapped by torch.
"""

import http.client
import json
import struct
import threading
import warnings

import numpy as np
import pytest

from cxxnet_tpu import config as jcfg
from cxxnet_tpu import serve as jserve
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.serve import wire as jwire

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import serve as tserve
from cxxnet_tpu_torch.serve import wire as twire

CONF = """
netconfig = start
layer[0->c] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 4
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
seed = 5
"""
ROW = (4, 4, 2)
SCORE_ATOL = 1e-6  # f32 scores of one checkpoint in both packages


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


# ----------------------------------------------------------------------
# codec

FRAMES = [
    (dict(data=np.arange(24, dtype="<f4").reshape(2, 3, 4))),
    (dict(data=_rows(3), kind="scores")),
    (dict(data=_rows(1)[0], kind="extract", node="fc1")),
    (dict(data=_rows(2), kind="extract", model="m1", node="cv1",
          priority="batch", deadline_ms=250.7)),
    (dict(data=np.ones((1, 1, 1, 1, 1, 1, 1, 2), "<f4"), deadline_ms=0.2)),
]


@pytest.mark.parametrize("frame", FRAMES)
def test_codec_frames_equal_both_ways(frame):
    ours = twire.encode_request(**frame)
    ref = jwire.encode_request(**frame)
    assert bytes(ours) == bytes(ref)
    for dec in (twire.decode_request, jwire.decode_request):
        req = dec(bytes(ours))
        assert req.kind == frame.get("kind", "predict")
        assert (req.model, req.node) == (frame.get("model", ""),
                                         frame.get("node", ""))
        np.testing.assert_array_equal(req.data, frame["data"])
        assert not req.data.flags.writeable  # a view over the frame
    assert twire.peek_header(ours) == jwire.peek_header(ref)
    kind = frame.get("kind", "predict")
    out = np.asarray(frame["data"], np.float32) * 2
    resp = twire.encode_response(out, kind, "ab12cd-7")
    assert resp == jwire.encode_response(out, kind, "ab12cd-7")
    for dec in (twire.decode_response, jwire.decode_response):
        k, rid, rows = dec(resp)
        assert (k, rid) == (kind, "ab12cd-7")
        np.testing.assert_array_equal(rows, out.reshape(rows.shape))
    patched = bytearray(ours)
    twire.patch_deadline(patched, 17.4)
    ref2 = bytearray(ref)
    jwire.patch_deadline(ref2, 17.4)
    assert patched == ref2
    assert twire.DEADLINE_OFFSET == jwire.DEADLINE_OFFSET == 8
    assert twire.MAX_PAYLOAD_BYTES == jwire.MAX_PAYLOAD_BYTES == 64 << 20


def _good():
    return bytes(twire.encode_request(np.ones((2, 4), dtype="<f4")))


def _oversize():
    big = bytearray(_good())
    struct.pack_into("<I", big, 16, 0x40000000)  # dim0 -> 2**30 rows
    return bytes(big)


# the malformed frames of the JAX package's test_codec_malformed_reasons
MALFORMED = [
    ("bad_magic", lambda g: b"EVIL" + g[4:]),
    ("truncated_frame", lambda g: g[:10]),
    ("truncated_body", lambda g: g[:-3]),
    ("trailing_bytes", lambda g: g + b"\x00"),
    ("bad_kind", lambda g: g[:4] + b"\x09" + g[5:]),
    ("bad_dtype", lambda g: g[:5] + b"\x07" + g[6:]),
    ("bad_ndim", lambda g: g[:6] + b"\x00" + g[7:]),
    ("bad_priority", lambda g: g[:7] + b"\x05" + g[8:]),
    ("oversize_shape", lambda g: _oversize()),
]


@pytest.mark.parametrize("want,make", MALFORMED)
def test_codec_malformed_reasons_match_jax(want, make):
    buf = make(_good())
    reasons = []
    for dec, err in ((twire.decode_request, twire.WireError),
                     (jwire.decode_request, jwire.WireError)):
        with pytest.raises(err) as e:
            dec(buf)
        reasons.append(e.value.reason)
    assert reasons == [want, want]


def test_codec_refuses_what_it_cannot_encode():
    x = np.ones((2, 4), np.float32)
    for kw in (dict(kind="nope"), dict(priority="urgent")):
        with pytest.raises(twire.WireError):
            twire.encode_request(x, **kw)
    with pytest.raises(twire.WireError, match="ndim"):
        twire.encode_request(np.ones((1,) * 9, np.float32))


def test_oversize_full_width_frame_refused_by_both_codecs():
    """128 rows of 3x224x224 f32 are 77,070,336 payload bytes, over the
    64 MiB cap: both decoders refuse the frame; 111 rows still fit."""
    head = bytearray(jwire.encode_request(np.ones((1, 224, 224, 3), "<f4")))
    for rows, want in ((128, "oversize_shape"), (111, "truncated_body")):
        struct.pack_into("<I", head, 16, rows)
        for dec in (twire.decode_request, jwire.decode_request):
            with pytest.raises(Exception) as e:
                dec(bytes(head))
            assert e.value.reason == want


# ----------------------------------------------------------------------
# the two servers

def _serve(engine, make_server):
    httpd = make_server(engine, port=0)
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    return httpd, t


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server and the JAX server on one JAX-written
    checkpoint: ``{"port": (engine, port), "jax": (engine, port)}``."""
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(CONF))
    jt.init_model()
    path = str(tmp_path_factory.mktemp("wire") / "0001.model")
    jt.save_model(path)
    engines = {
        "port": (tserve.Engine(cfg=tcfg.parse_pairs(CONF), model_in=path,
                               max_batch_size=8, batch_timeout_ms=1),
                 tserve.make_server),
        "jax": (jserve.Engine(cfg=jcfg.parse_pairs(CONF), model_in=path,
                              max_batch_size=8, batch_timeout_ms=1),
                jserve.make_server),
    }
    out, running = {}, []
    for name, (eng, make) in engines.items():
        httpd, t = _serve(eng, make)
        running.append((httpd, t, eng))
        out[name] = (eng, httpd.server_port)
    yield out
    for httpd, t, eng in running:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        eng.close()


def _post(port, path, body, ctype, conn=None):
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": ctype})
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("Content-Type") or "", r
    finally:
        if own:
            conn.close()


def _json(port, path, obj):
    status, body, _, _ = _post(port, path, json.dumps(obj).encode(),
                               "application/json")
    assert status == 200, body
    return json.loads(body)


# (kind, route, JSON body extras, JSON reply key)
KINDS = [("predict", "/predict", {}, "pred"),
         ("scores", "/predict", {"raw": True}, "scores"),
         ("extract", "/extract", {"node": "fc1"}, "features")]


@pytest.mark.parametrize("server,codec", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("kind,route,extra,key", KINDS)
def test_client_of_one_package_against_the_others_server(
        servers, server, codec, kind, route, extra, key):
    """The other package's codec frames the request and reads the reply;
    the binary reply is bit-equal to the JSON reply of the same server,
    and the two servers agree within ``SCORE_ATOL``."""
    enc = (jwire if codec == "jax" else twire)
    _eng, port = servers[server]
    x = _rows(5, seed=1)
    node = extra.get("node", "")
    status, body, ctype, _ = _post(
        port, route, bytes(enc.encode_request(x, kind=kind, node=node)),
        enc.CONTENT_TYPE)
    assert status == 200 and ctype == enc.CONTENT_TYPE, body
    k, rid, got = enc.decode_response(body)
    assert k == kind and rid
    ref = np.asarray(_json(port, route, {"data": x.tolist(), **extra})[key],
                     np.float32)
    assert got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    other = "jax" if server == "port" else "port"
    far = np.asarray(_json(servers[other][1], route,
                           {"data": x.tolist(), **extra})[key], np.float32)
    np.testing.assert_allclose(got, far, atol=SCORE_ATOL, rtol=0)


def _fuzz_cases():
    x = _rows(2)
    good = bytes(twire.encode_request(x))
    big = bytearray(good)
    struct.pack_into("<I", big, 16, 0x7FFFFFF0)
    cases = [("/predict", b"EVIL" + good[4:]),
             ("/predict", good[:4] + b"\x09" + good[5:]),
             ("/predict", good[:5] + b"\x07" + good[6:]),
             ("/predict", good[:6] + b"\x09" + good[7:]),
             ("/predict", good[:7] + b"\x05" + good[8:]),
             ("/predict", good[:8]),
             ("/predict", good[:-4]),
             ("/predict", good + b"\x00\x00"),
             ("/predict", bytes(big)),
             ("/extract", good),  # a predict frame on /extract
             ("/extract", bytes(twire.encode_request(x, kind="extract"))),
             ("/predict", bytes(twire.encode_request(x, kind="extract",
                                                     node="fc1")))]
    rng = np.random.RandomState(3)
    header = [i for i in range(24) if not 8 <= i < 12]  # not the deadline
    for _ in range(12):  # random bytes over a valid frame's header
        buf = bytearray(good)
        for i in rng.choice(header, size=3):
            buf[i] = rng.randint(0, 256)
        cases.append(("/predict", bytes(buf)))
    return cases


def test_fuzzed_frames_get_the_jax_servers_400_never_500(servers):
    """Each fuzzed frame: a JSON 400 from the port's server with the
    reason the JAX server gives (or both 200 where the bytes still make
    a valid frame), never a 500, on one kept-alive socket that still
    serves a clean request after them."""
    conns = {name: http.client.HTTPConnection("127.0.0.1", port, timeout=30)
             for name, (_e, port) in servers.items()}
    try:
        for route, frame in _fuzz_cases():
            seen = {}
            for name, conn in conns.items():
                status, body, _, r = _post(None, route, frame,
                                           twire.CONTENT_TYPE, conn)
                assert status != 500 and not r.will_close, (name, body)
                seen[name] = (status, json.loads(body).get("reason")
                              if status == 400 else None)
            assert seen["port"] == seen["jax"], (route, frame[:24], seen)
        status, body, _, _ = _post(None, "/predict", _good_rows_frame(),
                                   twire.CONTENT_TYPE, conns["port"])
        assert status == 200
        twire.decode_response(body)
    finally:
        for conn in conns.values():
            conn.close()


def _good_rows_frame():
    return bytes(twire.encode_request(_rows(2)))


def test_wire_json_refuses_binary_frames(servers, tmp_path):
    eng, _ = servers["port"]
    json_eng = tserve.Engine(cfg=tcfg.parse_pairs(CONF) + [("wire", "json")],
                             trainer=eng.trainer, max_batch_size=8,
                             batch_timeout_ms=1)
    httpd, t = _serve(json_eng, tserve.make_server)
    try:
        port = httpd.server_port
        status, body, _, _ = _post(port, "/predict", _good_rows_frame(),
                                   twire.CONTENT_TYPE)
        assert status == 400 and json.loads(body)["reason"] == "wire_disabled"
        assert "pred" in _json(port, "/predict", {"data": _rows(2).tolist()})
        # a malformed frame still gets its own reason
        status, body, _, _ = _post(port, "/predict", b"EVIL" + b"\0" * 20,
                                   twire.CONTENT_TYPE)
        assert json.loads(body)["reason"] == "bad_magic"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        json_eng.close()
    with pytest.raises(ValueError, match="wire must be"):
        tserve.Engine(cfg=[("wire", "msgpack")], trainer=eng.trainer)


def test_json_binary_json_on_one_kept_alive_socket(servers):
    eng, port = servers["port"]
    before = eng.snapshot_stats()
    x = _rows(3)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    replies = []
    try:
        for body, ctype in (
                (json.dumps({"data": x.tolist(), "raw": True}).encode(),
                 "application/json"),
                (bytes(twire.encode_request(x, kind="scores")),
                 twire.CONTENT_TYPE),
                (json.dumps({"data": x.tolist(), "raw": True}).encode(),
                 "application/json")):
            status, data, _, r = _post(None, "/predict", body, ctype, conn)
            assert r.version == 11 and status == 200
            assert not r.will_close, "the server dropped keep-alive"
            replies.append(data)
    finally:
        conn.close()
    scores = twire.decode_response(replies[1])[2]
    assert scores.tobytes() == np.asarray(
        json.loads(replies[0])["scores"], np.float32).tobytes()
    after = eng.snapshot_stats()
    wires = {w: after["wire_requests"][w] - before["wire_requests"][w]
             for w in ("json", "binary")}
    assert wires == {"json": 2, "binary": 1}
    frame_in = len(twire.encode_request(x, kind="scores"))
    frame_out = len(replies[1])
    assert after["wire_bytes"]["in"] - before["wire_bytes"]["in"] == frame_in
    assert after["wire_bytes"]["out"] - before["wire_bytes"]["out"] == frame_out


def test_full_width_128_row_frame_gets_oversize_shape(servers):
    """The port's server reads the whole 77 MB frame (under its 512 MiB
    body cap) and answers 400 ``oversize_shape``, as the JAX decoder
    refuses it; the socket stays usable."""
    _eng, port = servers["port"]
    frame = twire.encode_request(np.zeros((128, 3, 224, 224), np.float32))
    assert len(frame) > twire.MAX_PAYLOAD_BYTES
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        status, body, _, r = _post(None, "/predict", bytes(frame),
                                   twire.CONTENT_TYPE, conn)
        assert status == 400 and not r.will_close
        assert json.loads(body)["reason"] == "oversize_shape"
        status, _, _, _ = _post(None, "/predict", _good_rows_frame(),
                                twire.CONTENT_TYPE, conn)
        assert status == 200
    finally:
        conn.close()


@pytest.mark.parametrize("n", [1, 3, 8])
def test_frame_rows_are_never_wrapped_by_torch(servers, n):
    """A decoded frame's rows alias the (read-only) request body: the
    engine serves them at every bucket, padded or not, without torch's
    non-writable-array warning, and leaves the buffer as it was."""
    eng, _ = servers["port"]
    x = _rows(n, seed=n)
    frame = bytes(twire.encode_request(x, kind="scores"))
    req = twire.decode_request(frame)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = eng.scores(req.data)
    assert out.shape == (n, 6)
    assert frame == bytes(twire.encode_request(x, kind="scores"))
    np.testing.assert_array_equal(out, eng.scores(x.copy()))
