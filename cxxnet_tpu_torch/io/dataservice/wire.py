"""``CXD1``: the length-prefixed binary batch protocol of the data service.

The serving plane already moves bulk floats in binary frames
(``serve/wire.py``, ``CXB1``/``CXR1``) because JSON codec — not the
model — was the fleet bottleneck; the input plane has exactly the same
shape problem at scale (a decoded batch is megabytes of f32), so the
data service speaks the same dialect: little-endian ``struct`` headers
behind a 4-byte magic, stable machine-readable error tokens, and
``np.frombuffer`` zero-copy payload views.  Unlike CXB1 (one frame per
HTTP body) these frames ride a raw TCP stream, so every frame is
preceded by a ``u32`` byte length — the framing that lets a client
pipeline GETs and match responses without a parser state machine.

Frame kinds (header = magic ``CXD1`` + kind byte)::

    OPEN   0  client->server  JSON session params (batch_size, rank,
                              nworker, window)
    OPENED 1  server->client  JSON session grant (session id, dataset
                              fingerprint, clamped window)
    GET    2  client->server  <IQ>  epoch, local block index
    BATCH  3  server->client  _BATCH header + dims + f32 data +
                              f32 label + optional u32 inst_index
    EOE    4  server->client  <IQ>  epoch, local blocks in the epoch
    ERR    5  server->client  JSON {reason, detail}; ``overloaded`` is
                              the 429-style admission shed
    CLOSE  6  client->server  polite session teardown (EOF works too)

``BATCH`` echoes ``(epoch, block)`` so a client that reconnects
mid-stream can verify it is receiving exactly the cursor it asked for;
``flags`` bit0 marks a server cache hit (observability rides the wire),
bit1 marks an ``inst_index`` payload.

Reason tokens (``WireError.reason``): ``bad_magic``, ``bad_kind``,
``bad_json``, ``bad_open``, ``truncated_frame``, ``truncated_body``,
``trailing_bytes``, ``oversize_shape``.  Server refusals arrive as ERR
frames and surface as :class:`ServiceError` (reason tokens there:
``overloaded``, ``batch_size_mismatch``, ``bad_request``, ``internal``).

The port's copy of ``cxxnet_tpu/io/dataservice/wire.py``: every frame
is byte-equal to the JAX package's for the same inputs.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "MAGIC", "OPEN", "OPENED", "GET", "BATCH", "EOE", "ERR", "CLOSE",
    "WireError", "ServiceError", "MAX_FRAME_BYTES",
    "read_frame", "write_frame",
    "encode_open", "encode_opened", "encode_get", "encode_batch",
    "encode_eoe", "encode_err", "encode_close",
    "decode_kind", "decode_json", "decode_get", "decode_batch",
    "decode_eoe",
]

MAGIC = b"CXD1"

OPEN, OPENED, GET, BATCH, EOE, ERR, CLOSE = range(7)
_KIND_NAMES = ("OPEN", "OPENED", "GET", "BATCH", "EOE", "ERR", "CLOSE")

_HDR = struct.Struct("<4sB")      # magic, kind
_LEN = struct.Struct("<I")        # stream frame length prefix
_GET = struct.Struct("<IQ")       # epoch, local block
_EOE = struct.Struct("<IQ")       # epoch, local blocks this epoch
#: BATCH: flags, epoch, block, nrows, num_batch_padd, label_width, ndim
_BATCH = struct.Struct("<BIQIIHB")

FLAG_CACHE_HIT = 0x01
FLAG_HAS_INST = 0x02

_MAX_NDIM = 8
_F32 = np.dtype("<f4")
_U32 = np.dtype("<u4")

#: one decoded batch tops out well under this; the bound kills a
#: desynchronized length prefix before it becomes a giant allocation
MAX_FRAME_BYTES = 256 << 20


class WireError(ValueError):
    """Malformed ``CXD1`` frame.  ``reason`` is the stable token tests
    and clients key on; the text is for humans."""

    def __init__(self, reason: str, detail: str) -> None:
        self.reason = reason
        super().__init__(detail)


class ServiceError(RuntimeError):
    """A well-formed ERR frame from the server (refusal, not protocol
    damage).  ``reason == 'overloaded'`` is the retriable admission
    shed; everything else is a caller bug or server fault."""

    def __init__(self, reason: str, detail: str) -> None:
        self.reason = reason
        super().__init__(f"{reason}: {detail}")


# ----------------------------------------------------------------------
# stream framing
def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes; EOF mid-read is a ConnectionError so
    the client's reconnect path treats a killed server like any other
    broken pipe."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            raise ConnectionError(
                f"connection closed {got}/{n} bytes into a frame")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def read_frame(sock: socket.socket) -> Optional[bytes]:
    """Next frame body, or None on a clean EOF at a frame boundary."""
    head = b""
    while len(head) < _LEN.size:
        b = sock.recv(_LEN.size - len(head))
        if not b:
            if head:
                raise ConnectionError("connection closed inside a "
                                      "frame length prefix")
            return None
        head += b
    (n,) = _LEN.unpack(head)
    if n < _HDR.size or n > MAX_FRAME_BYTES:
        raise WireError("truncated_frame",
                        f"frame length {n} outside "
                        f"[{_HDR.size}, {MAX_FRAME_BYTES}]")
    return _recv_exact(sock, n)


def write_frame(sock: socket.socket, parts) -> None:
    """Send one frame from header+payload buffers with a single length
    prefix; the payload arrays are written straight from their
    memoryviews (no join copy)."""
    if isinstance(parts, (bytes, bytearray, memoryview)):
        parts = [parts]
    total = sum(len(p) for p in parts)
    if total > MAX_FRAME_BYTES:
        raise WireError("oversize_shape",
                        f"frame of {total} bytes exceeds "
                        f"{MAX_FRAME_BYTES}")
    sock.sendall(_LEN.pack(total))
    for p in parts:
        sock.sendall(p)


# ----------------------------------------------------------------------
# encoders
def _json_frame(kind: int, doc: dict) -> bytes:
    return _HDR.pack(MAGIC, kind) + json.dumps(
        doc, sort_keys=True, separators=(",", ":")).encode("utf-8")


def encode_open(batch_size: int, rank: int, nworker: int,
                window: int) -> bytes:
    return _json_frame(OPEN, {
        "batch_size": int(batch_size), "rank": int(rank),
        "nworker": int(nworker), "window": int(window),
    })


def encode_opened(session: int, fingerprint: str, window: int) -> bytes:
    return _json_frame(OPENED, {
        "session": int(session), "fingerprint": fingerprint,
        "window": int(window),
    })


def encode_get(epoch: int, block: int) -> bytes:
    return _HDR.pack(MAGIC, GET) + _GET.pack(epoch, block)


def encode_eoe(epoch: int, nblocks: int) -> bytes:
    return _HDR.pack(MAGIC, EOE) + _EOE.pack(epoch, nblocks)


def encode_err(reason: str, detail: str) -> bytes:
    return _json_frame(ERR, {"reason": reason, "detail": detail})


def encode_close() -> bytes:
    return _HDR.pack(MAGIC, CLOSE)


def encode_batch(data: np.ndarray, label: np.ndarray,
                 inst_index: Optional[np.ndarray], num_batch_padd: int,
                 epoch: int, block: int,
                 cache_hit: bool) -> List[bytes]:
    """``[header, data, label, inst?]`` buffers for :func:`write_frame`
    — the decoded arrays go to the socket without a join copy."""
    d = np.ascontiguousarray(data, _F32)
    lab = np.ascontiguousarray(label, _F32)
    if d.ndim < 1 or d.ndim > _MAX_NDIM:
        raise WireError("oversize_shape", f"cannot frame ndim {d.ndim}")
    nrows = d.shape[0]
    if lab.ndim != 2 or lab.shape[0] != nrows:
        raise WireError("oversize_shape",
                        f"label shape {lab.shape} does not match "
                        f"{nrows} data rows")
    flags = FLAG_CACHE_HIT if cache_hit else 0
    parts: List[bytes] = []
    if inst_index is not None:
        flags |= FLAG_HAS_INST
    head = _HDR.pack(MAGIC, BATCH) + _BATCH.pack(
        flags, epoch, block, nrows, num_batch_padd, lab.shape[1], d.ndim)
    head += struct.pack(f"<{d.ndim}I", *d.shape)
    parts.append(head)
    parts.append(memoryview(d).cast("B"))
    parts.append(memoryview(lab).cast("B"))
    if inst_index is not None:
        inst = np.ascontiguousarray(inst_index, _U32)
        if inst.shape != (nrows,):
            raise WireError("oversize_shape",
                            f"inst_index shape {inst.shape} for "
                            f"{nrows} rows")
        parts.append(memoryview(inst).cast("B"))
    return parts


# ----------------------------------------------------------------------
# decoders
def decode_kind(body) -> Tuple[int, memoryview]:
    """Validate the header; ``(kind, payload view)``."""
    view = memoryview(body)
    if len(view) < _HDR.size:
        raise WireError("truncated_frame",
                        f"{len(view)} bytes cannot hold a CXD1 header")
    magic, kind = _HDR.unpack_from(view, 0)
    if magic != MAGIC:
        raise WireError("bad_magic", f"bad frame magic {bytes(magic)!r}")
    if kind >= len(_KIND_NAMES):
        raise WireError("bad_kind", f"unknown kind byte {kind}")
    return kind, view[_HDR.size:]


def decode_json(payload: memoryview) -> dict:
    try:
        doc = json.loads(bytes(payload).decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        raise WireError("bad_json", "frame payload is not JSON")
    if not isinstance(doc, dict):
        raise WireError("bad_json", "frame payload is not a JSON object")
    return doc


def _fixed(payload: memoryview, st: struct.Struct, what: str):
    if len(payload) != st.size:
        raise WireError("truncated_body",
                        f"{what} payload is {len(payload)} bytes, "
                        f"want {st.size}")
    return st.unpack_from(payload, 0)


def decode_get(payload: memoryview) -> Tuple[int, int]:
    return _fixed(payload, _GET, "GET")  # (epoch, block)


def decode_eoe(payload: memoryview) -> Tuple[int, int]:
    return _fixed(payload, _EOE, "EOE")  # (epoch, nblocks)


def decode_batch(payload: memoryview):
    """``(epoch, block, cache_hit, data, label, inst, num_batch_padd)``
    — arrays are read-only ``np.frombuffer`` views over the frame."""
    if len(payload) < _BATCH.size:
        raise WireError("truncated_body",
                        f"BATCH payload is {len(payload)} bytes, "
                        f"header alone is {_BATCH.size}")
    flags, epoch, block, nrows, padd, label_width, ndim = \
        _BATCH.unpack_from(payload, 0)
    if not 1 <= ndim <= _MAX_NDIM:
        raise WireError("bad_kind", f"BATCH ndim {ndim} outside "
                                    f"1..{_MAX_NDIM}")
    dims_end = _BATCH.size + 4 * ndim
    if len(payload) < dims_end:
        raise WireError("truncated_body", "BATCH ends inside its shape")
    dims = struct.unpack_from(f"<{ndim}I", payload, _BATCH.size)
    if dims[0] != nrows:
        raise WireError("oversize_shape",
                        f"BATCH dim0 {dims[0]} != nrows {nrows}")
    data_bytes = 4
    for d in dims:
        if d < 1:
            raise WireError("oversize_shape",
                            f"non-positive dim {d} in shape {dims}")
        data_bytes *= d
        if data_bytes > MAX_FRAME_BYTES:
            raise WireError("oversize_shape",
                            f"shape {dims} implies > {MAX_FRAME_BYTES} "
                            "payload bytes")
    label_bytes = 4 * nrows * label_width
    inst_bytes = 4 * nrows if flags & FLAG_HAS_INST else 0
    body_end = dims_end + data_bytes + label_bytes + inst_bytes
    if len(payload) < body_end:
        raise WireError("truncated_body",
                        f"BATCH payload needs {body_end - dims_end} "
                        f"bytes, frame has {len(payload) - dims_end}")
    if len(payload) > body_end:
        raise WireError("trailing_bytes",
                        f"{len(payload) - body_end} bytes past the "
                        "BATCH payload")
    data = np.frombuffer(payload, _F32, count=data_bytes // 4,
                         offset=dims_end).reshape(dims)
    label = np.frombuffer(payload, _F32, count=nrows * label_width,
                          offset=dims_end + data_bytes)
    label = label.reshape(nrows, label_width)
    inst = None
    if flags & FLAG_HAS_INST:
        inst = np.frombuffer(payload, _U32, count=nrows,
                             offset=dims_end + data_bytes + label_bytes)
    return (epoch, block, bool(flags & FLAG_CACHE_HIT),
            data, label, inst, padd)
