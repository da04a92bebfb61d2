"""Binary zero-copy wire protocol for the serving data plane.

The port's own copy of ``cxxnet_tpu/serve/wire.py``: the same frames,
byte for byte, so a client of either package talks to the server of the
other.  A JSON request pays ``json.loads`` -> Python lists ->
``np.asarray`` on the way in and ``tolist()`` -> ``json.dumps`` on the
way out; this wire moves the rows as raw little-endian f32 instead, in
a versioned frame negotiated by ``Content-Type: application/x-cxb`` on
the existing ``/predict`` and ``/extract`` routes.  JSON stays as it
was.

Request frame (``CXB1``)::

    offset size  field
    0      4     magic  b"CXB1"  (the version lives in the magic)
    4      1     kind       0=predict  1=scores  2=extract
    5      1     dtype      1=float32 (the only dtype this version moves)
    6      1     ndim       1..8 (dim0 = request rows)
    7      1     priority   0=interactive  1=batch
    8      4     deadline_ms  u32, 0 = none  -- FIXED offset: the fleet
                 router patches the REMAINING budget in place
                 (struct.pack_into) without re-encoding the frame
    12     2     model_len  (utf-8 bytes, 0 = default route)
    14     2     node_len   (utf-8 bytes; extract's feature node)
    16     4*ndim  shape dims, u32 each
    ...          model bytes, then node bytes
    ...          payload: prod(shape)*4 raw little-endian f32, C order

The server decodes the payload with ``np.frombuffer`` over a
``memoryview`` — no copy between the socket buffer and the
micro-batcher.  Responses stream raw f32 rows back the same way
(``CXR1``: magic, kind echo, dtype, ndim, rid, shape, payload — no
``tolist()``).  Malformed frames are a client error: the server answers
400 with a machine-stable ``reason`` token (below), NEVER a 500, and
error bodies stay JSON so a failing client can always read them.

Reason tokens (``WireError.reason``): ``wire_disabled``, ``bad_magic``,
``bad_kind``, ``bad_dtype``, ``bad_ndim``, ``bad_priority``,
``oversize_shape``, ``truncated_frame``, ``truncated_body``,
``trailing_bytes``.

Imports numpy and the standard library only.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CONTENT_TYPE", "MAGIC_REQUEST", "MAGIC_RESPONSE", "WireError",
    "WireRequest", "encode_request", "decode_request", "peek_header",
    "patch_deadline", "encode_response_header", "encode_response",
    "decode_response",
    "MAX_PAYLOAD_BYTES",
]

CONTENT_TYPE = "application/x-cxb"

MAGIC_REQUEST = b"CXB1"
MAGIC_RESPONSE = b"CXR1"

#: request header: magic, kind, dtype, ndim, priority, deadline_ms,
#: model_len, node_len — deadline_ms sits at a FIXED byte offset so the
#: router can patch the remaining budget without re-encoding
_REQ = struct.Struct("<4sBBBBIHH")
DEADLINE_OFFSET = 8  # byte offset of deadline_ms inside the frame

#: response header: magic, kind, dtype, ndim, flags, rid_len, reserved
_RESP = struct.Struct("<4sBBBBHH")

_KINDS = ("predict", "scores", "extract")
_PRIORITIES = ("interactive", "batch")
_DTYPE_F32 = 1
_MAX_NDIM = 8
_F32 = np.dtype("<f4")

#: a frame's payload may not exceed the HTTP layer's body bound
MAX_PAYLOAD_BYTES = 64 << 20


class WireError(ValueError):
    """Malformed binary frame.  ``reason`` is the stable
    machine-readable token the 400 body carries (clients and the fuzz
    tests key on it; the text is for humans)."""

    def __init__(self, reason: str, detail: str) -> None:
        self.reason = reason
        super().__init__(detail)


@dataclasses.dataclass
class WireRequest:
    """A decoded ``CXB1`` frame.  ``data`` aliases the request buffer
    (read-only, zero-copy) — the batcher's staging copy is the first
    and only copy on the way to the device."""

    kind: str
    data: np.ndarray
    model: str = ""
    node: str = ""
    priority: str = "interactive"
    deadline_ms: Optional[float] = None


def _check_shape(ndim: int, dims: Tuple[int, ...]) -> int:
    """Validated payload byte count of ``dims`` (f32)."""
    if not 1 <= ndim <= _MAX_NDIM:
        raise WireError("bad_ndim", f"ndim {ndim} outside 1..{_MAX_NDIM}")
    n = 4
    for d in dims:
        if d < 1:
            raise WireError("oversize_shape",
                            f"non-positive dim {d} in shape {dims}")
        n *= d
        if n > MAX_PAYLOAD_BYTES:
            raise WireError(
                "oversize_shape",
                f"shape {dims} implies > {MAX_PAYLOAD_BYTES} payload bytes")
    return n


# ----------------------------------------------------------------------
# requests
def encode_request(data, kind: str = "predict", model: str = "",
                   node: str = "", priority: str = "interactive",
                   deadline_ms: Optional[float] = None) -> bytearray:
    """Client-side encoder.  Returns a mutable ``bytearray`` so a
    router holding the frame can :func:`patch_deadline` in place before
    relaying."""
    if kind not in _KINDS:
        raise WireError("bad_kind", f"unknown kind {kind!r}")
    if priority not in _PRIORITIES:
        raise WireError("bad_priority", f"unknown priority {priority!r}")
    arr = np.ascontiguousarray(data, _F32)
    if arr.ndim < 1 or arr.ndim > _MAX_NDIM:
        raise WireError("bad_ndim", f"cannot frame ndim {arr.ndim}")
    mb = model.encode("utf-8")
    nb = node.encode("utf-8")
    dl = 0
    if deadline_ms is not None and deadline_ms > 0:
        # u32 milliseconds; a sub-millisecond remainder still has to
        # reach the replica as a live (nonzero) budget
        dl = max(1, min(int(deadline_ms), 0xFFFFFFFF))
    out = bytearray(_REQ.pack(
        MAGIC_REQUEST, _KINDS.index(kind), _DTYPE_F32, arr.ndim,
        _PRIORITIES.index(priority), dl, len(mb), len(nb)))
    out += struct.pack(f"<{arr.ndim}I", *arr.shape)
    out += mb
    out += nb
    out += memoryview(arr).cast("B")
    return out


def peek_header(buf) -> Tuple[str, str, str, Optional[float], int]:
    """Validate a frame's header WITHOUT touching the payload and
    return ``(kind, model, priority, deadline_ms, payload_bytes)`` —
    what the fleet router needs for admission/classification/deadline
    before relaying the frame opaquely.  Raises :class:`WireError` on
    anything malformed, including a buffer whose length disagrees with
    the shape it declares."""
    view = memoryview(buf)
    if len(view) < _REQ.size:
        raise WireError("truncated_frame",
                        f"{len(view)} bytes cannot hold a frame header")
    magic, kind_b, dtype, ndim, prio_b, dl, mlen, nlen = \
        _REQ.unpack_from(view, 0)
    if magic != MAGIC_REQUEST:
        raise WireError("bad_magic",
                        f"bad frame magic {bytes(magic)!r}")
    if kind_b >= len(_KINDS):
        raise WireError("bad_kind", f"unknown kind byte {kind_b}")
    if dtype != _DTYPE_F32:
        raise WireError("bad_dtype",
                        f"unsupported dtype code {dtype} (want "
                        f"{_DTYPE_F32} = float32)")
    if prio_b >= len(_PRIORITIES):
        raise WireError("bad_priority",
                        f"unknown priority byte {prio_b}")
    dims_end = _REQ.size + 4 * ndim
    if not 1 <= ndim <= _MAX_NDIM:
        raise WireError("bad_ndim", f"ndim {ndim} outside 1..{_MAX_NDIM}")
    if len(view) < dims_end + mlen + nlen:
        raise WireError("truncated_frame",
                        "frame ends inside shape/name fields")
    dims = struct.unpack_from(f"<{ndim}I", view, _REQ.size)
    payload = _check_shape(ndim, dims)
    body_end = dims_end + mlen + nlen + payload
    if len(view) < body_end:
        raise WireError(
            "truncated_body",
            f"payload needs {payload} bytes, frame has "
            f"{len(view) - dims_end - mlen - nlen}")
    if len(view) > body_end:
        raise WireError("trailing_bytes",
                        f"{len(view) - body_end} bytes past the payload")
    try:
        model = str(view[dims_end:dims_end + mlen], "utf-8")
    except UnicodeDecodeError:
        raise WireError("truncated_frame", "model name is not utf-8")
    return (_KINDS[kind_b], model, _PRIORITIES[prio_b],
            float(dl) if dl else None, payload)


def decode_request(buf) -> WireRequest:
    """Full zero-copy decode: the returned array is an
    ``np.frombuffer`` view over ``buf`` (read-only)."""
    view = memoryview(buf)
    kind, model, priority, deadline_ms, _payload = peek_header(view)
    _magic, _k, _d, ndim, _p, _dl, mlen, nlen = _REQ.unpack_from(view, 0)
    dims = struct.unpack_from(f"<{ndim}I", view, _REQ.size)
    dims_end = _REQ.size + 4 * ndim
    try:
        node = str(view[dims_end + mlen:dims_end + mlen + nlen], "utf-8")
    except UnicodeDecodeError:
        raise WireError("truncated_frame", "node name is not utf-8")
    data = np.frombuffer(view, _F32,
                         offset=dims_end + mlen + nlen).reshape(dims)
    return WireRequest(kind=kind, data=data, model=model, node=node,
                       priority=priority, deadline_ms=deadline_ms)


def patch_deadline(frame: bytearray, deadline_ms: float) -> None:
    """Overwrite the frame's deadline with the REMAINING budget —
    the router's per-attempt update, no re-encode, no payload touch."""
    dl = max(1, min(int(deadline_ms), 0xFFFFFFFF)) if deadline_ms > 0 \
        else 0
    struct.pack_into("<I", frame, DEADLINE_OFFSET, dl)


# ----------------------------------------------------------------------
# responses
def encode_response_header(arr: np.ndarray, kind: str,
                           rid: str) -> Tuple[bytes, np.ndarray]:
    """``(header_bytes, payload_array)`` for a result — the server
    writes the two straight to the socket (header, then the array's
    memoryview) so the scores are never copied into a joined body."""
    out = np.ascontiguousarray(arr, _F32)
    if out.ndim < 1:
        out = out.reshape(1)
    rb = rid.encode("utf-8")
    head = _RESP.pack(MAGIC_RESPONSE, _KINDS.index(kind), _DTYPE_F32,
                      out.ndim, 0, len(rb), 0)
    head += struct.pack(f"<{out.ndim}I", *out.shape)
    head += rb
    return head, out


def encode_response(arr, kind: str, rid: str) -> bytes:
    head, out = encode_response_header(np.asarray(arr), kind, rid)
    return head + memoryview(out).cast("B").tobytes()


def decode_response(buf) -> Tuple[str, str, np.ndarray]:
    """``(kind, rid, rows)`` from a ``CXR1`` frame (client side)."""
    view = memoryview(buf)
    if len(view) < _RESP.size:
        raise WireError("truncated_frame",
                        f"{len(view)} bytes cannot hold a response header")
    magic, kind_b, dtype, ndim, _flags, rlen, _res = \
        _RESP.unpack_from(view, 0)
    if magic != MAGIC_RESPONSE:
        raise WireError("bad_magic",
                        f"bad response magic {bytes(magic)!r}")
    if dtype != _DTYPE_F32 or kind_b >= len(_KINDS):
        raise WireError("bad_dtype", "unsupported response encoding")
    if not 1 <= ndim <= _MAX_NDIM:
        raise WireError("bad_ndim", f"response ndim {ndim}")
    dims_end = _RESP.size + 4 * ndim
    if len(view) < dims_end + rlen:
        raise WireError("truncated_frame",
                        "response ends inside shape/rid fields")
    dims = struct.unpack_from(f"<{ndim}I", view, _RESP.size)
    payload = _check_shape(ndim, dims)
    if len(view) != dims_end + rlen + payload:
        raise WireError("truncated_body",
                        f"response payload needs {payload} bytes")
    rid = str(view[dims_end:dims_end + rlen], "utf-8")
    data = np.frombuffer(view, _F32, offset=dims_end + rlen).reshape(dims)
    return _KINDS[kind_b], rid, data
