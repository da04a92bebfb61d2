"""ctypes binding for the native page reader (``csrc/host/cxxnet_io.cc``).

Counterpart of ``cxxnet_tpu/io/native.py``.  The native library plays
the role of the reference's ThreadBuffer page + decode threads
(``iter_thread_imbin_x-inl.hpp:203-354``): a C++ reader thread streams
the pages while a libjpeg decode pool converts blobs to HWC uint8,
re-ordered to ``.lst`` order.  Python sees a simple pull iterator.

The library is the port's own copy of the JAX package's source, built
by ``ops/_build.py`` (``build_host``) into ``build/host/`` at first use;
nothing is built into or read from ``native/``.  ``available()`` is
False when it cannot be built (no ``g++``, no ``jpeglib.h``), and
:func:`unavailable_reason` then says why (the compiler's error line).
Records the C++ side cannot decode (non-JPEG) come back as raw blobs
for PIL.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False
_reason = ""
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from ..ops import _build

        try:
            lib = ctypes.CDLL(_build.build_host("libcxxnet_io"))
        except _build.HostBuildError as e:
            _reason = str(e)
            return None
        except OSError as e:
            _reason = f"cannot load the native reader: {e}"
            return None
        lib.cxio_open.restype = ctypes.c_void_p
        lib.cxio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.cxio_reset.argtypes = [ctypes.c_void_p]
        lib.cxio_next.restype = ctypes.c_int
        lib.cxio_next.argtypes = [ctypes.c_void_p]
        lib.cxio_kind.restype = ctypes.c_int
        lib.cxio_kind.argtypes = [ctypes.c_void_p]
        lib.cxio_shape.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.cxio_size.restype = ctypes.c_long
        lib.cxio_size.argtypes = [ctypes.c_void_p]
        lib.cxio_copy.restype = ctypes.c_long
        lib.cxio_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long
        ]
        lib.cxio_close.argtypes = [ctypes.c_void_p]
        lib.cxio_error.restype = ctypes.c_char_p
        lib.cxio_error.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Is the native reader built (or buildable now) and loaded?"""
    return _load() is not None


def unavailable_reason() -> str:
    """Why :func:`available` is False (``""`` when it is True)."""
    _load()
    return _reason


class NativePageReader:
    """Ordered record stream over page shards, decoded off-thread.

    ``next()`` returns ``(kind, payload)``: kind 1 → HWC uint8 ndarray;
    kind 0 → raw ``bytes`` for the caller to decode; None at the end.
    """

    def __init__(self, bin_paths: List[str], n_decode: int = 0) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native IO library unavailable: {_reason}")
        if n_decode <= 0:
            n_decode = max(2, (os.cpu_count() or 4) - 2)
        joined = "\n".join(bin_paths).encode("utf-8")
        self._lib = lib
        self._h = lib.cxio_open(joined, n_decode)
        if not self._h:
            raise ValueError(f"cxio_open failed for {bin_paths}")

    def reset(self) -> None:
        self._lib.cxio_reset(self._h)

    def next(self) -> Optional[Tuple[int, object]]:
        lib = self._lib
        if not lib.cxio_next(self._h):
            # a clean end of the stream, or a reader failure: a missing or
            # corrupt shard must raise (silent truncation would misalign
            # records with their .lst labels), as the Python reader does
            err = lib.cxio_error(self._h)
            if err:
                raise RuntimeError(err.decode("utf-8", "replace"))
            return None
        kind = lib.cxio_kind(self._h)
        size = lib.cxio_size(self._h)
        buf = np.empty(size, np.uint8)
        got = lib.cxio_copy(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), size
        )
        if got != size:
            raise RuntimeError("cxio_copy size mismatch")
        if kind == 1:
            h = ctypes.c_int()
            w = ctypes.c_int()
            c = ctypes.c_int()
            lib.cxio_shape(self._h, h, w, c)
            return 1, buf.reshape(h.value, w.value, c.value)
        return 0, buf.tobytes()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.cxio_close(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover - finalizer
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
