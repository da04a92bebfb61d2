"""Flat-function shim behind the port's C ABI (``csrc/host/cxxnet_capi.cc``).

Counterpart of ``cxxnet_tpu/capi_shim.py``.  The C library embeds
CPython and calls these module-level functions — one per ``shim_call``
site, names matching ``csrc/host/cxxnet_capi.h`` (the JAX package's
``CXN*`` header, unchanged) — so the C side stays pure marshalling.

Array-returning calls hand back C-contiguous float32 numpy arrays; the
C side holds a reference alongside the handle so the data pointer stays
alive until the next call on the same handle (the reference wrapper's
temp-buffer lifetime rule).

Data layout note: the reference is NCHW; the port is NHWC.  4-D shapes
returned here are ``(n, h, w, c)``; flat data comes back
``(n, 1, 1, d)``.  A net created with a device other than ``cpu`` runs
on the card and raises without one (``wrapper.Net``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .wrapper import DataIter, Net


def _c_f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _from_c4(d: np.ndarray) -> np.ndarray:
    """C-side data is always (n, h, w, c); collapse the (n, 1, 1, d)
    encoding of flat nodes back to (n, d) for the net input."""
    d = np.asarray(d)
    if d.ndim == 4 and d.shape[1] == 1 and d.shape[2] == 1:
        return d.reshape(d.shape[0], d.shape[3])
    return d


# ------------------------------------------------------------------ io
def io_create(cfg: str) -> DataIter:
    return DataIter(cfg)


def io_next(it: DataIter) -> int:
    return int(it.next())


def io_before_first(it: DataIter) -> None:
    it.before_first()


def io_get_data(it: DataIter) -> np.ndarray:
    d = np.asarray(it.get_data())
    if d.ndim == 2:
        d = d[:, None, None, :]
    elif d.ndim != 4:
        raise ValueError(f"io_get_data: unexpected data ndim {d.ndim}")
    return _c_f32(d)


def io_get_label(it: DataIter) -> np.ndarray:
    l = np.asarray(it.get_label())
    if l.ndim == 1:
        l = l[:, None]
    return _c_f32(l)


# ----------------------------------------------------------------- net
def net_create(device: Optional[str], cfg: str) -> Net:
    return Net(dev=device or "", cfg=cfg)


def net_set_param(net: Net, name: str, val: str) -> None:
    net.set_param(name, val)


def net_init_model(net: Net) -> None:
    net.init_model()


def net_save_model(net: Net, fname: str) -> None:
    net.save_model(fname)


def net_load_model(net: Net, fname: str) -> None:
    net.load_model(fname)


def net_start_round(net: Net, round_counter: int) -> None:
    net.start_round(round_counter)


def net_update_batch(net: Net, data: np.ndarray, label: np.ndarray) -> None:
    net.update(_from_c4(data), np.asarray(label))


def net_update_iter(net: Net, it: DataIter) -> None:
    net.update(it)


def net_predict_batch(net: Net, data: np.ndarray) -> np.ndarray:
    return _c_f32(net.predict(_from_c4(data)))


def net_predict_iter(net: Net, it: DataIter) -> np.ndarray:
    # DataIter path so num_batch_padd filler rows are trimmed
    return _c_f32(net.predict(it))


def net_extract_batch(net: Net, data: np.ndarray, name: str) -> np.ndarray:
    out = np.asarray(net.extract(_from_c4(data), name))
    return _c_f32(out.reshape(out.shape[0], -1))


def net_extract_iter(net: Net, it: DataIter, name: str) -> np.ndarray:
    out = np.asarray(net.extract(it, name))  # trims num_batch_padd rows
    return _c_f32(out.reshape(out.shape[0], -1))


def net_evaluate(net: Net, it: DataIter, name: str) -> str:
    return net.evaluate(it, name)


def net_set_weight(net: Net, weight: np.ndarray, layer: str, tag: str) -> None:
    net.set_weight(weight, layer, tag)


def net_get_weight(net: Net, layer: str, tag: str):
    """None (-> NULL at the C ABI, reference cxxnet_wrapper behavior)
    when the layer has no such weight."""
    w = net.get_weight(layer, tag)
    if w is None or w.size == 0:
        return None
    return _c_f32(w)
