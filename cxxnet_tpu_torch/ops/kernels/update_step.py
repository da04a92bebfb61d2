"""The fused SGD step: the CUDA kernel and its plain PyTorch version.

Counterpart of ``cxxnet_tpu/ops/kernels/update_step.py``.  The sgd rule
of ``updater.SGDUpdater``

    g  <- clip(g with NaNs zeroed, -clip, clip)     only when clip != 0
    m' =  mom * m - lr * (g + wd * w);   w' = w + m'

runs as one read-modify-write over ``(w, g, m)``, IN PLACE on ``w`` and
``m`` (the JAX package returns new arrays; the port updates the f32
masters where they lie, and the trainer then drops the operands it
prepared from the old weights).  ``torch.optim.SGD`` puts the weight
decay and the learning rate in other places, so it is not used.

``sgd_update_multi`` updates every tensor of a step in one launch of
``csrc/sgd_update.cu`` (one launch per ``MAX_TENSORS`` tensors, each
counted); ``sgd_update`` is the one-tensor counterpart of the JAX
package's function, a launch of the same kernel over a one-entry table.
Both take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from .. import _build

KERNEL = _build.Kernel(
    "sgd_update", "cxxnet_tpu/ops/kernels/update_step.py:38 _sgd_kernel",
    dtypes=("f32", "multi_f32"))

MAX_TENSORS = 480  # the tensor table's capacity (csrc/sgd_update.cu)

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_float] * 4 + [
    ctypes.c_void_p]
_MULTI_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4


def nan_clip(g: torch.Tensor, bound: float) -> torch.Tensor:
    """NaNs to 0, then clamp to ``[-bound, bound]``."""
    g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
    return torch.clamp(g, -bound, bound)


def sgd_update_plain(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     lr: float, mom: float, wd: float = 0.0,
                     clip: float = 0.0) -> None:
    """The plain version, in place, in the reference's op order (every
    operation rounds to f32; ``lr``/``mom``/``wd``/``clip`` are used as
    f32 values)."""
    with torch.no_grad():
        if clip != 0.0:
            g = nan_clip(g, clip)
        step = lr * (g + wd * w)
        m_new = mom * m - step
        m.copy_(m_new)
        w.add_(m_new)


def sgd_update(w: torch.Tensor, g: torch.Tensor, m: torch.Tensor, lr: float,
               mom: float, wd: float = 0.0, clip: float = 0.0) -> None:
    """One SGD step over one f32 tensor, in place on ``w`` and ``m``:
    the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if w.shape != g.shape or w.shape != m.shape:
        raise ValueError(f"sgd_update: shapes w {tuple(w.shape)}, g "
                         f"{tuple(g.shape)}, m {tuple(m.shape)} differ")
    if w.device.type == "cpu":
        sgd_update_plain(w, g, m, lr, mom, wd, clip)
        return
    for label, t in (("w", w), ("g", g), ("m", m)):
        _build.check_cuda(f"sgd_update {label}", t, w.dim(), torch.float32)
    KERNEL.launch("sgd_update_f32", _ARGS, w.data_ptr(), g.data_ptr(),
                  m.data_ptr(), w.numel(), lr, mom, wd, clip,
                  _build.stream_of(w))


def sgd_update_multi(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                     ms: Sequence[torch.Tensor], lrs: Sequence[float],
                     moms: Sequence[float], wds: Sequence[float],
                     clips: Sequence[float]) -> None:
    """One SGD step over many f32 tensors, each with its own ``lr``,
    ``mom``, ``wd`` and ``clip``, in place on every ``w`` and ``m``: one
    kernel launch per ``MAX_TENSORS`` tensors for CUDA tensors, the plain
    version tensor by tensor for CPU tensors.  The host work is kept to
    one pass of checks and three numpy tables a launch: the training
    step, which calls this once, is bound by the host."""
    if any(len(a) != len(ws) for a in (gs, ms, lrs, moms, wds, clips)):
        raise ValueError("sgd_update_multi: the argument lists differ in "
                         "length")
    for w, g, m in zip(ws, gs, ms):
        if not w.shape == g.shape == m.shape:
            raise ValueError(f"sgd_update_multi: shapes w {tuple(w.shape)}, "
                             f"g {tuple(g.shape)}, m {tuple(m.shape)} differ")
    if not ws:
        return
    if ws[0].device.type == "cpu":
        for args in zip(ws, gs, ms, lrs, moms, wds, clips):
            sgd_update_plain(*args)
        return
    f32, card = torch.float32, ws[0].get_device()
    tensors = (*ws, *gs, *ms)
    if not all(t.dtype == f32 and t.is_contiguous() and t.get_device() == card
               for t in tensors):
        for t in tensors:
            _build.check_cuda("sgd_update_multi", t, t.dim(), f32)
            if t.get_device() != card:
                raise ValueError(f"sgd_update_multi: tensors on {t.device} "
                                 f"and {ws[0].device}")
    hyper = np.array([lrs, moms, wds, clips], np.float32)
    stream = _build.stream_of(ws[0])
    for i in range(0, len(ws), MAX_TENSORS):
        part = slice(i, i + MAX_TENSORS)
        ptrs = np.array([[t.data_ptr() for t in ts[part]]
                         for ts in (ws, gs, ms)], np.uint64)
        sizes = np.array([w.numel() for w in ws[part]], np.int64)
        if not sizes.any():
            continue  # nothing to launch for
        table = np.ascontiguousarray(hyper[:, part])
        KERNEL.launch("sgd_update_multi_f32", _MULTI_ARGS, sizes.size,
                      ptrs.ctypes.data, sizes.ctypes.data,
                      table.ctypes.data, stream)
