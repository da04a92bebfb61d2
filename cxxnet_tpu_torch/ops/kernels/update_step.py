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

``sgd_update`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches ``csrc/sgd_update.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

KERNEL = _build.Kernel(
    "sgd_update", "cxxnet_tpu/ops/kernels/update_step.py:38 _sgd_kernel",
    dtypes=("f32",))

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_float] * 4 + [
    ctypes.c_void_p]


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
