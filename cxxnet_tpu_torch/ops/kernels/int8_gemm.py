"""int8 GEMM with the per-channel rescale in its epilogue: the CUDA
kernel and its plain PyTorch version.

Counterpart of ``cxxnet_tpu/ops/kernels/int8_gemm.py``.  The quantized
``fullc`` and 1x1 conv (``ops/quant.py``) contract the activations with
the RAW int8 codes, f32 accumulation, and fold the per-output-channel
rescale and the f32 bias into one epilogue:

    y = relu?((x2d @ q.T) * scale + bias), rounded once to x2d's dtype

``x2d`` is ``(M, K)`` float32 or bfloat16, ``q`` ``(O, K)`` int8 (the
fullc layout; the weights stay one byte an element on the card),
``scale`` ``(O,)`` float32, ``bias`` ``(O,)`` float32 or None.

``int8_gemm_rescale`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches ``csrc/int8_gemm.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

KERNEL = _build.Kernel(
    "int8_gemm", "cxxnet_tpu/ops/kernels/int8_gemm.py:32 _int8_kernel")

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def probe(x=None, q=None) -> Optional[str]:
    """None when the kernel takes these operands, else the reason."""
    if x is not None and x.dtype not in (torch.float32, torch.bfloat16):
        return f"unsupported activation dtype {x.dtype}"
    if q is not None and q.dtype != torch.int8:
        return f"codes must be int8, got {q.dtype}"
    return None


def int8_gemm_plain(x2d: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """The plain version: f32 product over the codes, times the scale,
    plus the bias, relu if asked, one rounding to ``x2d``'s dtype."""
    y = (x2d.float() @ q.float().t()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x2d.dtype)


def int8_gemm_rescale(x2d: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """``relu?((x2d @ q.T) * scale + bias)`` in ``x2d``'s dtype: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x2d.dim() != 2 or q.dim() != 2 or x2d.shape[1] != q.shape[1]:
        raise ValueError(f"int8_gemm_rescale: x {tuple(x2d.shape)} and q "
                         f"{tuple(q.shape)} are not (M, K) and (O, K)")
    reason = probe(x2d, q)
    if reason is not None:
        raise TypeError(f"int8_gemm_rescale: {reason}")
    if x2d.device.type == "cpu":
        return int8_gemm_plain(x2d, q, scale, bias, relu)
    m, k = x2d.shape
    o = q.shape[0]
    _build.check_cuda("int8_gemm x", x2d, 2)
    _build.check_cuda("int8_gemm q", q, 2, torch.int8)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        _build.check_cuda(f"int8_gemm {name}", t, 1, torch.float32)
        if t.shape[0] != o:
            raise ValueError(f"int8_gemm_rescale: {name} has {t.shape[0]} "
                             f"entries for {o} outputs")
    y = torch.empty((m, o), dtype=x2d.dtype, device=x2d.device)
    KERNEL.launch(f"int8_gemm_{_build.dtype_suffix(x2d)}", _ARGS,
                  x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  y.data_ptr(), m, k, o, int(relu), _build.stream_of(x2d))
    return y
