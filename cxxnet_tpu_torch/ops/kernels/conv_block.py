"""Fused sibling-1x1 conv block: the CUDA GEMM kernel and its plain
PyTorch version.

Counterpart of ``cxxnet_tpu/ops/kernels/conv_block.py``.  A 1x1 conv
is a GEMM: output pixel ``(n, y, x)`` is ``x_row @ W``.  The group of
sibling 1x1 convs that read one node (``nnet/net.py``) runs as ONE
``(M, K) x (K, O)`` product with every member's bias in the epilogue;
a strided 1x1 conv subsamples the input first (exact for a 1x1/pad-0
conv: output pixel ``(i, j)`` reads only ``x[i*s, j*s]``).

``conv_block_gemm`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches ``csrc/conv_block_gemm.cu`` or raises.
In bfloat16 the source has two kernels, chosen by ``takes_wgmma``'s
rule and never by a failure: the main path on ``wgmma`` and TMA for K
and O multiples of 8 and X and W 16-byte aligned (what a TMA tensor map
takes; every GoogLeNet group), and the ``mma.sync`` edge path for any
other shape or alignment.  ``KERNEL.by_symbol`` counts each.  The main
path reads W's rows at a multiple of 32 bytes: for O % 16 == 8 the
wrapper hands it a copy of W with its rows padded by 8 zero columns.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build

KERNEL = _build.Kernel(
    "conv_block_gemm",
    "cxxnet_tpu/ops/kernels/conv_block.py:41 _gemm_bias_kernel")

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
WGMMA = "conv_block_gemm_bf16"  # the bf16 main path's C entry
EDGE = "conv_block_gemm_bf16_mma"  # the bf16 edge path's


def takes_wgmma(x2d: torch.Tensor, w2d: torch.Tensor) -> bool:
    """The rule for the bf16 main path: K and O multiples of 8 (16-byte
    rows) and X and W 16-byte aligned; ``Y`` is allocated aligned."""
    return (x2d.dtype == torch.bfloat16 and x2d.shape[1] % 8 == 0
            and w2d.shape[1] % 8 == 0 and x2d.data_ptr() % 16 == 0
            and w2d.data_ptr() % 16 == 0)


def conv_block_plain(x2d: torch.Tensor, w2d: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     relu: bool = False) -> torch.Tensor:
    """The plain version: f32 product, f32 bias add, optional relu, one
    rounding to the input dtype."""
    y = x2d.float() @ w2d.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x2d.dtype)


def conv_block_gemm(x2d: torch.Tensor, w2d: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """``relu?(x2d @ w2d + bias)`` with ``x2d`` (M, K), ``w2d`` (K, O),
    ``bias`` (O,) or None, all of one dtype; returns (M, O) in that
    dtype.  The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x2d.shape[1] != w2d.shape[0]:
        raise ValueError(f"conv_block_gemm: K mismatch {x2d.shape[1]} vs "
                         f"{w2d.shape[0]}")
    if x2d.device.type == "cpu":
        return conv_block_plain(x2d, w2d, bias, relu)
    _build.check_cuda("conv_block_gemm x", x2d, 2)
    _build.check_cuda("conv_block_gemm w", w2d, 2, x2d.dtype)
    o = w2d.shape[1]
    if bias is not None:
        _build.check_cuda("conv_block_gemm bias", bias, 1, x2d.dtype)
        if bias.shape[0] != o:
            raise ValueError(f"conv_block_gemm: bias has {bias.shape[0]} "
                             f"entries for {o} outputs")
    if x2d.dtype != torch.bfloat16:
        symbol = f"conv_block_gemm_{_build.dtype_suffix(x2d)}"
    elif not takes_wgmma(x2d, w2d):
        symbol = EDGE
    else:
        symbol = WGMMA
        if o % 16:  # rows of 32 bytes, which TMA reads at its full rate
            w2d = F.pad(w2d, (0, 16 - o % 16))
    return launch(symbol, x2d, w2d, bias, relu, o)


def launch(symbol: str, x2d: torch.Tensor, w2d: torch.Tensor,
           bias: Optional[torch.Tensor], relu: bool,
           o: Optional[int] = None) -> torch.Tensor:
    """Launch one C entry of the source on checked CUDA operands, ``o``
    outputs (``w2d``'s columns unless its rows are padded; the smoke test
    times the edge path at the main path's shapes with it)."""
    m, k = x2d.shape
    o = w2d.shape[1] if o is None else o
    y = torch.empty((m, o), dtype=x2d.dtype, device=x2d.device)
    KERNEL.launch(symbol, _ARGS, x2d.data_ptr(), w2d.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  y.data_ptr(), m, k, o, int(relu), _build.stream_of(x2d))
    return y


class _ConvBlockGemm(torch.autograd.Function):
    """K6 forward; plain GEMMs backward (the JAX package has no backward
    kernel for the group: its train forward runs the stock conv and XLA
    differentiates it): ``dX = dY W^T``, ``dW = X^T dY``,
    ``db = sum_rows dY``, in the operands' dtype."""

    @staticmethod
    def forward(ctx, x2d, w2d, bias, relu):
        y = conv_block_gemm(x2d, w2d, bias, relu)
        ctx.save_for_backward(x2d, w2d, y if relu else None)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, gy):
        x2d, w2d, y = ctx.saved_tensors
        if ctx.relu:
            gy = torch.where(y > 0, gy, torch.zeros_like(gy))
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        gx = gy @ w2d.t() if need_x else None
        gw = x2d.t() @ gy if need_w else None
        gb = gy.sum(0) if need_b else None
        return gx, gw, gb, None


def conv1x1_block(x: torch.Tensor, w2d: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  relu: bool = False) -> torch.Tensor:
    """The group's 1x1 conv as the fused GEMM: ``x`` NHWC, ``w2d`` the
    concatenated ``(C, O)`` kernel, ``bias`` the concatenated ``(O,)``
    member biases.  Returns NHWC with ``O`` channels.  Differentiable in
    ``x``, ``w2d`` and ``bias`` when any of them takes part in autograd
    (the gradient of a strided input lands on ``x[:, ::s, ::s]``)."""
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    n, h, w, c = x.shape
    x2d = x.contiguous().reshape(-1, c)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2d, w2d, bias)):
        y = _ConvBlockGemm.apply(x2d, w2d, bias, relu)
    else:
        y = conv_block_gemm(x2d, w2d, bias, relu)
    return y.reshape(n, h, w, -1)
