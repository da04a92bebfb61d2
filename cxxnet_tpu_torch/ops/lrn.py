"""Cross-channel local response normalization, forward and backward:
the CUDA kernels and their plain PyTorch versions.

Counterpart of ``cxxnet_tpu/ops/lrn.py``.  Semantics:
``y = x * (knorm + alpha/n * sum_win(x^2))^-beta`` over the window of
``n`` channels ``[c - n//2, c - n//2 + n)`` (asymmetric for even ``n``),
with zeros past the channel edges, in f32 math whatever the input dtype.
``F.local_response_norm`` centres its window differently and pads the
average, so it is not used.  The backward recomputes the norm instead
of saving it (LRN sits on large activations) and sums
``t = g * x * norm^(-beta-1)`` over the REVERSED window:

    dx = g * norm^-beta - 2 (alpha/n) beta * x * sum_{d=-hi..-lo} t[c+d]

* ``lrn_fwd`` (K4, ``csrc/lrn_fwd.cu``) and ``lrn_bwd`` (K5,
  ``csrc/lrn_bwd.cu``) take the plain version only for a tensor on the
  CPU; for a CUDA tensor they launch their kernel or raise: the one-pass
  kernel over 16-byte channel vectors where ``takes_vector`` holds
  (both GoogLeNet LRNs), the scalar edge kernel elsewhere;
* ``lrn``: the differentiable entry, a ``torch.autograd.Function`` with
  K4 forward (saving ``x`` only) and K5 backward.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

KERNEL = _build.Kernel("lrn_fwd", "cxxnet_tpu/ops/lrn.py:62 _fwd_kernel")
BWD_KERNEL = _build.Kernel("lrn_bwd", "cxxnet_tpu/ops/lrn.py:70 _bwd_kernel")

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
         ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int] + [ctypes.c_float] * 4 + [
    ctypes.c_void_p]


def window_offsets(nsize: int) -> Tuple[int, int]:
    """Window ``[c-half, c-half+nsize)`` as offsets ``-half .. nsize-1-half``."""
    half = nsize // 2
    return -half, nsize - 1 - half


def _shifted_sum(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``sum_{d=lo..hi} v[..., c+d]`` with zeros past the edges, added in
    offset order."""
    c = v.shape[-1]
    vp = F.pad(v, (max(0, -lo), max(0, hi)))
    off = max(0, -lo)
    acc = None
    for d in range(lo, hi + 1):
        sh = vp[..., off + d:off + d + c]
        acc = sh if acc is None else acc + sh
    return acc


def _norm(xf: torch.Tensor, nsize: int, alpha: float,
          knorm: float) -> torch.Tensor:
    lo, hi = window_offsets(nsize)
    return knorm + (alpha / nsize) * _shifted_sum(xf * xf, lo, hi)


def lrn_plain(x: torch.Tensor, nsize: int, alpha: float, beta: float,
              knorm: float) -> torch.Tensor:
    """The plain forward: f32 squares summed over the zero-padded
    channel window in offset order, then the power and the product."""
    xf = x.float()
    norm = _norm(xf, nsize, alpha, knorm)
    return (xf * norm.pow(-beta)).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, g: torch.Tensor, nsize: int, alpha: float,
                  beta: float, knorm: float) -> torch.Tensor:
    """The plain backward, f32 math in the CUDA kernel's order: the norm
    recomputed, ``t`` summed over the reversed window."""
    xf, gf = x.float(), g.float()
    lo, hi = window_offsets(nsize)
    norm = _norm(xf, nsize, alpha, knorm)
    t = gf * xf * norm.pow(-beta - 1.0)
    back = _shifted_sum(t, -hi, -lo)
    coef = 2.0 * (alpha / nsize) * beta
    return (gf * norm.pow(-beta) - (coef * xf) * back).to(x.dtype)


def _rows(x: torch.Tensor) -> Tuple[int, int]:
    c = x.shape[-1]
    return (x.numel() // c if c else 0), c


# the main path's largest window (its C source is instantiated for each
# nsize up to this: a halo of at most 4 channels a side, which one
# neighbouring 16-byte vector holds in both dtypes)
VECTOR_NSIZE = 9
# the main path's block holds whole positions of at most this many
# 16-byte vectors (``BLOCK_VECTORS`` in ``csrc/lrn_vec.cuh``)
_BLOCK_VECTORS = 256


def takes_vector(x: torch.Tensor, *others: torch.Tensor, nsize: int) -> bool:
    """The rule for K4's and K5's main path (the one-pass kernels over
    16-byte channel vectors): C a multiple of the vector (4 f32 or 8
    bf16 channels) and at most 256 vectors, ``x`` and ``others`` (K5's
    ``g``; outputs are allocated aligned) 16-byte aligned and under
    2**31 elements, and ``1 <= nsize <= VECTOR_NSIZE``.  Anything else
    takes the scalar edge kernel."""
    lanes = 16 // x.element_size()
    c = x.shape[-1]
    return (c % lanes == 0 and c // lanes <= _BLOCK_VECTORS
            and 1 <= nsize <= VECTOR_NSIZE
            and all(t.data_ptr() % 16 == 0 and t.numel() < 2 ** 31
                    for t in (x, *others)))


def lrn_fwd(x: torch.Tensor, nsize: int, alpha: float, beta: float,
            knorm: float) -> torch.Tensor:
    """LRN over the last (channel) axis of an NHWC or (N, C) tensor: the
    CUDA kernel for a CUDA tensor (the vector kernel where
    ``takes_vector`` holds, else the edge kernel), the plain version for
    a CPU tensor."""
    if x.device.type == "cpu":
        return lrn_plain(x, nsize, alpha, beta, knorm)
    _build.check_cuda("lrn_fwd", x, x.dim())
    if nsize < 1:
        raise ValueError(f"lrn_fwd: local_size must be >= 1, got {nsize}")
    symbol = f"lrn_fwd_{_build.dtype_suffix(x)}"
    if not takes_vector(x, nsize=nsize):
        symbol += "_edge"  # the scalar kernel's C entry
    return launch_fwd(symbol, x, nsize, alpha, beta, knorm)


def launch_fwd(symbol: str, x: torch.Tensor, nsize: int, alpha: float,
               beta: float, knorm: float) -> torch.Tensor:
    """Launch one C entry of K4's source on a checked CUDA ``x`` (the
    smoke test times the edge kernel at the main path's shapes with it);
    returns ``y``."""
    m, c = _rows(x)
    y = torch.empty_like(x)
    KERNEL.launch(symbol, _ARGS, x.data_ptr(), y.data_ptr(), m, c, nsize,
                  alpha / nsize, beta, knorm, _build.stream_of(x))
    return y


def lrn_bwd(x: torch.Tensor, g: torch.Tensor, nsize: int, alpha: float,
            beta: float, knorm: float) -> torch.Tensor:
    """The input gradient of :func:`lrn_fwd` for the output gradient
    ``g`` (same shape and dtype as ``x``): the CUDA kernel for CUDA
    tensors (the vector kernel where ``takes_vector`` holds, else the
    edge kernel), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, g, nsize, alpha, beta, knorm)
    _build.check_cuda("lrn_bwd x", x, x.dim())
    _build.check_cuda("lrn_bwd g", g, x.dim(), x.dtype)
    if g.shape != x.shape:
        raise ValueError(f"lrn_bwd: g {tuple(g.shape)} vs x {tuple(x.shape)}")
    if nsize < 1:
        raise ValueError(f"lrn_bwd: local_size must be >= 1, got {nsize}")
    symbol = f"lrn_bwd_{_build.dtype_suffix(x)}"
    if not takes_vector(x, g, nsize=nsize):
        symbol += "_edge"  # the scalar kernel's C entry
    return launch_bwd(symbol, x, g, nsize, alpha, beta, knorm)


def launch_bwd(symbol: str, x: torch.Tensor, g: torch.Tensor, nsize: int,
               alpha: float, beta: float, knorm: float) -> torch.Tensor:
    """Launch one C entry of K5's source on checked CUDA operands (the
    smoke test times the edge kernel at the main path's shapes with it);
    returns ``dx``."""
    m, c = _rows(x)
    dx = torch.empty_like(x)
    BWD_KERNEL.launch(symbol, _BWD_ARGS, x.data_ptr(), g.data_ptr(),
                      dx.data_ptr(), m, c, nsize, alpha / nsize, beta, knorm,
                      2.0 * (alpha / nsize) * beta, _build.stream_of(x))
    return dx


class _LRN(torch.autograd.Function):
    """K4 forward saving ``x`` only; K5 backward."""

    @staticmethod
    def forward(ctx, x, nsize, alpha, beta, knorm):
        ctx.save_for_backward(x)
        ctx.args = (nsize, alpha, beta, knorm)
        return lrn_fwd(x, nsize, alpha, beta, knorm)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_bwd(x, g.contiguous(), *ctx.args),
                None, None, None, None)


def lrn(x: torch.Tensor, nsize: int, alpha: float, beta: float,
        knorm: float) -> torch.Tensor:
    """LRN with the K5 backward when ``x`` takes part in autograd; the
    forward alone (the same K4 launch) otherwise."""
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _LRN.apply(x, nsize, alpha, beta, knorm)
    return lrn_fwd(x, nsize, alpha, beta, knorm)
