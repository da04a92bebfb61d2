"""Ceil-shape max pooling over NHWC with the reference's unpool
backward: three CUDA kernels and their plain PyTorch versions.

Counterpart of ``cxxnet_tpu/ops/maxpool.py``.  Semantics: the reference
pooling layer's ceil output shape with partial edge windows; taps
outside the input count as -inf.  ``F.max_pool2d`` with
``ceil_mode=True`` uses another ceil rule (it never drops the last
window the way the ``p > 0`` branch below does), and its backward gives
a window's gradient to one winner, so it is not used.  The backward is
the mshadow ``unpool`` rule: every input equal to a covering window's
max receives that window's gradient, so ties share it.

* ``maxpool_fwd`` (K1, ``csrc/maxpool_fwd.cu``): the forward, a gather
  over 16-byte channel vectors where ``takes_vector_fwd`` holds (every
  GoogLeNet pool), the scalar edge kernel elsewhere;
* ``maxpool_bwd`` (K2, ``csrc/maxpool_bwd.cu``): the backward for any
  geometry, summed in f32 in (dy, dx) window-offset order: a gather over
  16-byte channel vectors where ``takes_vector`` holds (every GoogLeNet
  stride-2 pool), the scalar edge kernel elsewhere;
* ``maxpool_bwd_s1`` (K3, ``csrc/maxpool_bwd_s1.cu``): the backward of a
  same-size stride-1 pool, summed in f32 in the order of the Pallas
  kernel it replaces (over output offsets): a gather over 16-byte
  channel vectors where ``takes_vector_s1`` holds (every GoogLeNet
  inception pool), the scalar edge kernel elsewhere;
* ``maxpool``: the differentiable entry, a ``torch.autograd.Function``
  whose forward is K1 and whose backward is K3 where the pool is
  eligible and K2 otherwise.

Each wrapper takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

KERNEL = _build.Kernel("maxpool_fwd", "cxxnet_tpu/ops/maxpool.py:56 _fwd_kernel")
BWD_KERNEL = _build.Kernel("maxpool_bwd",
                           "cxxnet_tpu/ops/maxpool.py:71 _bwd_kernel")
BWD_S1_KERNEL = _build.Kernel("maxpool_bwd_s1",
                              "cxxnet_tpu/ops/maxpool.py:149 _bwd_s1_kernel")

_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_S1_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def ceil_pool_shape(in_size: int, k: int, s: int, p: int = 0) -> int:
    """The reference pooling output size.  ``p == 0`` is the reference
    formula; with ``p > 0`` the caffe convention ceil((in+2p-k)/s)+1,
    clipped so the last window starts inside the left-padded input."""
    if p == 0:
        return min(in_size - k + s - 1, in_size - 1) // s + 1
    out = (in_size + 2 * p - k + s - 1) // s + 1
    if (out - 1) * s >= in_size + p:
        out -= 1
    return out


def geometry(h: int, w: int, kh: int, kw: int, s: int, py: int, px: int):
    """``((plh, prh), (plw, prw), oh, ow)``: the left/right padding that
    makes VALID windows realize the ceil shape, and the output size."""
    oh, ow = ceil_pool_shape(h, kh, s, py), ceil_pool_shape(w, kw, s, px)
    prh = max(0, (oh - 1) * s + kh - h - py)
    prw = max(0, (ow - 1) * s + kw - w - px)
    return (py, prh), (px, prw), oh, ow


def same_size_s1(kh: int, kw: int, s: int, py: int, px: int) -> bool:
    """Whether the one-pass stride-1 backward (K3) applies: the
    eligibility test of the JAX package's ``pool_impl = pallas_bwd``
    (``cxxnet_tpu/layers/conv.py:688-693``)."""
    return s == 1 and kh == kw and py == px and 2 * py == kh - 1


def shifted_windows(xp: torch.Tensor, kh: int, kw: int, s: int, oh: int,
                    ow: int):
    """The k*k strided slices of a padded NHWC tensor, one per window
    offset, in (dy, dx) order — the tree every pooling reduces over."""
    for dy in range(kh):
        for dx in range(kw):
            yield xp[:, dy:dy + (oh - 1) * s + 1:s,
                     dx:dx + (ow - 1) * s + 1:s, :]


def pad_nhwc(x: torch.Tensor, pads_h, pads_w, value: float) -> torch.Tensor:
    return F.pad(x, (0, 0, pads_w[0], pads_w[1], pads_h[0], pads_h[1]),
                 value=value)


# ----------------------------------------------------------------------
# plain versions


def maxpool_plain(x: torch.Tensor, kh: int, kw: int, s: int, py: int = 0,
                  px: int = 0) -> torch.Tensor:
    """The plain forward: pad with -inf, max over the shifted slices."""
    pads_h, pads_w, oh, ow = geometry(x.shape[1], x.shape[2], kh, kw, s,
                                      py, px)
    xp = pad_nhwc(x, pads_h, pads_w, float("-inf"))
    acc = None
    for sl in shifted_windows(xp, kh, kw, s, oh, ow):
        acc = sl if acc is None else torch.maximum(acc, sl)
    return acc.contiguous()


def maxpool_bwd_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                      kh: int, kw: int, s: int, py: int = 0,
                      px: int = 0) -> torch.Tensor:
    """The plain unpool backward: on the -inf-padded f32 plane, add each
    window offset's equality-gated gradient at its strided positions, in
    (dy, dx) order, then crop and round once to ``x``'s dtype."""
    h, w = x.shape[1], x.shape[2]
    pads_h, pads_w, oh, ow = geometry(h, w, kh, kw, s, py, px)
    xp = pad_nhwc(x.float(), pads_h, pads_w, float("-inf"))
    yf, gf = y.float(), g.float()
    acc = torch.zeros_like(xp)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            sl = (slice(None), slice(dy, dy + (oh - 1) * s + 1, s),
                  slice(dx, dx + (ow - 1) * s + 1, s), slice(None))
            acc[sl] += torch.where(xp[sl] == yf, gf, zero)
    return acc[:, py:py + h, px:px + w, :].to(x.dtype).contiguous()


def maxpool_bwd_s1_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                         k: int, p: int) -> torch.Tensor:
    """The plain same-size stride-1 backward, in the Pallas kernel's
    order: pad y with +inf and g with 0 so every window covering an
    input is a shifted slice, sum the k*k equality-gated reads over
    OUTPUT offsets (dy, dx) in f32, round once to ``x``'s dtype."""
    h, w = x.shape[1], x.shape[2]
    xf = x.float()
    pads = (k - 1 - p, p)
    yp = pad_nhwc(y.float(), pads, pads, float("inf"))
    gp = pad_nhwc(g.float(), pads, pads, 0.0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    acc = torch.zeros_like(xf)
    for dy in range(k):
        for dx in range(k):
            ys = yp[:, dy:dy + h, dx:dx + w, :]
            gs = gp[:, dy:dy + h, dx:dx + w, :]
            acc = acc + torch.where(xf == ys, gs, zero)
    return acc.to(x.dtype).contiguous()


# ----------------------------------------------------------------------
# wrappers


# a block's shared memory, which holds a main path's band of window rows
_SMEM_LIMIT = 232448
# K1's and K3's blocks each stage one channel slice of at most 128 bytes
# a position (``SLICE`` vectors in ``csrc/channel_vec.cuh``)
_SLICE_BYTES = 128


def _vector_operands(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """``x``'s C a multiple of the 16-byte vector (8 bf16 or 4 f32
    channels), ``x`` and ``others`` 16-byte aligned and under 2**31
    elements (32-bit indices): what the three channel-vector kernels
    share."""
    return (x.shape[-1] % (16 // x.element_size()) == 0
            and all(t.data_ptr() % 16 == 0 and t.numel() < 2 ** 31
                    for t in (x, *others)))


def takes_vector_fwd(x: torch.Tensor, kh: int, kw: int, s: int, py: int = 0,
                     px: int = 0) -> bool:
    """The rule for K1's main path (the channel-vector gather): C a
    multiple of the 16-byte vector, ``x`` 16-byte aligned (``y`` is
    allocated aligned), ``x`` and ``y`` under 2**31 elements, and a band
    of window rows that fits in a block's shared memory: the at most
    ``kh`` input rows that one output row's windows cover, one channel
    slice (128 bytes a position) wide.  Anything else takes the scalar
    edge kernel."""
    n, h, w, c = x.shape
    _, _, oh, ow = geometry(h, w, kh, kw, s, py, px)
    band = min(h, kh) * w * min(c * x.element_size(), _SLICE_BYTES)
    return (_vector_operands(x) and n * oh * ow * c < 2 ** 31
            and band <= _SMEM_LIMIT)


def maxpool_fwd(x: torch.Tensor, kh: int, kw: int, s: int, py: int = 0,
                px: int = 0) -> torch.Tensor:
    """Max pool an NHWC tensor with the ceil geometry: the CUDA kernel
    for a CUDA tensor (the vector gather where ``takes_vector_fwd``
    holds, else the edge kernel), the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return maxpool_plain(x, kh, kw, s, py, px)
    _build.check_cuda("maxpool_fwd", x, 4)
    symbol = f"maxpool_fwd_{_build.dtype_suffix(x)}"
    if not takes_vector_fwd(x, kh, kw, s, py, px):
        symbol += "_edge"  # the scalar kernel's C entry
    return launch_fwd(symbol, x, kh, kw, s, py, px)


def launch_fwd(symbol: str, x: torch.Tensor, kh: int, kw: int, s: int,
               py: int, px: int) -> torch.Tensor:
    """Launch one C entry of K1's source on a checked CUDA ``x`` (the
    smoke test times the edge kernel at the main path's shapes with it);
    returns ``y``."""
    n, h, w, c = x.shape
    _, _, oh, ow = geometry(h, w, kh, kw, s, py, px)
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    KERNEL.launch(symbol, _ARGS, x.data_ptr(), y.data_ptr(), n, h, w, c, oh,
                  ow, kh, kw, s, py, px, _build.stream_of(x))
    return y


def _check_bwd(name: str, x, y, g, oh: int, ow: int) -> None:
    n, _, _, c = x.shape
    for label, t in (("x", x), ("y", y), ("g", g)):
        _build.check_cuda(f"{name} {label}", t, 4, x.dtype)
    if tuple(y.shape) != (n, oh, ow, c) or tuple(g.shape) != tuple(y.shape):
        raise ValueError(f"{name}: y {tuple(y.shape)} and g "
                         f"{tuple(g.shape)} must be {(n, oh, ow, c)}")


def takes_vector(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, kh: int,
                 s: int) -> bool:
    """The rule for K2's main path (the channel-vector gather): C a
    multiple of the 16-byte vector (8 bf16 or 4 f32 channels), ``x``,
    ``y`` and ``g`` 16-byte aligned (``dx`` is allocated aligned), fewer
    than 2**31 elements in ``x`` and in ``y`` (32-bit indices), and a
    band of window rows that fits in a block's shared memory: the y and
    g rows of the at most ``(kh - 1) // s + 1`` windows that cover one
    input row.  Anything else takes the scalar edge kernel."""
    oh, ow, c = y.shape[1], y.shape[2], y.shape[3]
    band = 2 * min(oh, (kh - 1) // s + 1) * ow * c * x.element_size()
    return _vector_operands(x, y, g) and band <= _SMEM_LIMIT


def maxpool_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, kh: int,
                kw: int, s: int, py: int = 0, px: int = 0) -> torch.Tensor:
    """The unpool backward for any pool geometry: ``x`` the pool's input,
    ``y`` its output, ``g`` the output's gradient, all NHWC of one
    dtype; returns ``dx``.  The CUDA kernel for CUDA tensors (the
    vector gather where ``takes_vector`` holds, else the edge kernel),
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return maxpool_bwd_plain(x, y, g, kh, kw, s, py, px)
    n, h, w, c = x.shape
    _, _, oh, ow = geometry(h, w, kh, kw, s, py, px)
    _check_bwd("maxpool_bwd", x, y, g, oh, ow)
    symbol = f"maxpool_bwd_{_build.dtype_suffix(x)}"
    if not takes_vector(x, y, g, kh, s):
        symbol += "_edge"  # the scalar kernel's C entry
    return launch_bwd(symbol, x, y, g, kh, kw, s, py, px)


def launch_bwd(symbol: str, x: torch.Tensor, y: torch.Tensor,
               g: torch.Tensor, kh: int, kw: int, s: int, py: int,
               px: int) -> torch.Tensor:
    """Launch one C entry of K2's source on checked CUDA operands (the
    smoke test times the edge kernel at the main path's shapes with it);
    returns ``dx``."""
    n, h, w, c = x.shape
    _, _, oh, ow = geometry(h, w, kh, kw, s, py, px)
    dx = torch.empty_like(x)
    BWD_KERNEL.launch(symbol, _BWD_ARGS, x.data_ptr(), y.data_ptr(),
                      g.data_ptr(), dx.data_ptr(), n, h, w, c, oh, ow, kh,
                      kw, s, py, px, _build.stream_of(x))
    return dx


def maxpool_bwd_s1(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, k: int,
                   p: int) -> torch.Tensor:
    """The one-pass backward of a same-size stride-1 ``k x k`` pool with
    pad ``p = (k - 1) / 2``: the CUDA kernel for CUDA tensors (the vector
    gather where ``takes_vector_s1`` holds, else the edge kernel), the
    plain version for CPU tensors."""
    if not same_size_s1(k, k, 1, p, p):
        raise ValueError(f"maxpool_bwd_s1: k={k} p={p} is not a same-size "
                         "stride-1 pool (needs 2p == k - 1)")
    if x.device.type == "cpu":
        return maxpool_bwd_s1_plain(x, y, g, k, p)
    _check_bwd("maxpool_bwd_s1", x, y, g, x.shape[1], x.shape[2])
    symbol = f"maxpool_bwd_s1_{_build.dtype_suffix(x)}"
    if not takes_vector_s1(x, y, g, k):
        symbol += "_edge"  # the scalar kernel's C entry
    return launch_bwd_s1(symbol, x, y, g, k, p)


def takes_vector_s1(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                    k: int) -> bool:
    """The rule for K3's main path (the channel-vector gather): C a
    multiple of the 16-byte vector, ``x``, ``y`` and ``g`` 16-byte
    aligned and under 2**31 elements, and a band that fits in a block's
    shared memory: the y and g rows of the at most ``k`` window rows
    that cover one input row, one channel slice (128 bytes a position)
    wide.  Anything else takes the scalar edge kernel."""
    h, w, c = x.shape[1], x.shape[2], x.shape[3]
    band = 2 * min(h, k) * w * min(c * x.element_size(), _SLICE_BYTES)
    return _vector_operands(x, y, g) and band <= _SMEM_LIMIT


def launch_bwd_s1(symbol: str, x: torch.Tensor, y: torch.Tensor,
                  g: torch.Tensor, k: int, p: int) -> torch.Tensor:
    """Launch one C entry of K3's source on checked CUDA operands (the
    smoke test times the edge kernel at the main path's shapes with it);
    returns ``dx``."""
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    BWD_S1_KERNEL.launch(symbol, _BWD_S1_ARGS, x.data_ptr(), y.data_ptr(),
                         g.data_ptr(), dx.data_ptr(), n, h, w, c, k, p,
                         _build.stream_of(x))
    return dx


class _MaxPool(torch.autograd.Function):
    """K1 forward saving ``(x, y)``; K3 or K2 backward."""

    @staticmethod
    def forward(ctx, x, kh, kw, s, py, px):
        y = maxpool_fwd(x, kh, kw, s, py, px)
        ctx.save_for_backward(x, y)
        ctx.geom = (kh, kw, s, py, px)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        kh, kw, s, py, px = ctx.geom
        g = g.contiguous()
        if same_size_s1(kh, kw, s, py, px):
            dx = maxpool_bwd_s1(x, y, g, kh, py)
        else:
            dx = maxpool_bwd(x, y, g, kh, kw, s, py, px)
        return dx, None, None, None, None, None


def maxpool(x: torch.Tensor, kh: int, kw: int, s: int, py: int = 0,
            px: int = 0) -> torch.Tensor:
    """Max pool with the unpool backward when ``x`` takes part in
    autograd; the forward alone (the same K1 launch) otherwise."""
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool.apply(x, kh, kw, s, py, px)
    return maxpool_fwd(x, kh, kw, s, py, px)
