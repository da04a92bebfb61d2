"""Spatial layers: conv, the pooling family, LRN, batch norm.

Counterpart of ``cxxnet_tpu/layers/conv.py``.  Activations are NHWC and
conv weights HWIO at every public function and in the params dict, as
in the JAX package.  Inside, the conv goes to cuDNN (oneDNN on the
CPU): ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is already
``channels_last`` memory, ``F.conv2d`` on it with a ``channels_last``
OIHW weight (built once per load by ``prepare``) returns a
``channels_last`` result, and ``.permute(0, 2, 3, 1)`` of that is NHWC
again — no transposes at run time.

Max pooling and LRN go through the port's hand-written kernels
(``ops/maxpool.py``, ``ops/lrn.py``) as ``torch.autograd.Function``s:
the forward kernel, and in training the backward kernels (the unpool
backward of max pooling: the one-pass stride-1 kernel for a same-size
pool, the general one otherwise; the LRN backward).  The sum/avg pools
are the plain shifted-slice sums of the JAX package (no Pallas kernel
there), differentiated by autograd.  ``prepare`` is differentiable, so
training runs it per step from the f32 masters.

Two opt-in rewrites of the conv, exact in real arithmetic, keep the
HWIO weights as they are (checkpoints and updaters do not see them):

* ``conv_s2d = 1`` (a strided, ungrouped conv): space-to-depth of the
  input and the same regroup of the kernel taps, then a stride-1
  ``F.conv2d`` (``conv_s2d``);
* ``conv_wino = 1|2`` (a 3x3 stride-1 ungrouped conv over at least 8
  input channels): Winograd F(4x4, 3x3) or F(2x2, 3x3)
  (``conv_winograd3``).  The input and filter transforms are f32
  einsums rounded to the compute dtype, the (m+2)^2 batched GEMM takes
  those rounded operands in f32 with TF32 off, and the output transform
  stays f32 until the one cast at the end, as the JAX package's
  ``preferred_element_type = f32`` product does.

Each use is counted in ``REWRITE_USES`` (per forward, as the kernel
wrappers count their launches).  ``insanity_max_pooling`` jitters each
pixel in training (with probability ``(1 - keep) / 4`` each, its up,
down, left or right neighbour, clamped at the border) and then runs the
max-pool kernels.

``batch_norm`` is plain PyTorch, on the card too (the JAX package
computes it in XLA, with no Pallas kernel): statistics in f32 over every
axis but the channel, ``bn_stats = onepass`` as ``max(E[x^2] - E[x]^2,
0)``, then ``((x - mean) * rsqrt(var + eps) * slope + bias)`` in f32,
cast to x's dtype.  Its ``wmat`` (slope) and ``bias`` stay f32 under a
bf16 compute dtype.  ``bn_eval = running`` adds ``rmean``/``rvar`` layer
state (``init_aux``): training updates it as ``aux * mom + (1 - mom) *
batch_stat`` with the biased variance, from detached statistics, and
eval normalises with it.  ``F.batch_norm`` is not used: its running
variance is unbiased, its momentum the batch's share, and its eps 1e-5.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import lrn as ops_lrn
from ..ops import maxpool as ops_mp
from ..parallel import distributed as pdist
from .base import Layer, Params, Shape, register
from .elemwise import uniform

#: Uses of each conv rewrite (``conv_s2d``, ``conv_wino``) since the last
#: ``REWRITE_USES.clear()``: one per conv layer a forward runs through it.
REWRITE_USES: collections.Counter = collections.Counter()


def conv_s2d(x: torch.Tensor, w: torch.Tensor, s: int, py: int,
             px: int) -> torch.Tensor:
    """A stride-``s`` conv of NHWC ``x`` with the HWIO kernel ``w`` as a
    stride-1 conv on the ``s x s`` space-to-depth input: tap ``dy = s*t
    + a`` reads phase ``a`` of row ``oy + t``.  A kernel extent not a
    multiple of ``s`` gets zero taps at its tail; a padded input extent
    not a multiple of ``s`` gets zero rows on the right, whose outputs
    are cut off."""
    kh, kw, c, o = w.shape
    n, h, wd = x.shape[0], x.shape[1], x.shape[2]
    oh = (h + 2 * py - kh) // s + 1
    ow = (wd + 2 * px - kw) // s + 1
    hp, wp = h + 2 * py, wd + 2 * px
    eh, ew = (-hp) % s, (-wp) % s
    xp = F.pad(x, (0, 0, px, px + ew, py, py + eh))
    hq, wq = (hp + eh) // s, (wp + ew) // s
    xs = (xp.reshape(n, hq, s, wq, s, c).permute(0, 1, 3, 2, 4, 5)
          .reshape(n, hq, wq, s * s * c))
    k2h, k2w = -(-kh // s), -(-kw // s)
    wpad = F.pad(w, (0, 0, 0, 0, 0, k2w * s - kw, 0, k2h * s - kh))
    ws = (wpad.reshape(k2h, s, k2w, s, c, o).permute(0, 2, 1, 3, 4, 5)
          .reshape(k2h, k2w, s * s * c, o))
    y = F.conv2d(
        xs.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last),
        ws.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last))
    return y.permute(0, 2, 3, 1)[:, :oh, :ow, :]


# Winograd F(m x m, 3x3) (Lavin & Gray 2015): (m, B^T, G, A^T).
# conv_wino = 1 is F(4x4), 36 products per 16 outputs, transform
# constants up to |8|; conv_wino = 2 is F(2x2), 16 per 4, constants in
# {0, +-1, 1/2}: within ~3x of the direct conv's error in bf16.
_WG_F4 = (
    4,
    np.array([[4, 0, -5, 0, 1, 0],
              [0, -4, -4, 1, 1, 0],
              [0, 4, -4, -1, 1, 0],
              [0, -2, -1, 2, 1, 0],
              [0, 2, -1, -2, 1, 0],
              [0, 4, 0, -5, 0, 1]], np.float32),
    np.array([[1 / 4, 0, 0],
              [-1 / 6, -1 / 6, -1 / 6],
              [-1 / 6, 1 / 6, -1 / 6],
              [1 / 24, 1 / 12, 1 / 6],
              [1 / 24, -1 / 12, 1 / 6],
              [0, 0, 1]], np.float32),
    np.array([[1, 1, 1, 1, 1, 0],
              [0, 1, -1, 2, -2, 0],
              [0, 1, 1, 4, 4, 0],
              [0, 1, -1, 8, -8, 1]], np.float32),
)
_WG_F2 = (
    2,
    np.array([[1, 0, -1, 0],
              [0, 1, 1, 0],
              [0, -1, 1, 0],
              [0, 1, 0, -1]], np.float32),
    np.array([[1, 0, 0],
              [1 / 2, 1 / 2, 1 / 2],
              [1 / 2, -1 / 2, 1 / 2],
              [0, 0, 1]], np.float32),
    np.array([[1, 1, 1, 0],
              [0, 1, -1, -1]], np.float32),
)


@functools.lru_cache(maxsize=None)
def _wino_matrices(m: int, device: torch.device):
    """``(B^T, G, A^T)`` of F(m x m, 3x3) as f32 tensors on ``device``
    (made outside inference mode, so autograd may save them later)."""
    tables = _WG_F2 if m == 2 else _WG_F4
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device) for t in tables[1:])


@contextlib.contextmanager
def _no_tf32():
    """f32 matmuls in full f32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def conv_winograd3(x: torch.Tensor, w: torch.Tensor, py: int, px: int,
                   variant: int = 1) -> torch.Tensor:
    """The 3x3 stride-1 conv of NHWC ``x`` with the HWIO kernel ``w``
    by Winograd F(4x4) (``variant`` 1) or F(2x2) (2): the input tiles'
    transform ``B^T d B`` and the filter's ``G w G^T`` as f32 einsums
    rounded to ``x``'s dtype, the (m+2)^2 batched ``(tiles, C) x (C,
    O)`` product of those rounded operands in f32 (TF32 off), the output
    transform ``A^T . A`` in f32, one cast to ``x``'s dtype at the end.
    Autograd differentiates the whole pipeline."""
    m = 2 if variant == 2 else 4
    bt, g, at = _wino_matrices(m, x.device)
    a = m + 2
    n, h, wd, c = x.shape
    o = w.shape[3]
    oh, ow = h + 2 * py - 2, wd + 2 * px - 2
    th, tw = -(-oh // m), -(-ow // m)
    xp = F.pad(x, (0, 0, px, m * tw + 2 - wd - px, py, m * th + 2 - h - py))
    # d[n, t, u, c, i, j] = xp[n, m*t + i, m*u + j, c]
    d = xp.unfold(1, a, m).unfold(2, a, m)
    v = torch.einsum("ai,ntucij,bj->abntuc", bt, d.float(), bt).to(x.dtype)
    u = torch.einsum("ak,klco,bl->abco", g, w.float(), g).to(x.dtype)
    with _no_tf32():
        mm = torch.matmul(v.float().reshape(a * a, n * th * tw, c),
                          u.float().reshape(a * a, c, o))
    mm = mm.reshape(a, a, n, th, tw, o)
    y = torch.einsum("pa,abntuo,qb->ntpuqo", at, mm, at)
    y = y.reshape(n, m * th, m * tw, o)
    return y[:, :oh, :ow, :].to(x.dtype)


@register
class ConvolutionLayer(Layer):
    type_name = "conv"

    def __init__(self) -> None:
        super().__init__()
        self.conv_s2d = 0
        self.conv_wino = 0

    def set_param(self, name, val):
        if name == "conv_s2d":
            self.conv_s2d = int(val)
        elif name == "conv_wino":
            if val not in ("0", "1", "2"):
                raise ValueError(
                    f"conv_wino must be 0 (off), 1 (F4x4) or 2 (F2x2), "
                    f"got {val!r}")
            self.conv_wino = int(val)
        else:
            super().set_param(name, val)

    def rewrite(self, cin: int) -> str:
        """The rewrite this conv takes over ``cin`` input channels:
        ``"conv_wino"``, ``"conv_s2d"`` or ``""`` (the direct conv).
        Winograd takes a 3x3 stride-1 ungrouped conv over at least 8
        channels (fewer starve its GEMM, whose K is ``cin``)."""
        p = self.param
        if (self.conv_wino and p.stride == 1 and p.num_group == 1
                and p.kernel_height == 3 and p.kernel_width == 3
                and cin >= 8):
            return "conv_wino"
        if self.conv_s2d and p.stride > 1 and p.num_group == 1:
            return "conv_s2d"
        return ""

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 4:
            raise ValueError("ConvolutionLayer: input must be an NHWC image node")
        p = self.param
        n, h, w, c = shape
        if c % p.num_group != 0:
            raise ValueError("input channels must divide group size")
        if p.num_channel <= 0 or p.num_channel % p.num_group != 0:
            raise ValueError("must set nchannel correctly (divisible by ngroup)")
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("must set kernel_size correctly")
        if p.kernel_width > w + 2 * p.pad_x or p.kernel_height > h + 2 * p.pad_y:
            raise ValueError("kernel size exceeds input")
        if p.num_input_channel == 0:
            p.num_input_channel = c
        elif p.num_input_channel != c:
            raise ValueError("ConvolutionLayer: inconsistent input channels")
        oh = (h + 2 * p.pad_y - p.kernel_height) // p.stride + 1
        ow = (w + 2 * p.pad_x - p.kernel_width) // p.stride + 1
        return [(n, oh, ow, p.num_channel)]

    def init_params(self, gen, in_shapes) -> Params:
        p = self.param
        cin_g = in_shapes[0][3] // p.num_group
        # HWIO, O grouped in ngroup blocks (the JAX package's layout)
        shape = (p.kernel_height, p.kernel_width, cin_g, p.num_channel)
        in_num = cin_g * p.kernel_height * p.kernel_width
        out_num = p.num_channel // p.num_group
        out: Params = {"wmat": p.rand_init_weight(gen, shape, in_num, out_num)}
        if p.no_bias == 0:
            out["bias"] = torch.full((p.num_channel,), p.init_bias)
        return out

    def prepare(self, params: Params, dtype: torch.dtype) -> Params:
        w = params["wmat"].to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        out = {"w": w.contiguous(memory_format=torch.channels_last)}
        if "bias" in params:
            out["bias"] = params["bias"].to(dtype)
        return out

    def apply(self, params, inputs, train=False, gen=None, step=None):
        p = self.param
        x = inputs[0]
        how = self.rewrite(x.shape[3])
        if not how:
            y = F.conv2d(x.permute(0, 3, 1, 2), params["w"],
                         params.get("bias"), stride=p.stride,
                         padding=(p.pad_y, p.pad_x), groups=p.num_group)
            return [y.permute(0, 2, 3, 1).contiguous()]
        REWRITE_USES[how] += 1
        w = params["w"].permute(2, 3, 1, 0)  # OIHW -> HWIO
        if how == "conv_wino":
            y = conv_winograd3(x, w, p.pad_y, p.pad_x, self.conv_wino)
        else:
            y = conv_s2d(x, w, p.stride, p.pad_y, p.pad_x)
        if "bias" in params:
            y = y + params["bias"]
        return [y.contiguous()]


class _PoolBase(Layer):
    """Shared ceil-shape pooling over NHWC."""

    def set_param(self, name, val):
        if name == "pool_impl":
            # parsed for conf compatibility; the card always runs the
            # max-pool kernels (see PERF.md)
            if val not in ("auto", "pallas", "pallas_bwd", "xla"):
                raise ValueError(
                    f"pool_impl must be auto|pallas|pallas_bwd|xla, "
                    f"got {val!r}")
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 4:
            raise ValueError(f"{self.type_name}: input must be an NHWC image node")
        p = self.param
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("must set kernel_size correctly")
        n, h, w, c = shape
        if p.kernel_width > w + 2 * p.pad_x or p.kernel_height > h + 2 * p.pad_y:
            raise ValueError("kernel size exceeds input")
        return [(
            n,
            ops_mp.ceil_pool_shape(h, p.kernel_height, p.stride, p.pad_y),
            ops_mp.ceil_pool_shape(w, p.kernel_width, p.stride, p.pad_x),
            c,
        )]

    def _max_pool(self, x: torch.Tensor) -> torch.Tensor:
        p = self.param
        return ops_mp.maxpool(x, p.kernel_height, p.kernel_width, p.stride,
                              p.pad_y, p.pad_x)

    def _sum_pool(self, x: torch.Tensor) -> torch.Tensor:
        p = self.param
        kh, kw, s = p.kernel_height, p.kernel_width, p.stride
        pads_h, pads_w, oh, ow = ops_mp.geometry(
            x.shape[1], x.shape[2], kh, kw, s, p.pad_y, p.pad_x)
        xp = ops_mp.pad_nhwc(x, pads_h, pads_w, 0.0)
        acc = None
        for sl in ops_mp.shifted_windows(xp, kh, kw, s, oh, ow):
            acc = sl if acc is None else acc + sl
        return acc


@register
class MaxPoolingLayer(_PoolBase):
    type_name = "max_pooling"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [self._max_pool(inputs[0])]


@register
class SumPoolingLayer(_PoolBase):
    type_name = "sum_pooling"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [self._sum_pool(inputs[0])]


@register
class AvgPoolingLayer(_PoolBase):
    type_name = "avg_pooling"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        p = self.param
        # parity: divide by the full k*k even for truncated edge windows
        scale = 1.0 / (p.kernel_height * p.kernel_width)
        return [self._sum_pool(inputs[0]) * scale]


@register
class ReluMaxPoolingLayer(_PoolBase):
    type_name = "relu_max_pooling"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [self._max_pool(torch.relu(inputs[0]))]


def jitter_fn(x: torch.Tensor, flag: torch.Tensor, keep: float) -> torch.Tensor:
    """``insanity_max_pooling``'s jitter of NHWC ``x``: where the draw
    ``flag`` (``U[0, 1)`` of ``x``'s shape) is at least ``keep``, the
    pixel takes its up, down, left or right neighbour (clamped at the
    border), each with probability ``(1 - keep) / 4``."""
    up = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    down = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    left = torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
    right = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
    d = (1.0 - keep) / 4.0
    flag = flag.to(x.dtype)
    side = torch.where(flag < keep + 3 * d, left, right)
    side = torch.where(flag < keep + 2 * d, down, side)
    side = torch.where(flag < keep + d, up, side)
    return torch.where(flag < keep, x, side)


@register
class InsanityPoolingLayer(_PoolBase):
    type_name = "insanity_max_pooling"

    def __init__(self) -> None:
        super().__init__()
        self.p_keep = 1.0

    def set_param(self, name, val):
        if name == "keep":
            self.p_keep = float(val)
        else:
            super().set_param(name, val)

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        if train and gen is not None and self.p_keep < 1.0:
            x = jitter_fn(x, uniform(x, gen), self.p_keep)
        return [self._max_pool(x)]


@register
class LRNLayer(Layer):
    type_name = "lrn"

    def __init__(self) -> None:
        super().__init__()
        self.nsize = 3
        self.alpha = 0.001
        self.beta = 0.75
        self.knorm = 1.0

    def set_param(self, name, val):
        if name == "local_size":
            self.nsize = int(val)
            if self.nsize < 1:
                raise ValueError(f"local_size must be >= 1, got {val!r}")
        elif name == "alpha":
            self.alpha = float(val)
        elif name == "beta":
            self.beta = float(val)
        elif name == "knorm":
            self.knorm = float(val)
        elif name == "lrn_impl":
            # parsed for conf compatibility; the card always runs the
            # LRN kernels (see PERF.md)
            if val not in ("auto", "pallas", "xla", "matmul"):
                raise ValueError(
                    f"lrn_impl must be auto|pallas|xla|matmul, got {val!r}")
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        return [tuple(in_shapes[0])]

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [ops_lrn.lrn(inputs[0], self.nsize, self.alpha, self.beta,
                            self.knorm)]


@register
class BatchNormLayer(Layer):
    type_name = "batch_norm"

    def __init__(self) -> None:
        super().__init__()
        self.init_slope = 1.0
        self.init_bias_bn = 0.0
        self.eps = 1e-10
        self.bn_eval = "batch"  # the reference's; "running" for EMA stats
        self.bn_momentum = 0.9
        self.bn_stats = "twopass"

    def set_param(self, name, val):
        if name == "init_slope":
            self.init_slope = float(val)
        elif name == "init_bias":
            self.init_bias_bn = float(val)
        elif name == "eps":
            self.eps = float(val)
        elif name == "bn_eval":
            if val not in ("batch", "running"):
                raise ValueError("bn_eval must be batch or running")
            self.bn_eval = val
        elif name == "bn_momentum":
            self.bn_momentum = float(val)
        elif name == "bn_stats":
            if val not in ("twopass", "onepass"):
                raise ValueError("bn_stats must be twopass or onepass")
            self.bn_stats = val
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        return [tuple(in_shapes[0])]

    def init_params(self, gen, in_shapes) -> Params:
        ch = in_shapes[0][-1]
        return {"wmat": torch.full((ch,), self.init_slope),
                "bias": torch.full((ch,), self.init_bias_bn)}

    def init_aux(self, in_shapes, device=None):
        """The running statistics, only under ``bn_eval = running``."""
        if self.bn_eval != "running":
            return {}
        ch = in_shapes[0][-1]
        return {"rmean": torch.zeros(ch, device=device),
                "rvar": torch.ones(ch, device=device)}

    def prepare(self, params, dtype):
        """Slope and bias stay f32 under any compute dtype."""
        return dict(params)

    def _normalize(self, x, mean, var, params):
        inv = torch.rsqrt(var + self.eps)
        return ((x.float() - mean) * inv * params["wmat"].float()
                + params["bias"].float()).to(x.dtype)

    def _batch_stats(self, x):
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        if pdist.batch_shard() is not None:
            return self._global_stats(xf, dims)
        mean = xf.mean(dim=dims)
        if self.bn_stats == "onepass":
            var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean,
                                  0.0)
        else:
            var = ((xf - mean) ** 2).mean(dim=dims)
        return mean, var

    def _global_stats(self, xf, dims):
        """The statistics of the group's global batch (every rank holds
        an equal share): f32 sums all-reduced with their gradient,
        ``twopass`` with a second reduction after the mean, ``onepass``
        as ``max(E[x^2] - E[x]^2, 0)`` from one reduction of both
        sums."""
        count = float(xf[..., 0].numel() * pdist.batch_shard()[1])
        if self.bn_stats == "onepass":
            sums = pdist.all_reduce_sum(
                torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]))
            mean = sums[0] / count
            return mean, torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        mean = pdist.all_reduce_sum(xf.sum(dim=dims)) / count
        var = pdist.all_reduce_sum(((xf - mean) ** 2).sum(dim=dims)) / count
        return mean, var

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        return [self._normalize(x, *self._batch_stats(x), params)]

    def apply_stateful(self, params, aux, inputs, train=False, gen=None,
                       step=None):
        """``(outs, new_aux)``: batch statistics and the EMA update in
        training, the running statistics at eval."""
        x = inputs[0]
        if not train:
            return [self._normalize(x, aux["rmean"], aux["rvar"],
                                    params)], aux
        mean, var = self._batch_stats(x)
        # the JAX package's f32 scalars: mom, and 1 - mom rounded in f32
        mom = np.float32(self.bn_momentum)
        rest = float(np.float32(1.0) - mom)
        with torch.no_grad():
            new_aux = {"rmean": aux["rmean"] * float(mom)
                       + rest * mean.detach(),
                       "rvar": aux["rvar"] * float(mom) + rest * var.detach()}
        return [self._normalize(x, mean, var, params)], new_aux
