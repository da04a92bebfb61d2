"""Elementwise layers: activations, the leaky-ReLU family, dropout, bias.

Counterpart of ``cxxnet_tpu/layers/elemwise.py``.  ``gelu`` is the tanh
approximation, which is what ``jax.nn.gelu`` computes by default.
Dropout is inverted
dropout: in training it keeps each value with probability
``pkeep = 1 - threshold`` and scales the kept ones by ``1 / pkeep``; at
predict time, or with ``threshold = 0``, it is the identity.

The leaky-ReLU family works on the last axis as the channel (NHWC's C,
a flat node's feature):

* ``xelu``: negative slope ``1/b`` (``b = 5``);
* ``prelu``: a learned per-channel slope, kept under the param tag
  ``bias`` so ``bias:lr`` / ``bias:wd`` reach it, as in the JAX package;
  in training with ``random > 0`` the slope is multiplied by ``1 +
  U(-1, 1) * random``; the mask is then clipped to [0, 1];
* ``insanity`` (randomized leaky ReLU): slope ``1/u`` with ``u ~ U[lb,
  ub]`` in training, ``2 / (lb + ub)`` at eval; with ``calm_end >
  calm_start`` the interval closes linearly on its midpoint as the
  update counter (``step``) runs from ``calm_start`` to ``calm_end``.
  Its math is f32, the result cast back to the input's dtype.

Each random layer is a plain function of ``(x, u)`` (``prelu_fn``,
``insanity_fn``), the uniform draws ``u`` taken by :func:`uniform` from
the step's ``torch.Generator`` on the input's device, so a test can feed
another implementation the same draws.  In a data-parallel group (under
``parallel.distributed.sharded_batch``) every draw, dropout's too, is of
the GLOBAL batch's shape and each rank takes its own rows
(:func:`batch_rand`), as the JAX package's SPMD step draws one mask for
the global batch: ``world`` times the draws of one rank's rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import distributed as pdist
from .base import Layer, Params, Shape, register


def draw(shape, gen: torch.Generator, device) -> torch.Tensor:
    """``U[0, 1)`` f32 draws of ``shape`` from ``gen`` on ``device``."""
    return torch.rand(shape, generator=gen, device=device)


def batch_rand(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """:func:`draw` for ``x``'s shape; in a group, this rank's rows of
    the draws of the global batch's shape (batch-major ``x``)."""
    shard = pdist.batch_shard()
    if shard is None:
        return draw(x.shape, gen, x.device)
    rank, world = shard
    n = x.shape[0]
    u = draw((n * world,) + tuple(x.shape[1:]), gen, x.device)
    return u[rank * n:(rank + 1) * n]


def uniform(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``U[0, 1)`` draws of ``x``'s shape, f32, on ``x``'s device, from
    ``gen`` (the random layers' one source of draws)."""
    return batch_rand(x, gen)


class _UnaryLayer(Layer):
    """1-in/1-out shape-preserving elementwise layer."""

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        return [tuple(in_shapes[0])]


@register
class SigmoidLayer(_UnaryLayer):
    type_name = "sigmoid"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [torch.sigmoid(inputs[0])]


@register
class TanhLayer(_UnaryLayer):
    type_name = "tanh"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [torch.tanh(inputs[0])]


@register
class ReluLayer(_UnaryLayer):
    type_name = "relu"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [torch.relu(inputs[0])]


@register
class SoftplusLayer(_UnaryLayer):
    type_name = "softplus"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [F.softplus(inputs[0])]


@register
class GeluLayer(_UnaryLayer):
    type_name = "gelu"

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [F.gelu(inputs[0], approximate="tanh")]


@register
class DropoutLayer(_UnaryLayer):
    type_name = "dropout"

    def __init__(self) -> None:
        super().__init__()
        self.threshold = 0.0

    def set_param(self, name, val):
        if name == "threshold":
            self.threshold = float(val)
            if not (0.0 <= self.threshold < 1.0):
                raise ValueError("DropoutLayer: invalid dropout threshold")
        else:
            super().set_param(name, val)

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        if not train or self.threshold <= 0.0 or gen is None:
            return [x]
        pkeep = 1.0 - self.threshold
        # uniform draws from the step's generator (Philox on a CUDA one)
        keep = batch_rand(x, gen) < pkeep
        return [torch.where(keep, x / pkeep, torch.zeros_like(x))]


@register
class XeluLayer(_UnaryLayer):
    """Leaky ReLU with negative slope ``1/b``."""

    type_name = "xelu"

    def __init__(self) -> None:
        super().__init__()
        self.b = 5.0

    def set_param(self, name, val):
        if name == "b":
            self.b = float(val)
        else:
            super().set_param(name, val)

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        return [torch.where(x > 0, x, x / self.b)]


def prelu_fn(x: torch.Tensor, slope: torch.Tensor, u: Optional[torch.Tensor],
             random: float) -> torch.Tensor:
    """PReLU of ``x`` with the per-channel ``slope`` (last axis); ``u``
    (``U[0, 1)`` draws of ``x``'s shape, or None) jitters the mask by
    ``1 + (2u - 1) * random`` before the clip to [0, 1]."""
    mask = slope.to(x.dtype).expand(x.shape)
    if u is not None:
        mask = mask * (1.0 + (u.to(x.dtype) * 2.0 - 1.0) * random)
    mask = torch.clamp(mask, 0.0, 1.0)
    return torch.where(x > 0, x, x * mask)


@register
class PReluLayer(_UnaryLayer):
    type_name = "prelu"

    def __init__(self) -> None:
        super().__init__()
        self.init_slope = 0.25
        self.init_random = 0
        self.random = 0.0

    def set_param(self, name, val):
        if name == "init_slope":
            self.init_slope = float(val)
        elif name == "random_slope":
            self.init_random = int(val)
        elif name == "random":
            self.random = float(val)
        else:
            super().set_param(name, val)

    def init_params(self, gen, in_shapes) -> Params:
        ch = in_shapes[0][-1]
        if self.init_random:
            slope = self.init_slope * torch.rand((ch,), generator=gen)
        else:
            slope = torch.full((ch,), self.init_slope)
        return {"bias": slope}  # the tag bias:lr / bias:wd address

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        u = (uniform(x, gen) if train and self.random > 0 and gen is not None
             else None)
        return [prelu_fn(x, params["bias"], u, self.random)]


def insanity_fn(x: torch.Tensor, lb: float, ub: float,
                u: Optional[torch.Tensor]) -> torch.Tensor:
    """Randomized leaky ReLU of ``x`` over the interval ``[lb, ub]``:
    slope ``1 / (lb + u * (ub - lb))`` for draws ``u``, else the
    midpoint's; f32 math, cast back to ``x``'s dtype."""
    xf = x.float()
    if u is not None:
        div = u.float() * (ub - lb) + lb
    else:
        div = torch.tensor((lb + ub) / 2.0, dtype=torch.float32,
                           device=x.device)
    return torch.where(xf > 0, xf, xf / div).to(x.dtype)


@register
class InsanityLayer(_UnaryLayer):
    type_name = "insanity"

    def __init__(self) -> None:
        super().__init__()
        self.lb = 5.0
        self.ub = 10.0
        self.calm_start = 0
        self.calm_end = 0

    def set_param(self, name, val):
        if name == "lb":
            self.lb = float(val)
        elif name == "ub":
            self.ub = float(val)
        elif name == "calm_start":
            self.calm_start = int(val)
        elif name == "calm_end":
            self.calm_end = int(val)
        else:
            super().set_param(name, val)

    def interval(self, step: Optional[int]) -> Tuple[float, float]:
        """``(lb, ub)`` at update ``step``: the endpoints move linearly to
        their midpoint over ``[calm_start, calm_end]`` (in f32, as the
        JAX package computes them)."""
        f32 = np.float32
        lb, ub = f32(self.lb), f32(self.ub)
        if self.calm_end > self.calm_start and step is not None:
            mid = (self.lb + self.ub) / 2.0
            t = np.clip(f32(step - self.calm_start)
                        / f32(self.calm_end - self.calm_start), f32(0),
                        f32(1))
            lb, ub = (lb + f32(mid - self.lb) * t,
                      ub + f32(mid - self.ub) * t)
        return float(lb), float(ub)

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        lb, ub = self.interval(step)
        u = uniform(x, gen) if train and gen is not None else None
        return [insanity_fn(x, lb, ub, u)]


@register
class BiasLayer(_UnaryLayer):
    """Additive per-feature bias over flat nodes."""

    type_name = "bias"

    def infer_shape(self, in_shapes):
        self._check_arity(in_shapes, 1)
        if len(in_shapes[0]) != 2:
            raise ValueError("BiasLayer: input must be a flat matrix node")
        return [tuple(in_shapes[0])]

    def init_params(self, gen, in_shapes) -> Params:
        return {"bias": torch.full((in_shapes[0][1],), self.param.init_bias)}

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [inputs[0] + params["bias"].to(inputs[0].dtype)]
