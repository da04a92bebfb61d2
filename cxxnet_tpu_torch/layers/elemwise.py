"""Elementwise layers: relu, sigmoid, tanh, gelu, dropout.

Counterpart of ``cxxnet_tpu/layers/elemwise.py``.  ``gelu`` is the tanh
approximation, which is what ``jax.nn.gelu`` computes by default.
Dropout is inverted
dropout: in training it keeps each value with probability
``pkeep = 1 - threshold`` and scales the kept ones by ``1 / pkeep``; at
predict time, or with ``threshold = 0``, it is the identity.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from .base import Layer, Shape, register


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
        keep = torch.rand(x.shape, generator=gen, device=x.device) < pkeep
        return [torch.where(keep, x / pkeep, torch.zeros_like(x))]
