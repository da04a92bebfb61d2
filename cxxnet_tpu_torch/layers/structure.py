"""Graph-structural layers: split, concat, ch_concat, eltwise_sum.

Counterpart of ``cxxnet_tpu/layers/structure.py``: ``concat`` joins the
feature axis of flat nodes or the width axis of images, ``ch_concat``
the channel (last) axis of NHWC nodes — the inception-block join.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .base import Layer, Shape, register


@register
class SplitLayer(Layer):
    type_name = "split"

    def __init__(self) -> None:
        super().__init__()
        self.n_split = 1  # set by the net from the number of output nodes

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        return [tuple(in_shapes[0]) for _ in range(self.n_split)]

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [inputs[0] for _ in range(self.n_split)]


class _ConcatBase(Layer):
    def _axis(self, shape: Shape) -> int:
        raise NotImplementedError

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        if not (2 <= len(in_shapes) <= 4):
            raise ValueError(
                f"{self.type_name}: supports 2-4 inputs, got {len(in_shapes)}")
        ax = self._axis(in_shapes[0])
        base = list(in_shapes[0])
        total = 0
        for s in in_shapes:
            if len(s) != len(base):
                raise ValueError(f"{self.type_name}: rank mismatch")
            for j in range(len(base)):
                if j != ax and s[j] != base[j]:
                    raise ValueError(
                        f"{self.type_name}: shape mismatch on axis {j}")
            total += s[ax]
        base[ax] = total
        return [tuple(base)]

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [torch.cat(list(inputs), dim=self._axis(inputs[0].shape))]


@register
class ConcatLayer(_ConcatBase):
    """Feature concat: last axis of flat nodes, width axis of images."""

    type_name = "concat"

    def _axis(self, shape: Shape) -> int:
        return 1 if len(shape) == 2 else 2


@register
class ChConcatLayer(_ConcatBase):
    """Channel concat (NHWC last axis)."""

    type_name = "ch_concat"

    def _axis(self, shape: Shape) -> int:
        if len(shape) != 4:
            raise ValueError("ch_concat: input must be an NHWC image node")
        return 3


@register
class ElemwiseSumLayer(Layer):
    """n-ary elementwise sum (residual connections)."""

    type_name = "eltwise_sum"

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        if len(in_shapes) < 2:
            raise ValueError("eltwise_sum: needs at least 2 inputs")
        first = tuple(in_shapes[0])
        for s in in_shapes[1:]:
            if tuple(s) != first:
                raise ValueError(
                    f"eltwise_sum: shape mismatch {tuple(s)} vs {first}")
        return [first]

    def apply(self, params, inputs, train=False, gen=None, step=None):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out]
