"""Dense layers: fullc and flatten.

Counterpart of ``cxxnet_tpu/layers/linear.py``: ``fullc`` computes
``x @ W^T + bias`` with ``W`` stored ``(nout, nin)`` (the layout of
``torch.nn.Linear.weight`` too); ``flatten`` ravels an NHWC node in
NHWC order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from .base import Layer, Params, Shape, register


@register
class FullConnectLayer(Layer):
    type_name = "fullc"

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) not in (2, 3):
            raise ValueError(
                "FullcLayer: input needs to be a matrix or sequence node")
        if self.param.num_hidden <= 0:
            raise ValueError("FullcLayer: must set nhidden correctly")
        nin = shape[-1]
        if self.param.num_input_node == 0:
            self.param.num_input_node = nin
        elif self.param.num_input_node != nin:
            raise ValueError("FullcLayer: input hidden nodes inconsistent")
        return [tuple(shape[:-1]) + (self.param.num_hidden,)]

    def init_params(self, gen, in_shapes) -> Params:
        p = self.param
        nin, nout = in_shapes[0][-1], p.num_hidden
        out: Params = {"wmat": p.rand_init_weight(gen, (nout, nin), nin, nout)}
        if p.no_bias == 0:
            out["bias"] = torch.full((nout,), p.init_bias)
        return out

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [F.linear(inputs[0], params["wmat"], params.get("bias"))]


@register
class FlattenLayer(Layer):
    type_name = "flatten"

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        n = 1
        for d in shape[1:]:
            n *= d
        return [(shape[0], n)]

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]
