"""Dense layers: fullc, fixconn and flatten.

Counterpart of ``cxxnet_tpu/layers/linear.py``: ``fullc`` computes
``x @ W^T + bias`` with ``W`` stored ``(nout, nin)`` (the layout of
``torch.nn.Linear.weight`` too); ``fixconn`` computes ``x @ W^T`` with a
frozen ``W`` read at shape inference from the ``fixconn_weight`` text
file (``nrow ncol nnz`` then ``nnz`` triples ``row col val``), which is
no param: no updater sees it and no checkpoint holds it; ``flatten``
ravels an NHWC node in NHWC order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
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
class FixConnectLayer(Layer):
    """fullc with a frozen sparse weight matrix read from a text file."""

    type_name = "fixconn"

    def __init__(self) -> None:
        super().__init__()
        self.fname_weight = "NULL"
        self._wmat: Optional[np.ndarray] = None
        # the frozen weight on each (device, dtype) it has run on
        self._placed: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    def set_param(self, name, val):
        if name == "fixconn_weight":
            self.fname_weight = val
        super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 2:
            raise ValueError("FixConnLayer: input needs to be a matrix node")
        if self.param.num_hidden <= 0:
            raise ValueError("FixConnLayer: must set nhidden correctly")
        if self.fname_weight == "NULL":
            raise ValueError("FixConnLayer: must specify fixconn_weight")
        if self._wmat is None or self._wmat.shape != (self.param.num_hidden,
                                                      shape[1]):
            self._wmat = self._load_sparse(self.fname_weight,
                                           self.param.num_hidden, shape[1])
            self._placed = {}
        return [(shape[0], self.param.num_hidden)]

    @staticmethod
    def _load_sparse(fname: str, nrow_want: int, ncol_want: int) -> np.ndarray:
        with open(fname, "r", encoding="utf-8") as f:
            toks = f.read().split()
        nrow, ncol, nnz = int(toks[0]), int(toks[1]), int(toks[2])
        if nrow != nrow_want or ncol != ncol_want:
            raise ValueError("FixConnLayer: fixconn_weight shape does not "
                             "match architecture")
        w = np.zeros((nrow, ncol), np.float32)
        vals = toks[3:]
        if len(vals) != 3 * nnz:
            raise ValueError("FixConnLayer: fixconn_weight invalid sparse "
                             "matrix format")
        for k in range(nnz):
            x, y, v = (int(vals[3 * k]), int(vals[3 * k + 1]),
                       float(vals[3 * k + 2]))
            if not (0 <= x < nrow and 0 <= y < ncol):
                raise ValueError("FixConnLayer: fixconn_weight index exceeds "
                                 "matrix shape")
            w[x, y] = v
        return w

    def apply(self, params, inputs, train=False, gen=None, step=None):
        if self._wmat is None:
            raise RuntimeError("FixConnLayer: infer_shape must run before "
                               "apply")
        x = inputs[0]
        key = (x.device, x.dtype)
        w = self._placed.get(key)
        if w is None:  # outside inference mode: autograd may save it
            with torch.inference_mode(False):
                w = self._placed[key] = torch.from_numpy(self._wmat).to(
                    device=x.device, dtype=x.dtype)
        return [F.linear(x, w)]


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
