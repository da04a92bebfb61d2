"""Token embedding layer for sequence models.

Counterpart of ``cxxnet_tpu/layers/embed.py``.  ``embedding`` config
keys:

* ``nvocab`` — vocabulary size (required)
* ``nhidden`` — embedding dimension (required)
* ``pos = none|learned|sin`` — positional encoding added to the token
  embedding: a trained ``(T, D)`` table (tag ``pos``) or fixed
  sinusoidal
* ``decode = 1`` with ``decode_window = T`` — incremental decoding: the
  positions are absolute (the decode loop's ``step``), and the learned
  table spans the window, so its shape is the training checkpoint's

Input is a flat ``(N, T)`` node of token ids (float32, exact to 2^24);
output is the ``(N, T, D)`` sequence node.  The layer sets
``integer_input`` so the net keeps the ids out of the bf16 compute
dtype (bf16 would corrupt ids above 256).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from .base import Layer, Params, Shape, register


def sin_pos_table(t: int, d: int, device=None) -> torch.Tensor:
    """Sinusoidal positional encodings, (T, D) f32."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    half = (d + 1) // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


@register
class EmbeddingLayer(Layer):
    type_name = "embedding"

    #: the net must NOT cast this layer's input to the compute dtype
    integer_input = True

    def __init__(self) -> None:
        super().__init__()
        self.nvocab = 0
        self.pos = "none"
        self.decode = 0
        self.decode_window = 0

    def set_param(self, name, val):
        if name == "nvocab":
            self.nvocab = int(val)
        elif name == "pos":
            if val not in ("none", "learned", "sin"):
                raise ValueError(
                    f"embedding: pos must be none|learned|sin, got {val!r}")
            self.pos = val
        elif name == "decode":
            self.decode = int(val)
        elif name == "decode_window":
            self.decode_window = int(val)
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 2:
            raise ValueError(
                "embedding: input must be a flat (N, T) id node "
                f"(input_shape = 1,1,T), got {shape}")
        if self.nvocab <= 0 or self.param.num_hidden <= 0:
            raise ValueError("embedding: set nvocab and nhidden")
        n, t = shape
        return [(n, t, self.param.num_hidden)]

    def _table_len(self, t: int) -> int:
        if self.decode:
            if self.decode_window <= 0:
                raise ValueError(
                    "embedding: decode=1 needs decode_window (the training "
                    "T, so the pos table matches the checkpoint)")
            return self.decode_window
        return t

    def init_params(self, gen, in_shapes) -> Params:
        d = self.param.num_hidden
        t = self._table_len(in_shapes[0][1])
        sigma = self.param.init_sigma
        p = {"wmat": sigma * torch.randn((self.nvocab, d), generator=gen)}
        if self.pos == "learned":
            p["pos"] = sigma * torch.randn((t, d), generator=gen)
        return p

    def apply(self, params, inputs, train=False, gen=None,
              step: Optional[int] = None):
        ids = torch.clamp(torch.round(inputs[0]).long(), 0, self.nvocab - 1)
        out = F.embedding(ids, params["wmat"])
        t, d = out.shape[1], out.shape[2]
        # absolute positions step..step+t-1 under decode, else 0..t-1;
        # a start past the table is clamped, as lax.dynamic_slice does
        start = 0
        if self.decode:
            start = min(max(int(step or 0), 0), self._table_len(t) - t)
        if self.pos == "learned":
            out = out + params["pos"][start:start + t].to(out.dtype)[None]
        elif self.pos == "sin":
            table = sin_pos_table(self._table_len(t), d, out.device)
            out = out + table[start:start + t].to(out.dtype)[None]
        return [out]
