"""PairTest layer: two implementations of one layer run side by side.

Counterpart of ``cxxnet_tpu/layers/pairtest.py``.  The conf name
``pairtest-<master>-<slave>`` builds both layers and configures both
with every key; the net sees the master: its shapes (the slave's must
agree), its params (the slave runs on them too), its output and its
layer state.  ``compare`` runs both in eval mode on one input and
returns the largest relative error between their outputs.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .base import Layer, Params, Shape


class PairTestLayer(Layer):
    type_name = "pairtest"

    def __init__(self, master: Layer, slave: Layer) -> None:
        super().__init__()
        self.master = master
        self.slave = slave

    def set_param(self, name, val):
        self.master.set_param(name, val)
        self.slave.set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        out_m = self.master.infer_shape(in_shapes)
        out_s = self.slave.infer_shape(in_shapes)
        if out_m != out_s:
            raise ValueError(
                f"pairtest: master/slave shape mismatch {out_m} vs {out_s}")
        return out_m

    def init_params(self, gen, in_shapes) -> Params:
        return self.master.init_params(gen, in_shapes)

    def prepare(self, params: Params, dtype: torch.dtype) -> Params:
        return self.master.prepare(params, dtype)

    def init_aux(self, in_shapes, device=None):
        init = getattr(self.master, "init_aux", None)
        return init(in_shapes, device) if init is not None else {}

    def apply_stateful(self, params, aux, inputs, train=False, gen=None,
                       step=None):
        return self.master.apply_stateful(params, aux, inputs, train=train,
                                          gen=gen, step=step)

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return self.master.apply(params, inputs, train=train, gen=gen,
                                 step=step)

    def compare(self, params, inputs, rtol_floor: float = 1e-8
                ) -> torch.Tensor:
        """Max relative error between the master's and the slave's
        outputs in eval mode, each error over ``max(|master|,
        rtol_floor)``."""
        out_m = self.master.apply(params, inputs, train=False)
        out_s = self.slave.apply(params, inputs, train=False)
        errs = [((m - s).abs() / m.abs().clamp_min(rtol_floor)).max()
                for m, s in zip(out_m, out_s)]
        return torch.stack(errs).max()
