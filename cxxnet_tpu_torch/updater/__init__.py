"""Updaters: per-tensor update rules over the f32 master weights.

The port's counterpart of ``cxxnet_tpu/updater/__init__.py``.  Each
updater is ``init_state(w) -> state`` plus ``apply(w, grad, state,
epoch)``, which updates ``w`` and ``state`` IN PLACE (the JAX package
returns new arrays).  This slice ports ``sgd``:

    m = mom * m - lr * (clip(g) + wd * w);   w += m

where ``clip`` also zeroes NaNs and applies only when
``clip_gradient != 0`` (the reference's built-in NaN guard,
``update_step.nan_clip``).  The step
itself is the fused kernel of ``ops/kernels/update_step.py`` (K8) on a
card, its plain version on the CPU.  The other updaters of the JAX
package (nag, adam, rmsprop, adagrad, lars, lamb) raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.kernels import update_step
from .param import UpdaterParam

State = Dict[str, torch.Tensor]


class Updater:
    """Base: one instance per weight tensor, carrying its UpdaterParam."""

    type_name = ""

    def __init__(self, tag: str) -> None:
        self.param = UpdaterParam(tag)

    def set_param(self, name: str, val: str) -> None:
        self.param.set_param(name, val)

    def init_state(self, w: torch.Tensor) -> State:
        raise NotImplementedError

    def apply(self, w: torch.Tensor, g: torch.Tensor, state: State,
              epoch: int) -> None:
        raise NotImplementedError


class SGDUpdater(Updater):
    type_name = "sgd"

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    def apply(self, w, g, state, epoch):
        p = self.param
        update_step.sgd_update(
            w, g, state["m"], float(p.learning_rate(epoch)),
            float(p.momentum_at(epoch)), wd=p.wd, clip=p.clip_gradient)


_NOT_PORTED = ("nag", "adam", "rmsprop", "adagrad", "lars", "lamb")


def create_updater(type_name: str, tag: str) -> Updater:
    """Factory (``updater = sgd`` in the conf)."""
    if type_name == "sgd":
        return SGDUpdater(tag)
    if type_name in _NOT_PORTED:
        raise NotImplementedError(
            f"updater={type_name} is not ported yet (ROADMAP.md queue A "
            "item 5); this slice trains with updater=sgd")
    raise ValueError(f"unknown updater type: {type_name!r}")
