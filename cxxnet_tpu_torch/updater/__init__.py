"""Updaters: per-tensor update rules over the f32 master weights.

The port's counterpart of ``cxxnet_tpu/updater/__init__.py``.  Each
updater is ``init_state(w) -> state`` plus ``apply(w, grad, state,
epoch)``, which updates ``w`` and ``state`` IN PLACE (the JAX package
returns new arrays).  Ported:

* ``sgd``: ``m = mom * m - lr * (clip(g) + wd * w);   w += m``, where
  ``clip`` also zeroes NaNs and applies only when ``clip_gradient != 0``
  (the reference's built-in NaN guard, ``update_step.nan_clip``).  The
  step is the fused kernel of ``ops/kernels/update_step.py`` (K8) on a
  card, its plain version on the CPU; ``apply_all`` runs a step's SGD
  tensors through one multi-tensor launch.
* ``adam``, in plain torch ops (the JAX package has no Pallas kernel for
  it), with the reference's quirks: ``beta1`` and ``beta2`` are the
  DECAY rates (defaults 0.1 and 0.001), weight decay is SUBTRACTED from
  the gradient, ``lr_t = base_lr * sqrt(fix2) / fix1`` with ``fix_i = 1
  - (1 - decay_i) ** (epoch + 1)`` (no lr schedule), and ``eps = 1e-8``
  outside the square root:

      m1 += decay1 * (g - m1);  m2 += decay2 * (g*g - m2)
      w  -= lr_t * m1 / (sqrt(m2) + 1e-8)

  The host scalars are evaluated in ``np.float32``.
* ``nag``: ``m' = mom * m - lr * (g + wd * w);  w += (1 + mom) * m' -
  mom * m`` (no clip, as in the JAX package).
* ``rmsprop`` (``rho`` 0.95, ``eps`` 1e-8) and ``adagrad`` (``eps``
  1e-8): the clip of ``sgd``, then ``g += wd * w``; ``v = rho * v + (1 -
  rho) * g * g`` or ``v += g * g``; ``w -= lr * g / (sqrt(v) + eps)``.
* ``lars`` (``trust_coeff`` 0.001, ``eps`` 1e-9): the clip, ``g += wd *
  w``, the trust ratio ``trust_coeff * ||w|| / (||g|| + eps)`` (1 where
  either norm is not positive), ``m = mom * m - lr * trust * g; w += m``.
* ``lamb`` (conventional ``beta1`` 0.9, ``beta2`` 0.999, ``eps`` 1e-6):
  the clip, Adam moments with bias correction, ``u = m1_hat /
  (sqrt(m2_hat) + eps) + wd * w``, trust ``||w|| / ||u||`` (1 where
  either norm is not positive), ``w -= lr * trust * u``.

These five have no kernel in the JAX package either: they are plain
PyTorch on the card, in the JAX updaters' operation order, their
schedule scalars evaluated on the host in ``np.float32``.  The norms of
``lars`` and ``lamb`` stay on the device (no host sync); over a tensor
cut on a model axis, or on the data axis under ``zero``, they are the
whole tensor's, the squared sums added over each sub-group that holds
the other slices (``norm_groups``), one all-reduce each.  A global
``eps`` reaches every updater that takes one, and batch norm's too.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import update_step
from ..parallel import distributed as pdist
from .param import UpdaterParam

State = Dict[str, torch.Tensor]


class Updater:
    """Base: one instance per weight tensor, carrying its UpdaterParam."""

    type_name = ""
    #: the rule reads each element of (w, grad, state) alone, so a slice
    #: of the tensor updates as the whole would; False for the rules that
    #: read whole-tensor norms, whose slices sum them over ``norm_groups``
    elementwise = True

    def __init__(self, tag: str) -> None:
        self.param = UpdaterParam(tag)
        #: the sub-groups (model, data) of the ranks that hold the other
        #: slices of the tensor (empty: this rank holds it whole); a rule
        #: that reads whole-tensor norms sums their squares over each
        self.norm_groups: tuple = ()

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

    def scalars(self, epoch: int) -> Tuple[float, float, float, float]:
        """``(lr, mom, wd, clip)`` of the step at ``epoch``: the schedule
        values in ``np.float32``."""
        p = self.param
        return (float(p.learning_rate(epoch)), float(p.momentum_at(epoch)),
                p.wd, p.clip_gradient)

    def apply(self, w, g, state, epoch):
        update_step.sgd_update(w, g, state["m"], *self.scalars(epoch))


class AdamUpdater(Updater):
    type_name = "adam"

    def __init__(self, tag: str) -> None:
        super().__init__(tag)
        self.decay1 = 0.1
        self.decay2 = 0.001

    def set_param(self, name: str, val: str) -> None:
        if name == "beta1":
            self.decay1 = float(val)
        elif name == "beta2":
            self.decay2 = float(val)
        else:
            super().set_param(name, val)

    def init_state(self, w):
        return {"m1": torch.zeros_like(w), "m2": torch.zeros_like(w)}

    def apply(self, w, g, state, epoch):
        p = self.param
        f32 = np.float32
        t1 = f32(epoch) + f32(1.0)
        fix1 = f32(1.0) - np.power(f32(1.0 - self.decay1), t1)
        fix2 = f32(1.0) - np.power(f32(1.0 - self.decay2), t1)
        lr_t = float(f32(p.base_lr) * np.sqrt(fix2) / fix1)
        m1, m2 = state["m1"], state["m2"]
        with torch.no_grad():
            if p.wd > 0.0:
                g = g - p.wd * w
            m1.add_(self.decay1 * (g - m1))
            m2.add_(self.decay2 * (g * g - m2))
            w.sub_(lr_t * (m1 / (torch.sqrt(m2) + 1e-8)))


class NAGUpdater(Updater):
    type_name = "nag"

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    def apply(self, w, g, state, epoch):
        p = self.param
        lr, mom = float(p.learning_rate(epoch)), float(p.momentum_at(epoch))
        old_m = state["m"]
        with torch.no_grad():
            m = mom * old_m - lr * (g + p.wd * w)
            w.copy_(w + (1.0 + mom) * m - mom * old_m)
            old_m.copy_(m)


class RMSPropUpdater(Updater):
    type_name = "rmsprop"

    def __init__(self, tag: str) -> None:
        super().__init__(tag)
        self.rho = 0.95
        self.eps = 1e-8

    def set_param(self, name: str, val: str) -> None:
        if name == "rho":
            self.rho = float(val)
        elif name == "eps":
            self.eps = float(val)
        else:
            super().set_param(name, val)

    def init_state(self, w):
        return {"v": torch.zeros_like(w)}

    def apply(self, w, g, state, epoch):
        p = self.param
        lr = float(p.learning_rate(epoch))
        v = state["v"]
        with torch.no_grad():
            if p.clip_gradient != 0.0:
                g = update_step.nan_clip(g, p.clip_gradient)
            g = g + p.wd * w
            v.copy_(self.rho * v + (1.0 - self.rho) * g * g)
            w.sub_(lr * g / (torch.sqrt(v) + self.eps))


class AdagradUpdater(Updater):
    type_name = "adagrad"

    def __init__(self, tag: str) -> None:
        super().__init__(tag)
        self.eps = 1e-8

    def set_param(self, name: str, val: str) -> None:
        if name == "eps":
            self.eps = float(val)
        else:
            super().set_param(name, val)

    def init_state(self, w):
        return {"v": torch.zeros_like(w)}

    def apply(self, w, g, state, epoch):
        p = self.param
        lr = float(p.learning_rate(epoch))
        v = state["v"]
        with torch.no_grad():
            if p.clip_gradient != 0.0:
                g = update_step.nan_clip(g, p.clip_gradient)
            g = g + p.wd * w
            v.add_(g * g)
            w.sub_(lr * g / (torch.sqrt(v) + self.eps))


def _norms(a: torch.Tensor, b: torch.Tensor, groups
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``||a||`` and ``||b||`` of the whole tensors whose slices the
    ranks of ``groups`` hold (one all-reduce of the two squared sums
    over each group: the model axis, then the data axis)."""
    sq = torch.stack([(a.float() ** 2).sum(), (b.float() ** 2).sum()])
    for group in groups:
        sq = pdist.all_reduce_(sq, group)
    n = torch.sqrt(sq)
    return n[0], n[1]


def _trust(num: torch.Tensor, den: torch.Tensor,
           ratio: torch.Tensor) -> torch.Tensor:
    """``ratio`` where both norms are positive, else 1 (a device
    scalar)."""
    return torch.where((num > 0) & (den > 0), ratio, torch.ones_like(ratio))


class LARSUpdater(Updater):
    type_name = "lars"
    elementwise = False  # the trust ratio reads ||w|| and ||g||

    def __init__(self, tag: str) -> None:
        super().__init__(tag)
        self.trust_coeff = 0.001
        self.eps = 1e-9

    def set_param(self, name: str, val: str) -> None:
        if name == "trust_coeff":
            self.trust_coeff = float(val)
        elif name == "eps":
            self.eps = float(val)
        else:
            super().set_param(name, val)

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    def apply(self, w, g, state, epoch):
        p = self.param
        lr, mom = float(p.learning_rate(epoch)), float(p.momentum_at(epoch))
        m = state["m"]
        with torch.no_grad():
            if p.clip_gradient != 0.0:
                g = update_step.nan_clip(g, p.clip_gradient)
            g = g + p.wd * w
            wn, gn = _norms(w, g, self.norm_groups)
            trust = _trust(wn, gn, self.trust_coeff * wn / (gn + self.eps))
            m.copy_(mom * m - lr * trust * g)
            w.add_(m)


class LAMBUpdater(Updater):
    type_name = "lamb"
    elementwise = False  # the trust ratio reads ||w|| and ||u||

    def __init__(self, tag: str) -> None:
        super().__init__(tag)
        self.beta1 = 0.9
        self.beta2 = 0.999
        self.eps = 1e-6

    def set_param(self, name: str, val: str) -> None:
        if name == "beta1":
            self.beta1 = float(val)
        elif name == "beta2":
            self.beta2 = float(val)
        elif name == "eps":
            self.eps = float(val)
        else:
            super().set_param(name, val)

    def init_state(self, w):
        return {"m1": torch.zeros_like(w), "m2": torch.zeros_like(w)}

    def apply(self, w, g, state, epoch):
        p = self.param
        f32 = np.float32
        lr = float(p.learning_rate(epoch))
        t = f32(epoch) + f32(1.0)
        fix1 = float(f32(1.0) - np.power(f32(self.beta1), t))
        fix2 = float(f32(1.0) - np.power(f32(self.beta2), t))
        m1, m2 = state["m1"], state["m2"]
        with torch.no_grad():
            if p.clip_gradient != 0.0:
                g = update_step.nan_clip(g, p.clip_gradient)
            m1.copy_(self.beta1 * m1 + (1.0 - self.beta1) * g)
            m2.copy_(self.beta2 * m2 + (1.0 - self.beta2) * g * g)
            u = (m1 / fix1) / (torch.sqrt(m2 / fix2) + self.eps)
            u = u + p.wd * w
            wn, un = _norms(w, u, self.norm_groups)
            trust = _trust(wn, un, wn / un)
            w.sub_(lr * trust * u)


def apply_all(items: Sequence[Tuple[Updater, torch.Tensor, torch.Tensor,
                                    State]], epoch: int) -> None:
    """One step's updates over ``(updater, w, grad, state)`` items, in
    place: every ``SGDUpdater`` tensor in one ``sgd_update_multi`` call,
    the others by their own ``apply``.  The schedules are evaluated once
    per distinct set of updater settings (most tensors share one of a
    few), not once per tensor."""
    sgd, scalars = [], {}
    for up, w, g, state in items:
        if isinstance(up, SGDUpdater):
            key = tuple(vars(up.param).values())
            if key not in scalars:
                scalars[key] = up.scalars(epoch)
            sgd.append((w, g, state["m"], *scalars[key]))
        else:
            up.apply(w, g, state, epoch)
    if sgd:
        update_step.sgd_update_multi(*zip(*sgd))


_UPDATERS = {"sgd": SGDUpdater, "nag": NAGUpdater, "adam": AdamUpdater,
             "rmsprop": RMSPropUpdater, "adagrad": AdagradUpdater,
             "lars": LARSUpdater, "lamb": LAMBUpdater}


def create_updater(type_name: str, tag: str) -> Updater:
    """Factory (``updater = ...`` in the conf)."""
    if type_name not in _UPDATERS:
        raise ValueError(f"unknown updater type: {type_name!r}")
    return _UPDATERS[type_name](tag)
