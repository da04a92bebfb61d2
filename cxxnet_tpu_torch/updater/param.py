"""Updater hyper-parameters: learning-rate and momentum schedules, and
the per-tag scoping of the keys.

The port's copy of ``cxxnet_tpu/updater/param.py``:

* ``epoch`` is the number of updates so far (the trainer's
  ``epoch_counter``), NOT the round;
* lr schedules: constant ``base_lr``; expdecay
  ``base_lr * gamma ** (epoch / step)``; polydecay
  ``base_lr * (1 + (epoch // step) * gamma) ** -alpha``; factor
  ``base_lr * factor ** (epoch // step)``; clamped below by
  ``minimum_lr``, and ``base_lr`` before ``start_epoch``;
* momentum: constant, or with ``momentum_schedule`` a linear ramp from
  ``base_momentum`` to ``final_momentum`` over ``saturation_epoch``;
* a key ``wmat:lr`` applies only to the updaters of tag ``wmat``; the
  tag is stripped and the rest parsed; ``lr:...`` / ``eta:...`` keys
  configure the schedule.

The JAX package evaluates the schedules in float32 inside its step
program; here they run on the host in ``np.float32`` arithmetic, in the
same order, and the kernel takes the float32 results.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


class UpdaterParam:
    def __init__(self, tag: str = "") -> None:
        self.tag = tag
        self.base_lr = 0.01
        self.wd = 0.0
        self.momentum = 0.9
        self.lr_schedule = 0  # 0 const, 1 expdecay, 2 polydecay, 3 factor
        self.momentum_schedule = 0
        self.lr_step = 1
        self.lr_gamma = 0.5
        self.lr_alpha = 0.5
        self.lr_factor = 0.1
        self.lr_minimum = 0.00001
        self.start_epoch = 0
        self.base_momentum = 0.5
        self.final_momentum = 0.90
        self.saturation_epoch = 0
        self.clip_gradient = 0.0
        self.silent = 0

    def set_param(self, name: str, val: str) -> None:
        # tag-scoped override: "wmat:lr" applies only when tag == "wmat"
        if (self.tag and name.startswith(self.tag) and len(name) > len(self.tag)
                and name[len(self.tag)] == ":"):
            name = name[len(self.tag) + 1:]
        if name in ("lr", "eta"):
            self.base_lr = float(val)
        elif name == "wd":
            self.wd = float(val)
        elif name == "momentum":
            self.momentum = float(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "momentum_schedule":
            self.momentum_schedule = int(val)
        elif name == "clip_gradient":
            self.clip_gradient = float(val)
        elif name == "final_momentum":
            self.final_momentum = float(val)
        elif name == "base_momentum":
            self.base_momentum = float(val)
        elif name == "saturation_epoch":
            self.saturation_epoch = int(val)
        elif name.startswith("lr:") or name.startswith("eta:"):
            sub = name.split(":", 1)[1]
            if sub == "schedule":
                table = {"constant": 0, "expdecay": 1, "polydecay": 2,
                         "factor": 3}
                if val in table:
                    self.lr_schedule = table[val]
            elif sub == "gamma":
                self.lr_gamma = float(val)
            elif sub == "alpha":
                self.lr_alpha = float(val)
            elif sub == "step":
                self.lr_step = int(val)
            elif sub == "factor":
                self.lr_factor = float(val)
            elif sub == "minimum_lr":
                self.lr_minimum = float(val)
            elif sub == "start_epoch":
                self.start_epoch = int(val)

    # --- schedule evaluation (float32, on the host) --------------------
    def learning_rate(self, epoch: int) -> np.float32:
        e = _F(epoch)
        base = _F(self.base_lr)
        if self.lr_schedule == 0:
            lr = base
        elif self.lr_schedule == 1:
            lr = base * np.power(_F(self.lr_gamma), e / _F(self.lr_step))
        elif self.lr_schedule == 2:
            lr = base * np.power(
                _F(1.0) + np.floor(e / _F(self.lr_step)) * _F(self.lr_gamma),
                -_F(self.lr_alpha))
        elif self.lr_schedule == 3:
            lr = base * np.power(_F(self.lr_factor),
                                 np.floor(e / _F(self.lr_step)))
        else:
            raise ValueError("unknown lr schedule")
        lr = np.maximum(_F(lr), _F(self.lr_minimum))
        if self.start_epoch > 0 and e < _F(self.start_epoch):
            lr = base
        return _F(lr)

    def momentum_at(self, epoch: int) -> np.float32:
        e = _F(epoch)
        if self.momentum_schedule and self.saturation_epoch > 0:
            ramp = _F(self.base_momentum) + (
                _F(self.final_momentum - self.base_momentum) * e
                / _F(self.saturation_epoch))
            return _F(np.minimum(ramp, _F(self.final_momentum)))
        return _F(self.momentum)
