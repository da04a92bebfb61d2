"""Loss layers: softmax, l2_loss, multi_logistic.

Counterpart of ``cxxnet_tpu/layers/loss.py``.  Each defines
``transform`` (the prediction output, computed on f32 logits) and a
per-row loss whose gradient is the one the reference injects:

* softmax — probabilities; grad ``p - onehot(y)`` (summed cross-entropy);
* l2_loss — identity; grad ``x - y`` (``0.5 * sum (x - y)^2``);
* multi_logistic — sigmoid; grad ``sigmoid(x) - y`` (summed binary
  cross-entropy with logits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LossLayer, register


def _rows(v: torch.Tensor) -> torch.Tensor:
    """Sum every axis but the first."""
    return v.reshape(v.shape[0], -1).sum(1)


@register
class SoftmaxLayer(LossLayer):
    type_name = "softmax"

    def transform(self, x):
        return torch.softmax(x, dim=-1)

    def row_loss(self, x, labels):
        # integer class ids over x's leading dims: (N,) / (N, 1) for a
        # classifier, (N, T) for a per-position sequence loss
        lab = labels.reshape(x.shape[:-1]).long()
        logp = F.log_softmax(x, dim=-1)
        return -_rows(logp.gather(-1, lab.unsqueeze(-1)))


@register
class L2LossLayer(LossLayer):
    type_name = "l2_loss"

    def row_loss(self, x, labels):
        lab = labels.reshape(x.shape).to(x.dtype)
        return 0.5 * _rows((x - lab) ** 2)


@register
class MultiLogisticLayer(LossLayer):
    type_name = "multi_logistic"

    def transform(self, x):
        return torch.sigmoid(x)

    def row_loss(self, x, labels):
        lab = labels.reshape(x.shape).to(x.dtype)
        return _rows(torch.clamp_min(x, 0) - x * lab
                     + torch.log1p(torch.exp(-torch.abs(x))))
