"""The overlapped async train step: per-group gradient exchange.

The port's ``cxxnet_tpu/parallel/async_ps/step.py``.  The synchronous
step sums every gradient with one collective; ``async_overlap = 1``
re-expresses the ``det_reduce`` step as a pipeline of groups
(``groups.partition_groups``):

1. each rank's backward over its own rows, with no collective (the
   trainer's per-rank gradient path, the one ``det_reduce`` uses);
2. from the last group to the first (the order the backward makes the
   gradients), the group's gradients packed into one flat buffer and
   all-gathered over the data sub-group with ``async_op=True``, one
   group ahead, so group k - 1's exchange is in flight while group k
   folds and applies; the fold is the rank-order ``((g0 + g1) + g2) +
   ...`` of ``det_reduce``, so ``staleness = 0`` is bitwise equal to it;
3. the fold pushed into the group's bounded-staleness buffer
   (``updater.AsyncUpdater``) and applied when due: the trainer's
   ``apply_all`` over that group's tensors only (for ``sgd`` one launch
   of the fused SGD kernel per group per step).

The loss rides in the first exchanged group's buffer, so the step's
loss is the group's, folded as ``det_reduce`` folds it.  The host
fences only at :meth:`AsyncStepper.round_end` (the round boundary,
where every ``async_resync_period`` rounds the buffers are drained
first) and wherever the caller bills a fetch with
:meth:`AsyncStepper.add_blocked` (the divergence guard's and
``eval_train``'s); ``async_overlap_fraction`` is the round's share of
wall time not spent in those fences.  Events: ``async.armed`` and
``async.resync``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...obs import events as obs_events
from ...obs.registry import registry as obs_registry
from .. import distributed as pdist
from .groups import group_param_counts, partition_groups
from .updater import AsyncUpdater


def _overlap_gauge():
    return obs_registry().gauge(
        "async_overlap_fraction",
        "Per-round fraction of wall time the host was not blocked in a "
        "device fence (1.0 = fully overlapped dispatch).")


class AsyncStepper:
    """Drives one trainer's async pipeline; built lazily at the first
    async update and dropped when the trainer rebuilds its net."""

    def __init__(self, trainer) -> None:
        from ...nnet.trainer import rank_order_fold

        self.trainer = trainer
        self._fold = rank_order_fold
        self.groups = partition_groups(trainer.params, trainer.async_groups)
        self.resync_period = max(1, int(trainer.async_resync_period))
        self.updater = AsyncUpdater(trainer, self.groups,
                                    staleness=trainer.staleness,
                                    apply_fn=self._apply)
        self._round_t0: Optional[float] = None
        self._blocked_s = 0.0
        self.last_overlap_fraction = 0.0
        obs_events.emit(
            "async.armed", groups=len(self.groups),
            staleness=self.updater.staleness,
            resync_period=self.resync_period,
            group_params=group_param_counts(trainer.params, self.groups))

    def _apply(self, gid: int, grads: list, epoch: int) -> None:
        """One group's updater math, in place (``apply_all`` over the
        group's tensors)."""
        with torch.no_grad():
            self.trainer._apply_updates(self.groups[gid], grads, epoch)

    def _exchange(self, gid: int, grads: Dict[Tuple[str, str], torch.Tensor],
                  loss: Optional[torch.Tensor]):
        """Start group ``gid``'s all-gather: ``(work, parts)``."""
        flat = [grads[kt].reshape(-1) for kt in self.groups[gid]]
        if loss is not None:
            flat.append(loss.float().reshape(1))
        return pdist.all_gather_async(torch.cat(flat),
                                      self.trainer.mesh_plan.data_group)

    def step(self, names: Sequence[Tuple[str, str]],
             grads: Sequence[torch.Tensor], loss: torch.Tensor,
             epoch: int) -> torch.Tensor:
        """One async step over this rank's gradients ``grads`` (of the
        tensors ``names``) and loss: each group's exchange, fold, push
        and pull_req, last group first.  Returns the folded loss."""
        if self._round_t0 is None:
            self._round_t0 = time.perf_counter()
            self._blocked_s = 0.0
        by_name = dict(zip((tuple(n) for n in names), grads))
        order = list(range(len(self.groups) - 1, -1, -1))
        pending = self._exchange(order[0], by_name, loss)
        total = loss
        for i, gid in enumerate(order):
            work, parts = pending
            if i + 1 < len(order):
                # the next group's exchange goes out before this one folds
                pending = self._exchange(order[i + 1], by_name, None)
            if work is not None:
                work.wait()
            buf = self._fold(parts)
            folded, off = [], 0
            for kt in self.groups[gid]:
                g = by_name[kt]
                folded.append(buf[off:off + g.numel()].view_as(g))
                off += g.numel()
            if i == 0:
                total = buf[off]
            self.updater.push(gid, folded, epoch)
            self.updater.pull_req(gid)
        return total

    def add_blocked(self, dt: float) -> None:
        """Host time blocked outside the stepper (the divergence guard's
        and the train metrics' fetches) counts against the round's
        overlap fraction."""
        if self._round_t0 is not None:
            self._blocked_s += dt

    def round_end(self, round_: int) -> bool:
        """The round-boundary fence; every ``async_resync_period`` rounds
        the buffers are drained first (the hard re-sync barrier).  Sets
        ``async_overlap_fraction``; True when this boundary resynced."""
        resync = (round_ % self.resync_period) == 0
        drained = self.updater.drain() if resync else 0
        t0 = time.perf_counter()
        self.trainer.sync()
        self._blocked_s += time.perf_counter() - t0
        now = time.perf_counter()
        wall = (now - self._round_t0) if self._round_t0 else 0.0
        frac = max(0.0, 1.0 - self._blocked_s / wall) if wall > 0 else 0.0
        self.last_overlap_fraction = frac
        _overlap_gauge().set(frac)
        if resync:
            obs_events.emit("async.resync", round=round_, drained=drained,
                            overlap_fraction=round(frac, 4))
        self._round_t0 = None
        return resync

    def snapshot(self) -> dict:
        d = self.updater.snapshot()
        d["overlap_fraction"] = round(self.last_overlap_fraction, 4)
        d["resync_period"] = self.resync_period
        return d
