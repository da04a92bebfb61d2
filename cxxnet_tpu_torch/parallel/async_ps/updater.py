"""Push / PullReq / PullWait: the bounded-staleness async updater.

The port's ``cxxnet_tpu/parallel/async_ps/updater.py``: the reference's
``IAsyncUpdater`` contract per gradient-exchange group, over the
trainer's updaters.

* :meth:`AsyncUpdater.push` enqueues a group's folded gradient (a list
  of tensors, the group's in order), stamped with its step (the
  updaters' schedule position) and the membership generation;
* :meth:`AsyncUpdater.pull_req` applies the oldest aggregates until at
  most ``staleness`` stay pending: ``staleness = 0`` applies every push
  at once (the synchronous step, bitwise); ``staleness = k`` applies the
  k-step-old aggregate;
* :meth:`AsyncUpdater.pull_wait` waits for the card's queue before a
  host reader touches a group's weights (a no-op on the CPU);
* :meth:`AsyncUpdater.drain` applies everything pending in push order
  (every ``async_resync_period`` rounds and before a checkpoint);
* :meth:`AsyncUpdater.reset_staleness` drops everything pending and
  moves to a new generation; the apply re-checks each aggregate's
  stamp, so a dead generation's gradient is never applied.

Metrics on the port's ``obs`` registry: ``async_staleness_steps{group}``
(pending aggregates), ``async_pushes_total{group}``,
``async_stale_dropped_total{reason}``; events
``async.stale_generation_dropped`` and ``async.reset_staleness``.
"""

from __future__ import annotations

import collections
from typing import Callable, Deque, Dict, List, NamedTuple, Optional

import torch

from ...obs import events as obs_events
from ...obs.registry import registry as obs_registry
from .groups import GroupKey


class _Aggregate(NamedTuple):
    grads: list      # the group's folded gradients, in group order
    epoch: int       # origin step (the updater schedule position)
    generation: int  # membership generation the reduction ran under


def _staleness_gauge():
    return obs_registry().gauge(
        "async_staleness_steps",
        "Pending (not yet applied) gradient aggregates per exchange "
        "group — the staleness the next apply will carry.",
        labelnames=("group",))


def _pushes_counter():
    return obs_registry().counter(
        "async_pushes_total",
        "Gradient aggregates pushed into the async exchange buffers.",
        labelnames=("group",))


def _dropped_counter():
    return obs_registry().counter(
        "async_stale_dropped_total",
        "Buffered aggregates discarded instead of applied.",
        labelnames=("reason",))


class AsyncUpdater:
    """Bounded-staleness aggregate buffers over the trainer's updaters.

    ``apply_fn(gid, grads, epoch)`` applies one group's aggregate to
    its tensors in place (the stepper's, through the trainer's
    ``apply_all``)."""

    def __init__(self, trainer, groups: List[List[GroupKey]],
                 staleness: int = 0,
                 apply_fn: Optional[Callable] = None) -> None:
        self.trainer = trainer
        self.groups = groups
        self.staleness = max(0, int(staleness))
        self.generation = 0
        self._apply_fn = apply_fn
        self._pending: List[Deque[_Aggregate]] = [
            collections.deque() for _ in groups]
        self.pushes = 0
        self.applies = 0
        self.dropped = 0

    def pending_depth(self, gid: int) -> int:
        return len(self._pending[gid])

    def push(self, gid: int, grads: list, epoch: int) -> None:
        """Enqueue one group's folded gradient, generation-stamped."""
        self._pending[gid].append(
            _Aggregate(grads, int(epoch), self.generation))
        self.pushes += 1
        _pushes_counter().labels(group=str(gid)).inc()
        _staleness_gauge().labels(group=str(gid)).set(
            len(self._pending[gid]))

    def pull_req(self, gid: int) -> int:
        """Apply until at most ``staleness`` aggregates stay pending.
        Returns the applies made (a stale generation's discard is not
        one)."""
        n = 0
        while len(self._pending[gid]) > self.staleness:
            if self._apply_oldest(gid):
                n += 1
        return n

    def pull_wait(self, gid: int) -> None:
        """Wait until this group's weights are written: the card's queue
        on the tensors' device; a no-op on the CPU."""
        for key, tag in self.groups[gid]:
            w = self.trainer.params[key][tag]
            if w.is_cuda:
                torch.cuda.current_stream(w.device).synchronize()
                return

    def _apply_oldest(self, gid: int) -> bool:
        """Pop and apply one aggregate; False when the stamp check
        discarded it instead."""
        agg = self._pending[gid].popleft()
        _staleness_gauge().labels(group=str(gid)).set(
            len(self._pending[gid]))
        if agg.generation != self.generation:
            # reduced under a dead membership generation: never applied
            self.dropped += 1
            _dropped_counter().labels(reason="generation").inc()
            obs_events.emit("async.stale_generation_dropped", group=gid,
                            epoch=agg.epoch, aggregate_gen=agg.generation,
                            current_gen=self.generation)
            return False
        self._apply_fn(gid, agg.grads, agg.epoch)
        self.applies += 1
        return True

    def drain(self) -> int:
        """Apply every pending aggregate in push order (a stale
        generation's are discarded, not counted); the caller fences."""
        n = 0
        for gid in range(len(self.groups)):
            while self._pending[gid]:
                if self._apply_oldest(gid):
                    n += 1
        return n

    def reset_staleness(self, generation: Optional[int] = None,
                        reason: str = "rebuild") -> int:
        """Discard every pending aggregate and move to a new generation
        (``generation``, or the next).  Returns how many were dropped."""
        dropped = 0
        for gid, dq in enumerate(self._pending):
            dropped += len(dq)
            dq.clear()
            _staleness_gauge().labels(group=str(gid)).set(0)
        if dropped:
            self.dropped += dropped
            _dropped_counter().labels(reason=reason).inc(dropped)
        old = self.generation
        self.generation = (old + 1 if generation is None
                           else int(generation))
        obs_events.emit("async.reset_staleness", reason=reason,
                        dropped=dropped, old_generation=old,
                        generation=self.generation)
        return dropped

    def snapshot(self) -> Dict[str, object]:
        return {
            "groups": len(self.groups),
            "staleness": self.staleness,
            "generation": self.generation,
            "pending": [len(dq) for dq in self._pending],
            "pushes": self.pushes,
            "applies": self.applies,
            "dropped": self.dropped,
        }
