"""Knob factories: bind the controller to the tunable subsystems.

The controller itself is generic (``controller.py``); this module knows
where the live knobs actually live — the decode pool's worker/window
resize API (``io/pipeline.py``), the serve engine's micro-batcher
setters (``serve/engine.py``), the closed loop's fine-tune rounds
(``loop/continuous.py``) — and what sane bounds look like on the
current host.  Imports of io/serve stay inside the factory functions so
``cxxnet_tpu_torch.tune`` itself remains import-cheap for every layer.
"""

from __future__ import annotations

import os
from typing import List

from .controller import Knob

__all__ = ["find_pipeline", "pipeline_knobs", "batcher_knobs",
           "tenant_round_knobs"]


def find_pipeline(it):
    """Walk an iterator chain (``.base`` / ``.aug`` links) down to its
    :class:`~cxxnet_tpu_torch.io.pipeline.ParallelAugmentIterator`, or None
    when the chain has no parallel decode stage (csv/synthetic/...)."""
    from ..io.pipeline import ParallelAugmentIterator

    seen = set()
    while it is not None and id(it) not in seen:
        if isinstance(it, ParallelAugmentIterator):
            return it
        seen.add(id(it))
        it = getattr(it, "base", None) or getattr(it, "aug", None)
    return None


def pipeline_knobs(pipe) -> List[Knob]:
    """Decode-pool knobs over one ``ParallelAugmentIterator``:
    ``num_decode_workers`` (live pool resize; serial chains grow a pool
    at the next epoch boundary) and ``decode_queue_depth`` (in-flight
    chunk window, applied immediately)."""
    hi = max(4, 2 * (os.cpu_count() or 2))
    return [
        Knob("num_decode_workers",
             getter=lambda: max(1, pipe.num_workers),
             setter=pipe.request_workers,
             lo=1, hi=hi),
        Knob("decode_queue_depth",
             getter=lambda: max(1, pipe.queue_depth),
             setter=pipe.set_queue_depth,
             lo=1, hi=64),
    ]


def batcher_knobs(engine) -> List[Knob]:
    """Micro-batcher knobs over one serve :class:`Engine`:
    ``max_batch_size`` (prewarmed before it applies, so the first
    coalesced batch of a new bucket never pays its first forward) and
    ``batch_timeout_ms`` (live).  The engine's configured
    ``max_batch_size`` is the hard ceiling — it is also the request-
    size validation cap and the largest warmed bucket."""
    return [
        Knob("max_batch_size",
             getter=lambda: engine.batcher.max_batch_size,
             setter=engine.set_max_batch_size,
             lo=1, hi=engine.max_batch_size),
        Knob("batch_timeout_ms",
             getter=lambda: engine.batcher.batch_timeout * 1e3,
             setter=engine.set_batch_timeout_ms,
             lo=0.25, hi=50.0, integer=False),
    ]



def tenant_round_knobs(loops, max_rounds: int = 8) -> List[Knob]:
    """One knob per tenant loop: its fine-tune ``rounds_per_cycle``
    (live setter — the next cycle reads the new value).  These are the
    units the multi-tenant arbiter trades against the shared card
    (``loop/tenant.py``): more rounds for a tenant whose extra passes
    keep turning into published improvements, fewer for one whose
    feedback has gone stale."""
    return [
        Knob(f"tenant_rounds:{loop.name or i}",
             getter=(lambda lp=loop: lp.rounds_per_cycle),
             setter=(lambda v, lp=loop: lp.set_rounds_per_cycle(v)),
             lo=1, hi=max(2, int(max_rounds)))
        for i, loop in enumerate(loops)
    ]
