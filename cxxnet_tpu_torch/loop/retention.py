"""Feedback-log retention: compact consumed shards, crash-safely.

The port's copy of ``cxxnet_tpu/loop/retention.py``: it deletes the
shards the JAX package deletes over the same log.  A month of
million-user feedback must not eat the disk.  The cursor + ``.commit``
sidecar protocol makes *safe to delete* computable: a shard is
compactable exactly when

* it lies wholly **behind the consumed-and-published cursor** — the
  :class:`~cxxnet_tpu_torch.loop.continuous.ContinuousLoop` persists its
  cursor only after a cycle RESOLVES (published or rejected), so every
  page behind it has both been trained on and had its publish/reject
  decision recorded;
* it holds **no pending-lineage range** — records a cycle is training
  on right now (read but not yet resolved) must survive a crash so the
  cycle can replay them; and
* it is **not the writer's live shard** — an uncommitted buffered tail
  lives only there (implied by the cursor bound: the cursor can never
  pass uncommitted bytes).

Deletion order is crash-safe: the retention pointer
(``retention.json`` — ``{"compacted_below": k}``) is written atomically
and fsynced BEFORE any unlink.  A ``kill -9`` mid-sweep therefore
leaves either the old boundary with every file intact, or the new
boundary with some below-boundary orphans — readers ignore shards below
the boundary (``feedback_log.FeedbackReader``) and the next sweep
deletes the orphans, so every record a reader can reach stays
CRC-verified.  The reverse order would be a lie: unlink-then-pointer
crashed between the two leaves a boundary claiming deleted shards still
exist, and a stale cursor would silently skip instead of failing with
:class:`~cxxnet_tpu_torch.loop.feedback_log.StaleCursorError`.

Knobs: ``feedback_retain_shards`` keeps the newest N
fully-consumed shards as an operator re-read hedge (-1 disables
retention entirely — the serve_train default); ``feedback_retain_bytes``
only deletes while the log exceeds the byte bound (0 = unbounded
deletion of consumed shards).  Every sweep exports
``feedback_disk_bytes{tenant}`` / ``feedback_shards{tenant}`` and each
deleting sweep counts ``loop_compactions_total{tenant}`` /
``loop_compacted_bytes_total{tenant}`` and emits a ``loop.compact``
event naming the shards it reclaimed.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from ..utils import diskio
from ..utils.checkpoint import atomic_write_bytes
from .feedback_log import (
    COMMIT_SUFFIX,
    RETENTION_FILE,
    _read_commits,
    list_shards,
    read_retention,
)

__all__ = ["RetentionOptions", "Sweeper", "safe_boundary"]


class _RetentionMetrics:
    def __init__(self) -> None:
        reg = obs_registry()
        self.compactions = reg.counter(
            "loop_compactions_total",
            "Retention sweeps that deleted at least one feedback shard.",
            labelnames=("tenant",))
        self.compacted_bytes = reg.counter(
            "loop_compacted_bytes_total",
            "Feedback-log bytes reclaimed by retention compaction.",
            labelnames=("tenant",))
        self.disk_bytes = reg.gauge(
            "feedback_disk_bytes",
            "On-disk bytes of a tenant's feedback log (shards + "
            "sidecars), set at each retention sweep.",
            labelnames=("tenant",))
        self.shards = reg.gauge(
            "feedback_shards",
            "Shard files in a tenant's feedback log, set at each "
            "retention sweep.",
            labelnames=("tenant",))


_METRICS: Optional[_RetentionMetrics] = None
_METRICS_LOCK = threading.Lock()


def _metrics() -> _RetentionMetrics:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = _RetentionMetrics()
        return _METRICS


class RetentionOptions:
    """Parsed ``feedback_retain_*`` keys.  ``retain_shards < 0`` means
    retention is OFF (nothing is ever deleted)."""

    def __init__(self, retain_shards: int = -1,
                 retain_bytes: int = 0) -> None:
        self.retain_shards = int(retain_shards)
        self.retain_bytes = int(retain_bytes)

    @property
    def armed(self) -> bool:
        return self.retain_shards >= 0


def _shard_containing_seq(dir_: str, seq: int) -> Optional[int]:
    """Index of the shard whose committed pages cover lineage id
    ``seq``; None when no committed page claims it (legacy pages
    without ``seq0``, or the id is still buffered)."""
    for idx, path in list_shards(dir_):
        for ent in _read_commits(path):
            s0 = ent.get("seq0")
            if s0 is not None and s0 <= seq < s0 + int(ent["nrec"]):
                return idx
    return None


def safe_boundary(dir_: str, cursor: Dict,
                  pending_first_seq: Optional[int] = None) -> int:
    """The highest shard index ``k`` such that every shard below ``k``
    is safe to delete: wholly behind the resolved ``cursor`` and not
    holding the in-flight cycle's ``pending_first_seq``.  A pending id
    that cannot be located (legacy pages) conservatively freezes the
    boundary at 0 — never guess about data a crash would need."""
    k = int(cursor.get("shard", 0))
    if pending_first_seq is not None:
        holder = _shard_containing_seq(dir_, int(pending_first_seq))
        if holder is None:
            return 0
        k = min(k, holder)
    return k


def _dir_stats(dir_: str) -> Tuple[int, int]:
    """(shard_count, total_bytes incl. sidecars) of a feedback dir."""
    shards = list_shards(dir_)
    total = 0
    for _idx, path in shards:
        for p in (path, path + COMMIT_SUFFIX):
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
    return len(shards), total


class Sweeper:
    """One tenant's retention policy bound to its feedback directory.

    :meth:`sweep` is idempotent and cheap when there is nothing to do;
    the :class:`~cxxnet_tpu_torch.loop.continuous.ContinuousLoop` calls it at
    the end of every cycle (and the tenant manager on every tick), so
    the log's disk footprint tracks consumption instead of history.
    """

    def __init__(self, dir_: str, opts: RetentionOptions,
                 tenant: str = "default", silent: bool = True) -> None:
        self.dir = dir_
        self.opts = opts
        self.tenant = tenant
        self.silent = silent
        self._m = _metrics()

    # ------------------------------------------------------------------
    def sweep(self, cursor: Dict,
              pending_first_seq: Optional[int] = None) -> Dict:
        """One compaction pass; returns ``{deleted_shards,
        deleted_bytes, compacted_below, disk_bytes, shards}``.

        Delete order per shard: the retention pointer covering the
        whole batch is fsynced FIRST, then shards unlink oldest-first
        (data file before sidecar — a surviving sidecar for a missing
        file is below the boundary and ignored either way)."""
        out = {"deleted_shards": 0, "deleted_bytes": 0}
        if not self.opts.armed:
            return self._finish(out)
        boundary = safe_boundary(self.dir, cursor, pending_first_seq)
        prev_below = read_retention(self.dir)["compacted_below"]
        shards = list_shards(self.dir)
        # candidates: consumed shards below the safe boundary, minus
        # the newest retain_shards of them (the operator re-read hedge)
        candidates = [(idx, path) for idx, path in shards
                      if idx < boundary]
        if self.opts.retain_shards > 0:
            candidates = candidates[: -self.opts.retain_shards] \
                if len(candidates) > self.opts.retain_shards else []
        # byte bound: only delete while the log exceeds retain_bytes
        _, total_bytes = _dir_stats(self.dir)
        doomed: List[Tuple[int, str, int]] = []
        for idx, path in candidates:
            if self.opts.retain_bytes > 0 and total_bytes <= \
                    self.opts.retain_bytes:
                break
            size = 0
            for p in (path, path + COMMIT_SUFFIX):
                try:
                    size += os.path.getsize(p)
                except OSError:
                    pass
            doomed.append((idx, path, size))
            total_bytes -= size
        new_below = max(prev_below,
                        (doomed[-1][0] + 1) if doomed else 0)
        if new_below > prev_below:
            # the crash-safety pivot: boundary durable BEFORE unlink
            atomic_write_bytes(
                os.path.join(self.dir, RETENTION_FILE),
                json.dumps({"compacted_below": new_below}).encode("utf-8"))
        # idempotent cleanup: everything below the (possibly
        # pre-existing) boundary goes, including orphans a previous
        # crashed sweep left behind
        for idx, path in list_shards(self.dir):
            if idx >= new_below:
                continue
            size = 0
            for p in (path, path + COMMIT_SUFFIX):
                try:
                    size += os.path.getsize(p)
                    diskio.unlink(p)
                except OSError:
                    pass  # already gone / transient: next sweep retries
            out["deleted_shards"] += 1
            out["deleted_bytes"] += size
        if out["deleted_shards"]:
            self._m.compactions.labels(tenant=self.tenant).inc()
            self._m.compacted_bytes.labels(tenant=self.tenant).inc(
                out["deleted_bytes"])
            obs_events.emit(
                "loop.compact", tenant=self.tenant,
                deleted_shards=out["deleted_shards"],
                deleted_bytes=out["deleted_bytes"],
                compacted_below=new_below)
            if not self.silent:
                print(f"loop[{self.tenant}]: compacted "
                      f"{out['deleted_shards']} shard(s), "
                      f"{out['deleted_bytes']} bytes reclaimed "
                      f"(boundary {new_below})", flush=True)
        out["compacted_below"] = new_below
        return self._finish(out)

    def _finish(self, out: Dict) -> Dict:
        nshards, nbytes = _dir_stats(self.dir)
        self._m.disk_bytes.labels(tenant=self.tenant).set(nbytes)
        self._m.shards.labels(tenant=self.tenant).set(nshards)
        out["disk_bytes"] = nbytes
        out["shards"] = nshards
        out.setdefault("compacted_below",
                       read_retention(self.dir)["compacted_below"])
        return out
