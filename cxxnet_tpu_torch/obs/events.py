"""Structured event log: lifecycle facts as rotating JSONL.

The port's copy of ``cxxnet_tpu/obs/events.py``.  Metrics say how
MUCH; events say WHAT HAPPENED: checkpoint saves and restores, hot
reloads, quarantined records, fault injections, watchdog fires,
divergence-guard trips, preemption snapshots.  Each event is one JSON
object per line — ``{"ts": <unix seconds>, "kind": "checkpoint.save",
...fields}`` — the JAX package's records, key for key.

Behavior:

* an **in-memory ring** (bounded, ``event_log_ring``) always records,
  file or not — tests and introspection read :func:`recent`;
* a **file sink** activates when ``event_log = <path>`` is configured,
  with size-based rotation (``event_log_max_bytes``, default 4 MiB;
  ``event_log_backups``, default 2: ``events.jsonl`` → ``.1`` → ``.2``);
* :func:`emit` **never raises** — observability must not take down the
  thing it observes; write failures are counted (``dropped``,
  ``events_dropped_total{sink,reason}``) and, for
  ``event_log_holdoff_s`` after one, the file sink is skipped while the
  ring keeps recording;
* every emit bumps the ``obs_events_total{kind=...}`` counter in the
  metrics registry, so event rates are scrapeable from ``/metricsz``;
* :func:`log_exception_once` deduplicates noisy failure sites: the
  first exception per key is logged in full, repeats only count.

The file operations go through ``utils/diskio.py``: the append at the
``obs.append`` fault site, the rotation through ``diskio.truncate``,
``unlink`` and ``replace``, so a recording sees every one of them.
"""

from __future__ import annotations

import collections
import errno
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from . import registry as _registry

__all__ = [
    "EventLog",
    "event_log",
    "emit",
    "recent",
    "configure",
    "log_exception_once",
    "record_drop",
]

ConfigEntry = Tuple[str, str]


def _jsonable(v):
    """Coerce a field value to something json.dumps accepts (events must
    never raise; a numpy scalar or Path in a field is not an error)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
    except Exception:  # noqa: BLE001 - numpy optional here
        pass
    return str(v)


class EventLog:
    """One rotating JSONL sink + in-memory ring (see module docstring)."""

    def __init__(self, ring: int = 512) -> None:
        # reentrant: a failing file write reports through the diskio
        # layer, whose disk-full accounting emits right back here
        self._lock = threading.RLock()
        self._ring: Deque[dict] = collections.deque(maxlen=max(1, int(ring)))
        self.path: Optional[str] = None
        self.max_bytes = 4 << 20
        self.backups = 2
        self.dropped = 0
        #: bounded drop under a sick disk: after a write failure the
        #: file sink is skipped (events counted, ring still recording)
        #: for this long, instead of re-running makedirs + rotation +
        #: open against a full disk on EVERY event
        self.holdoff_s = 2.0
        self._skip_until = 0.0
        self._skip_reason = "io"
        self._once_counts: Dict[str, int] = {}
        self._counter = None  # obs_events_total, created lazily
        self._drop_counter = None  # events_dropped_total, lazy
        # file-sink re-entrancy guard: writing an event can itself emit
        # (a fault firing at the obs.append site, disk-full accounting
        # in diskio) — nested events go to the ring only, never back
        # into the file write that is already on this thread's stack
        self._tls = threading.local()

    # config -------------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        if name == "event_log":
            self.path = val or None
        elif name == "event_log_max_bytes":
            self.max_bytes = max(1024, int(val))
        elif name == "event_log_backups":
            self.backups = max(0, int(val))
        elif name == "event_log_holdoff_s":
            self.holdoff_s = max(0.0, float(val))
        elif name == "event_log_ring":
            with self._lock:
                self._ring = collections.deque(
                    self._ring, maxlen=max(1, int(val))
                )

    def configure(self, cfg: Sequence[ConfigEntry]) -> None:
        for n, v in cfg:
            self.set_param(n, v)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._once_counts.clear()
        self.path = None
        self.max_bytes = 4 << 20
        self.backups = 2
        self.dropped = 0
        self.holdoff_s = 2.0
        self._skip_until = 0.0
        self._skip_reason = "io"

    # emission -----------------------------------------------------------
    def _count(self, kind: str) -> None:
        try:
            if self._counter is None:
                self._counter = _registry.registry().counter(
                    "obs_events_total",
                    "Structured events emitted, by kind.",
                    labelnames=("kind",),
                )
            self._counter.labels(kind=kind).inc()
        except Exception:  # noqa: BLE001 - never raise from emit
            pass

    def record_drop(self, sink: str, reason: str) -> None:
        """Count one dropped observability record:
        ``events_dropped_total{sink,reason}`` (``reason="disk"`` is the
        full-disk degrade path)."""
        try:
            if self._drop_counter is None:
                self._drop_counter = _registry.registry().counter(
                    "events_dropped_total",
                    "Observability records dropped by the file sink "
                    "(bounded degrade; the ring keeps recording).",
                    labelnames=("sink", "reason"),
                )
            self._drop_counter.labels(sink=sink, reason=reason).inc()
        except Exception:  # noqa: BLE001 - never raise from emit
            pass

    def _rotate_locked(self, need: int) -> None:
        """Rotate ``path`` when appending ``need`` bytes would cross
        ``max_bytes``.  Caller holds the lock."""
        from ..utils import diskio

        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size + need <= self.max_bytes:
            return
        if self.backups <= 0:
            # no backups: truncate in place
            diskio.truncate(self.path, 0)
            return
        oldest = f"{self.path}.{self.backups}"
        if os.path.exists(oldest):
            diskio.unlink(oldest)
        for i in range(self.backups - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                diskio.replace(src, f"{self.path}.{i + 1}")
        diskio.replace(self.path, f"{self.path}.1")

    def emit(self, kind: str, /, **fields) -> dict:
        """Record one event; returns the record.  Never raises.

        ``kind`` is positional-only so a field may itself be named
        ``kind``; field names colliding with the envelope (``ts`` /
        ``kind``) are stored with a ``_`` suffix rather than clobbering
        it."""
        rec = {"ts": time.time(), "kind": str(kind)}
        for k, v in fields.items():
            k = str(k)
            if k in ("ts", "kind"):
                k += "_"
            rec[k] = _jsonable(v)
        try:
            line = json.dumps(rec, separators=(",", ":"))
        except Exception:  # noqa: BLE001 - _jsonable should prevent this
            rec = {"ts": rec["ts"], "kind": rec["kind"],
                   "error": "unserializable fields"}
            line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            self._ring.append(rec)
            if self.path and getattr(self._tls, "writing", False):
                pass  # nested emit inside a file write: ring only
            elif self.path:
                if time.monotonic() < self._skip_until:
                    # bounded drop: the file sink failed recently; skip
                    # the I/O attempt entirely until the holdoff passes
                    self.dropped += 1
                    self.record_drop("events", self._skip_reason)
                else:
                    self._tls.writing = True
                    try:
                        d = os.path.dirname(self.path)
                        if d:
                            os.makedirs(d, exist_ok=True)
                        self._rotate_locked(len(line) + 1)
                        from ..utils import diskio

                        diskio.append_bytes(
                            self.path, (line + "\n").encode("utf-8"),
                            site="obs.append")
                    except OSError as e:
                        self.dropped += 1
                        reason = ("disk" if getattr(e, "errno", None)
                                  == errno.ENOSPC else "io")
                        self._skip_reason = reason
                        self._skip_until = (time.monotonic()
                                            + self.holdoff_s)
                        self.record_drop("events", reason)
                    finally:
                        self._tls.writing = False
        self._count(rec["kind"])
        return rec

    def emit_once(self, key: str, kind: str, **fields) -> bool:
        """Emit at most once per ``key`` (process lifetime) — for
        recurring facts a poll loop would otherwise flood the log with
        (e.g. the same invalid checkpoint skipped every reload poll).
        Repeats only count (:meth:`suppressed_count`).  Returns True
        when this call actually emitted."""
        with self._lock:
            n = self._once_counts.get(key, 0)
            self._once_counts[key] = n + 1
        if n:
            return False
        self.emit(kind, key=key, deduped=True, **fields)
        return True

    def log_exception_once(self, key: str, exc: BaseException,
                          kind: str = "error", **fields) -> bool:
        """:meth:`emit_once` for exceptions: the first failure per
        ``key`` is logged in full, repeats only count.  Returns True
        when this call actually emitted."""
        return self.emit_once(key, kind,
                              error=f"{type(exc).__name__}: {exc}",
                              **fields)

    def suppressed_count(self, key: str) -> int:
        """How many times ``key`` fired (including the logged first)."""
        with self._lock:
            return self._once_counts.get(key, 0)

    # reading ------------------------------------------------------------
    def recent(self, n: int = 50, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [r for r in out if r.get("kind") == kind]
        return out[-n:]


_LOG = EventLog()


def event_log() -> EventLog:
    """The process-wide event log."""
    return _LOG


def emit(kind: str, /, **fields) -> dict:
    return _LOG.emit(kind, **fields)


def emit_once(key: str, kind: str, **fields) -> bool:
    return _LOG.emit_once(key, kind, **fields)


def recent(n: int = 50, kind: Optional[str] = None) -> List[dict]:
    return _LOG.recent(n, kind)


def configure(cfg: Sequence[ConfigEntry]) -> None:
    _LOG.configure(cfg)


def log_exception_once(key: str, exc: BaseException,
                       kind: str = "error", **fields) -> bool:
    return _LOG.log_exception_once(key, exc, kind, **fields)


def record_drop(sink: str, reason: str) -> None:
    """Count one dropped observability record (telemetry.jsonl uses
    this; the event sink counts its own drops internally)."""
    _LOG.record_drop(sink, reason)
