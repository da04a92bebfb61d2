"""Lightweight span tracing: context-manager spans → Chrome trace JSON.

The port's copy of ``cxxnet_tpu/obs/trace.py``.  These spans answer
"what is the HOST doing" — checkpoint writes, batch coalescing, round
phases — at near-zero cost; the export is Chrome trace-event JSON,
loadable in ``chrome://tracing`` / Perfetto beside a ``torch.profiler``
trace of the card.

* :func:`span` — a context manager; nesting is tracked per thread
  (thread-local parent stack), so a span records its parent id and the
  viewer shows host call trees per thread.
* completed spans land in a **bounded ring** (oldest evicted).
* config keys (via :func:`configure`): ``trace_dir`` enables tracing
  and names the output directory; ``trace_steps`` (default 50) sizes
  the train-loop capture window — the round loop calls :func:`step`
  once per training step and the window's spans are flushed to
  ``<trace_dir>/host_trace_<start>-<end>.json`` when it closes;
  ``trace_ring`` (default 4096) bounds the ring.

When tracing is disabled (the default), :func:`span` returns a shared
no-op context manager — one attribute load and two no-op calls on the
hot path, no allocation.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Span", "Tracer", "tracer", "span", "configure", "step"]

ConfigEntry = Tuple[str, str]


class Span:
    """One completed span (immutable once recorded)."""

    __slots__ = ("name", "cat", "start_us", "dur_us", "tid", "thread_name",
                 "span_id", "parent_id", "args")

    def __init__(self, name, cat, start_us, dur_us, tid, thread_name,
                 span_id, parent_id, args) -> None:
        self.name = name
        self.cat = cat
        self.start_us = start_us
        self.dur_us = dur_us
        self.tid = tid
        self.thread_name = thread_name
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args

    def to_event(self, pid: int) -> Dict[str, object]:
        from .events import _jsonable

        # span args are caller-supplied (set(shape=np.int64(...)) is
        # legal API use) — coerce so export can never throw mid-train
        args = {k: _jsonable(v) for k, v in (self.args or {}).items()}
        args["span_id"] = self.span_id
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        return {
            "name": self.name,
            "cat": self.cat or "host",
            "ph": "X",
            "ts": self.start_us,
            "dur": self.dur_us,
            "pid": pid,
            "tid": self.tid,
            "args": args,
        }


class _NopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **args) -> None:
        return None


_NOP = _NopSpan()


class _LiveSpan:
    """An open span; records itself into the tracer ring on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0",
                 "span_id", "parent_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.span_id = None
        self.parent_id = None
        self._t0 = 0.0

    def set(self, **args) -> None:
        """Attach key/values to the span after entry (results, counts)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __enter__(self) -> "_LiveSpan":
        tr = self._tracer
        self.span_id = tr._next_id()
        stack = tr._stack()
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        th = threading.current_thread()
        tr._record(Span(
            self.name, self.cat,
            start_us=(self._t0 - tr._epoch) * 1e6,
            dur_us=(t1 - self._t0) * 1e6,
            tid=th.ident or 0, thread_name=th.name,
            span_id=self.span_id, parent_id=self.parent_id,
            args=self.args,
        ))


class Tracer:
    """Bounded ring of completed spans + the train-step capture window."""

    def __init__(self, ring: int = 4096) -> None:
        self._lock = threading.Lock()
        self._ring_size = max(1, int(ring))
        self._ring: List[Span] = []
        self._tls = threading.local()
        self._id = 0
        self._epoch = time.perf_counter()
        self.enabled = False
        self.trace_dir = ""
        self.trace_steps = 50
        self.dropped = 0
        # train-loop capture window state
        self._win_start: Optional[int] = None
        self._win_done = False

    # config -------------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        if name == "trace_dir":
            self.trace_dir = val
            self.enabled = bool(val)
        elif name == "trace_steps":
            self.trace_steps = int(val)
        elif name == "trace_ring":
            with self._lock:
                self._ring_size = max(1, int(val))

    def configure(self, cfg: Sequence[ConfigEntry]) -> None:
        for n, v in cfg:
            self.set_param(n, v)

    def enable(self, ring: Optional[int] = None) -> None:
        """Programmatic enable (tests / embedding use; no auto-flush)."""
        if ring is not None:
            with self._lock:
                self._ring_size = max(1, int(ring))
        self.enabled = True

    def reset(self) -> None:
        with self._lock:
            self._ring = []
            self.dropped = 0
        self.enabled = False
        self.trace_dir = ""
        self.trace_steps = 50
        self._win_start = None
        self._win_done = False

    # span recording -----------------------------------------------------
    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _record(self, s: Span) -> None:
        with self._lock:
            self._ring.append(s)
            if len(self._ring) > self._ring_size:
                drop = len(self._ring) - self._ring_size
                del self._ring[:drop]
                self.dropped += drop

    def span(self, name: str, cat: str = "", **args):
        """Open a span; use as ``with tracer().span("checkpoint.write"):``.
        Returns a shared no-op when tracing is disabled."""
        if not self.enabled:
            return _NOP
        return _LiveSpan(self, name, cat, args or None)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring = []

    # export -------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, object]:
        pid = os.getpid()
        spans = self.spans()
        events: List[Dict[str, object]] = []
        seen_tids = {}
        for s in spans:
            seen_tids.setdefault(s.tid, s.thread_name)
        for tid, tname in sorted(seen_tids.items()):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        events.extend(s.to_event(pid) for s in spans)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the ring as Chrome trace JSON; returns the path.
        Atomic, so a crash mid-export can't leave a half-written trace
        that chrome://tracing rejects."""
        from ..utils import diskio

        diskio.write_atomic(
            path, json.dumps(self.to_chrome_trace()).encode("utf-8"),
            site=None)
        return path

    # train-loop capture window ------------------------------------------
    def step(self, global_step: int) -> None:
        """Called once per training step.  With ``trace_dir`` set, the
        FIRST ``trace_steps`` steps are captured (spans are recording
        the whole time — the window only decides when to flush), then
        the ring is exported once and tracing disables itself (one
        window a process)."""
        if not self.enabled or not self.trace_dir or self._win_done:
            return
        if self._win_start is None:
            self._win_start = global_step
        if global_step - self._win_start + 1 >= self.trace_steps:
            self.flush_window(global_step)

    def flush_window(self, end_step: Optional[int] = None) -> Optional[str]:
        """Export the current window (round end / close); idempotent."""
        if not self.trace_dir or self._win_done or self._win_start is None:
            return None
        self._win_done = True
        # one-window discipline holds even when the export fails (full
        # disk): recording stops either way, the hot path must not keep
        # paying span cost for a trace that can no longer be written
        self.enabled = False
        path = os.path.join(
            self.trace_dir,
            f"host_trace_{self._win_start:06d}-"
            f"{(end_step if end_step is not None else self._win_start):06d}"
            ".json",
        )
        try:
            return self.export(path)
        except (OSError, TypeError, ValueError):
            # the flush runs inside the train loop — a full disk or a
            # pathological span must never abort the round
            return None


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-wide tracer."""
    return _TRACER


def span(name: str, cat: str = "", **args):
    """Module-level convenience: ``with obs.span("serve.batch"): ...``."""
    return _TRACER.span(name, cat, **args)


def configure(cfg: Sequence[ConfigEntry]) -> None:
    _TRACER.configure(cfg)


def step(global_step: int) -> None:
    _TRACER.step(global_step)
