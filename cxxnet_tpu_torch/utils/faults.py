"""Fail-fast stall detection for background workers.

The port's copy of ``Watchdog`` from ``cxxnet_tpu/utils/faults.py``,
used by the serving batcher and the prefetch thread (the
fault-injection registry and the circuit breaker belong to later
slices).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Optional


class WatchdogError(RuntimeError):
    """A monitored worker made no progress within the watchdog timeout."""


class Watchdog:
    """The worker calls :meth:`beat` on every unit of progress; a blocked
    consumer calls :meth:`wait`, which raises :class:`WatchdogError` —
    with the worker thread's current stack in the message — once no beat
    has landed for ``timeout_s``.  ``timeout_s <= 0`` disables it."""

    def __init__(self, what: str = "worker", timeout_s: float = 600.0,
                 thread: Optional[threading.Thread] = None) -> None:
        self.what = what
        self.timeout_s = float(timeout_s)
        self.thread = thread
        self._last = time.monotonic()

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def beat(self) -> None:
        self._last = time.monotonic()

    def diagnostic(self, dt: float) -> str:
        msg = (f"{self.what} made no progress for {dt:.1f}s "
               f"(watchdog_timeout_s={self.timeout_s:g}); failing fast "
               "instead of blocking forever")
        t = self.thread
        if t is not None:
            if not t.is_alive():
                return msg + f"; thread {t.name!r} is DEAD"
            frame = sys._current_frames().get(t.ident)
            if frame is not None:
                stack = "".join(traceback.format_stack(frame))
                msg += f"\nhung thread {t.name!r} stack:\n{stack}"
        return msg

    def check(self) -> None:
        """Raise :class:`WatchdogError` when no beat has landed for
        ``timeout_s`` (a consumer polling a queue calls this)."""
        if not self.enabled:
            return
        dt = time.monotonic() - self._last
        if dt > self.timeout_s:
            raise WatchdogError(self.diagnostic(dt))

    def wait(self, event: threading.Event, poll: float = 0.2,
             since: Optional[float] = None) -> None:
        """Block on ``event`` with stall checks; raises on a stall.
        ``since`` anchors the stall window for this waiter, so a worker
        that was idle before the wait began is not mistaken for hung."""
        if not self.enabled:
            event.wait()
            return
        if since is None:
            since = time.monotonic()
        while not event.wait(min(poll, self.timeout_s)):
            dt = time.monotonic() - max(self._last, since)
            if dt > self.timeout_s:
                raise WatchdogError(self.diagnostic(dt))
