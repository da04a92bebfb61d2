"""Fault handling: the stall watchdog, the retry policy, the breaker.

The port's copy of three pieces of ``cxxnet_tpu/utils/faults.py``:
``Watchdog`` (the serving batcher and the prefetch thread),
``RetryPolicy`` (transient I/O retried with backoff: the serving
engine's checkpoint loads) and ``CircuitBreaker`` (the hot-reload
breaker).  The fault-injection registry (``fault_point``) and the
bad-record budget wait for the imgbin chain (ROADMAP.md).
"""

from __future__ import annotations

import random
import sys
import threading
import time
import traceback
import zlib
from typing import Callable, Dict, Optional, Tuple


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


# ----------------------------------------------------------------------
# retry
def _cfg_get(cfg, name, default):
    """The last value of ``name`` in ``(name, value)`` pairs, else
    ``default``."""
    out = default
    for n, v in cfg or ():
        if n == name:
            out = v
    return out


class RetryPolicy:
    """Transient-failure retry: exponential backoff with deterministic
    jitter and a total deadline.  ``attempts`` bounds the tries;
    ``deadline_s > 0`` also bounds the total time (the policy re-raises
    rather than start a sleep that would cross it).  The jitter comes
    from an RNG seeded per policy and call site, so a schedule
    replays."""

    def __init__(self, attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: float = 0.25,
                 deadline_s: float = 0.0,
                 exceptions: Tuple[type, ...] = (OSError,),
                 seed: int = 0) -> None:
        if attempts < 1:
            raise ValueError("RetryPolicy: attempts must be >= 1")
        self.attempts = int(attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline_s = float(deadline_s)
        self.exceptions = tuple(exceptions)
        self.seed = int(seed)

    @classmethod
    def from_cfg(cls, cfg, **overrides) -> "RetryPolicy":
        """From the keys ``retry_attempts``, ``retry_base_delay``
        (seconds), ``retry_max_delay``, ``retry_jitter`` and
        ``retry_deadline_s``."""
        kw = dict(
            attempts=int(_cfg_get(cfg, "retry_attempts", 4)),
            base_delay=float(_cfg_get(cfg, "retry_base_delay", 0.05)),
            max_delay=float(_cfg_get(cfg, "retry_max_delay", 2.0)),
            jitter=float(_cfg_get(cfg, "retry_jitter", 0.25)),
            deadline_s=float(_cfg_get(cfg, "retry_deadline_s", 0.0)),
        )
        kw.update(overrides)
        return cls(**kw)

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        d = min(self.base_delay * (2 ** (attempt - 1)), self.max_delay)
        if self.jitter > 0:
            d *= 1.0 + self.jitter * rng.random()
        return d

    def run(self, fn: Callable, what: str = "I/O", silent: bool = False,
            _sleep: Callable[[float], None] = time.sleep,
            _clock: Callable[[], float] = time.monotonic):
        """Run ``fn()`` under the policy; the last failure propagates."""
        rng = random.Random(self.seed ^ zlib.crc32(what.encode()))
        t0 = _clock()
        for k in range(1, self.attempts + 1):
            try:
                return fn()
            except self.exceptions as e:
                if k == self.attempts:
                    raise
                delay = self.delay_for(k, rng)
                if (self.deadline_s > 0
                        and _clock() - t0 + delay > self.deadline_s):
                    if not silent:
                        print(f"{what} failed ({type(e).__name__}: {e}); "
                              f"retry deadline {self.deadline_s:.2f}s "
                              "exhausted, giving up", flush=True)
                    raise
                if not silent:
                    print(f"{what} failed ({type(e).__name__}: {e}); "
                          f"retry {k}/{self.attempts - 1} in {delay:.2f}s",
                          flush=True)
                _sleep(delay)


# ----------------------------------------------------------------------
# circuit breaker
class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open -> half-open).

    ``failure_threshold`` consecutive failures open it: :meth:`allow`
    returns False until ``cooldown_s`` has passed, then lets one trial
    through (half-open); the trial's success closes the breaker, its
    failure opens it again and restarts the cooldown.  ``clock`` is
    injectable for tests.  Thread-safe."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self.total_failures = 0
        self.total_successes = 0
        self.times_opened = 0

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == "open"
                    and self._clock() - self._opened_at >= self.cooldown_s):
                return "half-open"
            return self._state

    def allow(self) -> bool:
        """May the protected operation run now?  The caller that sees
        the cooldown over claims the half-open trial, and the cooldown
        is re-armed so concurrent callers do not all pass."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._opened_at = self._clock()
                self._state = "half-open"
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.total_successes += 1
            self._consecutive = 0
            self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self.total_failures += 1
            self._consecutive += 1
            if (self._state == "half-open"
                    or self._consecutive >= self.failure_threshold):
                if self._state != "open":
                    self.times_opened += 1
                self._state = "open"
                self._opened_at = self._clock()

    def snapshot(self) -> Dict[str, object]:
        return {
            "state": self.state,
            "consecutive_failures": self._consecutive,
            "total_failures": self.total_failures,
            "total_successes": self.total_successes,
            "times_opened": self.times_opened,
        }
