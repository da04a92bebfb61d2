"""Fault handling: injection, the bad-record budget, the stall watchdog,
the retry policy, the breaker.

The port's copy of these pieces of ``cxxnet_tpu/utils/faults.py``:

* the fault-injection registry (``FaultInjector``, ``fault_point``,
  ``install``, ``configure``, ``reset``): ``fault_inject =
  site:kind:prob[:limit]`` arms a site, ``fault_seed`` seeds its draws
  (one RNG per site and kind, so a schedule replays).  The port visits
  the sites of its data chain (``imgbin.page``, ``imgbin.record``,
  ``pipeline.worker``, ``prefetch.producer``, ``csv.read``, ``csv.row``,
  ``libsvm.read``, ``libsvm.row``, ``text.read``), of its durable
  writers (``checkpoint.write``, ``checkpoint.read``, ``obs.append``,
  through ``utils/diskio.py``), of the server (``serve.batch``,
  ``serve.reload``), of the live train state (``device.state``), of the
  closed loop's feedback log (``loop.append``, ``loop.commit``), of
  the data service's client (``dataservice.rpc``), of the serving
  fleet's replicas (``serve.replica``) and of the group's step fence
  (``mesh.replica``, in ``NetTrainer.sync``): every site of the JAX
  package;
* ``BadRecordBudget``: skip-and-quarantine accounting with its
  ``.quarantine`` sidecar (``max_bad_records`` of the imgbin chain and
  the text readers);
* ``Watchdog`` (the serving batcher, the prefetch thread, the decode
  pool), ``RetryPolicy`` (transient I/O retried with backoff: the
  serving engine's checkpoint loads, the text readers' file reads,
  ``retried_read_lines``) and ``CircuitBreaker`` (the hot-reload
  breaker).

Each fault that fires emits ``fault.injected`` and counts in
``faults_injected_total{site,kind}``; a quarantined record emits
``data.quarantined``, a budget past its limit ``data.budget_exceeded``
and a stall ``watchdog.fire`` (``obs/events.py``), as in the JAX
package.
"""

from __future__ import annotations

import errno
import os
import random
import sys
import threading
import time
import traceback
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry

#: Every injection site of the JAX package and the fault kinds it takes.
SITES: Dict[str, Tuple[str, ...]] = {
    "imgbin.page": ("ioerror", "corrupt", "latency", "hang"),
    "imgbin.record": ("corrupt",),
    "csv.read": ("ioerror", "latency"),
    "csv.row": ("corrupt",),
    "libsvm.read": ("ioerror", "latency"),
    "libsvm.row": ("corrupt",),
    "text.read": ("ioerror", "latency"),
    "prefetch.producer": ("latency", "hang"),
    "pipeline.worker": ("latency", "hang"),
    "checkpoint.write": ("ioerror", "latency", "enospc", "short"),
    "checkpoint.read": ("ioerror", "latency"),
    "serve.reload": ("ioerror", "latency"),
    "serve.batch": ("ioerror", "latency", "hang"),
    "loop.append": ("ioerror", "latency", "enospc"),
    "loop.commit": ("ioerror", "enospc", "short"),
    "obs.append": ("ioerror", "enospc"),
    "mesh.replica": ("hang", "ioerror", "latency"),
    "serve.replica": ("hang", "ioerror"),
    "dataservice.rpc": ("ioerror", "latency", "hang"),
    "device.state": ("bitflip",),
}

#: The sites the port visits: all of :data:`SITES`.
PORTED_SITES = tuple(SITES)


class InjectedFault(OSError):
    """An injected transient I/O failure (an ``OSError``, so retries and
    the bad-record budget treat it as a real one)."""


class InjectedDiskFull(InjectedFault):
    """An injected ENOSPC, with ``errno`` set, so callers that treat a
    full disk apart (``disk_full_total``) see the real thing."""

    def __init__(self, site: str) -> None:
        super().__init__(errno.ENOSPC,
                         f"injected ENOSPC (disk full) at {site}")


class InjectedShortWrite(InjectedDiskFull):
    """An injected short write: the disk filled up mid-write after
    ``keep`` bytes of the payload landed.  ``utils/diskio.py`` writes
    exactly that prefix and re-raises."""

    def __init__(self, site: str, keep: int) -> None:
        OSError.__init__(self, errno.ENOSPC,
                         f"injected short write at {site} "
                         f"({keep} bytes landed)")
        self.keep = keep


class InjectedCorruption(ValueError):
    """Injected corruption at a site with no byte payload to mutate."""


class WatchdogError(RuntimeError):
    """A monitored worker made no progress within the watchdog timeout."""


class BadDataError(RuntimeError):
    """The ``max_bad_records`` skip budget was exceeded; ``__cause__`` is
    the error of the record that broke it."""


# ----------------------------------------------------------------------
# fault injection
class FaultSpec:
    """One armed fault: ``site:kind:prob[:limit]``."""

    def __init__(self, site: str, kind: str, prob: float,
                 limit: int = 0) -> None:
        self.site = site
        self.kind = kind
        self.prob = float(prob)
        self.limit = int(limit)  # 0: no limit
        self.fired = 0
        self.visits = 0


def _corrupt_bytes(blob: bytes, rng: random.Random) -> bytes:
    """Flip byte 0 (it kills format magics and raw headers) and up to
    three bytes at the RNG's positions."""
    b = bytearray(blob)
    if not b:
        return bytes(b)
    b[0] ^= 0xFF
    for _ in range(min(3, len(b) - 1)):
        b[rng.randrange(len(b))] ^= 0xFF
    return bytes(b)


def _corrupt_text(text: str, rng: random.Random) -> str:
    """A text record with its leading field made unparseable: ``~`` at
    position 0 and at up to two of the RNG's positions (``~`` starts no
    comment in any text format read here, so the row is parsed and
    fails)."""
    chars = list(text)
    if not chars:
        return "~"
    chars[0] = "~"
    for _ in range(min(2, len(chars) - 1)):
        chars[rng.randrange(len(chars))] = "~"
    return "".join(chars)


class FaultInjector:
    """The process-wide registry of armed faults.  Draws are serialized
    under a lock; each (site, kind) has its own RNG seeded from
    ``(fault_seed, site, kind)``, so a site's firings depend only on its
    own visits."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[FaultSpec]] = {}
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self.seed = 0
        self.latency_s = 0.05
        self.hang_s = 3600.0
        self._release = threading.Event()

    def install(self, spec: str) -> FaultSpec:
        """Arm one ``site:kind:prob[:limit]`` spec."""
        parts = spec.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"fault_inject spec {spec!r}: want site:kind:prob[:limit]")
        site, kind = parts[0], parts[1]
        if site not in SITES:
            raise ValueError(f"fault_inject: unknown site {site!r}; known: "
                             f"{', '.join(sorted(SITES))}")
        if kind not in SITES[site]:
            raise ValueError(f"fault_inject: site {site!r} supports kinds "
                             f"{SITES[site]}, not {kind!r}")
        prob = float(parts[2])
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault_inject: prob must be in [0,1], got {prob}")
        fs = FaultSpec(site, kind, prob, int(parts[3]) if len(parts) == 4
                       else 0)
        with self._lock:
            self._by_site.setdefault(site, []).append(fs)
            self._rngs[(site, kind)] = random.Random(
                (self.seed << 16) ^ zlib.crc32(f"{site}:{kind}".encode()))
        return fs

    def configure(self, cfg: Sequence[Tuple[str, str]]) -> None:
        """Arm the specs of an ordered config stream: ``fault_seed``
        (read before the specs it seeds), ``fault_latency_ms``,
        ``fault_hang_s`` and any number of ``fault_inject``."""
        for name, val in cfg:
            if name == "fault_seed":
                self.seed = int(val)
            elif name == "fault_latency_ms":
                self.latency_s = float(val) / 1e3
            elif name == "fault_hang_s":
                self.hang_s = float(val)
            elif name == "fault_inject":
                self.install(val)

    def reset(self) -> None:
        """Disarm everything and release the threads held at a hang."""
        with self._lock:
            self._by_site.clear()
            self._rngs.clear()
            self.seed = 0
            self.latency_s = 0.05
            self.hang_s = 3600.0
            self._release.set()
            self._release = threading.Event()

    def armed(self, *sites: str) -> bool:
        """Is a spec armed at one of ``sites``?  (A reader's fast path
        that skips the per-record hooks asks this.)"""
        return any(self._by_site.get(s) for s in sites)

    def specs(self) -> List[FaultSpec]:
        with self._lock:
            return [s for specs in self._by_site.values() for s in specs]

    def fire_counts(self) -> Dict[str, int]:
        return {f"{s.site}:{s.kind}": s.fired for s in self.specs()}

    def fault_point(self, site: str, payload=None):
        """The hook at a named site, given the record's bytes or text
        where there are some; returns them (corrupted when a ``corrupt``
        spec fires), or sleeps, hangs or raises."""
        if not self._by_site:
            return payload
        with self._lock:
            firing: List[Tuple[FaultSpec, random.Random]] = []
            for fs in self._by_site.get(site, ()):
                fs.visits += 1
                if fs.limit and fs.fired >= fs.limit:
                    continue
                rng = self._rngs[(site, fs.kind)]
                if fs.prob >= 1.0 or rng.random() < fs.prob:
                    fs.fired += 1
                    firing.append((fs, rng))
            release = self._release
        for fs, _rng in firing:
            # every injection is a lifecycle fact: a chaos run can be
            # audited afterwards from the event log and /metricsz
            obs_events.emit("fault.injected", site=fs.site,
                            fault_kind=fs.kind, fired=fs.fired,
                            visits=fs.visits)
            obs_registry().counter(
                "faults_injected_total", "Chaos-harness fault firings.",
                labelnames=("site", "kind"),
            ).labels(site=fs.site, kind=fs.kind).inc()
        for fs, rng in firing:
            if fs.kind == "latency":
                time.sleep(self.latency_s)
            elif fs.kind == "hang":
                release.wait(self.hang_s)  # reset() lets it go
            elif fs.kind == "corrupt":
                if isinstance(payload, (bytes, bytearray, memoryview)):
                    payload = _corrupt_bytes(bytes(payload), rng)
                elif isinstance(payload, str):
                    payload = _corrupt_text(payload, rng)
                else:
                    raise InjectedCorruption(f"injected corruption at {site}")
            elif fs.kind == "bitflip":
                # the payload (a NetTrainer) flips a real bit in one of
                # its live tensors, chosen by this spec's RNG
                if payload is None or not hasattr(payload, "inject_bitflip"):
                    raise InjectedCorruption(
                        f"bitflip at {site}: payload has no "
                        "inject_bitflip hook")
                payload.inject_bitflip(rng)
            elif fs.kind == "enospc":
                raise InjectedDiskFull(site)
            elif fs.kind == "short":
                keep = 0
                if isinstance(payload, (bytes, bytearray, memoryview)):
                    n = len(payload)
                    keep = max(1, n // 2) if n else 0
                raise InjectedShortWrite(site, keep)
            else:  # ioerror
                raise InjectedFault(f"injected I/O error at {site}")
        return payload


_INJECTOR = FaultInjector()


def injector() -> FaultInjector:
    return _INJECTOR


def fault_point(site: str, payload=None):
    """The hook the instrumented sites call (a dict lookup while nothing
    is armed)."""
    return _INJECTOR.fault_point(site, payload)


def install(spec: str) -> FaultSpec:
    return _INJECTOR.install(spec)


def configure(cfg: Sequence[Tuple[str, str]]) -> None:
    _INJECTOR.configure(cfg)


def reset() -> None:
    _INJECTOR.reset()


# ----------------------------------------------------------------------
# watchdog


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

    def stalled_for(self) -> float:
        """Seconds since the last beat."""
        return time.monotonic() - self._last

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

    def _fire(self, dt: float) -> WatchdogError:
        obs_events.emit("watchdog.fire", what=self.what, stalled_s=dt,
                        timeout_s=self.timeout_s)
        return WatchdogError(self.diagnostic(dt))

    def check(self) -> None:
        """Raise :class:`WatchdogError` when no beat has landed for
        ``timeout_s`` (a consumer polling a queue calls this)."""
        if not self.enabled:
            return
        dt = time.monotonic() - self._last
        if dt > self.timeout_s:
            raise self._fire(dt)

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
                raise self._fire(dt)


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

    #: the keys :meth:`from_cfg` reads; the readers pass exactly these on
    CONFIG_KEYS = ("retry_attempts", "retry_base_delay", "retry_max_delay",
                   "retry_jitter", "retry_deadline_s")

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


def retried_read_lines(path: str, site: str, retry_cfg,
                       silent: bool = False) -> List[str]:
    """The lines of ``path`` under the configured :class:`RetryPolicy`,
    through the fault site ``site``.  A byte that is not UTF-8 becomes
    U+FFFD, so it spoils one row (which a budget can skip), not the
    read."""
    def _read():
        fault_point(site)
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.readlines()

    return RetryPolicy.from_cfg(retry_cfg).run(
        _read, what=f"reading {path}", silent=silent)


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


# ----------------------------------------------------------------------
# skip-and-quarantine
class BadRecordBudget:
    """Skip-and-quarantine accounting for one data source.

    ``max_bad_records`` bounds the skips of one epoch (``start_epoch``
    resets the count).  Each skipped record appends ``offset\treason`` to
    a ``<source>.quarantine`` sidecar (in ``quarantine_dir`` when set),
    once per (source, offset) across epochs.  ``max_bad_records = 0`` is
    strict: the first bad record raises :class:`BadDataError` and writes
    no sidecar."""

    def __init__(self, max_bad_records: int = 0, what: str = "data",
                 silent: bool = False,
                 quarantine_dir: Optional[str] = None) -> None:
        self.max_bad_records = int(max_bad_records)
        self.what = what
        self.silent = silent
        self.quarantine_dir = quarantine_dir
        self.epoch_count = 0
        self.total_count = 0
        self.events: List[Tuple[str, object, str]] = []
        self._seen: set = set()
        self._sidecar_warned = False

    def start_epoch(self) -> None:
        self.epoch_count = 0

    def _sidecar_path(self, source: str) -> str:
        if self.quarantine_dir:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            return os.path.join(self.quarantine_dir,
                                os.path.basename(source) + ".quarantine")
        return source + ".quarantine"

    def record(self, source: str, offset, exc: BaseException,
               note: str = "") -> None:
        """Count one bad record or page; raise :class:`BadDataError` past
        the budget.  ``note`` says what else the skip drops."""
        reason = f"{type(exc).__name__}: {exc}"
        if note:
            reason += f" [{note}]"
        self.epoch_count += 1
        self.total_count += 1
        obs_events.emit("data.quarantined", what=self.what, source=source,
                        offset=offset, reason=reason,
                        epoch_count=self.epoch_count)
        key = (source, offset)
        if key not in self._seen:
            self._seen.add(key)
            self.events.append((source, offset, reason))
            if self.max_bad_records > 0:
                try:
                    with open(self._sidecar_path(source), "a",
                              encoding="utf-8") as f:
                        f.write(f"{offset}\t{reason}\n")
                except OSError as e:
                    if not self._sidecar_warned:
                        self._sidecar_warned = True
                        print(f"{self.what}: cannot write quarantine "
                              f"sidecar ({e}); continuing without it",
                              flush=True)
        if self.epoch_count > self.max_bad_records:
            obs_events.emit("data.budget_exceeded", what=self.what,
                            epoch_count=self.epoch_count,
                            max_bad_records=self.max_bad_records,
                            source=source, offset=offset)
            raise BadDataError(
                f"{self.what}: bad-record budget exceeded "
                f"({self.epoch_count} bad records this epoch > "
                f"max_bad_records={self.max_bad_records}); last: "
                f"{source} @ {offset}: {reason}\n{self.summary()}") from exc
        if not self.silent:
            print(f"{self.what}: skipped bad record {source} @ {offset} "
                  f"({reason}) [{self.epoch_count}/"
                  f"{self.max_bad_records} this epoch]", flush=True)

    def summary(self) -> str:
        srcs = sorted({s for s, _, _ in self.events})
        return (f"{self.what}: {self.total_count} bad record(s) skipped "
                f"({len(self.events)} distinct) across "
                f"{len(srcs)} source(s): {', '.join(srcs) or '-'}")
