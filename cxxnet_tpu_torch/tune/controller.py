"""Telemetry-driven knob controller: the measure→decide→act loop.

The port's copy of ``cxxnet_tpu/tune/controller.py``: the same
decisions, events, gauges and counters, so both packages tune alike
under the same objective sequence.  A :class:`KnobController` owns a set of runtime-adjustable
:class:`Knob`\\ s (decode-pool workers, queue depth, micro-batcher
size/timeout — anything with a live getter/setter) and hill-climbs them
toward the configuration that maximizes a throughput *objective*,
online, while the workload runs:

* **objective** — a callable returning a MONOTONIC cumulative work
  count (rows decoded, batch rows executed); the controller samples it
  every ``period_s`` and works on interval rates, so any registry
  counter (or a benchmark's own tally) plugs in directly.
* **hill climbing** — one knob moves at a time (round-robin), one
  multiplicative step in its preferred direction; the objective is
  re-measured over ``measure_ticks`` fresh intervals after
  ``settle_ticks`` transition intervals are discarded.
* **noise band** — a move only counts as better/worse when the new
  rate leaves the ``band`` envelope around the pre-move baseline
  (:func:`band_verdict`).  Within
  the band the move is *reverted*, never kept: noise must not
  random-walk the knobs.
* **rollback on regression** — a move whose measured rate leaves the
  band downward is rolled back immediately and the knob's preferred
  direction flips.
* **hysteresis** — a knob whose both directions failed goes on a
  ``cooldown_ticks`` cooldown before it is probed again, so a noisy
  plateau costs two bounded probes per cooldown period instead of an
  oscillation.

Every decision is observable: ``tune.adjust`` / ``tune.rollback``
events, ``tune_effective{knob}`` gauges (the satellite contract: what
the controller chose, readable from ``/metricsz`` without the event
log), ``tune_adjustments_total{knob,action}`` /
``tune_rollbacks_total{knob}`` / ``tune_decisions_total{decision}``
counters and a ``tune_objective_rows_per_sec`` gauge.

Drive it manually with :meth:`KnobController.step_once` (tests, bench
harnesses) or as a daemon thread via :meth:`KnobController.start` —
the CLI starts one per task when the conf carries ``controller = 1``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry

__all__ = [
    "band_verdict",
    "Knob",
    "KnobController",
    "TuneOptions",
    "options_from_cfg",
    "set_effective",
]

ConfigEntry = Tuple[str, str]


def band_verdict(value: float, baseline: Optional[float], band: float,
                 lower_is_better: bool = False) -> str:
    """``"better"`` / ``"worse"`` / ``"noise"`` for ``value`` against
    ``baseline`` with a fractional noise ``band``, orientation-aware.

    The controller's keep/rollback verdicts are this comparison.  A
    missing/zero baseline is
    ``"noise"`` — nothing can be concluded against it."""
    if baseline is None or baseline <= 0:
        return "noise"
    ratio = float(value) / float(baseline)
    if lower_is_better:
        if ratio > 1.0 + band:
            return "worse"
        if ratio < 1.0 - band:
            return "better"
    else:
        if ratio < 1.0 - band:
            return "worse"
        if ratio > 1.0 + band:
            return "better"
    return "noise"


class Knob:
    """One runtime-adjustable setting: a live getter/setter pair plus
    the move policy (bounds, multiplicative step, integer rounding).

    ``preferred`` / ``tried`` / ``cooldown`` are the controller's
    per-knob search state (direction memory, probed-this-plateau set,
    hysteresis countdown) — they live here so multiple controllers
    never share them."""

    def __init__(self, name: str, getter: Callable[[], float],
                 setter: Callable[[float], object], lo: float, hi: float,
                 scale: float = 2.0, integer: bool = True) -> None:
        if lo > hi:
            raise ValueError(f"knob {name}: lo {lo} > hi {hi}")
        if scale <= 1.0:
            raise ValueError(f"knob {name}: scale must be > 1")
        self.name = name
        self._get = getter
        self._set = setter
        self.lo = lo
        self.hi = hi
        self.scale = float(scale)
        self.integer = bool(integer)
        self.preferred = +1          # last direction that helped
        self.tried: set = set()      # directions probed on this plateau
        self.cooldown = 0            # decision cycles to sit out

    def read(self) -> float:
        v = self._get()
        return int(v) if self.integer else float(v)

    def apply(self, value: float) -> None:
        self._set(int(value) if self.integer else float(value))
        set_effective(self.name, value)

    def propose(self, direction: int) -> Optional[float]:
        """The next value one step in ``direction`` (+1 up / -1 down),
        clamped to the bounds; None when already pinned there."""
        cur = self.read()
        nxt = cur * self.scale if direction > 0 else cur / self.scale
        if self.integer:
            nxt = int(round(nxt))
            # a multiplicative step must always move an integer knob
            if direction > 0 and nxt <= cur:
                nxt = int(cur) + 1
            elif direction < 0 and nxt >= cur:
                nxt = int(cur) - 1
        nxt = min(self.hi, max(self.lo, nxt))
        if self.integer:
            nxt = int(round(nxt))
        return None if nxt == cur else nxt


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


_EFFECTIVE_LOCK = threading.Lock()
_EFFECTIVE_GAUGE = None


def set_effective(knob: str, value: float) -> None:
    """Publish a knob's current effective value as
    ``tune_effective{knob=...}`` — set by every runtime setter (engine,
    pipeline, controller), so operators see what is live even when no
    controller runs."""
    global _EFFECTIVE_GAUGE
    with _EFFECTIVE_LOCK:
        if _EFFECTIVE_GAUGE is None:
            _EFFECTIVE_GAUGE = obs_registry().gauge(
                "tune_effective",
                "Current effective value of a runtime-adjustable knob.",
                labelnames=("knob",))
        g = _EFFECTIVE_GAUGE
    g.labels(knob=knob).set(float(value))


class TuneOptions:
    """Parsed ``controller`` / ``tune_*`` config keys."""

    def __init__(self) -> None:
        self.enabled = 0
        self.period_s = 1.0
        self.band = 0.1
        self.measure_ticks = 2
        self.settle_ticks = 1
        self.cooldown_ticks = 6
        self.targets = "auto"   # auto | comma list of pipeline,batcher

    def wants(self, target: str) -> bool:
        if self.targets.strip() in ("", "auto"):
            return True
        return target in [t.strip() for t in self.targets.split(",")]


def options_from_cfg(cfg: Sequence[ConfigEntry]) -> TuneOptions:
    opt = TuneOptions()
    for name, val in cfg:
        if name == "controller":
            opt.enabled = int(val)
        elif name == "tune_period_s":
            opt.period_s = max(0.05, float(val))
        elif name == "tune_band":
            opt.band = max(0.0, float(val))
        elif name == "tune_measure_ticks":
            opt.measure_ticks = max(1, int(val))
        elif name == "tune_settle_ticks":
            opt.settle_ticks = max(0, int(val))
        elif name == "tune_cooldown_ticks":
            opt.cooldown_ticks = max(0, int(val))
        elif name == "tune_targets":
            opt.targets = val
    return opt


class KnobController:
    """Hill-climb a set of :class:`Knob`\\ s against a throughput
    objective (see the module docstring for the algorithm).

    ``objective()`` must return a monotonic cumulative work count; the
    controller differentiates it per tick.  ``on_tick`` (optional) runs
    at the top of every tick on the controller thread — the serve
    engine hangs its speculative bucket prewarm there.  Exceptions in
    either are swallowed after one logged event: a broken probe must
    never take down the workload it tunes."""

    def __init__(self, objective: Callable[[], float],
                 knobs: Sequence[Knob], period_s: float = 1.0,
                 band: float = 0.1, measure_ticks: int = 2,
                 settle_ticks: int = 1, cooldown_ticks: int = 6,
                 name: str = "tune",
                 on_tick: Optional[Callable[[], object]] = None) -> None:
        if not knobs:
            raise ValueError("KnobController needs at least one knob")
        self._objective = objective
        self.knobs: List[Knob] = list(knobs)
        self.period_s = float(period_s)
        self.band = float(band)
        self.measure_ticks = max(1, int(measure_ticks))
        self.settle_ticks = max(0, int(settle_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.name = name
        self._on_tick = on_tick
        self._phase = "baseline"     # baseline | settle | measure
        self._window: List[float] = []
        self._baseline: Optional[float] = None
        self._active: Optional[Tuple[Knob, float, float, int]] = None
        self._idx = 0
        self._settle_left = 0
        self._prev_sample: Optional[Tuple[float, float]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        reg = obs_registry()
        self._rate_gauge = reg.gauge(
            "tune_objective_rows_per_sec",
            "Interval rate of the controller's work objective.",
            labelnames=("controller",))
        self._ticks_total = reg.counter(
            "tune_ticks_total", "Controller evaluation ticks.",
            labelnames=("controller",))
        self._adjustments = reg.counter(
            "tune_adjustments_total",
            "Knob moves applied, by knob and direction.",
            labelnames=("knob", "action"))
        self._rollbacks = reg.counter(
            "tune_rollbacks_total",
            "Knob moves rolled back after a measured regression.",
            labelnames=("knob",))
        self._decisions = reg.counter(
            "tune_decisions_total",
            "Concluded move verdicts: keep / rollback / revert.",
            labelnames=("decision",))
        for k in self.knobs:
            set_effective(k.name, k.read())

    # ------------------------------------------------------------------
    def _rate(self, now: float) -> Optional[float]:
        work = float(self._objective())
        prev, self._prev_sample = self._prev_sample, (now, work)
        if prev is None:
            return None
        dt = now - prev[0]
        if dt <= 0:
            return None
        return max(0.0, work - prev[1]) / dt

    def step_once(self, now: Optional[float] = None) -> Dict[str, object]:
        """One controller tick (serialized; the thread and manual
        callers may interleave).  Returns the decision taken, for tests
        and bench harnesses."""
        with self._lock:
            return self._step_locked(now)

    def _step_locked(self, now: Optional[float]) -> Dict[str, object]:
        self.ticks += 1
        self._ticks_total.labels(controller=self.name).inc()
        if self._on_tick is not None:
            try:
                self._on_tick()
            except Exception as e:  # noqa: BLE001 - probe must not kill us
                obs_events.log_exception_once(
                    f"tune.on_tick.{self.name}", e, kind="tune.error")
        # the tick timestamp is taken AFTER on_tick: a slow hook (a
        # bucket's first forward in the prewarm) must count inside the
        # interval, or the work accrued during it gets divided by the
        # short nominal period and inflates the measured rate — enough
        # to make a regressing probe look like an improvement
        if now is None:
            now = time.monotonic()
        try:
            rate = self._rate(now)
        except Exception as e:  # noqa: BLE001 - objective broke; idle
            obs_events.log_exception_once(
                f"tune.objective.{self.name}", e, kind="tune.error")
            return {"action": "error"}
        if rate is None:
            return {"action": "prime"}
        self._rate_gauge.labels(controller=self.name).set(rate)
        if self._phase == "settle":
            self._settle_left -= 1
            if self._settle_left <= 0:
                self._phase = "measure" if self._active else "baseline"
                self._window = []
            return {"action": "settle", "rate": rate}
        self._window.append(rate)
        if len(self._window) < self.measure_ticks:
            return {"action": "collect", "rate": rate}
        value = _median(self._window)
        self._window = []
        if self._phase == "baseline":
            self._baseline = value
            return self._begin_move(value)
        return self._conclude(value)

    # ------------------------------------------------------------------
    def _pick(self) -> Tuple[Optional[Knob], int, Optional[float]]:
        n = len(self.knobs)
        for off in range(n):
            k = self.knobs[(self._idx + off) % n]
            if k.cooldown > 0:
                continue
            for d in (k.preferred, -k.preferred):
                if d in k.tried:
                    continue
                target = k.propose(d)
                if target is not None:
                    self._idx = (self._idx + off) % n
                    return k, d, target
        return None, 0, None

    def _begin_move(self, baseline: float) -> Dict[str, object]:
        knob, direction, target = self._pick()
        if knob is None:
            self._tick_cooldowns()
            return {"action": "idle", "baseline": baseline}
        prev = knob.read()
        try:
            knob.apply(target)
        except Exception as e:  # noqa: BLE001 - a broken setter sits out
            obs_events.log_exception_once(
                f"tune.apply.{knob.name}", e, kind="tune.error")
            knob.cooldown = max(1, self.cooldown_ticks)
            return {"action": "error", "knob": knob.name}
        action = "up" if direction > 0 else "down"
        self._adjustments.labels(knob=knob.name, action=action).inc()
        obs_events.emit("tune.adjust", controller=self.name,
                        knob=knob.name, prev=prev, to=target,
                        direction=action, baseline=baseline)
        self._active = (knob, prev, target, direction)
        self._phase = "settle" if self.settle_ticks else "measure"
        self._settle_left = self.settle_ticks
        return {"action": "adjust", "knob": knob.name, "prev": prev,
                "to": target, "baseline": baseline}

    def _conclude(self, candidate: float) -> Dict[str, object]:
        knob, prev, target, direction = self._active
        self._active = None
        self._phase = "baseline"
        verdict = band_verdict(candidate, self._baseline, self.band)
        out: Dict[str, object] = {
            "knob": knob.name, "baseline": self._baseline,
            "candidate": candidate, "prev": prev, "to": target,
        }
        if verdict == "better":
            # keep and keep climbing this knob in this direction; the
            # just-measured candidate doubles as the next baseline, so
            # a climb costs one settle+measure per rung, not two
            knob.preferred = direction
            knob.tried.clear()
            self._decisions.labels(decision="keep").inc()
            self._baseline = candidate
            out["action"] = "keep"
            self._tick_cooldowns()
            out["next"] = self._begin_move(candidate)["action"]
            return out
        elif verdict == "worse":
            self._apply_guarded(knob, prev)
            knob.preferred = -direction
            knob.tried.add(direction)
            self._rollbacks.labels(knob=knob.name).inc()
            self._decisions.labels(decision="rollback").inc()
            obs_events.emit("tune.rollback", controller=self.name,
                            knob=knob.name, prev=prev, to=target,
                            baseline=self._baseline, candidate=candidate)
            self._finish_knob(knob)
            out["action"] = "rollback"
        else:
            # within the noise band: revert, never keep — noise must
            # not random-walk the knobs (the hysteresis contract)
            self._apply_guarded(knob, prev)
            knob.tried.add(direction)
            self._decisions.labels(decision="revert").inc()
            self._finish_knob(knob)
            out["action"] = "revert"
        self._tick_cooldowns()
        return out

    def _apply_guarded(self, knob: Knob, value: float) -> None:
        """Restore a knob, swallowing setter failures: a rollback that
        raises must neither kill the tick thread nor leave the knob
        silently cooling at the degraded probe value unreported."""
        try:
            knob.apply(value)
        except Exception as e:  # noqa: BLE001 - tuning stays alive
            obs_events.log_exception_once(
                f"tune.restore.{knob.name}", e, kind="tune.error")
            knob.cooldown = max(knob.cooldown, self.cooldown_ticks)

    def _finish_knob(self, knob: Knob) -> None:
        exhausted = all(
            d in knob.tried or knob.propose(d) is None for d in (1, -1)
        )
        if exhausted:
            knob.cooldown = self.cooldown_ticks
            knob.tried.clear()
        self._idx = (self._idx + 1) % len(self.knobs)

    def _tick_cooldowns(self) -> None:
        for k in self.knobs:
            if k.cooldown > 0:
                k.cooldown -= 1

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Live introspection (bench verdicts, ``/statsz``-style)."""
        with self._lock:
            return {
                "controller": self.name,
                "phase": self._phase,
                "ticks": self.ticks,
                "baseline": self._baseline,
                "knobs": {k.name: k.read() for k in self.knobs},
                "cooldowns": {k.name: k.cooldown for k in self.knobs},
            }

    def start(self) -> "KnobController":
        """Start the background tick thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"cxxnet-tune-{self.name}", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.step_once()
            except Exception as e:  # noqa: BLE001 - the tick thread
                # must survive any single broken tick; the workload it
                # tunes keeps running either way
                obs_events.log_exception_once(
                    f"tune.tick.{self.name}", e, kind="tune.error")

    def stop(self) -> None:
        """Stop the tick thread and ROLL BACK any probe that was
        applied but never measured — otherwise a stop() landing between
        adjust and conclude would leave a deliberately-degraded probe
        value as the 'chosen' configuration (and snapshot() would
        report it as such to the autotune verdicts)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._thread = None
        with self._lock:
            active, self._active = self._active, None
            self._phase = "baseline"
            self._window = []
        if active is not None:
            knob, prev, target, _direction = active
            try:
                knob.apply(prev)
            except Exception as e:  # noqa: BLE001 - best-effort restore
                obs_events.log_exception_once(
                    f"tune.stop_restore.{knob.name}", e, kind="tune.error")
            obs_events.emit("tune.abort_probe", controller=self.name,
                            knob=knob.name, probe=target, restored=prev)
