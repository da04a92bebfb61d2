"""Declarative alert evaluator over the metrics registry.

The port's copy of ``cxxnet_tpu/obs/alerts.py``: config-driven
threshold rules evaluated against registry snapshots on a background
thread:

    alert = <name>:<metric>:<op>:<threshold>[:<for_s>]
    alert = slow_predict:serve_request_latency_seconds_mean:>:0.25:10
    alert = shedding:serve_request_outcomes_rate{outcome="shed"}:>:0
    alert = hbm:xla_device_memory_bytes{stat="peak_bytes_in_use"}:>:6e10

* ``metric`` names a registry sample: a family (every labelset of it is
  a candidate; the rule fires if ANY crosses) or one exact sample
  (``family{label="v"}``).  Two **derived** series exist per evaluation
  interval so rules can clear again: every counter sample ``X_total``
  also appears as ``X_rate`` (per-second delta since the previous
  evaluation) and every histogram ``Y`` as ``Y_mean`` (interval
  Δsum/Δcount — absent when no new observations landed).
* ``op`` is one of ``> < >= <=`` (spellings ``gt lt ge le`` accepted
  for shell-quoting comfort).
* ``for_s`` debounces: the condition must hold continuously that long
  before the rule transitions to ``firing`` (default 0: immediate).

Transitions emit structured events (``alert.firing`` /
``alert.cleared``), flip the ``obs_alerts_firing{name}`` gauge, and
count in ``obs_alert_transitions_total{name,to}``.  The server exposes
:meth:`AlertEvaluator.status` as ``GET /alertz`` and the engine
degrades ``/healthz`` while anything fires.  Evaluation is pull-only —
a broken rule or scrape can never touch the hot paths it watches.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import events as obs_events
from .registry import registry as obs_registry

__all__ = [
    "AlertRule",
    "AlertEvaluator",
    "evaluator",
    "configure",
    "reset",
    "parse_rule",
]

ConfigEntry = Tuple[str, str]

_OPS = {
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
    "gt": lambda v, t: v > t,
    "lt": lambda v, t: v < t,
    "ge": lambda v, t: v >= t,
    "le": lambda v, t: v <= t,
}
_OP_CANON = {"gt": ">", "lt": "<", "ge": ">=", "le": "<="}

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_.\-]*$")


class AlertRule:
    """One parsed threshold rule (immutable config; mutable state lives
    in the evaluator)."""

    __slots__ = ("name", "metric", "op", "threshold", "for_s")

    def __init__(self, name: str, metric: str, op: str,
                 threshold: float, for_s: float = 0.0) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"alert: bad rule name {name!r}")
        if op not in _OPS:
            raise ValueError(
                f"alert {name}: op must be one of > < >= <= "
                f"(or gt/lt/ge/le), got {op!r}")
        if not metric:
            raise ValueError(f"alert {name}: empty metric")
        self.name = name
        self.metric = metric
        self.op = _OP_CANON.get(op, op)
        self.threshold = float(threshold)
        self.for_s = max(0.0, float(for_s))

    def crossed(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)

    def to_dict(self) -> Dict[str, object]:
        return {"name": self.name, "metric": self.metric, "op": self.op,
                "threshold": self.threshold, "for_s": self.for_s}


def parse_rule(spec: str) -> AlertRule:
    """``name:metric:op:threshold[:for_s]`` → :class:`AlertRule`.

    The metric token may itself contain ``{label="v"}`` selectors whose
    VALUES contain colons (device labels like ``device="cuda:0"``), so
    the spec is split from the outside in: the rule name from the left,
    op/threshold/for_s from the right, everything between is the
    metric.  The trailing fields' grammar (op symbol + numbers) is
    unambiguous, so a metric can never be misparsed as them."""
    name, sep, rest = spec.partition(":")
    if not sep:
        raise ValueError(
            f"alert={spec!r}: want name:metric:op:threshold[:for_s]")
    # try the 5-field form first: ...:op:threshold:for_s
    for n_tail in (3, 2):
        parts = rest.rsplit(":", n_tail)
        if len(parts) != n_tail + 1:
            continue
        metric, op, thresh = parts[0], parts[1], parts[2]
        for_s = parts[3] if n_tail == 3 else "0"
        if op not in _OPS:
            continue
        try:
            return AlertRule(name, metric, op, float(thresh),
                             float(for_s))
        except ValueError:
            continue
    raise ValueError(
        f"alert={spec!r}: want name:metric:op:threshold[:for_s] "
        "(op one of > < >= <= / gt lt ge le, numeric threshold)")


class _RuleState:
    __slots__ = ("state", "value", "cross_since", "changed_ts")

    def __init__(self) -> None:
        self.state = "ok"          # ok | pending | firing
        self.value: Optional[float] = None
        self.cross_since: Optional[float] = None
        self.changed_ts: Optional[float] = None


class AlertEvaluator:
    """Threshold rules over periodic registry snapshots.

    Drive it manually with :meth:`evaluate_once` (tests, one-shot
    tools) or as a daemon thread via :meth:`start` — the CLI starts it
    whenever the conf carries ``alert=`` rules, for every task."""

    def __init__(self, registry=None, period_s: float = 2.0) -> None:
        self._registry = registry
        self.period_s = float(period_s)
        self._lock = threading.Lock()
        # serializes whole evaluation passes: transitions mutate rule
        # state and emit events, so two concurrent evaluate_once calls
        # (the thread + a manual driver, or parallel scrapers in tests)
        # must not interleave and double-fire
        self._eval_lock = threading.Lock()
        self._rules: List[AlertRule] = []
        self._states: Dict[str, _RuleState] = {}
        self._prev: Optional[Dict[str, float]] = None
        self._prev_ts: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.evaluations = 0
        self._gauge = None
        self._transitions = None

    # ------------------------------------------------------------------
    def _reg(self):
        return self._registry if self._registry is not None \
            else obs_registry()

    def _metrics(self):
        if self._gauge is None:
            reg = self._reg()
            self._gauge = reg.gauge(
                "obs_alerts_firing",
                "1 while the named alert rule is firing.",
                labelnames=("name",))
            self._transitions = reg.counter(
                "obs_alert_transitions_total",
                "Alert state transitions, by rule and target state.",
                labelnames=("name", "to"))
        return self._gauge, self._transitions

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            if any(r.name == rule.name for r in self._rules):
                raise ValueError(f"alert: duplicate rule {rule.name!r}")
            self._rules.append(rule)
            self._states[rule.name] = _RuleState()
        gauge, _ = self._metrics()
        gauge.labels(name=rule.name).set(0)

    def configure(self, cfg: Sequence[ConfigEntry]) -> int:
        """Consume ``alert=`` specs and ``alert_period_s`` from the
        ordered config stream; returns how many rules were added.
        A re-parsed spec whose name already exists is ignored (the CLI
        configures once; tests may configure twice)."""
        added = 0
        for name, val in cfg:
            if name == "alert_period_s":
                self.period_s = max(0.05, float(val))
            elif name == "alert":
                rule = parse_rule(val)
                with self._lock:
                    dup = any(r.name == rule.name for r in self._rules)
                if dup:
                    continue
                self.add_rule(rule)
                added += 1
        return added

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules)

    # ------------------------------------------------------------------
    # sample space
    @staticmethod
    def _flatten(snapshot: Dict[str, Dict[str, float]]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for fam in snapshot.values():
            out.update(fam)
        return out

    @staticmethod
    def _derive(cur: Dict[str, float], prev: Optional[Dict[str, float]],
                dt: float) -> Dict[str, float]:
        """Interval-delta series: ``X_total`` → ``X_rate`` (per second),
        histogram ``Y_sum``/``Y_count`` pairs → ``Y_mean`` (mean of the
        observations that landed THIS interval; absent when none did)."""
        derived: Dict[str, float] = {}
        if prev is None or dt <= 0:
            return derived
        for key, v in cur.items():
            name, _, labels = key.partition("{")
            if name.endswith("_total"):
                d = v - prev.get(key, 0.0)
                if d < 0:
                    d = v  # registry was reset between evaluations
                rk = name[:-len("_total")] + "_rate"
                derived[rk + ("{" + labels if labels else "")] = d / dt
            elif name.endswith("_sum"):
                ck = name[:-len("_sum")] + "_count" + (
                    "{" + labels if labels else "")
                if ck not in cur:
                    continue
                dsum = v - prev.get(key, 0.0)
                dcount = cur[ck] - prev.get(ck, 0.0)
                if dcount > 0:
                    mk = name[:-len("_sum")] + "_mean"
                    derived[mk + ("{" + labels if labels else "")] = \
                        dsum / dcount
        return derived

    @staticmethod
    def _match(metric: str, samples: Dict[str, float]) -> List[float]:
        """Values the rule's metric selector matches: the exact sample,
        or every labelset of a bare family name."""
        if metric in samples:
            return [samples[metric]]
        prefix = metric + "{"
        return [v for k, v in samples.items() if k.startswith(prefix)]

    # ------------------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the transition events emitted
        (empty when nothing changed state).  Passes are serialized —
        concurrent callers queue rather than double-firing transitions."""
        with self._eval_lock:
            return self._evaluate_locked(now)

    def _evaluate_locked(self, now: Optional[float]) -> List[dict]:
        now = time.monotonic() if now is None else now
        try:
            cur = self._flatten(self._reg().snapshot())
        except Exception as e:  # noqa: BLE001 - a bad collector must not
            obs_events.log_exception_once(   # kill the evaluator thread
                "obs.alerts.snapshot", e, kind="obs.alert_error")
            return []
        with self._lock:
            prev, prev_ts = self._prev, self._prev_ts
            self._prev, self._prev_ts = cur, now
            rules = list(self._rules)
            self.evaluations += 1
        samples = dict(cur)
        samples.update(self._derive(
            cur, prev, (now - prev_ts) if prev_ts is not None else 0.0))
        gauge, transitions = self._metrics()
        emitted: List[dict] = []
        for rule in rules:
            st = self._states[rule.name]
            values = self._match(rule.metric, samples)
            crossing = [v for v in values if rule.crossed(v)]
            if crossing:
                # report the worst offender for the rule's direction
                worst = (max if rule.op.startswith(">") else min)(crossing)
                st.value = worst
                if st.cross_since is None:
                    st.cross_since = now
                if (st.state != "firing"
                        and now - st.cross_since >= rule.for_s):
                    st.state = "firing"
                    st.changed_ts = time.time()
                    gauge.labels(name=rule.name).set(1)
                    transitions.labels(name=rule.name, to="firing").inc()
                    emitted.append(obs_events.emit(
                        "alert.firing", name=rule.name,
                        metric=rule.metric, op=rule.op,
                        threshold=rule.threshold, value=worst,
                        for_s=rule.for_s))
                elif st.state == "ok":
                    st.state = "pending"
            else:
                st.value = (max(values) if values else None)
                st.cross_since = None
                if st.state == "firing":
                    st.state = "ok"
                    st.changed_ts = time.time()
                    gauge.labels(name=rule.name).set(0)
                    transitions.labels(name=rule.name, to="cleared").inc()
                    emitted.append(obs_events.emit(
                        "alert.cleared", name=rule.name,
                        metric=rule.metric, value=st.value))
                elif st.state == "pending":
                    st.state = "ok"
        return emitted

    def firing(self) -> List[str]:
        """Names of the rules currently firing (the /healthz detail)."""
        with self._lock:
            return sorted(n for n, st in self._states.items()
                          if st.state == "firing")

    def status(self) -> Dict[str, object]:
        """The ``GET /alertz`` body: every configured rule with its
        live state and last-seen value."""
        with self._lock:
            rules = list(self._rules)
            out_rules = []
            for r in rules:
                st = self._states[r.name]
                d = r.to_dict()
                d.update({
                    "state": st.state,
                    "value": st.value,
                    "since": st.changed_ts,
                })
                out_rules.append(d)
            return {
                "period_s": self.period_s,
                "evaluations": self.evaluations,
                "running": self._thread is not None
                and self._thread.is_alive(),
                "rules": out_rules,
                "firing": sorted(r["name"] for r in out_rules
                                 if r["state"] == "firing"),
            }

    # ------------------------------------------------------------------
    def start(self) -> "AlertEvaluator":
        """Start the background evaluation thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="cxxnet-obs-alerts", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.evaluate_once()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._thread = None


_EVALUATOR: Optional[AlertEvaluator] = None
_EVALUATOR_LOCK = threading.Lock()


def evaluator() -> AlertEvaluator:
    """The process-wide evaluator (what /alertz and /healthz read)."""
    global _EVALUATOR
    with _EVALUATOR_LOCK:
        if _EVALUATOR is None:
            _EVALUATOR = AlertEvaluator()
        return _EVALUATOR


def configure(cfg: Sequence[ConfigEntry]) -> None:
    """Arm the process-wide evaluator from the config stream and start
    its thread when any rules exist (no rules → no thread)."""
    ev = evaluator()
    ev.configure(cfg)
    if ev.rules():
        ev.start()


def reset() -> None:
    """Test isolation: stop the thread and drop the singleton."""
    global _EVALUATOR
    with _EVALUATOR_LOCK:
        ev, _EVALUATOR = _EVALUATOR, None
    if ev is not None:
        ev.stop()
