"""Process-wide metrics registry: Counters, Gauges, bucketed Histograms.

The port's copy of ``cxxnet_tpu/obs/registry.py``, the metrics pillar
of the observability plane:

* :class:`MetricsRegistry` — thread-safe, name-keyed registry of
  labeled metrics with get-or-create semantics (two subsystems asking
  for the same counter share it) and pluggable *collectors* for state
  that is cheaper to snapshot at scrape time than to double-write (the
  card's memory watermarks, ``obs/device.py``).
* :class:`Counter` / :class:`Gauge` / :class:`Histogram` — the
  Prometheus metric kinds.  Histograms are cumulative-bucket
  (``le``-labeled) with ``_sum``/``_count``.
* :class:`PercentileWindow` — the sliding-window percentile estimator:
  exact window percentiles for human-facing output.
* :meth:`MetricsRegistry.render_prometheus` — the text exposition
  (version 0.0.4) behind the server's ``GET /metricsz``, rendered
  byte for byte as the JAX package renders it.

Everything here is stdlib-only and import-cheap: the registry is
touched from hot paths (request accounting) and at import time across
serve/, utils/ and nnet/.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "PercentileWindow",
    "MetricsRegistry",
    "registry",
    "DEFAULT_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Prometheus' classic latency buckets (seconds) — wide enough for both
#: sub-ms device dispatch and multi-second cold compiles.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelValues = Tuple[str, ...]


def escape_label_value(value: str) -> str:
    """Escape a label value per the text exposition format: backslash,
    double-quote and newline must be escaped, everything else is raw."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (but not quotes)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    """Render a sample value: integers without a trailing ``.0``,
    non-finite values as Prometheus spells them."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_to_text(names: Sequence[str], values: LabelValues) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    """Base: one named family with fixed label names and per-labelset
    children.  ``labels(...)`` returns the child for one labelset;
    the no-label child is the metric itself (``inc``/``set``/``observe``
    directly on the family)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"bad label name {ln!r} for {name}")
        if len(set(labelnames)) != len(tuple(labelnames)):
            raise ValueError(f"duplicate label names for {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[LabelValues, object] = {}

    # child management ---------------------------------------------------
    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass labels positionally OR by name")
            try:
                values = tuple(kv[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r}"
                ) from None
            if len(kv) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: unexpected labels "
                    f"{sorted(set(kv) - set(self.labelnames))}"
                )
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label value(s), "
                f"got {len(values)}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
        return child

    def _default_child(self):
        """The ()-labelset child for label-less metrics."""
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()"
            )
        return self.labels()

    def _make_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def children(self) -> List[Tuple[LabelValues, object]]:
        with self._lock:
            return sorted(self._children.items())

    # exposition ---------------------------------------------------------
    def samples(self) -> List[Tuple[str, str, float]]:
        """``[(suffixed_name, rendered_labels, value), ...]``."""
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    """Monotonically increasing count (name it ``*_total``)."""

    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def samples(self):
        return [
            (self.name, _labels_to_text(self.labelnames, lv), c.value)
            for lv, c in self.children()
        ]


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._fn = None

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Sample ``fn()`` at scrape time (live gauges: queue depth).
        A raising ``fn`` makes the sample *absent* — scrape errors are
        the caller's to count (see ServingStats.queue_depth_errors);
        a sentinel value would poison dashboards silently."""
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        """Current value; raises whatever a bound function raises."""
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        return float(fn())


class Gauge(_Metric):
    """A value that can go up and down, or track a live callable."""

    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default_child().set_function(fn)

    def get(self) -> float:
        return self._default_child().get()

    def samples(self):
        out = []
        for lv, c in self.children():
            try:
                v = c.get()
            except Exception:  # noqa: BLE001 - absent sample, not a 500
                continue
            out.append((self.name, _labels_to_text(self.labelnames, lv), v))
        return out


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        for i, b in enumerate(self._bounds):  # noqa: B007
            if v <= b:
                break
        else:
            i = len(self._bounds)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count


class Histogram(_Metric):
    """Cumulative-bucket histogram (``le`` buckets + ``_sum``/``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"{name}: bucket bounds must be increasing")
        if "le" in labelnames:
            raise ValueError(f"{name}: 'le' is reserved for buckets")
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def samples(self):
        out = []
        for lv, c in self.children():
            counts, total, count = c.snapshot()
            acc = 0
            for b, n in zip(self.buckets, counts):
                acc += n
                out.append((
                    self.name + "_bucket",
                    _labels_to_text(
                        self.labelnames + ("le",), lv + (format_value(b),)
                    ),
                    acc,
                ))
            out.append((
                self.name + "_bucket",
                _labels_to_text(self.labelnames + ("le",), lv + ("+Inf",)),
                count,
            ))
            base = _labels_to_text(self.labelnames, lv)
            out.append((self.name + "_sum", base, total))
            out.append((self.name + "_count", base, count))
        return out


class PercentileWindow:
    """Thread-safe sliding-window percentile estimator.

    Keeps the newest ``window`` samples in a ring buffer; percentiles
    AND the window mean are computed over that window on demand, while
    lifetime ``count``/``total`` accumulate forever: exact small-window
    percentiles for human-facing snapshots, where a bucketed
    :class:`Histogram` would quantize."""

    def __init__(self, window: int = 2048) -> None:
        self._window = max(1, int(window))
        self._buf: List[float] = []
        self._pos = 0
        self._count = 0
        self._total = 0.0
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            if len(self._buf) < self._window:
                self._buf.append(float(value))
            else:
                self._buf[self._pos] = float(value)
                self._pos = (self._pos + 1) % self._window
            self._count += 1
            self._total += float(value)

    @property
    def count(self) -> int:
        return self._count

    @staticmethod
    def _percentiles_of(snap: List[float],
                        qs: Sequence[float]) -> Dict[str, float]:
        n = len(snap)
        out = {}
        for q in qs:
            idx = min(n - 1, max(0, int(round(q / 100.0 * n)) - 1))
            out[f"p{q:g}"] = snap[idx]
        return out

    def percentiles(
        self, qs: Sequence[float] = (50.0, 95.0, 99.0)
    ) -> Dict[str, float]:
        """``{"p50": ..., "p95": ...}`` over the current window (empty
        dict when no samples); nearest-rank on the sorted window."""
        with self._lock:
            snap = sorted(self._buf)
        if not snap:
            return {}
        return self._percentiles_of(snap, qs)

    def summary(self, scale: float = 1.0) -> Dict[str, float]:
        """count / mean / lifetime_mean / p50 / p95 / p99, each value
        multiplied by ``scale`` (pass 1e3 to report seconds as ms).

        ``mean`` and the percentiles cover the SAME sliding window, so
        they are mutually consistent; ``lifetime_mean`` (with ``count``)
        is the all-time average — the two diverge exactly when recent
        behavior shifted, which is the signal worth alerting on."""
        with self._lock:
            count, total = self._count, self._total
            snap = sorted(self._buf)
        if not count:
            return {"count": 0}
        out = {
            "count": float(count),
            "mean": sum(snap) / len(snap) * scale,
            "lifetime_mean": total / count * scale,
        }
        out.update(
            {k: v * scale
             for k, v in self._percentiles_of(snap, (50.0, 95.0, 99.0)).items()}
        )
        return out


#: A collector returns an iterable of ``(name, kind, help, samples)``
#: families at scrape time; samples are ``(labels_dict, value)`` pairs.
CollectorFn = Callable[[], Iterable[Tuple[str, str, str,
                                          List[Tuple[Dict[str, str], float]]]]]


class MetricsRegistry:
    """Thread-safe, name-keyed registry of metric families.

    ``counter()`` / ``gauge()`` / ``histogram()`` are get-or-create:
    asking twice for the same name returns the same object, and asking
    with a conflicting kind / label set / bucket layout raises — two
    subsystems cannot silently fork one metric.  ``register_collector``
    plugs in scrape-time exporters for state that already has its own
    locking (the card's memory watermarks)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[CollectorFn] = []

    # get-or-create ------------------------------------------------------
    def _get_or_make(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, labelnames=labelnames, **kw)
                self._metrics[name] = m
                return m
        if type(m) is not cls:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}"
            )
        if m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{m.labelnames}, not {tuple(labelnames)}"
            )
        if kw.get("buckets") is not None and tuple(
                sorted(float(b) for b in kw["buckets"])) != m.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                "buckets"
            )
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def register_collector(self, fn: CollectorFn) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: CollectorFn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric and collector (test isolation only — live
        code holds references to registered metrics, never re-asks)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    # exposition ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{family: {"name{labels}": value}}`` — the machine-readable
        twin of :meth:`render_prometheus` for in-process consumers,
        including collector-exported families."""
        out: Dict[str, Dict[str, float]] = {}
        for m in self.metrics():
            out[m.name] = {
                f"{n}{labels}": float(v) for n, labels, v in m.samples()
            }
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                families = list(fn())
            except Exception:  # noqa: BLE001 - same policy as render
                continue
            for name, _kind, _help, samples in families:
                fam = out.setdefault(name, {})
                for labelmap, value in samples:
                    names = tuple(sorted(labelmap))
                    txt = _labels_to_text(
                        names, tuple(str(labelmap[k]) for k in names)
                    )
                    fam[f"{name}{txt}"] = float(value)
        return out

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4 (the ``/metricsz`` body)."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, labels, value in m.samples():
                lines.append(f"{name}{labels} {format_value(value)}")
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                families = list(fn())
            except Exception:  # noqa: BLE001 - one bad collector must
                continue       # not take down the whole scrape
            for name, kind, help, samples in families:
                if not _NAME_RE.match(name):
                    continue
                if help:
                    lines.append(f"# HELP {name} {escape_help(help)}")
                lines.append(f"# TYPE {name} {kind}")
                for labelmap, value in samples:
                    names = tuple(sorted(labelmap))
                    txt = _labels_to_text(
                        names, tuple(str(labelmap[k]) for k in names)
                    )
                    lines.append(f"{name}{txt} {format_value(value)}")
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry (what ``/metricsz`` renders)."""
    return _REGISTRY
