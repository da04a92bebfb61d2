"""The observability plane: metrics, spans, structured events, alerts.

The port's copy of ``cxxnet_tpu/obs/``, all stdlib-only but
``device.py``'s lazy ``torch`` and safe to import from any layer:

* :mod:`~.registry` — the process-wide :class:`MetricsRegistry` of
  labeled Counters / Gauges / bucketed Histograms, rendered as
  Prometheus text by the server's ``GET /metricsz``;
* :mod:`~.trace` — context-manager host spans with thread-local parent
  tracking and a bounded ring, exported as Chrome trace-event JSON
  (``trace_dir`` / ``trace_steps`` / ``trace_ring``);
* :mod:`~.events` — a rotating structured JSONL event log for lifecycle
  facts (``event_log`` / ``event_log_max_bytes`` / ``event_log_backups``
  / ``event_log_holdoff_s`` / ``event_log_ring``), with an always-on
  in-memory ring;
* :mod:`~.device` — the card's memory watermarks and sampled step waits
  (``device_telemetry`` / ``device_sample_every``);
* :mod:`~.alerts` — declarative threshold alerts over registry
  snapshots (``alert=<name>:<metric>:<op>:<threshold>[:for_s]`` /
  ``alert_period_s``), surfaced at ``GET /alertz`` and in ``/healthz``.

:func:`configure` routes one ordered config stream to every pillar —
the CLI calls it once at startup, right after the fault injector.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from . import alerts as alerts
from . import device as device
from . import events as events
from . import trace as trace
from .events import emit, event_log, log_exception_once, recent
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    PercentileWindow,
    registry,
)
from .trace import span, tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PercentileWindow",
    "registry",
    "tracer",
    "span",
    "alerts",
    "device",
    "events",
    "trace",
    "event_log",
    "emit",
    "recent",
    "log_exception_once",
    "configure",
]

ConfigEntry = Tuple[str, str]


def configure(cfg: Sequence[ConfigEntry]) -> None:
    """Arm every pillar from one ordered config stream (idempotent;
    unknown keys ignored)."""
    trace.configure(cfg)
    events.configure(cfg)
    device.configure(cfg)
    alerts.configure(cfg)
