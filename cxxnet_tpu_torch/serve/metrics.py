"""Serving metrics: request/batch counters + latency percentiles.

The per-engine half of ``cxxnet_tpu/serve/metrics.py``: one
:class:`ServingStats` per engine, fed by the batcher and the request
path, rendered by ``GET /statsz``, with the served model's weight
gauges (``serve_weight_bytes``, ``serve_weight_bytes_f32`` and
``serve_quant_scheme`` there) and the two wire counters
(``serve_wire_requests_total`` by wire, ``serve_wire_bytes_total`` by
direction there), and the hot-reload lifecycle (``reload_attempts``,
``reload_failures``, ``reload_swaps``, ``last_reload_ok``).

Every ``record_*`` call also feeds the process-wide registry
(``obs/registry.py``) under the JAX package's families
(``serve_requests_total``, ``serve_request_outcomes_total{outcome}``,
``serve_request_latency_seconds``, ``serve_model_reloads_total{result}``,
the wire and weight families, ...), which is what ``GET /metricsz``
renders; ``/statsz`` keeps its shape.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..obs.registry import DEFAULT_BUCKETS, registry as obs_registry

__all__ = ["ServingStats", "serve_metrics"]


class _ServeMetrics:
    """The process-wide registry families of the serving subsystem
    (shared across engines in one process: Prometheus counters are
    per-process facts; per-engine detail stays in ``/statsz``)."""

    def __init__(self) -> None:
        reg = obs_registry()
        self.requests = reg.counter(
            "serve_requests_total", "Requests accepted into the engine.")
        self.rows_in = reg.counter(
            "serve_request_rows_total", "Instance rows across requests.")
        self.outcomes = reg.counter(
            "serve_request_outcomes_total",
            "Request outcomes: ok / shed (429) / expired (504) / error.",
            labelnames=("outcome",),
        )
        self.batches = reg.counter(
            "serve_batches_total", "Coalesced batches executed.")
        self.batch_rows = reg.counter(
            "serve_batch_rows_total", "Real rows in executed batches.")
        self.bucket_rows = reg.counter(
            "serve_bucket_rows_total",
            "Padded bucket rows computed (fill ratio denominator).",
        )
        self.latency = reg.histogram(
            "serve_request_latency_seconds",
            "End-to-end request latency (enqueue to result).",
            buckets=DEFAULT_BUCKETS,
        )
        self.reloads = reg.counter(
            "serve_model_reloads_total",
            "Hot-reload attempts by result: swapped / noop / failed.",
            labelnames=("result",),
        )
        self.queue_depth = reg.gauge(
            "serve_queue_depth", "Live micro-batcher queue depth.")
        self.model_round = reg.gauge(
            "serve_model_round",
            "Checkpoint round of the currently served model.")
        self.model_crc = reg.gauge(
            "serve_model_crc32",
            "Manifest CRC32 of the served checkpoint payload (weights "
            "fingerprint; -1 when unknown).")
        self.queue_depth_errors = reg.counter(
            "serve_queue_depth_errors_total",
            "Queue-depth gauge sampling failures.",
        )
        self.weight_bytes = reg.gauge(
            "serve_weight_bytes",
            "Model weight bytes at rest in the serving engine (as "
            "stored: int8 codes + f32 scales for quantized models).")
        self.weight_bytes_f32 = reg.gauge(
            "serve_weight_bytes_f32",
            "Dense-f32 cost of the same weight tensors (the "
            "quantization win's denominator).")
        self.quant_scheme = reg.gauge(
            "serve_quant_scheme",
            "Served weight precision (1 on the active scheme label).",
            labelnames=("scheme",),
        )
        self.request_buckets = reg.counter(
            "serve_request_bucket_total",
            "Requests by pow2 row-count bucket (shape histogram).",
            labelnames=("bucket",),
        )
        self.wire_requests = reg.counter(
            "serve_wire_requests_total",
            "Data-plane requests by wire format.",
            labelnames=("wire",),
        )
        self.wire_bytes = reg.counter(
            "serve_wire_bytes_total",
            "Binary-frame bytes moved, by direction (in / out).",
            labelnames=("dir",),
        )


_METRICS: Optional[_ServeMetrics] = None
_METRICS_LOCK = threading.Lock()


def serve_metrics() -> _ServeMetrics:
    """Lazily build (once) the serving metric families."""
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = _ServeMetrics()
        return _METRICS


class ServingStats:
    """Thread-safe counters: request outcomes (``ok`` / ``shed`` /
    ``expired`` / ``error``), executed batches with their real and
    padded rows, and end-to-end request latency over a window."""

    def __init__(self, latency_window: int = 2048) -> None:
        self._lock = threading.Lock()
        self._m = serve_metrics()
        self.started = time.time()
        self.requests = 0
        self.rows_in = 0
        self.outcomes = {"ok": 0, "shed": 0, "expired": 0, "error": 0}
        self.batches = 0
        self.batch_rows = 0
        self.bucket_rows = 0
        self._latency = collections.deque(maxlen=latency_window)
        self._queue_depth: Optional[Callable[[], int]] = None
        self.weight_bytes = 0
        self.weight_bytes_f32 = 0
        self.quant_scheme = "f32"
        # data-plane requests by wire, and binary-frame bytes by
        # direction: the share of traffic the zero-copy path carries
        self.wire_requests = {"json": 0, "binary": 0}
        self.wire_bytes = {"in": 0, "out": 0}
        # hot reload (the poll thread / try_reload): attempts, failures,
        # completed swaps, and the last poll's verdict
        self.reload_attempts = 0
        self.reload_failures = 0
        self.reload_swaps = 0
        self.last_reload_ok: Optional[bool] = None

    def bind_queue_depth(self, fn: Callable[[], int]) -> None:
        """The live queue depth for ``/statsz``, also sampled by the
        registry gauge at scrape time (last engine bound wins)."""
        self._queue_depth = fn
        self._m.queue_depth.set_function(fn)

    def set_weights(self, actual: int, f32_equiv: int, scheme: str) -> None:
        """The served model's weight bytes at rest as stored, their
        dense-f32 cost, and its precision scheme (``f32`` / ``int8`` /
        ``bf16``): the proof that an int8 export shrank what is served."""
        with self._lock:
            self.weight_bytes = int(actual)
            self.weight_bytes_f32 = int(f32_equiv)
            self.quant_scheme = scheme
        m = self._m
        m.weight_bytes.set(actual)
        m.weight_bytes_f32.set(f32_equiv)
        for s in ("f32", "int8", "bf16"):
            m.quant_scheme.labels(scheme=s).set(1.0 if s == scheme else 0.0)

    def record_request(self, rows: int,
                       bucket: Optional[int] = None) -> None:
        with self._lock:
            self.requests += 1
            self.rows_in += rows
        self._m.requests.inc()
        self._m.rows_in.inc(rows)
        if bucket is not None:
            self._m.request_buckets.labels(bucket=bucket).inc()

    def record_wire(self, wire: str, nbytes_in: int = 0) -> None:
        """One data-plane request on ``wire`` (``json`` / ``binary``),
        with a binary frame's bytes in."""
        with self._lock:
            self.wire_requests[wire] += 1
            self.wire_bytes["in"] += nbytes_in
        self._m.wire_requests.labels(wire=wire).inc()
        if nbytes_in:
            self._m.wire_bytes.labels(dir="in").inc(nbytes_in)

    def record_wire_out(self, nbytes: int) -> None:
        """A binary reply's bytes out."""
        with self._lock:
            self.wire_bytes["out"] += nbytes
        self._m.wire_bytes.labels(dir="out").inc(nbytes)

    def record_outcome(self, outcome: str,
                       latency_s: Optional[float] = None) -> None:
        key = outcome if outcome in self.outcomes else "error"
        with self._lock:
            self.outcomes[key] += 1
            if latency_s is not None:
                self._latency.append(latency_s)
        self._m.outcomes.labels(outcome=key).inc()
        if latency_s is not None:
            self._m.latency.observe(latency_s)

    def record_batch(self, rows: int, bucket_rows: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += rows
            self.bucket_rows += bucket_rows
        self._m.batches.inc()
        self._m.batch_rows.inc(rows)
        self._m.bucket_rows.inc(bucket_rows)

    def record_reload(self, ok: bool, swapped: bool = False) -> None:
        """One breaker-gated reload attempt: failed, a swap, or a no-op."""
        with self._lock:
            self.reload_attempts += 1
            self.last_reload_ok = ok
            if not ok:
                self.reload_failures += 1
            elif swapped:
                self.reload_swaps += 1
        result = "failed" if not ok else "swapped" if swapped else "noop"
        self._m.reloads.labels(result=result).inc()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            lat = np.asarray(self._latency, np.float64) * 1e3
            out: Dict[str, object] = {
                "uptime_sec": time.time() - self.started,
                "requests": self.requests,
                "rows_in": self.rows_in,
                **self.outcomes,
                "batches": self.batches,
                "batch_rows": self.batch_rows,
                "bucket_rows": self.bucket_rows,
                "batch_fill_ratio": (self.batch_rows / self.bucket_rows
                                     if self.bucket_rows else 0.0),
                "rows_per_batch": (self.batch_rows / self.batches
                                   if self.batches else 0.0),
                "weight_bytes": self.weight_bytes,
                "weight_bytes_f32": self.weight_bytes_f32,
                "quant_scheme": self.quant_scheme,
                "wire_requests": dict(self.wire_requests),
                "wire_bytes": dict(self.wire_bytes),
                "reload_attempts": self.reload_attempts,
                "reload_failures": self.reload_failures,
                "reload_swaps": self.reload_swaps,
                "last_reload_ok": self.last_reload_ok,
            }
        out["latency_ms"] = ({
            "count": int(lat.size),
            "mean": float(lat.mean()),
            "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)),
            "max": float(lat.max()),
        } if lat.size else {"count": 0})
        if self._queue_depth is not None:
            out["queue_depth"] = int(self._queue_depth())
        return out
