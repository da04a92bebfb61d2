"""Serving metrics: request/batch counters + latency percentiles.

The per-engine half of ``cxxnet_tpu/serve/metrics.py``: one
:class:`ServingStats` per engine, fed by the batcher and the request
path, rendered by ``GET /statsz``, with the served model's weight
gauges (``serve_weight_bytes``, ``serve_weight_bytes_f32`` and
``serve_quant_scheme`` there) and the two wire counters
(``serve_wire_requests_total`` by wire, ``serve_wire_bytes_total`` by
direction there), and the hot-reload lifecycle (``reload_attempts``,
``reload_failures``, ``reload_swaps``, ``last_reload_ok``).  The
process-wide Prometheus registry (``/metricsz``, with its
``serve_model_reloads_total``) belongs to a later slice.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np


class ServingStats:
    """Thread-safe counters: request outcomes (``ok`` / ``shed`` /
    ``expired`` / ``error``), executed batches with their real and
    padded rows, and end-to-end request latency over a window."""

    def __init__(self, latency_window: int = 2048) -> None:
        self._lock = threading.Lock()
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
        self._queue_depth = fn

    def set_weights(self, actual: int, f32_equiv: int, scheme: str) -> None:
        """The served model's weight bytes at rest as stored, their
        dense-f32 cost, and its precision scheme (``f32`` / ``int8`` /
        ``bf16``): the proof that an int8 export shrank what is served."""
        with self._lock:
            self.weight_bytes = int(actual)
            self.weight_bytes_f32 = int(f32_equiv)
            self.quant_scheme = scheme

    def record_request(self, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows_in += rows

    def record_wire(self, wire: str, nbytes_in: int = 0) -> None:
        """One data-plane request on ``wire`` (``json`` / ``binary``),
        with a binary frame's bytes in."""
        with self._lock:
            self.wire_requests[wire] += 1
            self.wire_bytes["in"] += nbytes_in

    def record_wire_out(self, nbytes: int) -> None:
        """A binary reply's bytes out."""
        with self._lock:
            self.wire_bytes["out"] += nbytes

    def record_outcome(self, outcome: str,
                       latency_s: Optional[float] = None) -> None:
        key = outcome if outcome in self.outcomes else "error"
        with self._lock:
            self.outcomes[key] += 1
            if latency_s is not None:
                self._latency.append(latency_s)

    def record_batch(self, rows: int, bucket_rows: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += rows
            self.bucket_rows += bucket_rows

    def record_reload(self, ok: bool, swapped: bool = False) -> None:
        """One breaker-gated reload attempt: failed, a swap, or a no-op."""
        with self._lock:
            self.reload_attempts += 1
            self.last_reload_ok = ok
            if not ok:
                self.reload_failures += 1
            elif swapped:
                self.reload_swaps += 1

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
