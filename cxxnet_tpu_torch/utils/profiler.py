"""Step timing, per-stage pipeline timing and trace capture.

The port's copy of ``cxxnet_tpu/utils/profiler.py``: ``StepTimer``,
``PipelineStats``/``pipeline_stats()`` (with its ``pipeline_stage_*``
collector) and ``PercentileTracker`` are the same code, and
``TraceController`` keeps the same keys and the same step window on
``torch.profiler``.

Config keys (all global):

* ``profile = 1`` — capture a ``torch.profiler`` trace window
* ``profile_dir = <dir>`` — trace output dir (default ``profile_out``)
* ``profile_start = 5`` — global step index to start the trace
* ``profile_steps = 10`` — number of steps to trace

The trace is Chrome trace JSON (``<profile_dir>/trace_<pid>_<n>.json``,
loadable in ``chrome://tracing`` or Perfetto), not the XLA xplane that
the JAX package writes: it holds the host's PyTorch ops and, on the
card, the CUDA kernels and copies they launched (the port's kernels
under their C symbols).  On the CPU it records CPU activity only.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs.registry import PercentileWindow, registry as _obs_registry

ConfigEntry = Tuple[str, str]


class PercentileTracker(PercentileWindow):
    """Thread-safe sliding-window percentile estimator (serving latency).

    A thin facade over :class:`cxxnet_tpu_torch.obs.registry.PercentileWindow`
    — the shared observability primitive — kept under its historical
    name so serving and pipeline call sites read unchanged.  Unlike
    :class:`StepTimer` (one round of a single-threaded train loop) this
    is written for many concurrent request threads recording into one
    tracker for the whole server lifetime, so it is locked and bounded.

    ``summary()`` reports a window-consistent ``mean`` (same samples as
    p50/p95/p99) plus the all-time ``lifetime_mean``/``count`` — the old
    mixed report (lifetime mean next to window percentiles) read as a
    contradiction whenever behavior shifted mid-run."""


class PipelineStats:
    """Per-stage input-pipeline timing: decode / augment / batch / h2d /
    device_wait (plus any custom stage name), each on a
    :class:`PercentileTracker` with total-time and row accounting.

    One process-wide instance (:func:`pipeline_stats`) so the io/ chain,
    the trainer's transfer path, and the CLI's round loop all record
    into the same registry without plumbing.  Thread-safe — decode pool
    workers record concurrently.  A stage's ``rows_per_sec`` is its
    LOCAL rate (rows / time spent inside the stage), i.e. what the
    stage could sustain if it were the only bottleneck; comparing
    stages shows where the host pipeline's time actually goes.
    """

    STAGES = ("decode", "augment", "batch", "h2d", "device_wait")

    def __init__(self, window: int = 2048) -> None:
        self._window = window
        self._lock = threading.Lock()
        self._stages: Dict[str, list] = {}  # name -> [tracker, total_s, rows]

    def add(self, stage: str, dt_s: float, rows: int = 1) -> None:
        # the whole record happens under the lock: a concurrent reset()
        # swaps the stage dict, and an add must land entirely in one
        # epoch's dict — recording the tracker outside the lock let a
        # reset discard the entry between the totals and the sample
        with self._lock:
            ent = self._stages.get(stage)
            if ent is None:
                ent = [PercentileTracker(self._window), 0.0, 0]
                self._stages[stage] = ent
            ent[1] += float(dt_s)
            ent[2] += int(rows)
            ent[0].add(dt_s)

    def reset(self) -> None:
        """Start a new accounting epoch.  Swap-atomic: the old stage
        dict is replaced wholesale under the lock, so an ``add()``
        racing from a decode-pool worker lands either entirely in the
        discarded epoch or entirely in the new one — never half in
        each, and never into a tracker the snapshot can no longer
        reach."""
        with self._lock:
            self._stages = {}

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{stage: {count, rows, total_s, rows_per_sec, mean_ms,
        p50_ms, p95_ms, p99_ms}}`` — every canonical stage is present
        (zeroed when it never ran) so consumers can rely on the schema."""
        with self._lock:
            items = {k: (ent[0], ent[1], ent[2])
                     for k, ent in self._stages.items()}
        out: Dict[str, Dict[str, float]] = {}
        for name in (*self.STAGES, *sorted(set(items) - set(self.STAGES))):
            if name not in items:
                out[name] = {"count": 0, "rows": 0, "total_s": 0.0,
                             "rows_per_sec": 0.0}
                continue
            tracker, total_s, rows = items[name]
            row = {
                "count": float(tracker.count),
                "rows": float(rows),
                "total_s": total_s,
                "rows_per_sec": rows / total_s if total_s > 0 else 0.0,
            }
            summ = tracker.summary(scale=1e3)
            for k, v in summ.items():
                if k != "count":
                    row[f"{k}_ms"] = v
            out[name] = row
        return out

    def report(self) -> str:
        """One line per active stage: local rows/sec + mean ms/op."""
        parts = []
        for name, row in self.snapshot().items():
            if not row["count"]:
                continue
            parts.append(
                f"{name} {row['rows_per_sec']:.0f} rows/s "
                f"({row.get('mean_ms', 0.0):.2f} ms/op)"
            )
        return " | ".join(parts)

    def collect(self):
        """Scrape-time exporter for the metrics registry (registered on
        the process-wide instance), labeled ``{stage=...}`` —
        ``/metricsz`` coverage without double-writing every sample.
        Everything exports as GAUGES: the totals are per-epoch (the
        round loop calls :meth:`reset` each round), and a counter that
        sawtooths to zero would poison ``rate()``/``increase()`` on any
        Prometheus-compatible scraper."""
        snap = self.snapshot()
        fams = []
        for name, kind, help_, field in (
            ("pipeline_stage_rows", "gauge",
             "Rows processed per host-pipeline stage (current epoch; "
             "resets each round).", "rows"),
            ("pipeline_stage_seconds", "gauge",
             "Seconds spent inside each host-pipeline stage "
             "(current epoch; resets each round).", "total_s"),
            ("pipeline_stage_mean_ms", "gauge",
             "Window-mean milliseconds per operation, per stage.",
             "mean_ms"),
            ("pipeline_stage_p99_ms", "gauge",
             "Window p99 milliseconds per operation, per stage.",
             "p99_ms"),
        ):
            samples = [({"stage": st}, row[field])
                       for st, row in snap.items() if field in row]
            fams.append((name, kind, help_, samples))
        return fams


_PIPELINE_STATS = PipelineStats()
_obs_registry().register_collector(_PIPELINE_STATS.collect)


def pipeline_stats() -> PipelineStats:
    """The process-wide per-stage pipeline timing registry."""
    return _PIPELINE_STATS


class StepTimer:
    """Wall-clock statistics over training steps (one round at a time)."""

    def __init__(self) -> None:
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int = 1) -> None:
        """``n_steps > 1``: the timed span covered a multi-step device
        program (update_scan); record the per-step average so the round
        statistics stay per-step comparable."""
        if self._t0 is not None:
            self.add(time.perf_counter() - self._t0, n_steps)
            self._t0 = None

    def add(self, dt: float, n_steps: int = 1) -> None:
        """Record an externally measured span covering ``n_steps`` steps
        (the async-overlap train loop times fence-to-fence laps itself
        so the spans sum to the round's wall time)."""
        per = dt / max(1, n_steps)
        self._times.extend([per] * max(1, n_steps))

    def clear(self) -> None:
        self._times = []
        self._t0 = None

    @property
    def count(self) -> int:
        return len(self._times)

    def summary(self, batch_size: int = 0) -> Dict[str, float]:
        """mean/p50/p99 step ms (+ samples/sec if batch_size given).

        The first step of a round is dropped when there are enough
        samples — it absorbs the warm-up (kernel builds, cuDNN's
        algorithm search).
        """
        if not self._times:
            return {}
        ts = sorted(self._times[1:] if len(self._times) > 4 else self._times)
        n = len(ts)
        mean = sum(ts) / n
        out = {
            "steps": float(len(self._times)),
            "mean_ms": mean * 1e3,
            "p50_ms": ts[n // 2] * 1e3,
            "p99_ms": ts[min(n - 1, int(n * 0.99))] * 1e3,
        }
        if batch_size:
            out["samples_per_sec"] = batch_size / mean
        return out

    def report(self, batch_size: int = 0) -> str:
        s = self.summary(batch_size)
        if not s:
            return ""
        msg = (
            f"step {s['mean_ms']:.1f} ms avg "
            f"(p50 {s['p50_ms']:.1f}, p99 {s['p99_ms']:.1f})"
        )
        if "samples_per_sec" in s:
            msg += f", {s['samples_per_sec']:.1f} samples/sec"
        return msg


class TraceController:
    """Starts/stops a ``torch.profiler`` trace over a configured step
    window (the JAX package's window: the trace opens at the first step
    ``>= profile_start`` and closes ``profile_steps`` steps later, or at
    :meth:`close`), then writes it as Chrome trace JSON into
    ``profile_dir``."""

    def __init__(self) -> None:
        self.enabled = 0
        self.trace_dir = "profile_out"
        self.start_step = 5
        self.num_steps = 10
        self._active = False
        self._done = False
        self._prof = None
        self.trace_path: Optional[str] = None

    def set_param(self, name: str, val: str) -> None:
        if name == "profile":
            self.enabled = int(val)
        elif name == "profile_dir":
            self.trace_dir = val
        elif name == "profile_start":
            self.start_step = int(val)
        elif name == "profile_steps":
            self.num_steps = int(val)

    def configure(self, cfg: Sequence[ConfigEntry]) -> None:
        for n, v in cfg:
            self.set_param(n, v)

    def _start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def _stop(self) -> None:
        import torch

        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's kernels land in it
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        n = 0
        while True:
            path = os.path.join(self.trace_dir,
                                f"trace_{os.getpid()}_{n}.json")
            if not os.path.exists(path):
                break
            n += 1
        prof.export_chrome_trace(path)
        self.trace_path = path

    def step(self, global_step: int) -> None:
        """Call once per training step with the global step index."""
        if not self.enabled or self._done:
            return
        if not self._active and global_step >= self.start_step:
            self._start()
            self._active = True
            self._stop_at = global_step + self.num_steps
        elif self._active and global_step >= self._stop_at:
            self._stop()
            self._active = False
            self._done = True

    def close(self) -> None:
        if self._active:
            self._stop()
            self._active = False
            self._done = True
