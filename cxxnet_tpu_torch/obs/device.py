"""Device-plane telemetry for the card: memory watermarks, sampled steps.

The port's counterpart of ``cxxnet_tpu/obs/device.py``.  The host-side
pillars (registry / spans / events) say what the PROCESS is doing; this
module says what the CARD holds and how long a training step keeps it
busy.  All of it lands in the shared metrics registry, so ``GET
/metricsz`` exposes the device plane next to the host plane, under the
JAX package's names (one ``alert=`` rule reads both packages):

* ``xla_device_memory_bytes{device,stat}`` — live (``bytes_in_use``:
  ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``) and peak
  (``peak_bytes_in_use``: ``["allocated_bytes.all.peak"]``) bytes of
  PyTorch's caching allocator, and the card's ``bytes_limit`` (its total
  memory), sampled at scrape time for every card this process has
  initialized; absent on the CPU, as in the JAX package;
* ``train_step_device_seconds`` — a histogram of sampled step waits
  (``device_sample_every = N``: every Nth update waits for the card with
  ``torch.cuda.synchronize`` and the wait is observed).  Default off — a
  wait breaks the overlap of the host's enqueue with the card's work, so
  it is an opt-in diagnostic;
* ``kernel_selected{name,backend}`` — 1 for each C entry of the
  hand-written kernels (K1–K10, ``ops/_build.py``) this process has
  launched on the card (``backend = cuda``), and beside it
  ``kernel_launches_total{kernel,name}``, each entry's launches in this
  process (a port-only family, collected in ``ops/_build.py``);
* ``train_state_shard_bytes{device}`` / ``train_state_total_bytes`` —
  the trainer's params and updater state, as placed.

What is not ported: the JAX module's per-program
``xla_program_{flops,bytes,compile_seconds}`` and the process-wide
``xla_compiles_total`` / ``xla_compile_seconds_total`` read XLA's own
cost analysis and compile events.  The port runs eager PyTorch and
``ctypes``-bound kernels built once by ``nvcc``: there is no program to
cost and no compile per shape, so it emits none of them.

Nothing here raises into the code it measures, and nothing fails open
silently: an accounting fault is ``log_exception_once``'d (one event a
site, repeats counted).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from . import events as obs_events
from .registry import registry as obs_registry

__all__ = [
    "configure",
    "enabled",
    "register_memory_collector",
    "maybe_sample_step",
    "mark_kernel_selected",
    "set_train_state_bytes",
    "summary",
    "device_metrics",
    "reset",
]

ConfigEntry = Tuple[str, str]

#: sampled step-wait buckets (seconds), the JAX package's
STEP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: ``torch.cuda.memory_stats`` keys exported, under the JAX stat labels
_MEM_STATS = (("allocated_bytes.all.current", "bytes_in_use"),
              ("allocated_bytes.all.peak", "peak_bytes_in_use"))


class _State:
    """Module config + lifetime totals."""

    def __init__(self) -> None:
        # CXXNET_DEVICE_TELEMETRY=0 is the environment kill switch
        self.enabled = os.environ.get("CXXNET_DEVICE_TELEMETRY", "1") != "0"
        self.sample_every = 0
        self.lock = threading.Lock()
        self.sampled_steps = 0
        self.sampled_seconds = 0.0


_STATE = _State()


class _DeviceMetrics:
    """Lazy registry families for the device plane (shared process-wide)."""

    def __init__(self) -> None:
        self.step_seconds = obs_registry().histogram(
            "train_step_device_seconds",
            "Sampled per-step device fence time "
            "(device_sample_every = N).",
            buckets=STEP_BUCKETS,
        )


_METRICS: Optional[_DeviceMetrics] = None
_METRICS_LOCK = threading.Lock()


def device_metrics() -> _DeviceMetrics:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = _DeviceMetrics()
        return _METRICS


# ----------------------------------------------------------------------
# config
def configure(cfg: Sequence[ConfigEntry]) -> None:
    """Arm from the ordered config stream (``device_telemetry``,
    ``device_sample_every``); unknown keys ignored."""
    for name, val in cfg:
        if name == "device_telemetry":
            _STATE.enabled = bool(int(val))
        elif name == "device_sample_every":
            _STATE.sample_every = max(0, int(val))
    if _STATE.enabled:
        register_memory_collector()


def enabled() -> bool:
    return _STATE.enabled


def reset() -> None:
    """Test isolation: restore defaults and zero the lifetime totals."""
    global _METRICS
    _STATE.enabled = True
    _STATE.sample_every = 0
    with _STATE.lock:
        _STATE.sampled_steps = 0
        _STATE.sampled_seconds = 0.0
    with _METRICS_LOCK:
        _METRICS = None


# ----------------------------------------------------------------------
# device-memory watermarks (scrape-time collector)
def memory_samples():
    """``[({"device", "stat"}, bytes), ...]`` for every card this process
    has initialized; empty on the CPU (and before the first CUDA call,
    which a scrape must not make for it)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    samples = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        dev = f"cuda:{i}"
        for key, label in _MEM_STATS:
            v = stats.get(key)
            if v is not None:
                samples.append(({"device": dev, "stat": label}, float(v)))
        samples.append(({"device": dev, "stat": "bytes_limit"}, float(
            torch.cuda.get_device_properties(i).total_memory)))
    return samples


def _memory_collector():
    """Collector: the ``xla_device_memory_bytes{device,stat}`` family."""
    try:
        samples = memory_samples()
    except Exception as e:  # noqa: BLE001 - the scrape must survive
        obs_events.log_exception_once(
            "obs.device.memory", e, kind="obs.device_error")
        return []
    if not samples:
        return []
    return [("xla_device_memory_bytes", "gauge",
             "Device allocator watermarks from memory_stats() "
             "(absent on backends that do not report them).",
             samples)]


def register_memory_collector() -> None:
    """Plug the memory collector into the registry (idempotent, and
    again after a registry ``reset``)."""
    obs_registry().register_collector(_memory_collector)


# ----------------------------------------------------------------------
# the kernels' routes
def mark_kernel_selected(name: str, backend: str, active: bool) -> None:
    """Publish ``kernel_selected{name,backend}`` (1 = the hand-written
    kernel's C entry ``name`` runs on ``backend``, 0 = not).  Called by
    ``ops/_build.py`` when a C entry is first bound, so once a process
    per entry, never per launch."""
    try:
        obs_registry().gauge(
            "kernel_selected",
            "Kernel selection state: 1 when the named C entry of a "
            "hand-written kernel runs on this backend, else 0.",
            labelnames=("name", "backend"),
        ).labels(name=name, backend=backend).set(1.0 if active else 0.0)
    except Exception as e:  # noqa: BLE001 - telemetry must never raise
        obs_events.log_exception_once(
            "obs.device.kernel_selected", e, kind="obs.device_error")


# ----------------------------------------------------------------------
# train-state residency
def set_train_state_bytes(per_device: Dict[str, float], total: float) -> None:
    """Publish ``train_state_shard_bytes{device}`` (params + updater
    state resident on each device) and ``train_state_total_bytes`` (one
    full copy).  One device a process here, so the two agree.  Called by
    ``NetTrainer`` whenever its state is (re)placed: init, load, copy."""
    try:
        reg = obs_registry()
        g = reg.gauge(
            "train_state_shard_bytes",
            "Params + updater-state bytes resident per device "
            "(~1/N of the replicated total on a ZeRO mesh).",
            labelnames=("device",),
        )
        for dev, nbytes in sorted(per_device.items()):
            g.labels(device=dev).set(float(nbytes))
        reg.gauge(
            "train_state_total_bytes",
            "Bytes one full (replicated) copy of params + updater "
            "state costs — the ZeRO memory-win denominator.",
        ).set(float(total))
    except Exception as e:  # noqa: BLE001 - telemetry must never raise
        obs_events.log_exception_once(
            "obs.device.state_bytes", e, kind="obs.device_error")


# ----------------------------------------------------------------------
# sampled step waits
def maybe_sample_step(step: int, sync_fn: Callable[[], None]) -> bool:
    """Every ``device_sample_every``-th step (and only when the key is
    set), block on ``sync_fn`` and observe the wait as
    ``train_step_device_seconds``.  Off (the default) this is one int
    compare."""
    n = _STATE.sample_every
    if n <= 0 or (step % n) != 0:
        return False
    t0 = time.perf_counter()
    try:
        sync_fn()
    finally:
        dt = time.perf_counter() - t0
        try:
            device_metrics().step_seconds.observe(dt)
            with _STATE.lock:
                _STATE.sampled_steps += 1
                _STATE.sampled_seconds += dt
        except Exception as e:  # noqa: BLE001 - telemetry must never raise
            obs_events.log_exception_once(
                "obs.device.sample", e, kind="obs.device_error")
    return True


# ----------------------------------------------------------------------
def summary() -> Dict[str, float]:
    """Lifetime totals: the sampled step waits and their seconds."""
    with _STATE.lock:
        return {
            "sampled_steps": _STATE.sampled_steps,
            "sampled_seconds": round(_STATE.sampled_seconds, 6),
        }
