"""Serving fleet: replica supervision, rolling reload, int8 canaries.

The port's copy of ``cxxnet_tpu/serve/fleet.py``.  One ``task=serve``
process is one crash away from an empty front door.  This module runs N
engine **replicas** — each a full ``task=serve`` subprocess of the port
with its own engine, batcher, CUDA context and caching allocator —
behind one front end (:mod:`~cxxnet_tpu_torch.serve.router`), with:

* **supervision** — :class:`ReplicaSupervisor` probes every replica's
  ``/healthz`` on a fixed cadence: answering → HEALTHY, a few missed
  probes → SLOW (still in rotation — a transient blip must not empty
  the front door), missed probes past ``fleet_slow_probes`` → WEDGED
  (ejected from rotation, killed, restarted), process exit → GONE
  (restarted).  Restarts back off exponentially
  (``fleet_restart_backoff_s`` … ``fleet_restart_backoff_max_s``) and
  are capped by ``fleet_max_restarts`` (0 = unlimited).  Losing k of N
  replicas shrinks admission capacity and throughput — never
  availability, as long as one replica answers.  A replica that cannot
  reach its device raises at start, exits, and is seen GONE.
* **rolling reload** — :meth:`ServingFleet.rolling_reload` walks the
  rotation ONE replica at a time, triggering each engine's breaker-gated
  hot reload through ``POST /reloadz`` and waiting for the replica to
  probe healthy on the new round before touching the next; a
  fleet-level :class:`~cxxnet_tpu_torch.utils.faults.CircuitBreaker`
  aborts the rollout on repeated failures, so a bad round can wedge at
  most ``threshold`` replicas while the rest keep serving the old one.
* **int8 canary** — with ``canary = int8``, ``canary_replicas`` of the
  fleet are launched with ``quant=int8`` (they prefer the gated
  ``.quant.model`` sibling); the router sends a ``canary_slice`` of live
  predict traffic to them and MIRRORS a ``canary_sample`` of baseline
  traffic for row-level agreement.  Agreement and latency land in the
  shared registry families (``canary_agreement``,
  ``canary_latency_ratio``, ``canary_requests_total{leg}``), an alert
  rule on ``canary_agreement`` is armed automatically, and
  :class:`CanaryController` promotes (publish pointer → the quant
  artifact, canary joins the rotation at full weight) or rolls back
  (publish pointer restored, canary relaunched at f32); the rollback
  trigger is the ``/alertz`` evaluator firing.

The families keep the JAX package's names, so one ``alert=`` rule reads
either package.  The chaos site is ``serve.replica`` (``hang`` wedges a
replica's health plane, ``ioerror`` crashes the process;
``serve/server.py::replica_fault_probe``).  Imports the standard library
and the port's ``obs`` and ``utils`` only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from ..parallel.elastic import free_port
from ..utils.faults import CircuitBreaker

ConfigEntry = Tuple[str, str]

__all__ = [
    "FleetOptions",
    "Replica",
    "ReplicaSupervisor",
    "CanaryController",
    "ServingFleet",
    "fleet_metrics",
    "cli_spawn_fn",
    "stub_spawn_fn",
]

#: replica states.  HEALTHY and SLOW are in rotation; everything else
#: is not.  SLOW = missed probes below the wedge threshold (transient
#: blips must not empty the front door); WEDGED = ejected + restarting;
#: QUARANTINED = answering but integrity-degraded (golden canary
#: mismatch) — ejected from rotation, NOT killed, readmitted by the
#: next clean probe.
STATES = ("starting", "healthy", "slow", "quarantined", "wedged",
          "gone", "backoff", "failed", "stopped")
IN_ROTATION = ("healthy", "slow")


# ----------------------------------------------------------------------
@dataclasses.dataclass
class FleetOptions:
    """The ``replicas`` / ``fleet_*`` / ``canary_*`` config surface."""

    replicas: int = 1
    probe_period_s: float = 1.0
    probe_timeout_s: float = 2.0
    slow_probes: int = 3           # consecutive missed probes => wedged
    start_timeout_s: float = 180.0
    restart_backoff_s: float = 0.5
    restart_backoff_max_s: float = 15.0
    max_restarts: int = 0          # per replica; 0 = unlimited
    replica_inflight: int = 64     # admission: in-flight cap per healthy replica
    batch_shed_ratio: float = 0.5  # batch sheds above this capacity fraction
    dispatch_retries: int = 2      # failovers per request beyond the first try
    dispatch_timeout_s: float = 60.0
    pool_size: int = 8             # idle keep-alive connections kept per replica
    log_dir: str = ""              # replica stdout/stderr logs
    reload_timeout_s: float = 120.0
    reload_breaker_threshold: int = 3
    canary: str = ""               # quant scheme for canary replicas; "" = off
    canary_replicas: int = 1
    canary_slice: float = 0.1      # live-traffic fraction routed to the canary
    canary_sample: float = 0.25    # baseline fraction mirrored for agreement
    canary_min_requests: int = 50  # compared rows before any decision
    canary_min_agreement: float = 0.99
    canary_decision_period_s: float = 1.0

    @classmethod
    def from_cfg(cls, cfg: Sequence[ConfigEntry]) -> "FleetOptions":
        o = cls()
        for name, val in cfg:
            if name == "replicas":
                o.replicas = int(val)
            elif name == "fleet_probe_period_s":
                o.probe_period_s = float(val)
            elif name == "fleet_probe_timeout_s":
                o.probe_timeout_s = float(val)
            elif name == "fleet_slow_probes":
                o.slow_probes = int(val)
            elif name == "fleet_start_timeout_s":
                o.start_timeout_s = float(val)
            elif name == "fleet_restart_backoff_s":
                o.restart_backoff_s = float(val)
            elif name == "fleet_restart_backoff_max_s":
                o.restart_backoff_max_s = float(val)
            elif name == "fleet_max_restarts":
                o.max_restarts = int(val)
            elif name == "fleet_replica_inflight":
                o.replica_inflight = int(val)
            elif name == "fleet_batch_shed_ratio":
                o.batch_shed_ratio = float(val)
            elif name == "fleet_dispatch_retries":
                o.dispatch_retries = int(val)
            elif name == "fleet_dispatch_timeout_s":
                o.dispatch_timeout_s = float(val)
            elif name == "fleet_pool_size":
                o.pool_size = int(val)
            elif name == "fleet_log_dir":
                o.log_dir = val
            elif name == "fleet_reload_timeout_s":
                o.reload_timeout_s = float(val)
            elif name == "fleet_reload_breaker_threshold":
                o.reload_breaker_threshold = int(val)
            elif name == "canary":
                o.canary = "" if val in ("", "0", "off", "none") else val
            elif name == "canary_replicas":
                o.canary_replicas = int(val)
            elif name == "canary_slice":
                o.canary_slice = float(val)
            elif name == "canary_sample":
                o.canary_sample = float(val)
            elif name == "canary_min_requests":
                o.canary_min_requests = int(val)
            elif name == "canary_min_agreement":
                o.canary_min_agreement = float(val)
            elif name == "canary_decision_period_s":
                o.canary_decision_period_s = float(val)
        if o.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if o.slow_probes < 1:
            raise ValueError("fleet_slow_probes must be >= 1")
        if o.replica_inflight < 1:
            raise ValueError("fleet_replica_inflight must be >= 1")
        if o.pool_size < 1:
            raise ValueError("fleet_pool_size must be >= 1")
        if not 0.0 < o.batch_shed_ratio <= 1.0:
            raise ValueError("fleet_batch_shed_ratio must be in (0, 1]")
        if o.canary:
            if not 0 < o.canary_replicas < o.replicas:
                raise ValueError(
                    "canary_replicas must leave at least one baseline "
                    "replica (0 < canary_replicas < replicas)")
            for frac_name in ("canary_slice", "canary_sample"):
                v = getattr(o, frac_name)
                if not 0.0 <= v <= 1.0:
                    raise ValueError(f"{frac_name} must be in [0, 1]")
            if not 0.0 < o.canary_min_agreement <= 1.0:
                raise ValueError(
                    "canary_min_agreement must be in (0, 1]")
        return o


# ----------------------------------------------------------------------
class _FleetMetrics:
    """Process-wide registry families for the fleet front end.  The canary agreement /
    latency gauges are deliberately NOT created here: a zero-valued
    ``canary_agreement`` existing before any comparison would instantly
    fire the auto-armed rollback alert — they materialize on the first
    recorded comparison (:meth:`CanaryController.record_compare`)."""

    def __init__(self) -> None:
        reg = obs_registry()
        self.replicas = reg.gauge(
            "fleet_replicas", "Fleet replica counts by state.",
            labelnames=("state",))
        self.restarts = reg.counter(
            "fleet_restarts_total",
            "Replica restarts by reason: crash / wedged / canary_rollback.",
            labelnames=("reason",))
        self.requests = reg.counter(
            "fleet_requests_total",
            "Requests ARRIVING at the fleet front-end by priority "
            "class, before admission (shed arrivals included; admitted "
            "= requests - shed).",
            labelnames=("priority",))
        self.shed = reg.counter(
            "fleet_shed_total",
            "Requests shed by admission control (429), by priority class.",
            labelnames=("priority",))
        self.dispatch = reg.counter(
            "fleet_dispatch_total",
            "Requests dispatched, by replica index.",
            labelnames=("replica",))
        self.failovers = reg.counter(
            "fleet_failovers_total",
            "Dispatches retried on another replica after a network "
            "failure (the killed-replica in-flight path).")
        self.inflight = reg.gauge(
            "fleet_inflight", "Requests currently admitted at the router.")
        self.restart_seconds = reg.histogram(
            "fleet_restart_seconds",
            "Wall-clock from replica-down detection to healthy again.")
        self.reloads = reg.counter(
            "fleet_reloads_total",
            "Rolling-reload outcomes per replica: swapped / noop / "
            "failed / aborted.",
            labelnames=("result",))
        self.canary_total = reg.counter(
            "canary_total",
            "Canary lifecycle decisions: promote / rollback.",
            labelnames=("decision",))
        self.canary_requests = reg.counter(
            "canary_requests_total",
            "Canary traffic by leg: slice (live) / mirror (shadow "
            "comparison).",
            labelnames=("leg",))
        # router→replica persistent-connection pool: a connects rate far
        # below the dispatch rate is the pool doing its job
        self.pool_connects = reg.counter(
            "fleet_pool_connects_total",
            "New router-to-replica keep-alive connections opened.")
        self.pool_retired = reg.counter(
            "fleet_pool_retired_total",
            "Pooled connections retired (error / replica eject / "
            "reload / server-requested close).")
        self.pool_idle = reg.gauge(
            "fleet_pool_idle_connections",
            "Idle keep-alive connections parked at the router.")


_METRICS: Optional[_FleetMetrics] = None
_METRICS_LOCK = threading.Lock()


def fleet_metrics() -> _FleetMetrics:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = _FleetMetrics()
        return _METRICS


# ----------------------------------------------------------------------
class Replica:
    """One supervised engine replica (usually a subprocess)."""

    def __init__(self, idx: int, port: int, role: str = "serve",
                 host: str = "127.0.0.1") -> None:
        self.idx = idx
        self.port = port
        self.role = role              # "serve" | "canary"
        self.host = host
        self.proc: Optional[subprocess.Popen] = None
        self.log_handle = None
        self.state = "starting"
        self.consecutive_fail = 0
        self.restarts = 0
        self.backoff_s = 0.0          # set by the supervisor
        self.restart_at = 0.0
        self.down_since: Optional[float] = None
        self.down_reason = ""
        self.inflight = 0             # router-maintained, under its lock
        self.dispatched = 0
        self.spawned_at = time.monotonic()
        self.last_round = -1
        self.last_model: Optional[str] = None
        self.last_status = ""
        self.reasons: List[str] = []

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def in_rotation(self) -> bool:
        return self.state in IN_ROTATION

    def snapshot(self) -> Dict[str, object]:
        return {
            "idx": self.idx, "port": self.port, "role": self.role,
            "pid": self.pid, "state": self.state,
            "restarts": self.restarts, "inflight": self.inflight,
            "dispatched": self.dispatched, "round": self.last_round,
            "reasons": list(self.reasons),
        }


def _http_get_json(addr: str, path: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(f"http://{addr}{path}",
                                timeout=timeout_s) as r:
        return json.loads(r.read().decode("utf-8"))


def _http_post_json(addr: str, path: str, obj: dict,
                    timeout_s: float) -> dict:
    req = urllib.request.Request(
        f"http://{addr}{path}",
        data=json.dumps(obj).encode("utf-8"),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        return json.loads(r.read().decode("utf-8"))


class ReplicaSupervisor:
    """Launches, probes, classifies, and restarts the replica set.

    ``spawn_fn(replica) -> subprocess.Popen`` owns process creation —
    the CLI binds :func:`cli_spawn_fn` (a full ``task=serve`` child),
    tests bind :func:`stub_spawn_fn`.  ``spawn_fn=None`` supervises
    EXTERNAL replicas (probe/classify/eject only, no restart)."""

    def __init__(self, opts: FleetOptions,
                 spawn_fn: Optional[Callable[[Replica],
                                             subprocess.Popen]] = None,
                 host: str = "127.0.0.1") -> None:
        self.opts = opts
        self.spawn_fn = spawn_fn
        self.host = host
        self.replicas: List[Replica] = []
        self.last_restart_wall_s = 0.0
        self.restarts_total = 0
        # eject notification (the router binds this to retire its
        # keep-alive pool, so no request rides a socket into a corpse)
        self.on_down: Optional[Callable[[Replica], None]] = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def add_replica(self, role: str = "serve",
                    port: Optional[int] = None) -> Replica:
        r = Replica(len(self.replicas), port or free_port(), role=role,
                    host=self.host)
        r.backoff_s = self.opts.restart_backoff_s
        self.replicas.append(r)
        return r

    def start(self) -> "ReplicaSupervisor":
        """Create the configured replica set (``replicas`` total, the
        last ``canary_replicas`` of them canaries when armed), spawn
        every process, and start the probe loop."""
        if not self.replicas:
            n_canary = (self.opts.canary_replicas if self.opts.canary
                        else 0)
            for i in range(self.opts.replicas):
                role = ("canary" if i >= self.opts.replicas - n_canary
                        else "serve")
                self.add_replica(role=role)
        for r in self.replicas:
            self._spawn(r)
        obs_events.emit("fleet.start", replicas=len(self.replicas),
                        canary=self.opts.canary or None)
        self._thread = threading.Thread(
            target=self._probe_loop, name="cxxnet-fleet-probe", daemon=True)
        self._thread.start()
        return self

    def _spawn(self, r: Replica) -> None:
        r.spawned_at = time.monotonic()
        if self.spawn_fn is None:
            r.state = "starting"  # external replica: probe-only
            return
        r.proc = self.spawn_fn(r)
        r.state = "starting"
        r.consecutive_fail = 0

    # ------------------------------------------------------------------
    def wait_ready(self, timeout_s: Optional[float] = None,
                   min_healthy: Optional[int] = None) -> bool:
        """Block until ``min_healthy`` (default: all) replicas probe
        healthy; False on timeout."""
        want = min_healthy if min_healthy is not None else len(self.replicas)
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.opts.start_timeout_s)
        while time.monotonic() < deadline:
            if len(self.healthy()) >= want:
                return True
            time.sleep(min(0.05, self.opts.probe_period_s))
        return len(self.healthy()) >= want

    def rotation(self) -> List[Replica]:
        with self._lock:
            return [r for r in self.replicas if r.in_rotation()]

    def healthy(self) -> List[Replica]:
        with self._lock:
            return [r for r in self.replicas if r.state == "healthy"]

    def state_counts(self) -> Dict[str, int]:
        with self._lock:
            counts = {s: 0 for s in STATES}
            for r in self.replicas:
                counts[r.state] = counts.get(r.state, 0) + 1
            return counts

    def note_dispatch_failure(self, r: Replica) -> None:
        """Router feedback: a dispatch hit a connection failure.  Count
        it like a missed probe and wake the probe loop so a dead
        replica is confirmed within one probe round-trip instead of a
        full period."""
        with self._lock:
            if r.state in ("healthy", "slow"):
                r.consecutive_fail += 1
                if r.state == "healthy":
                    r.state = "slow"
        self._wake.set()

    # ------------------------------------------------------------------
    # probe loop
    def _probe_loop(self) -> None:
        while True:
            self._wake.wait(self.opts.probe_period_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            self.probe_once()

    def probe_once(self) -> None:
        """One supervision sweep over every replica (the loop body;
        tests may call it directly for deterministic stepping)."""
        now = time.monotonic()
        for r in list(self.replicas):
            if r.state in ("failed", "stopped"):
                continue
            proc = r.proc
            if (r.state not in ("backoff",) and proc is not None
                    and proc.poll() is not None):
                self._on_down(r, "crash",
                              f"process exited rc={proc.returncode}")
            elif r.state == "backoff":
                pass
            else:
                ok, body, err = self._probe_http(r)
                if ok:
                    self._on_probe_ok(r, body)
                else:
                    self._on_probe_fail(r, err)
            if (r.state == "backoff"
                    and time.monotonic() >= r.restart_at):
                self._respawn(r)
        self._export_gauges()

    def _probe_http(self, r: Replica):
        try:
            body = _http_get_json(r.address, "/healthz",
                                  self.opts.probe_timeout_s)
        except Exception as e:  # noqa: BLE001 - any failure is a miss
            return False, None, f"{type(e).__name__}: {e}"
        if not isinstance(body, dict):
            return False, None, "bad body (not a JSON object)"
        if body.get("status") not in ("ok", "degraded"):
            return False, body, f"status={body.get('status')!r}"
        return True, body, None

    def _on_probe_ok(self, r: Replica, body: dict) -> None:
        with self._lock:
            was = r.state
            reasons = [str(x) for x in (body.get("reasons") or ())]
            # integrity quarantine: a replica whose golden canary failed still
            # ANSWERS, but its compute cannot be trusted — eject it
            # from rotation WITHOUT killing it (its canary keeps
            # running and a later clean score readmits it; a restart
            # would land on the same possibly-bad device anyway)
            quarantined = "integrity_failed" in reasons
            r.state = "quarantined" if quarantined else "healthy"
            r.consecutive_fail = 0
            r.last_status = str(body.get("status", "ok"))
            if body.get("round") is not None:
                r.last_round = int(body["round"])
            r.last_model = body.get("model")
            r.reasons = reasons
            came_back = r.down_since is not None
            if came_back:
                wall = time.monotonic() - r.down_since
                r.down_since = None
                self.last_restart_wall_s = wall
            r.backoff_s = self.opts.restart_backoff_s
        if quarantined and was != "quarantined":
            obs_events.emit("fleet.replica_quarantined", replica=r.idx,
                            role=r.role, port=r.port,
                            round=r.last_round, reasons=reasons)
        elif not quarantined and was == "quarantined":
            obs_events.emit("fleet.replica_readmitted", replica=r.idx,
                            role=r.role, port=r.port, round=r.last_round)
        elif not quarantined and was != "healthy":
            obs_events.emit("fleet.replica_up", replica=r.idx,
                            role=r.role, port=r.port, round=r.last_round,
                            restarts=r.restarts)
        if came_back:
            try:
                fleet_metrics().restart_seconds.observe(wall)
            except Exception:  # noqa: BLE001 - telemetry must never raise
                pass

    def _on_probe_fail(self, r: Replica, err: Optional[str]) -> None:
        with self._lock:
            if r.state == "starting":
                # a replica that has never answered is still booting;
                # the wedge counter does not apply (a torch import, the
                # kernels' load and a warm-up forward take seconds) — but the boot
                # budget does: a child wedged BEFORE its first healthy
                # answer must still be ejected and restarted, or it
                # escapes supervision forever
                if (time.monotonic() - r.spawned_at
                        <= self.opts.start_timeout_s):
                    return
                wedged = True
            else:
                r.consecutive_fail += 1
                wedged = r.consecutive_fail >= self.opts.slow_probes
            if not wedged:
                if r.state == "healthy":
                    r.state = "slow"
                    obs_events.emit("fleet.replica_slow", replica=r.idx,
                                    misses=r.consecutive_fail, error=err)
                return
        # ejected: kill the wedged process and schedule a restart
        self._on_down(r, "wedged", err or "probe deadline exceeded")

    def _on_down(self, r: Replica, reason: str, detail: str) -> None:
        with self._lock:
            if r.state in ("backoff", "failed", "stopped"):
                return
            r.state = "wedged" if reason == "wedged" else "gone"
            if r.down_since is None:
                r.down_since = time.monotonic()
            r.down_reason = reason
        obs_events.emit(
            "fleet.replica_wedged" if reason == "wedged"
            else "fleet.replica_gone",
            replica=r.idx, role=r.role, port=r.port, detail=detail)
        if self.on_down is not None:
            try:
                self.on_down(r)
            except Exception:  # noqa: BLE001 - eject must never wedge
                pass
        self._kill(r)
        with self._lock:
            if self.spawn_fn is None:
                return  # external replica: ejected, nothing to restart
            r.state = "backoff"
            r.restart_at = time.monotonic() + r.backoff_s

    def _respawn(self, r: Replica) -> None:
        with self._lock:
            if (self.opts.max_restarts
                    and r.restarts >= self.opts.max_restarts):
                # given up: no phantom restart in the counters
                r.state = "failed"
                obs_events.emit("fleet.replica_failed", replica=r.idx,
                                restarts=r.restarts)
                return
            r.restarts += 1
            self.restarts_total += 1
            reason = r.down_reason or "crash"
            r.backoff_s = min(r.backoff_s * 2,
                              self.opts.restart_backoff_max_s)
        try:
            fleet_metrics().restarts.labels(reason=reason).inc()
        except Exception:  # noqa: BLE001 - telemetry must never raise
            pass
        obs_events.emit("fleet.restart", replica=r.idx, role=r.role,
                        reason=reason, attempt=r.restarts,
                        next_backoff_s=round(r.backoff_s, 3))
        self._spawn(r)

    def restart_replica(self, r: Replica, reason: str,
                        role: Optional[str] = None) -> None:
        """Kill and relaunch one replica deliberately (the canary
        rollback path; ``role`` flips e.g. canary → serve so the spawn
        function drops the quant override)."""
        with self._lock:
            if role is not None:
                r.role = role
            r.state = "gone"
            r.down_reason = reason
            if r.down_since is None:
                r.down_since = time.monotonic()
        self._kill(r)
        try:
            fleet_metrics().restarts.labels(reason=reason).inc()
        except Exception:  # noqa: BLE001
            pass
        with self._lock:
            r.restarts += 1
            self.restarts_total += 1
        self._spawn(r)

    def _kill(self, r: Replica) -> None:
        proc = r.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
                proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                pass
        if r.log_handle is not None:
            try:
                r.log_handle.close()
            except OSError:
                pass
            r.log_handle = None

    def _export_gauges(self) -> None:
        try:
            m = fleet_metrics()
            counts = self.state_counts()
            for state in STATES:
                m.replicas.labels(state=state).set(counts.get(state, 0))
        except Exception:  # noqa: BLE001 - telemetry must never raise
            pass

    # ------------------------------------------------------------------
    def stop(self, term_timeout_s: float = 15.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        procs = []
        for r in self.replicas:
            r.state = "stopped"
            if r.proc is not None and r.proc.poll() is None:
                try:
                    r.proc.terminate()
                    procs.append(r)
                except OSError:
                    pass
        deadline = time.monotonic() + term_timeout_s
        for r in procs:
            try:
                r.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                r.proc.kill()
                try:
                    r.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
        for r in self.replicas:
            if r.log_handle is not None:
                try:
                    r.log_handle.close()
                except OSError:
                    pass
                r.log_handle = None


# ----------------------------------------------------------------------
#: config keys the fleet must pin on its replica children — a replica
#: re-reading the parent's conf must come up as a SINGLE-engine server
#: on the assigned port (``replicas=1`` appended last wins over a conf
#: that armed the fleet, so a fleet conf can never fork-bomb).  Any
#: OTHER override (``quant=``, ``alert=``, ...) passes through to the
#: children untouched — except ``quant`` while a canary is armed,
#: because then the canary controller owns per-role precision.
_REPLICA_PINNED_KEYS = ("replicas", "task", "serve_port", "serve_host",
                        "serve_reload_period", "controller")


def cli_spawn_fn(conf_path: str, overrides: Sequence[str],
                 host: str, opts: FleetOptions,
                 log_dir: str = "") -> Callable[[Replica], subprocess.Popen]:
    """Spawn function for REAL replicas: a full ``task=serve`` CLI
    child on the replica's port, re-reading the fleet's conf plus the
    fleet's own CLI overrides (minus the fleet-controlling keys, which
    are pinned).  Canary replicas get ``quant=<scheme>``; baseline
    replicas are pinned to f32 while a canary is armed so the
    comparison legs actually differ."""
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    pinned = set(_REPLICA_PINNED_KEYS)
    if opts.canary:
        pinned.add("quant")  # per-role precision belongs to the canary
    keep = [o for o in overrides
            if o.split("=", 1)[0] not in pinned]

    def spawn(r: Replica) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "cxxnet_tpu_torch", conf_path]
        cmd += keep
        cmd += [
            "task=serve", f"serve_host={host}",
            f"serve_port={r.port}", "serve_reload_period=0",
            "controller=0", "replicas=1",
        ]
        if opts.canary:
            cmd.append(f"quant={opts.canary}" if r.role == "canary"
                       else "quant=0")
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        stdout = subprocess.DEVNULL
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            r.log_handle = open(
                os.path.join(log_dir, f"replica-{r.idx}.log"), "ab")
            stdout = r.log_handle
        return subprocess.Popen(cmd, stdout=stdout,
                                stderr=subprocess.STDOUT, env=env)

    return spawn


def stub_spawn_fn(extra: Sequence[str] = (),
                  per_replica: Optional[Callable[[Replica],
                                                 Sequence[str]]] = None,
                  ) -> Callable[[Replica], subprocess.Popen]:
    """Spawn function for the stdlib stub replica (``serve/stub.py``,
    run as a file so nothing imports torch) — the fast supervision /
    routing / canary tests.  ``per_replica(replica)`` appends
    per-instance args (e.g. ``--disagree`` for the canary)."""
    stub = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "stub.py")

    def spawn(r: Replica) -> subprocess.Popen:
        cmd = [sys.executable, stub, "--port", str(r.port)]
        cmd += list(extra)
        if per_replica is not None:
            cmd += list(per_replica(r))
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

    return spawn


# ----------------------------------------------------------------------
class CanaryController:
    """Measures the canary legs and decides promote vs rollback.

    The router feeds it: every mirrored comparison lands in
    :meth:`record_compare` (row-level equality of baseline vs canary
    predictions), every timed leg in :meth:`record_latency`.  The
    controller exports ``canary_agreement`` / ``canary_latency_ratio``
    gauges (created on FIRST data — a premature zero would instantly
    fire the rollback alert), auto-arms the
    ``canary_agreement < canary_min_agreement`` alert rule, and once
    ``canary_min_requests`` rows compared:

    * rule firing (the ``/alertz`` trigger) → **rollback**: publish
      pointer restored to the baseline round, ``canary.rollback``
      event, ``canary_total{decision="rollback"}``, canary replicas
      relaunched at f32;
    * otherwise (agreement at/above the bar) → **promote**: publish
      pointer flipped to the canary's artifact, ``canary.promote``,
      ``canary_total{decision="promote"}``, canary replicas join the
      rotation at full weight.
    """

    RULE_NAME = "canary_agreement"

    def __init__(self, supervisor: ReplicaSupervisor, opts: FleetOptions,
                 model_dir: Optional[str] = None,
                 silent: bool = True) -> None:
        self.sup = supervisor
        self.opts = opts
        self.model_dir = model_dir
        self.silent = silent
        self.state = "evaluating"   # evaluating | promoted | rolled_back
        self.decision_reason = ""
        self.compared = 0
        self.agreed = 0
        self._lat = {"baseline": [], "canary": []}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._agreement_gauge = None
        self._latency_gauge = None

    # ------------------------------------------------------------------
    def canaries(self) -> List[Replica]:
        return [r for r in self.sup.replicas if r.role == "canary"]

    def start(self) -> "CanaryController":
        self._arm_rule()
        self._thread = threading.Thread(
            target=self._loop, name="cxxnet-fleet-canary", daemon=True)
        self._thread.start()
        obs_events.emit("canary.start", scheme=self.opts.canary,
                        replicas=len(self.canaries()),
                        slice=self.opts.canary_slice,
                        sample=self.opts.canary_sample,
                        min_agreement=self.opts.canary_min_agreement)
        return self

    def _arm_rule(self) -> None:
        from ..obs import alerts as obs_alerts

        ev = obs_alerts.evaluator()
        if not any(r.name == self.RULE_NAME for r in ev.rules()):
            ev.add_rule(obs_alerts.parse_rule(
                f"{self.RULE_NAME}:canary_agreement:<:"
                f"{self.opts.canary_min_agreement:g}"))
        ev.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------------
    # measurement (router-fed)
    def record_compare(self, rows_equal: int, rows_total: int) -> None:
        """The gauge is set BEFORE the counts move, under the lock, and
        a comparison that lands after the decision is dropped.  So a
        caller that sees ``compared`` reach ``canary_min_requests`` and
        then runs :meth:`decide` always finds the agreement gauge the
        alert rule reads, and a mirror still in flight at a rollback
        cannot re-arm the gauge the rollback cleared (the JAX package
        sets the gauge after the counts and at any state: both races
        can make its rollback test fail)."""
        gauge = self._gauges()[0]
        with self._lock:
            if self.state != "evaluating":
                return
            compared = self.compared + rows_total
            agreed = self.agreed + rows_equal
            gauge.set(agreed / compared if compared else 1.0)
            self.compared, self.agreed = compared, agreed

    def record_latency(self, leg: str, dt_s: float) -> None:
        """Append-only — this runs on the live /predict path; the
        median ratio is computed once per decision period
        (:meth:`_update_latency_gauge`), not per request."""
        with self._lock:
            buf = self._lat[leg]
            buf.append(dt_s)
            if len(buf) > 512:
                del buf[: len(buf) - 512]

    def _update_latency_gauge(self) -> None:
        with self._lock:
            base = list(self._lat["baseline"])
            can = list(self._lat["canary"])
        if not base or not can:
            return
        med_b = sorted(base)[len(base) // 2]
        med_c = sorted(can)[len(can) // 2]
        if med_b > 0:
            self._gauges()[1].set(med_c / med_b)

    def _gauges(self):
        if self._agreement_gauge is None:
            reg = obs_registry()
            self._agreement_gauge = reg.gauge(
                "canary_agreement",
                "Row-level prediction agreement of the canary vs the "
                "baseline over mirrored traffic.")
            self._latency_gauge = reg.gauge(
                "canary_latency_ratio",
                "Canary / baseline median request latency over the "
                "compared legs.")
        return self._agreement_gauge, self._latency_gauge

    def agreement(self) -> Optional[float]:
        with self._lock:
            return (self.agreed / self.compared) if self.compared else None

    # ------------------------------------------------------------------
    # decision
    def _loop(self) -> None:
        while not self._stop.wait(self.opts.canary_decision_period_s):
            try:
                self.decide()
            except Exception as e:  # noqa: BLE001 - keep deciding
                obs_events.log_exception_once(
                    "fleet.canary_decide", e, kind="fleet.error")
            if self.state != "evaluating":
                return

    def decide(self) -> Optional[str]:
        """One decision pass (the loop body; tests drive it directly).
        Returns the decision when one was made."""
        if self.state != "evaluating":
            return None
        self._update_latency_gauge()
        with self._lock:
            compared = self.compared
        if compared < self.opts.canary_min_requests:
            return None
        from ..obs import alerts as obs_alerts

        ev = obs_alerts.evaluator()
        ev.evaluate_once()
        agreement = self.agreement()
        if self.RULE_NAME in ev.firing():
            self._rollback(f"alert {self.RULE_NAME} firing "
                           f"(agreement {agreement:.4f} < "
                           f"{self.opts.canary_min_agreement:g})")
            return "rollback"
        if agreement is not None \
                and agreement >= self.opts.canary_min_agreement:
            self._promote(agreement)
            return "promote"
        return None

    def _metric(self) -> dict:
        with self._lock:
            return {
                "canary_agreement": (self.agreed / self.compared
                                     if self.compared else None),
                "compared_rows": self.compared,
                "scheme": self.opts.canary,
            }

    def _baseline_replica(self) -> Optional[Replica]:
        cands = [r for r in self.sup.healthy() if r.role == "serve"]
        return cands[0] if cands else None

    def _write_pointer(self, round_: int, path: Optional[str],
                       metric: dict) -> None:
        """Promote/rollback both land through the publish pointer
        (``utils/checkpoint.py``) — the fleet's 'currently blessed
        artifact' record."""
        if not self.model_dir or path is None or round_ < 0:
            return
        from ..utils import checkpoint as ckpt

        try:
            prev = ckpt.read_publish_pointer(self.model_dir)
            ckpt.write_publish_pointer(
                self.model_dir, round_, path, metric=metric,
                prev_round=prev.get("round") if prev else None)
        except Exception as e:  # noqa: BLE001 - decision still stands
            obs_events.log_exception_once(
                "fleet.canary_pointer", e, kind="fleet.error")

    def _promote(self, agreement: float) -> None:
        canary = next((r for r in self.canaries()
                       if r.state == "healthy"), None)
        with self._lock:  # record_compare reads the state under it
            self.state = "promoted"
        self.decision_reason = f"agreement {agreement:.4f}"
        try:
            fleet_metrics().canary_total.labels(decision="promote").inc()
        except Exception:  # noqa: BLE001
            pass
        obs_events.emit("canary.promote", scheme=self.opts.canary,
                        agreement=round(agreement, 6),
                        compared=self.compared,
                        round=canary.last_round if canary else None,
                        path=canary.last_model if canary else None)
        if canary is not None:
            self._write_pointer(canary.last_round, canary.last_model,
                                self._metric())
        # full weight: the router includes promoted canaries in the
        # baseline pool (it checks controller.state)
        if not self.silent:
            print(f"fleet: canary PROMOTED ({self.decision_reason})",
                  flush=True)

    def _rollback(self, reason: str) -> None:
        with self._lock:
            self.state = "rolled_back"
        self.decision_reason = reason
        try:
            fleet_metrics().canary_total.labels(decision="rollback").inc()
        except Exception:  # noqa: BLE001
            pass
        agreement = self.agreement()
        obs_events.emit("canary.rollback", scheme=self.opts.canary,
                        reason=reason,
                        agreement=(round(agreement, 6)
                                   if agreement is not None else None),
                        compared=self.compared)
        base = self._baseline_replica()
        if base is not None:
            self._write_pointer(base.last_round, base.last_model,
                                self._metric())
        # relaunch the canary replicas as plain f32 members
        for r in self.canaries():
            self.sup.restart_replica(r, reason="canary_rollback",
                                     role="serve")
        # the comparison is over — clear the trigger gauge so /alertz
        # does not report the dead canary's agreement forever (the
        # durable record is canary_total{decision} + the event above)
        self._gauges()[0].set(1.0)
        if not self.silent:
            print(f"fleet: canary ROLLED BACK ({reason})", flush=True)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "scheme": self.opts.canary,
                "state": self.state,
                "reason": self.decision_reason,
                "compared": self.compared,
                "agreed": self.agreed,
                "agreement": (self.agreed / self.compared
                              if self.compared else None),
                "slice": self.opts.canary_slice,
                "sample": self.opts.canary_sample,
                "min_agreement": self.opts.canary_min_agreement,
            }


# ----------------------------------------------------------------------
class ServingFleet:
    """Supervisor + router + canary + rolling reload, composed.

    The CLI's ``task=serve`` with ``replicas >= 2`` builds one of these
    (``cli.py::task_serve_fleet``); tests compose the pieces directly
    with stub spawn functions.  ``start`` raises ``RuntimeError`` when no
    replica is healthy within ``fleet_start_timeout_s``."""

    def __init__(self, opts: FleetOptions,
                 spawn_fn: Optional[Callable] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 model_dir: Optional[str] = None,
                 default_deadline_ms: float = 0.0,
                 reload_period_s: float = 0.0,
                 silent: bool = True) -> None:
        from .router import FleetRouter

        self.opts = opts
        self.host = host
        self.port = port
        self.model_dir = model_dir
        self.reload_period_s = float(reload_period_s)
        self.silent = silent
        self.supervisor = ReplicaSupervisor(opts, spawn_fn=spawn_fn,
                                            host=host)
        self.canary: Optional[CanaryController] = (
            CanaryController(self.supervisor, opts, model_dir=model_dir,
                             silent=silent)
            if opts.canary else None)
        self.router = FleetRouter(self, default_deadline_ms=
                                  default_deadline_ms)
        self.supervisor.on_down = (
            lambda r: self.router.retire_replica_pool(r.address))
        self.reload_breaker = CircuitBreaker(
            failure_threshold=opts.reload_breaker_threshold,
            cooldown_s=60.0)
        self._reload_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.httpd = None

    # ------------------------------------------------------------------
    def start(self, min_healthy: Optional[int] = None):
        """Spawn replicas, wait for readiness, bind the front door.
        Returns the router's HTTP server (caller runs
        ``serve_forever``)."""
        self.supervisor.start()
        want = min_healthy if min_healthy is not None else len(
            self.supervisor.replicas)
        if not self.supervisor.wait_ready(min_healthy=want):
            if not self.supervisor.wait_ready(timeout_s=0.0,
                                              min_healthy=1):
                self.supervisor.stop()
                raise RuntimeError(
                    f"fleet: no replica became healthy within "
                    f"{self.opts.start_timeout_s:g}s")
            if not self.silent:
                print("fleet: starting DEGRADED (not all replicas "
                      "healthy in time)", flush=True)
        if self.canary is not None:
            self.canary.start()
        self.httpd = self.router.make_httpd(self.host, self.port)
        if self.reload_period_s > 0 and self.model_dir:
            self._reload_thread = threading.Thread(
                target=self._reload_loop, name="cxxnet-fleet-reload",
                daemon=True)
            self._reload_thread.start()
        return self.httpd

    # ------------------------------------------------------------------
    # rolling reload
    def _reload_loop(self) -> None:
        from ..utils import checkpoint as ckpt

        while not self._stop.wait(self.reload_period_s):
            try:
                found = ckpt.find_latest_valid(self.model_dir, silent=True)
            except Exception:  # noqa: BLE001 - keep polling
                continue
            if found is None:
                continue
            rounds = [r.last_round for r in self.supervisor.rotation()]
            if rounds and found[0] > min(rounds):
                self.rolling_reload(target_round=found[0])

    def rolling_reload(self, target_round: Optional[int] = None) -> dict:
        """Walk the rotation one replica at a time, reloading each
        through ``POST /reloadz`` and waiting for it to probe healthy
        on the new round before the next.  Breaker-gated: repeated
        failures abort the rollout and the remaining replicas keep the
        old model."""
        results = []
        aborted = False
        obs_events.emit("fleet.rollout_start", target_round=target_round)
        m = fleet_metrics()
        for r in list(self.supervisor.replicas):
            if not r.in_rotation():
                continue
            if not self.reload_breaker.allow():
                aborted = True
                m.reloads.labels(result="aborted").inc()
                obs_events.emit("fleet.rollout_abort", replica=r.idx,
                                breaker=self.reload_breaker.state)
                break
            ok, swapped, round_, err = self._reload_one(r, target_round)
            # the swapped engine invalidates any parked connection's
            # implicit model identity — start the replica's pool fresh
            self.router.retire_replica_pool(r.address)
            results.append({"replica": r.idx, "ok": ok,
                            "swapped": swapped, "round": round_,
                            "error": err})
            if ok:
                self.reload_breaker.record_success()
                m.reloads.labels(
                    result="swapped" if swapped else "noop").inc()
            else:
                self.reload_breaker.record_failure()
                m.reloads.labels(result="failed").inc()
                obs_events.emit("fleet.reload_failed", replica=r.idx,
                                error=err)
        out = {"aborted": aborted, "replicas": results,
               "target_round": target_round}
        obs_events.emit("fleet.rollout_done", aborted=aborted,
                        reloaded=sum(1 for x in results if x["ok"]))
        return out

    def _reload_one(self, r: Replica, target_round: Optional[int]):
        try:
            resp = _http_post_json(r.address, "/reloadz", {},
                                   self.opts.reload_timeout_s)
        except Exception as e:  # noqa: BLE001 - reported per replica
            return False, False, r.last_round, f"{type(e).__name__}: {e}"
        if not resp.get("ok"):
            return False, False, resp.get("round", r.last_round), \
                f"reload failed (breaker {resp.get('breaker')})"
        swapped = bool(resp.get("swapped"))
        round_ = resp.get("round", r.last_round)
        # wait for the replica to probe healthy on the new round before
        # touching the next one — the "one at a time" guarantee
        deadline = time.monotonic() + self.opts.reload_timeout_s
        while time.monotonic() < deadline:
            okp, body, _err = self.supervisor._probe_http(r)
            if okp and (target_round is None
                        or int(body.get("round", -1)) >= target_round
                        or not swapped):
                self.supervisor._on_probe_ok(r, body)
                return True, swapped, body.get("round", round_), None
            time.sleep(min(0.2, self.opts.probe_period_s))
        return False, swapped, round_, "not healthy after reload"

    # ------------------------------------------------------------------
    # aggregation (served by the router)
    def healthz(self) -> Dict[str, object]:
        counts = self.supervisor.state_counts()
        rotation = self.supervisor.rotation()
        reasons: List[str] = []
        with self.supervisor._lock:
            for r in self.supervisor.replicas:
                if r.state == "stopped":
                    continue
                if r.state != "healthy":
                    reasons.append(f"replica{r.idx}:{r.state}")
                else:
                    for why in r.reasons:
                        reasons.append(f"replica{r.idx}:{why}")
        status = ("down" if not rotation
                  else "degraded" if reasons else "ok")
        out: Dict[str, object] = {
            "status": status,
            "fleet": True,
            "replicas": {
                "total": len(self.supervisor.replicas),
                **{s: counts.get(s, 0) for s in STATES},
            },
            "rotation": len(rotation),
            "round": (min(r.last_round for r in rotation)
                      if rotation else -1),
            "reasons": reasons,
        }
        if self.canary is not None:
            out["canary"] = {"state": self.canary.state,
                             "agreement": self.canary.agreement()}
        return out

    def statsz(self) -> Dict[str, object]:
        out = self.router.stats.snapshot()
        out["replicas"] = [r.snapshot() for r in self.supervisor.replicas]
        out["last_restart_wall_s"] = self.supervisor.last_restart_wall_s
        out["restarts_total"] = self.supervisor.restarts_total
        out["reload_breaker"] = self.reload_breaker.snapshot()
        if self.canary is not None:
            out["canary"] = self.canary.snapshot()
        return out

    # ------------------------------------------------------------------
    def close(self, drain_timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._reload_thread is not None:
            self._reload_thread.join(timeout=5.0)
            self._reload_thread = None
        if self.canary is not None:
            self.canary.stop()
        self.router.close(drain_timeout_s)
        if self.httpd is not None:
            try:
                self.httpd.server_close()
            except OSError:
                pass
            self.httpd = None
        self.supervisor.stop()

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
