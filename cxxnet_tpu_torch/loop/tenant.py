"""Multi-tenant continuous learning: N loops, one device pool.

The port's copy of ``cxxnet_tpu/loop/tenant.py``: ``task=loop_fleet``.
The production shape of arXiv 1605.08695 applied to the closed loop:
N named models share one machine, each with its own serving engine,
feedback log, replay/eval streams and :class:`ContinuousLoop`, while a
single scheduler serializes their fine-tune cycles onto the ONE shared
device pool the serve plane also runs on.

* **tenants** — each ``[tenant:<name>]`` conf section
  (``config.split_tenant_sections``) names a model: its ``model_dir``
  (required), optionally its ``feedback_dir``, and any per-tenant
  overrides of the shared loop/publish/iterator keys.  A tenant's
  effective config is the shared stream + its section appended, so the
  usual last-entry-wins rule resolves everything — same net, different
  weights/feedback/knobs.
* **arbiter** — fine-tune rounds per tenant are runtime knobs
  (``tune/targets.tenant_round_knobs``) hill-climbed by a tuner
  :class:`~cxxnet_tpu_torch.tune.KnobController` whose objective is the
  aggregate published-improvement rate (each publish contributes
  ``1 + max(gain, 0)`` work units), subject to the serve plane's SLO:
  while ANY ``/alertz`` rule fires (e.g. the p99 bound), the scheduler
  SHEDS fine-tune cycles entirely — training is the elastic load, serve
  traffic is not (``loop_shed_total`` counts shed ticks, and the
  controller pauses so the starvation cannot be misread as a knob
  regression).
* **routing** — the serve front-end dispatches by the request's
  ``model`` field through a :class:`~cxxnet_tpu_torch.serve.router.
  ModelRouter` (``/predict`` to the tenant's engine, ``/feedback`` to
  the tenant's log; unknown model → 404 with the machine-readable
  ``unknown_model`` reason token).
* **retention** — every tenant gets a :class:`~cxxnet_tpu_torch.loop.
  retention.Sweeper` compacting consumed feedback shards behind its
  cursor (``feedback_retain_*`` keys), swept after every
  trained cycle and on every manager tick.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import config as cfgmod
from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from ..tune.controller import KnobController, TuneOptions
from ..tune.targets import tenant_round_knobs
from .continuous import ContinuousLoop
from .feedback_log import FeedbackWriter
from .retention import RetentionOptions, Sweeper

__all__ = ["Tenant", "TenantArbiter", "TenantManager", "TenantOptions"]

ConfigEntry = Tuple[str, str]


class _TenantMetrics:
    def __init__(self) -> None:
        reg = obs_registry()
        self.cycles = reg.counter(
            "tenant_cycles_total",
            "Per-tenant continuous-loop cycles by outcome "
            "(idle / published / rejected / error).",
            labelnames=("tenant", "outcome"))
        self.pending = reg.gauge(
            "tenant_pending_records",
            "Feedback records committed but not yet consumed by a "
            "tenant's cursor.",
            labelnames=("tenant",))
        self.sheds = reg.counter(
            "loop_shed_total",
            "Scheduler ticks where ALL tenants' fine-tune cycles were "
            "shed because an SLO alert was firing.")
        self.tenants = reg.gauge(
            "loop_tenants",
            "Tenants hosted by the running loop-fleet manager.")


_METRICS: Optional[_TenantMetrics] = None
_METRICS_LOCK = threading.Lock()


def _metrics() -> _TenantMetrics:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = _TenantMetrics()
        return _METRICS


class TenantOptions:
    """Shared loop defaults a tenant section can override (the
    ``loop_*`` / ``publish_*`` / ``feedback_*`` keys, parsed
    last-entry-wins from the tenant's effective config stream).

    ``DEFAULTS`` is the ONE table of these defaults — the CLI
    (``cli.LearnTask.__init__``) seeds its ``task=serve_train``
    attributes from it, so the single-tenant and multi-tenant parsers
    cannot drift apart on the same conf."""

    DEFAULTS = {
        "loop_rounds_per_cycle": 2,
        "loop_rounds_max": 8,        # arbiter knob ceiling
        "loop_replay_ratio": 0.25,
        "loop_min_records": 64,
        "loop_max_records": 0,       # per cycle; 0 = everything pending
        "publish_min_delta": 0.0,
        "publish_metric": "",        # substring match; "" = first reported
        "publish_slice_floor": -1.0,  # cohort gate; < 0 = off
        "publish_slice_min_count": 8,
        "publish_source_field": -1,  # label column keying source:<v>
        "feedback_page_bytes": 1 << 20,
        "feedback_rotate_bytes": 8 << 20,
        "feedback_retain_shards": -1,  # retention; < 0 = off
        "feedback_retain_bytes": 0,
    }

    def __init__(self, cfg: Sequence[ConfigEntry]) -> None:
        vals = dict(self.DEFAULTS)
        for name, val in cfg:
            if name in vals:
                vals[name] = type(self.DEFAULTS[name])(val) \
                    if not isinstance(self.DEFAULTS[name], str) else val
        self.__dict__.update(vals)

    @property
    def slice_floor(self) -> Optional[float]:
        return (self.publish_slice_floor
                if self.publish_slice_floor >= 0 else None)

    @property
    def source_field(self) -> Optional[int]:
        return (self.publish_source_field
                if self.publish_source_field >= 0 else None)


class Tenant:
    """One hosted model: engine + feedback log + loop + retention.

    ``cfg`` is the tenant's EFFECTIVE ordered stream (shared entries +
    its section appended); ``make_iters`` builds the tenant's own
    replay/eval iterator instances from it (iterators are stateful —
    they are never shared across tenants).
    """

    def __init__(
        self,
        name: str,
        cfg: List[ConfigEntry],
        make_iters,
        engine_factory,
        loop_dir: str,
        silent: bool = True,
    ) -> None:
        import os

        self.name = name
        self.cfg = cfg
        opts = TenantOptions(cfg)
        self.opts = opts
        model_dir = cfgmod.cfg_get(cfg, "model_dir")
        if not model_dir:
            raise ValueError(
                f"[tenant:{name}] needs a model_dir (its serving "
                "checkpoints and publish target)")
        self.model_dir = model_dir
        self.feedback_dir = cfgmod.cfg_get(
            cfg, "feedback_dir",
            os.path.join(loop_dir, name, "feedback"))
        self.engine = engine_factory(cfg, model_dir)
        self.feedback = FeedbackWriter(
            self.feedback_dir,
            page_bytes=opts.feedback_page_bytes,
            rotate_bytes=opts.feedback_rotate_bytes,
        )
        base_iter, eval_iter, eval_name = make_iters(cfg)
        retention = None
        ropts = RetentionOptions(opts.feedback_retain_shards,
                                 opts.feedback_retain_bytes)
        if ropts.armed:
            retention = Sweeper(self.feedback_dir, ropts, tenant=name,
                                silent=silent)
        self.loop = ContinuousLoop(
            self.engine,
            cfg,
            feedback_dir=self.feedback_dir,
            base_iter=base_iter,
            eval_iter=eval_iter,
            eval_name=eval_name,
            rounds_per_cycle=opts.loop_rounds_per_cycle,
            replay_ratio=opts.loop_replay_ratio,
            min_records=opts.loop_min_records,
            max_records_per_cycle=opts.loop_max_records,
            publish_min_delta=opts.publish_min_delta,
            publish_metric=opts.publish_metric,
            publish_slice_floor=opts.slice_floor,
            publish_slice_min_count=opts.publish_slice_min_count,
            publish_source_field=opts.source_field,
            feedback_writer=self.feedback,
            retention=retention,
            name=name,
            silent=silent,
        )

    def close(self) -> None:
        for closer in (self.loop.stop, self.feedback.close,
                       self.engine.close):
            try:
                closer()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass


class TenantArbiter:
    """SLO-constrained allocator of fine-tune rounds across tenants.

    The tuner's pattern applied to training effort: per-tenant
    ``rounds_per_cycle`` knobs hill-climbed against a monotonic work
    objective — cumulative published improvement, each publish worth
    ``1 + max(gain, 0)`` so frequency and magnitude both count.  The
    SLO overlay is hard, not hill-climbed: while any alert rule fires
    the scheduler sheds ALL tune cycles (serve traffic owns the pool),
    and the controller does not tick — a shed interval measuring zero
    work must never be attributed to whatever knob happened to be on
    probe.
    """

    def __init__(self, loops, tune_opts: Optional[TuneOptions] = None,
                 max_rounds: int = 8) -> None:
        opts = tune_opts or TuneOptions()
        self._lock = threading.Lock()
        self._work = 0.0
        self.shedding = False
        self._m = _metrics()
        self.controller = KnobController(
            objective=self.work,
            knobs=tenant_round_knobs(loops, max_rounds=max_rounds),
            period_s=opts.period_s,
            band=opts.band,
            measure_ticks=opts.measure_ticks,
            settle_ticks=opts.settle_ticks,
            cooldown_ticks=opts.cooldown_ticks,
            name="tenant_arbiter",
        )

    def work(self) -> float:
        with self._lock:
            return self._work

    def note_publish(self, gain: Optional[float]) -> None:
        with self._lock:
            self._work += 1.0 + max(0.0, float(gain or 0.0))

    # ------------------------------------------------------------------
    def slo_firing(self) -> List[str]:
        """Names of the alert rules currently firing — the shed signal
        (the same evaluator ``/alertz`` serves)."""
        from ..obs import alerts as obs_alerts

        try:
            return obs_alerts.evaluator().firing()
        except Exception:  # noqa: BLE001 - a broken evaluator must
            return []      # not stall every tenant's training forever

    def tick(self, now: Optional[float] = None) -> bool:
        """One scheduler decision: returns True when tune cycles may
        run this tick (no SLO alert firing), False when shed."""
        firing = self.slo_firing()
        if firing:
            if not self.shedding:
                obs_events.emit("tenant.shed", alerts=firing)
            self.shedding = True
            self._m.sheds.inc()
            return False
        if self.shedding:
            self.shedding = False
            obs_events.emit("tenant.shed_cleared")
        self.controller.step_once(now)
        return True


class TenantManager:
    """Host N tenants; schedule their loops onto the shared pool.

    One scheduler thread serializes every tenant's fine-tune cycles
    (round-robin, one cycle per tenant per tick) — the device pool is
    shared with the colocated serve engines, so training never runs
    concurrently with itself, and the arbiter sheds it entirely while
    the serve plane's SLO alerts fire.
    """

    def __init__(
        self,
        shared_cfg: Sequence[ConfigEntry],
        tenant_sections: Sequence[cfgmod.TenantSection],
        engine_factory,
        make_iters,
        loop_dir: str = "loop",
        period_s: float = 2.0,
        tune_opts: Optional[TuneOptions] = None,
        silent: bool = True,
    ) -> None:
        if not tenant_sections:
            raise ValueError(
                "task=loop_fleet needs at least one [tenant:<name>] "
                "section (tenant = <name> .. tenant = end)")
        self.period_s = float(period_s)
        self.silent = silent
        self._m = _metrics()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tenants: List[Tenant] = []
        shared = list(shared_cfg)
        try:
            for sec in tenant_sections:
                self.tenants.append(Tenant(
                    sec.name, shared + list(sec.entries),
                    make_iters=make_iters, engine_factory=engine_factory,
                    loop_dir=loop_dir, silent=silent))
        except Exception:
            self.close()
            raise
        max_rounds = max(t.opts.loop_rounds_max for t in self.tenants)
        self.arbiter = TenantArbiter(
            [t.loop for t in self.tenants], tune_opts=tune_opts,
            max_rounds=max_rounds)
        self._m.tenants.set(len(self.tenants))
        obs_events.emit("tenant.manager_up",
                        tenants=[t.name for t in self.tenants])

    # ------------------------------------------------------------------
    def tenant(self, name: str) -> Tenant:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def router(self):
        """A :class:`~cxxnet_tpu_torch.serve.router.ModelRouter` over the
        tenants (first tenant is the default route, matching the
        single-model server's behavior for model-less requests)."""
        from ..serve.router import ModelRouter

        r = ModelRouter()
        for i, t in enumerate(self.tenants):
            r.add(t.name, t.engine, feedback=t.feedback,
                  default=(i == 0))
        return r

    # ------------------------------------------------------------------
    def tick_once(self) -> Dict[str, str]:
        """One scheduler pass: arbiter decision, then (unless shed) one
        cycle per tenant, then retention.  Returns each tenant's cycle
        outcome — tests and bench harnesses drive this directly."""
        out: Dict[str, str] = {}
        may_train = self.arbiter.tick()
        for t in self.tenants:
            if not may_train:
                out[t.name] = "shed"
                t.loop.sweep_retention()
                continue
            try:
                outcome = t.loop.run_cycle()
            except Exception as e:  # noqa: BLE001 - one tenant's broken
                # cycle must not starve its neighbors
                outcome = "error"
                obs_events.log_exception_once(
                    f"tenant.cycle.{t.name}", e,
                    kind="loop.cycle_error", tenant=t.name)
            if outcome == "published":
                self.arbiter.note_publish(t.loop.publisher.last_gain)
            self._m.cycles.labels(tenant=t.name, outcome=outcome).inc()
            out[t.name] = outcome
        self._update_pending()
        return out

    def _update_pending(self) -> None:
        for t in self.tenants:
            try:
                self._m.pending.labels(tenant=t.name).set(
                    float(t.loop.reader.pending(
                        t.loop.cursor_file.load())))
            except Exception:  # noqa: BLE001 - gauge only
                pass

    # ------------------------------------------------------------------
    def run(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.tick_once()
            except Exception as e:  # noqa: BLE001 - scheduler survives
                obs_events.log_exception_once(
                    "tenant.tick", e, kind="loop.cycle_error")
            elapsed = time.monotonic() - t0
            self._stop.wait(max(0.05, self.period_s - elapsed))

    def start(self) -> "TenantManager":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, name="cxxnet-tenant-manager", daemon=True)
        self._thread.start()
        return self

    def request_stop(self) -> None:
        """Signal the scheduler to stop WITHOUT joining it — what a
        signal handler may safely call (a mid-cycle join would block
        the caller for up to a whole fine-tune cycle)."""
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=30.0)
        self._thread = None

    def close(self) -> None:
        self.stop()
        for t in self.tenants:
            t.close()

    # ------------------------------------------------------------------
    def healthz_tenants(self) -> Dict[str, dict]:
        """Per-tenant identity block — one projection, shared with the
        HTTP front-end's ``/healthz`` ``models`` block."""
        return self.router().healthz_models()
