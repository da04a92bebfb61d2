"""Eval-gated checkpoint publisher: no update ships without proof.

The port's copy of ``cxxnet_tpu/loop/publisher.py``.  The gate between
the continuous trainer and the serving plane.  A fine-tuned candidate
is published —
written as the next ``NNNN.model`` in the engine's watch directory and
hot-reloaded — only when ALL of:

* **divergence guard** — every candidate weight is finite
  (``NetTrainer.weights_finite``, the divergence guard applied before
  publishing instead of post-mortem);
* **per-slice gate** (``publish_slice_floor >= 0``) — no eval cohort's
  accuracy may regress more than the floor below the serving model's
  recorded cohort vector.  Cohorts are per-class (``class:<k>`` from
  the label's first column) and, with ``publish_source_field = <col>``,
  per-source (``source:<v>`` from that label column) — so a candidate
  cannot buy aggregate accuracy by sacrificing one slice of users, and
  a rejection NAMES the cohort it sacrificed (the reject event also
  carries the cycle's lineage, so the regression is attributable to the
  exact feedback seq range that caused it);
* **eval gate** — the held-out eval metric is at least
  ``publish_min_delta`` better than the SERVING model's recorded
  metric (orientation-aware: error/rmse/logloss improve downward,
  rec@n upward).  ``publish_min_delta = 0`` means "no worse";

On acceptance the checkpoint is written through the atomic manifest
machinery (``utils/checkpoint.write_checkpoint``), the **publish
pointer** (``PUBLISHED.json``) flips to it — recording the previous
version for rollback, the gate metric AND its cohort vector — and the
engine hot-reload hook fires so the new weights serve immediately.
Persisting the bar in the pointer is what makes restarts honest:
:meth:`EvalGatedPublisher.record_serving_baseline` reads the recorded
metric back instead of re-scoring the same weights, so a restarted
loop gates against the bar the serving model actually cleared, not a
fresh re-eval of it.  On rejection nothing reaches the model
directory; the caller (``loop/continuous.py``) rolls its trainer back
to the pointer's current version so fine-tuning never compounds on a
degraded model.  Every decision is emitted to the obs event log
(``loop.publish`` / ``loop.reject``) and counted in
``loop_publish_total{decision}`` — the ``/metricsz`` audit trail.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..obs import events as obs_events
from ..utils import checkpoint as ckpt
from .feedback_log import loop_metrics

__all__ = [
    "EvalGatedPublisher",
    "accumulate_cohort_counts",
    "cohort_accuracy",
    "metric_improvement",
    "parse_eval_metric",
]

#: metrics where a SMALLER value is better; anything else (rec@n) is
#: treated as larger-is-better
LOWER_IS_BETTER_PREFIXES = ("error", "rmse", "logloss")

_METRIC_RE = re.compile(
    r"(\S+?):([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)")


def parse_eval_metric(eval_text: str, metric_name: str = "",
                      prefix: str = "") -> Tuple[str, float]:
    """Extract ``(name, value)`` from a trainer eval line
    (``\\tname-metric:value`` format).  ``prefix`` restricts to one
    eval section's metrics (e.g. ``"eval-"`` — the trainer prepends a
    possibly-empty ``train-`` metric to the same line);
    ``metric_name`` further selects by substring; empty picks the
    first remaining metric.  Raises ``ValueError`` when nothing
    matches — a loop without a measurable gate must not silently
    publish."""
    pairs = _METRIC_RE.findall(eval_text or "")
    if prefix:
        pairs = [(n, v) for n, v in pairs if n.startswith(prefix)]
    if metric_name:
        pairs = [(n, v) for n, v in pairs if metric_name in n]
    if not pairs:
        want = " ".join(filter(None, (
            f"prefix {prefix!r}" if prefix else "",
            f"matching {metric_name!r}" if metric_name else "")))
        raise ValueError(
            f"no eval metric {want} in {eval_text!r}; the publish gate "
            "needs an eval section with a metric")
    name, val = pairs[0]
    return name, float(val)


def metric_improvement(name: str, serving: float, candidate: float) -> float:
    """Signed improvement of ``candidate`` over ``serving`` — positive
    is better, orientation-aware by metric name."""
    base = name.rsplit("-", 1)[-1]  # "eval-error[field]" -> "error[field]"
    lower_better = base.startswith(LOWER_IS_BETTER_PREFIXES)
    return (serving - candidate) if lower_better else (candidate - serving)


# ----------------------------------------------------------------------
# cohort metrics (the per-slice gate's eval plane)
def accumulate_cohort_counts(
    counts: Dict[str, list],
    preds: np.ndarray,
    labels: np.ndarray,
    source_field: Optional[int] = None,
) -> None:
    """Fold one eval batch into ``{cohort: [correct, total]}``.

    Cohorts: ``class:<k>`` keyed by the label's first column (the
    classification target), and ``source:<v>`` keyed by label column
    ``source_field`` when given (a request-source/user-segment tag the
    feedback or eval pipeline carries as an extra label field).
    Correctness is prediction == target, i.e. cohort accuracy — one
    orientation regardless of the aggregate gate metric, so floors
    compare the same way for every conf."""
    labels = np.asarray(labels)
    if labels.ndim == 1:
        labels = labels[:, None]
    preds = np.asarray(preds).reshape(labels.shape[0], -1)[:, 0]
    target = labels[:, 0]
    hit = preds == target
    keys = [("class", target)]
    if source_field is not None and 0 <= source_field < labels.shape[1]:
        keys.append(("source", labels[:, source_field]))
    for prefix, col in keys:
        for v in np.unique(col):
            mask = col == v
            tag = f"{prefix}:{int(v) if float(v).is_integer() else v}"
            c = counts.setdefault(tag, [0, 0])
            c[0] += int(hit[mask].sum())
            c[1] += int(mask.sum())


def cohort_accuracy(counts: Dict[str, list],
                    min_count: int = 0) -> Dict[str, float]:
    """``{cohort: accuracy}`` from accumulated counts; cohorts with
    fewer than ``min_count`` eval rows are dropped (too small to gate
    on without noise-rejecting every publish)."""
    return {k: c / t for k, (c, t) in counts.items()
            if t and t >= min_count}


class EvalGatedPublisher:
    """Gatekeeper of the serving model directory.

    ``engine`` is the live serving engine (its ``model_dir`` is the
    publish target and its ``try_reload`` the hot-swap hook);
    ``eval_iter`` the held-out eval iterator the gate scores on.
    """

    def __init__(
        self,
        engine,
        eval_iter,
        eval_name: str = "eval",
        metric_name: str = "",
        min_delta: float = 0.0,
        slice_floor: Optional[float] = None,
        slice_min_count: int = 8,
        source_field: Optional[int] = None,
        tenant: str = "",
        silent: bool = True,
    ) -> None:
        if engine.model_dir is None:
            raise ValueError(
                "EvalGatedPublisher needs an engine watching a "
                "model_dir (the publish target)")
        self.engine = engine
        self.eval_iter = eval_iter
        self.eval_name = eval_name
        self.metric_name = metric_name
        self.min_delta = float(min_delta)
        self.slice_floor = (None if slice_floor is None
                            else float(slice_floor))
        self.slice_min_count = int(slice_min_count)
        self.source_field = source_field
        self.tenant = tenant
        self.silent = silent
        self._m = loop_metrics()
        self.serving_metric: Optional[float] = None
        self.serving_metric_name: Optional[str] = None
        self.serving_cohorts: Optional[Dict[str, float]] = None
        self.last_gain: Optional[float] = None

    def _tag(self) -> dict:
        """Tenant identity folded into every event (multi-tenant runs
        need the audit trail to name whose loop decided)."""
        return {"tenant": self.tenant} if self.tenant else {}

    @property
    def slice_armed(self) -> bool:
        return self.slice_floor is not None and self.slice_floor >= 0

    # ------------------------------------------------------------------
    def evaluate(self, trainer) -> Tuple[str, float]:
        """Held-out eval of ``trainer``; returns ``(name, value)``.
        Only the eval section's own metrics qualify (the trainer
        prepends a ``train-`` metric to the same line when
        ``eval_train`` is on — scoring the gate on that would compare
        against an empty-count 0)."""
        text = trainer.evaluate(self.eval_iter, self.eval_name)
        return parse_eval_metric(text, self.metric_name,
                                 prefix=f"{self.eval_name}-")

    def evaluate_cohorts(self, trainer) -> Dict[str, float]:
        """Per-cohort accuracy of ``trainer`` over the held-out eval
        set (one extra predict pass; only run when the slice gate is
        armed).  Small cohorts (< ``slice_min_count`` rows) are dropped
        — see :func:`cohort_accuracy`."""
        counts: Dict[str, list] = {}
        self.eval_iter.before_first()
        while self.eval_iter.next():
            batch = self.eval_iter.value()
            n = batch.batch_size - batch.num_batch_padd
            if n <= 0:
                continue
            preds = trainer.predict(batch.data, batch.extra_data)[:n]
            labels = np.asarray(batch.label)[:n]
            accumulate_cohort_counts(counts, preds, labels,
                                     source_field=self.source_field)
        return cohort_accuracy(counts, min_count=self.slice_min_count)

    def record_serving_baseline(self, trainer) -> float:
        """Establish the bar every candidate is gated against.

        The bar is the RECORDED one when ``PUBLISHED.json`` names the
        round the engine is serving — a restarted loop must gate
        against the metric the serving model actually cleared, not a
        fresh re-eval of the same weights (re-baselining on restart
        silently reset the bar every time the manager bounced).  Only
        when no pointer covers the serving round (first boot of a
        model_dir, or an operator dropped a newer checkpoint in) are
        the serving weights scored fresh — and the result is persisted
        into the pointer so the NEXT restart reads it back."""
        ptr = ckpt.read_publish_pointer(self.engine.model_dir)
        met = (ptr or {}).get("metric") or {}
        recorded = (
            ptr is not None
            and int(ptr.get("round", -1)) == self.engine.round
            and isinstance(met.get("value"), (int, float))
            and (not self.metric_name
                 or self.metric_name in str(met.get("name") or ""))
        )
        live: Optional[Tuple[str, float]] = None
        if recorded and not self.metric_name:
            # no gate metric configured: candidates gate under whatever
            # the eval plane reports FIRST, so the recorded bar is only
            # comparable if that metric still carries the recorded name
            # (an eval-conf change between restarts would otherwise
            # compare values of different, possibly opposite-orientation
            # metrics).  One name-validation eval — the VALUE bar stays
            # recorded when the name matches.
            live = self.evaluate(trainer)
            if live[0] != str(met.get("name") or ""):
                recorded = False
        if recorded:
            name, val = str(met["name"]), float(met["value"])
            cohorts = met.get("cohorts")
            self.serving_cohorts = (dict(cohorts)
                                    if isinstance(cohorts, dict) else None)
            if self.slice_armed and self.serving_cohorts is None:
                # pointer predates slice gating: grow it the cohort
                # vector once, preserving every other recorded field
                self.serving_cohorts = self.evaluate_cohorts(trainer)
                self._write_pointer(
                    ptr["round"], ptr["path"],
                    net_fp=ptr.get("net_fingerprint"),
                    name=name, value=val, cohorts=self.serving_cohorts,
                    prev_round=(ptr.get("prev") or {}).get("round"),
                    lineage=ptr.get("lineage"))
        else:
            name, val = (live if live is not None
                         else self.evaluate(trainer))
            self.serving_cohorts = (self.evaluate_cohorts(trainer)
                                    if self.slice_armed else None)
            if self.engine.model_path is not None:
                self._write_pointer(
                    self.engine.round, self.engine.model_path,
                    net_fp=trainer.net_fp(), name=name, value=val,
                    cohorts=self.serving_cohorts,
                    prev_round=(ptr or {}).get("round"))
        self.serving_metric, self.serving_metric_name = val, name
        obs_events.emit("loop.baseline", metric=name, value=val,
                        round=self.engine.round,
                        source="recorded" if recorded else "evaluated",
                        **self._tag())
        if not self.silent:
            print(f"loop: serving baseline {name}:{val:g} "
                  f"({'recorded' if recorded else 'evaluated'}, "
                  f"round {self.engine.round})", flush=True)
        return val

    def _write_pointer(self, round_, path, net_fp, name, value,
                       cohorts=None, prev_round=None,
                       lineage=None) -> None:
        metric = {"name": name, "value": value}
        if cohorts is not None:
            metric["cohorts"] = {k: round(float(v), 6)
                                 for k, v in cohorts.items()}
        ckpt.write_publish_pointer(
            self.engine.model_dir, int(round_), path, net_fp=net_fp,
            metric=metric, prev_round=prev_round, lineage=lineage)

    # ------------------------------------------------------------------
    def consider(self, trainer, cycle: int = -1,
                 lineage: Optional[dict] = None) -> bool:
        """Gate one candidate; publish + hot-reload on pass.

        Returns True when the candidate was published.  On any gate
        failure (non-finite weights, eval regression beyond
        ``min_delta``) nothing is written and False returns — the
        caller rolls the trainer back.  ``lineage`` (the feedback-record
        id range + count the candidate was fine-tuned on) rides into the
        publish pointer so a served model is traceable back to the
        requests that trained it."""
        if self.serving_metric is None:
            raise RuntimeError(
                "record_serving_baseline must run before consider()")
        self.last_gain = None
        if not trainer.weights_finite():
            self._reject(cycle, reason="non-finite weights",
                         metric=self.serving_metric_name,
                         candidate=None, lineage=lineage)
            return False
        name, cand = self.evaluate(trainer)
        cand_cohorts = (self.evaluate_cohorts(trainer)
                        if self.slice_armed else None)
        # the slice gate runs FIRST: when a cohort regressed beyond the
        # floor, the rejection must name the cohort (the actionable
        # fact) even if the aggregate gate would also have failed
        if self.slice_armed and self.serving_cohorts:
            worst = None  # (drop, cohort, base, got)
            for cohort, base_acc in self.serving_cohorts.items():
                got = cand_cohorts.get(cohort)
                if got is None:
                    continue  # cohort shrank below min_count: not gated
                drop = float(base_acc) - float(got)
                if drop > self.slice_floor and (
                        worst is None or drop > worst[0]):
                    worst = (drop, cohort, float(base_acc), float(got))
            if worst is not None:
                drop, cohort, base_acc, got = worst
                self._reject(
                    cycle,
                    reason=f"slice gate: cohort {cohort} accuracy "
                           f"{base_acc:.4g} -> {got:.4g} (drop {drop:.4g}"
                           f" > publish_slice_floor "
                           f"{self.slice_floor:g})",
                    metric=name, candidate=cand, cohort=cohort,
                    lineage=lineage)
                return False
        gain = metric_improvement(name, self.serving_metric, cand)
        if gain < self.min_delta:
            self._reject(
                cycle, reason=f"eval gate: improvement {gain:g} < "
                              f"publish_min_delta {self.min_delta:g}",
                metric=name, candidate=cand, lineage=lineage)
            return False
        self._publish(trainer, name, cand, gain, cycle, lineage=lineage,
                      cohorts=cand_cohorts)
        return True

    # ------------------------------------------------------------------
    def _reject(self, cycle: int, reason: str, metric, candidate,
                cohort: Optional[str] = None,
                lineage: Optional[dict] = None) -> None:
        self._m.publishes.labels(decision="rejected").inc()
        obs_events.emit("loop.reject", cycle=cycle, reason=reason,
                        metric=metric, candidate=candidate,
                        serving=self.serving_metric,
                        serving_round=self.engine.round,
                        cohort=cohort, lineage=lineage, **self._tag())
        if not self.silent:
            print(f"loop: candidate REJECTED ({reason}; serving "
                  f"{metric}:{self.serving_metric:g}"
                  + (f", candidate {candidate:g}"
                     if candidate is not None else "") + ")",
                  flush=True)

    def _publish(self, trainer, name: str, cand: float, gain: float,
                 cycle: int, lineage: Optional[dict] = None,
                 cohorts: Optional[Dict[str, float]] = None) -> None:
        model_dir = self.engine.model_dir
        prev_round = self.engine.round
        latest = ckpt.list_checkpoints(model_dir)
        round_ = max(prev_round, latest[-1][0] if latest else -1) + 1
        path = ckpt.publish_path(model_dir, round_)
        ckpt.write_checkpoint(path, trainer.checkpoint_bytes(),
                              round_=round_, net_fp=trainer.net_fp())
        self._write_pointer(
            round_, path, net_fp=trainer.net_fp(),
            name=name, value=cand, cohorts=cohorts,
            prev_round=prev_round, lineage=lineage,
        )
        self.serving_metric, self.serving_metric_name = cand, name
        if cohorts is not None:
            self.serving_cohorts = dict(cohorts)
        self.last_gain = gain
        # the reload hook: the engine swaps to the published round NOW
        # (breaker-gated) instead of waiting for a poll period
        swapped = self.engine.try_reload()
        self._m.publishes.labels(decision="published").inc()
        obs_events.emit("loop.publish", cycle=cycle, round=round_,
                        path=path, metric=name, candidate=cand,
                        gain=gain, swapped=swapped,
                        prev_round=prev_round, lineage=lineage,
                        **self._tag())
        if not self.silent:
            print(f"loop: PUBLISHED round {round_} ({name}:{cand:g}, "
                  f"improvement {gain:g}, reloaded={swapped})",
                  flush=True)

    # ------------------------------------------------------------------
    def rollback_target(self) -> Optional[Tuple[int, str]]:
        """Where a rejected trainer should roll back to: the publish
        pointer's current version when one exists and validates, else
        the newest valid checkpoint in the model directory."""
        model_dir = self.engine.model_dir
        ptr = ckpt.read_publish_pointer(model_dir)
        if ptr is not None:
            path = ptr.get("path")
            if (path and os.path.exists(path)
                    and ckpt.validate_checkpoint(path) is None):
                return int(ptr["round"]), path
        return ckpt.find_latest_valid(model_dir, silent=True)
