"""Closed-loop continuous training: serve → feedback log → fine-tune →
eval-gated publish → hot reload (``task=serve_train``).

The port's copy of ``cxxnet_tpu/loop/``, driven on the card through
the same K1-K6 and K8 kernels as ``task=train``.  Its parts:

* :mod:`~cxxnet_tpu_torch.loop.feedback_log` — sharded append-only
  (input, label) log in the imgbin CXBP page format with atomic page
  commits, CRC sidecars, size rotation, and a cursor-tailing reader;
* :mod:`~cxxnet_tpu_torch.loop.continuous` — the fine-tune cycle runner:
  tail the log, mix with base-iterator replay, train, gate, advance
  the cursor;
* :mod:`~cxxnet_tpu_torch.loop.publisher` — the eval gate: divergence guard
  + held-out-metric comparison against the serving model, plus the
  per-slice cohort gate (``publish_slice_floor``); only passing
  candidates reach the model directory (and the engine's hot reload),
  with a publish pointer recording rollback state, the gate metric and
  its cohort vector;
* :mod:`~cxxnet_tpu_torch.loop.retention` — compaction of consumed feedback
  shards behind the resolved cursor, crash-safe (boundary fsynced
  before unlink);
* :mod:`~cxxnet_tpu_torch.loop.tenant` — ``task=loop_fleet``: N tenants on
  one device pool behind an SLO-constrained round arbiter.
"""

from .continuous import ContinuousLoop
from .feedback_log import (
    CursorFile,
    FeedbackReader,
    FeedbackRecord,
    FeedbackWriter,
    StaleCursorError,
    decode_record,
    encode_record,
    loop_metrics,
)
from .publisher import EvalGatedPublisher, metric_improvement, parse_eval_metric
from .retention import RetentionOptions, Sweeper
from .tenant import Tenant, TenantArbiter, TenantManager

__all__ = [
    "ContinuousLoop",
    "CursorFile",
    "FeedbackReader",
    "FeedbackRecord",
    "FeedbackWriter",
    "EvalGatedPublisher",
    "RetentionOptions",
    "StaleCursorError",
    "Sweeper",
    "Tenant",
    "TenantArbiter",
    "TenantManager",
    "decode_record",
    "encode_record",
    "loop_metrics",
    "metric_improvement",
    "parse_eval_metric",
]
