"""Evaluation metrics: error, rmse, logloss, rec@n + MetricSet.

The port's copy of ``cxxnet_tpu/utils/metric.py`` (numpy only), minus
the cross-process reduction of multi-process runs, which belong to a
later slice.  Parity with the reference's ``src/utils/metric.h``:

* ``error``: argmax mismatch (first max wins on ties); 1-column
  predictions threshold at 0 (metric.h:73-90)
* ``rmse``: *sum* of squared errors per instance, averaged over instances
  (the reference never takes the square root despite the name — kept)
* ``logloss``: -log p[target], clamped to [1e-15, 1-1e-15]; binary form
  for 1-column predictions with the built-in NaN check
* ``rec@n``: fraction of the label list present in the top-n predictions.
  Ties are broken RANDOMLY per instance, matching the reference
  (src/utils/metric.h:150-170 shuffles the index vector before its
  partial sort): fresh per-row random jitter from a seeded per-metric
  PRNG is the lexsort secondary key, so equal scores enter the top-n
  in a different random order for every row while runs stay
  reproducible.
* ``MetricSet``: multiple metrics over named label fields; report format
  ``\\tname-metric[field]:value`` (metric.h:193-203)

Config parsing (``nnet_impl-inl.hpp:57-67``): ``metric = error`` binds to
field "label" and the final output node; ``metric[field,node] = error``
selects a label field AND a named graph node to score — each metric
carries its node selector (``None`` = final out), and the trainer feeds
per-metric predictions the way the reference fills one ``eval_req``
entry per metric (``nnet_impl-inl.hpp:363-372``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np


class Metric:
    name = ""

    def __init__(self) -> None:
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def clear(self) -> None:
        self.sum_metric, self.cnt_inst = 0.0, 0

    def add_eval(self, pred: np.ndarray, label: np.ndarray) -> None:
        """pred: (N, K) scores; label: (N, L) field columns."""
        self.sum_metric += float(self._batch_sum(pred, label))
        self.cnt_inst += pred.shape[0]

    def get(self) -> float:
        return self.sum_metric / max(self.cnt_inst, 1)

    def _batch_sum(self, pred: np.ndarray, label: np.ndarray) -> float:
        raise NotImplementedError


class MetricError(Metric):
    name = "error"

    def _batch_sum(self, pred, label):
        if pred.shape[1] != 1:
            guess = pred.argmax(axis=1)
        else:
            guess = (pred[:, 0] > 0).astype(np.int64)
        return np.sum(guess != label[:, 0].astype(np.int64))


class MetricRMSE(Metric):
    name = "rmse"

    def _batch_sum(self, pred, label):
        if pred.shape != label.shape:
            raise ValueError("rmse: prediction and label sizes must match")
        return np.sum((pred - label) ** 2)


class MetricLogloss(Metric):
    name = "logloss"

    def _batch_sum(self, pred, label):
        eps = 1e-15
        if pred.shape[1] != 1:
            tgt = label[:, 0].astype(np.int64)
            p = np.clip(pred[np.arange(len(tgt)), tgt], eps, 1 - eps)
            return -np.sum(np.log(p))
        p = np.clip(pred[:, 0], eps, 1 - eps)
        y = label[:, 0]
        res = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        if np.isnan(res).any():
            raise FloatingPointError("logloss: NaN detected!")
        return np.sum(res)


class MetricRecall(Metric):
    def __init__(self, name: str) -> None:
        super().__init__()
        m = re.fullmatch(r"rec@(\d+)", name)
        if not m:
            raise ValueError("must specify n for rec@n")
        self.topn = int(m.group(1))
        self.name = name
        self._rng = np.random.RandomState(0)

    def _batch_sum(self, pred, label):
        if pred.shape[1] < self.topn:
            raise ValueError(
                f"rec@{self.topn} meaningless for prediction list of "
                f"size {pred.shape[1]}"
            )
        # random tie-break (reference parity): sort by score with a
        # fresh per-row random secondary key, so equal scores enter the
        # top-n in random order per instance
        jitter = self._rng.random_sample(pred.shape)
        order = np.lexsort((jitter, -pred), axis=1)
        top = order[:, : self.topn]
        total = 0.0
        for i in range(pred.shape[0]):
            hits = np.isin(label[i].astype(np.int64), top[i]).sum()
            total += hits / label.shape[1]
        return total


class MetricPerplexity(MetricLogloss):
    """exp(mean NLL) — the language-modeling spelling of logloss
    (per-token when the prediction is a sequence; new scope, no
    reference analog)."""

    name = "perplexity"

    def get(self) -> float:
        import math

        return math.exp(self.sum_metric / max(self.cnt_inst, 1))


def create_metric(name: str) -> Metric:
    if name == "error":
        return MetricError()
    if name == "rmse":
        return MetricRMSE()
    if name == "logloss":
        return MetricLogloss()
    if name == "perplexity":
        return MetricPerplexity()
    if name.startswith("rec@"):
        return MetricRecall(name)
    raise ValueError(f"Metric: unknown metric name: {name}")


_METRIC_KEY_RE = re.compile(r"metric(\[(?P<field>[^,\]]+)(,(?P<node>[^\]]+))?\])?")


class MetricSet:
    def __init__(self) -> None:
        self.metrics: List[Metric] = []
        self.fields: List[str] = []
        self.nodes: List[object] = []  # per-metric node name; None = out

    def add_metric(self, name: str, field: str = "label",
                   node: str | None = None) -> None:
        self.metrics.append(create_metric(name))
        self.fields.append(field)
        self.nodes.append(node)

    def try_add_from_config(self, key: str, val: str) -> bool:
        """Parse a ``metric`` / ``metric[field]`` / ``metric[field,node]``
        config entry; returns False if the key is not a metric key."""
        if not key.startswith("metric"):
            return False
        m = _METRIC_KEY_RE.fullmatch(key)
        if not m:
            return False
        field = m.group("field") or "label"
        self.add_metric(val, field, m.group("node"))
        return True

    def need_nodes(self) -> bool:
        """True when any metric scores a non-default graph node."""
        return any(n is not None for n in self.nodes)

    def clear(self) -> None:
        for mt in self.metrics:
            mt.clear()

    def add_eval(
        self,
        pred,
        labels: np.ndarray,
        label_ranges: Dict[str, Tuple[int, int]],
    ) -> None:
        """labels: (N, label_width); label_ranges: field → column span.

        ``pred`` is one (N, K) array applied to every metric, or a list
        with one prediction per metric (the reference's per-metric
        ``eval_req`` scores, metric.h AddEval)."""
        if labels.ndim == 1:
            labels = labels[:, None]
        if isinstance(pred, (list, tuple)):
            if len(pred) != len(self.metrics):
                raise ValueError(
                    f"MetricSet: {len(pred)} predictions for "
                    f"{len(self.metrics)} metrics"
                )
            preds = list(pred)
        else:
            preds = [pred] * len(self.metrics)
        for mt, field, pred in zip(self.metrics, self.fields, preds):
            if field not in label_ranges:
                raise ValueError(f"Metric: unknown target = {field}")
            a, b = label_ranges[field]
            if pred.ndim == 3:
                # per-position sequence predictions (N, T, V) — language
                # models: score each position as an instance; the
                # metric's field must span exactly the T positions
                # (label_vec[a,a+T) = field)
                n, t, v = pred.shape
                if b - a != t:
                    raise ValueError(
                        f"Metric[{field}]: sequence predictions with T={t}"
                        f" positions need a label field of width {t}, got"
                        f" columns [{a},{b})"
                    )
                mt.add_eval(
                    pred.reshape(n * t, v),
                    labels[:, a:b].reshape(n * t, 1),
                )
            else:
                mt.add_eval(pred, labels[:, a:b])

    def reduce_across_processes(self, group=None) -> None:
        """Sum ``(sum_metric, cnt_inst)`` over ``group``, the trainer's
        data sub-group (``MeshPlan.data_group``; ``None`` the whole job,
        ``parallel/distributed.py``): each data index
        scored its own rows (the model ranks of one index score the
        same), so the sums are the global metric's.  Collective: every
        rank calls.  A no-op on one process.  The counters travel as
        float64 words, exactly."""
        from ..parallel import distributed

        if distributed.process_info()[1] == 1 or not self.metrics:
            return
        rows = np.asarray([[m.sum_metric, m.cnt_inst] for m in self.metrics],
                          np.float64)
        total = distributed.gather_host(rows, group).sum(axis=0)
        for m, (s, c) in zip(self.metrics, total):
            m.sum_metric, m.cnt_inst = float(s), int(c)

    def print(self, evname: str) -> str:
        out = []
        for mt, field in zip(self.metrics, self.fields):
            tag = f"{evname}-{mt.name}"
            if field != "label":
                tag += f"[{field}]"
            out.append(f"\t{tag}:{mt.get():g}")
        return "".join(out)

    def __len__(self) -> int:
        return len(self.metrics)
