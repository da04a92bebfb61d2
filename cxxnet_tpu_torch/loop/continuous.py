"""Continuous fine-tuning loop: consume the feedback log, train, gate.

The port's copy of ``cxxnet_tpu/loop/continuous.py``:
``task=serve_train``'s training half.
:class:`ContinuousLoop` runs beside a live serving engine — typically on
a daemon thread of the same process — and repeats the cycle:

1. **tail** — read every feedback record committed past the persisted
   cursor (``loop/feedback_log.py``); fewer than ``min_records`` →
   the cycle is idle (counted, no training);
2. **fine-tune** — ``rounds_per_cycle`` passes over the new records,
   each batch mixed with ``replay_ratio`` base-iterator rows (the
   catastrophic-forgetting hedge: fresh feedback never fully displaces
   the original distribution);
3. **gate** — hand the candidate to the
   :class:`~cxxnet_tpu_torch.loop.publisher.EvalGatedPublisher`: divergence
   guard + held-out eval against the serving model's recorded metric.
   Published → the engine hot-reloads.  Rejected → the trainer ROLLS
   BACK to the publish pointer's current version (fine-tuning never
   compounds on a degraded model) and the cursor still advances (the
   poisoned records are consumed, not retried forever);
4. **advance** — persist the cursor only after the cycle resolves, so
   a crash mid-cycle replays the records into the next attempt.

The trainer is a FRESH ``NetTrainer`` loaded from the serving
checkpoint — the live engine's model is never mutated in place; the
only way weights reach serving is a published checkpoint.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..obs import events as obs_events
from ..obs import trace as obs_trace
from .feedback_log import (
    CursorFile,
    FeedbackReader,
    FeedbackRecord,
    loop_metrics,
)
from .publisher import EvalGatedPublisher

__all__ = ["ContinuousLoop"]

ConfigEntry = Tuple[str, str]


class _ReplayFeed:
    """Endless row source over the base iterator (replay mixing):
    yields ``(data_row, label_row)`` pairs, rewinding at epoch end.  The
    port's chains take ``before_first()`` before their first ``next()``
    (a ``threadbuffer`` produces nothing until then), so the feed
    rewinds once before it first reads."""

    def __init__(self, base_iter) -> None:
        self.base = base_iter
        self._rows: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pos = 0
        self._rewound = False

    def take(self, k: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        out = []
        while len(out) < k:
            if self._pos >= len(self._rows):
                if not self._refill():
                    break
            out.append(self._rows[self._pos])
            self._pos += 1
        return out

    def _refill(self) -> bool:
        self._rows, self._pos = [], 0
        if self.base is None:
            return False
        if not self._rewound:
            self.base.before_first()
            self._rewound = True
        if not self.base.next():
            self.base.before_first()
            if not self.base.next():
                return False
        b = self.base.value()
        n = b.batch_size - b.num_batch_padd
        data = np.asarray(b.data)[:n]
        label = np.asarray(b.label)[:n]
        if label.ndim == 1:
            label = label[:, None]
        self._rows = [(data[i], label[i]) for i in range(n)]
        return bool(self._rows)


class ContinuousLoop:
    """The serve→train→publish cycle runner.

    ``engine`` must watch a ``model_dir`` (that is both where the
    serving model came from and where publishes land); ``cfg`` is the
    full ordered config stream (netconfig + trainer globals — the
    fine-tune trainer is built from it exactly like the engine's).
    """

    def __init__(
        self,
        engine,
        cfg: Sequence[ConfigEntry],
        feedback_dir: str,
        base_iter=None,
        eval_iter=None,
        eval_name: str = "eval",
        rounds_per_cycle: int = 2,
        replay_ratio: float = 0.25,
        min_records: int = 64,
        max_records_per_cycle: int = 0,
        cycle_period_s: float = 2.0,
        publish_min_delta: float = 0.0,
        publish_metric: str = "",
        publish_slice_floor: Optional[float] = None,
        publish_slice_min_count: int = 8,
        publish_source_field: Optional[int] = None,
        cursor_path: Optional[str] = None,
        feedback_writer=None,
        retention=None,
        name: str = "",
        silent: bool = True,
    ) -> None:
        if eval_iter is None:
            raise ValueError(
                "ContinuousLoop needs a held-out eval iterator — the "
                "publish gate is not optional (add an eval section to "
                "the conf)")
        if not 0.0 <= replay_ratio < 1.0:
            raise ValueError("loop_replay_ratio must be in [0, 1)")
        self.engine = engine
        self.cfg = list(cfg)
        self.reader = FeedbackReader(feedback_dir)
        self.cursor_file = CursorFile(
            cursor_path or os.path.join(feedback_dir, "cursor.json"))
        self.replay = _ReplayFeed(base_iter)
        self.rounds_per_cycle = int(rounds_per_cycle)
        self.replay_ratio = float(replay_ratio)
        self.min_records = int(min_records)
        self.max_records_per_cycle = int(max_records_per_cycle)
        self.cycle_period_s = float(cycle_period_s)
        self.feedback_writer = feedback_writer
        self.retention = retention  # loop/retention.py Sweeper or None
        self.name = name
        self.silent = silent
        self._m = loop_metrics()
        self._stop = threading.Event()
        self.cycles = 0
        self.trained_cycles = 0
        # the in-flight cycle's first lineage id: records read but not
        # yet resolved (published/rejected).  Retention must never
        # compact the shard holding this range — a crash mid-cycle
        # replays exactly these records into the next attempt.
        self.pending_first_seq: Optional[int] = None
        self.publisher = EvalGatedPublisher(
            engine, eval_iter, eval_name=eval_name,
            metric_name=publish_metric, min_delta=publish_min_delta,
            slice_floor=publish_slice_floor,
            slice_min_count=publish_slice_min_count,
            source_field=publish_source_field,
            tenant=name, silent=silent,
        )
        self.trainer = self._load_trainer(engine.model_path)
        self._row_shape = tuple(
            self.trainer.net.input_node_shape(1)[1:])
        self.publisher.record_serving_baseline(self.trainer)

    # ------------------------------------------------------------------
    def _load_trainer(self, path: Optional[str]):
        from ..nnet.trainer import NetTrainer

        if path is None:
            raise ValueError(
                "serve_train needs the engine's model to come from a "
                "checkpoint file (model_dir), not an in-memory trainer")
        tr = NetTrainer()
        tr.set_params(self.cfg)
        tr.load_model(path)
        return tr

    # ------------------------------------------------------------------
    def _batches(self, records: List[FeedbackRecord]):
        """Yield ``(data, label)`` training batches: feedback rows
        padded out with ``replay_ratio`` base rows per batch."""
        bs = self.trainer.batch_size
        n_replay = min(int(round(bs * self.replay_ratio)), bs - 1)
        n_fresh = bs - n_replay
        lw = max(r.labels.shape[0] for r in records)
        for lo in range(0, len(records), n_fresh):
            chunk = records[lo: lo + n_fresh]
            rows = [(r.data.reshape(self._row_shape), r.labels)
                    for r in chunk]
            rows += self.replay.take(bs - len(chunk))
            if len(rows) < bs:
                # not enough replay data to fill: replicate (the
                # static-shape pad the reference's AdjustBatchSize did)
                rows += [rows[i % len(rows)]
                         for i in range(bs - len(rows))]
            data = np.stack([d for d, _ in rows]).astype(np.float32)
            labels = np.zeros((bs, max(lw, max(
                np.atleast_1d(l).shape[0] for _, l in rows))),
                np.float32)
            for i, (_, l) in enumerate(rows):
                l = np.atleast_1d(l)
                labels[i, : l.shape[0]] = l
            yield data, labels

    def run_cycle(self) -> str:
        """One cycle; returns ``idle`` / ``published`` / ``rejected``."""
        self.cycles += 1
        if self.feedback_writer is not None:
            # part-full pages are invisible to the reader until
            # committed: cycle boundaries flush so fresh feedback is
            # never stranded behind the page-size threshold
            self.feedback_writer.flush()
        cursor = self.cursor_file.load()
        pending = self.reader.pending(cursor)
        self._m.pending.set(pending)
        if pending < self.min_records:
            self._m.cycles.labels(outcome="idle").inc()
            return "idle"
        records, new_cursor = self.reader.read_since(
            cursor, max_records=self.max_records_per_cycle)
        if len(records) < self.min_records:
            if not records and new_cursor != cursor:
                # every committed page past the cursor was bad (CRC):
                # consume them now, or pending() keeps promising work
                # and every future cycle re-reads + re-counts the same
                # rot forever.  With SOME decodable records the cursor
                # holds so they train once min_records accumulate.
                self.cursor_file.store(new_cursor)
                self._m.pending.set(self.reader.pending(new_cursor))
            self._m.cycles.labels(outcome="idle").inc()
            return "idle"
        t0 = time.monotonic()
        # lineage covers exactly THIS cycle's records: a publish ships
        # only this cycle's fine-tuning (a rejected cycle rolls the
        # trainer back, so earlier consumed records never contribute),
        # and building it fresh per cycle means a cycle that failed
        # mid-training and replays its records cannot double-count them
        lineage = self._cycle_lineage(records)
        self.pending_first_seq = lineage["first_seq"]
        try:
            with obs_trace.span("loop.cycle", cycle=self.cycles,
                                records=len(records)):
                steps = 0
                for _ in range(self.rounds_per_cycle):
                    for data, labels in self._batches(records):
                        self.trainer.update_all(data, labels)
                        steps += 1
                self.trainer.sync()
                published = self.publisher.consider(
                    self.trainer, cycle=self.cycles, lineage=lineage)
                if not published:  # these records are spent either way
                    self._rollback()
            self.cursor_file.store(new_cursor)
        finally:
            # the range is pending until the cursor durably passes it:
            # a cycle that dies mid-training keeps its shard compaction-
            # proof so the replay can actually read the records back
            self.pending_first_seq = None
        self._m.pending.set(self.reader.pending(new_cursor))
        self._m.cycles.labels(outcome="trained").inc()
        self.trained_cycles += 1
        obs_events.emit(
            "loop.cycle", cycle=self.cycles, records=len(records),
            steps=steps, published=published, lineage=lineage,
            elapsed_s=time.monotonic() - t0, **self._tag())
        if not self.silent:
            print(f"loop{self._label()}: cycle {self.cycles}: "
                  f"{len(records)} records, {steps} steps, "
                  f"{'published' if published else 'rejected'} "
                  f"({time.monotonic() - t0:.2f}s)", flush=True)
        self.sweep_retention()
        return "published" if published else "rejected"

    # ------------------------------------------------------------------
    def _tag(self) -> dict:
        return {"tenant": self.name} if self.name else {}

    def _label(self) -> str:
        return f"[{self.name}]" if self.name else ""

    def set_rounds_per_cycle(self, n) -> int:
        """Live setter for the arbiter's per-tenant knob
        (``loop/tenant.py``): fine-tune passes per cycle, floor 1."""
        self.rounds_per_cycle = max(1, int(n))
        return self.rounds_per_cycle

    def sweep_retention(self) -> Optional[dict]:
        """One retention pass over this loop's feedback dir (no-op
        without a sweeper).  The cursor handed over is the PERSISTED
        one — only ranges a resolved cycle has durably consumed are
        behind it — clamped by the in-flight pending range."""
        if self.retention is None:
            return None
        try:
            return self.retention.sweep(
                self.cursor_file.load(),
                pending_first_seq=self.pending_first_seq)
        except Exception as e:  # noqa: BLE001 - retention must not
            # take down the loop; the disk keeps filling, loudly
            obs_events.log_exception_once(
                f"loop.retention.{self.name or 'default'}", e,
                kind="loop.retention_error")
            return None

    @staticmethod
    def _cycle_lineage(records: List[FeedbackRecord]) -> dict:
        """Lineage block for one cycle's consumed records: id range +
        count (records from pre-lineage pages have no seq and only
        count; ``cycles`` is kept for pointer-schema stability)."""
        seqs = [r.seq for r in records if r.seq is not None]
        return {
            "first_seq": min(seqs) if seqs else None,
            "last_seq": max(seqs) if seqs else None,
            "records": len(records),
            "cycles": 1,
        }

    def _rollback(self) -> None:
        """Reload the trainer from the last published/serving version
        so the next cycle fine-tunes from known-good weights."""
        target = self.publisher.rollback_target()
        if target is None:  # no checkpoint left: keep current weights
            obs_events.emit("loop.rollback", ok=False,
                            reason="no valid rollback checkpoint",
                            **self._tag())
            return
        round_, path = target
        self.trainer = self._load_trainer(path)
        self._m.publishes.labels(decision="rollback").inc()
        obs_events.emit("loop.rollback", ok=True, round=round_,
                        path=path, **self._tag())
        if not self.silent:
            print(f"loop{self._label()}: rolled trainer back to round "
                  f"{round_} ({path})", flush=True)

    # ------------------------------------------------------------------
    def run(self, max_cycles: int = 0) -> None:
        """Cycle until :meth:`stop` (or ``max_cycles`` trained cycles).
        Exceptions are contained per cycle: a failed cycle is logged
        and the loop keeps serving-side state intact."""
        while not self._stop.is_set():
            try:
                self.run_cycle()
            except Exception as e:  # noqa: BLE001 - loop must survive
                obs_events.log_exception_once(
                    "loop.cycle", e, kind="loop.cycle_error",
                    cycle=self.cycles)
                if not self.silent:
                    print(f"loop: cycle {self.cycles} failed: "
                          f"{type(e).__name__}: {e}", flush=True)
            if max_cycles and self.trained_cycles >= max_cycles:
                return
            self._stop.wait(self.cycle_period_s)

    def stop(self) -> None:
        self._stop.set()
