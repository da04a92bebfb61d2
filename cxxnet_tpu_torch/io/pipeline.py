"""The ordered decode pool: multi-worker decode and augmentation.

The port's copy of ``cxxnet_tpu/io/pipeline.py``.
``num_decode_workers = N`` (N > 1) starts N worker threads (PIL's decode
and numpy's array passes release the GIL).  The consumer thread reads
the records from the source in epoch order (so fault draws, the
bad-record budget and the record order are those of the serial chain),
groups them in chunks of ``decode_chunk`` records and hands each chunk
to the pool; at most ``decode_queue_depth`` chunks are in flight (0:
the smaller of the workers and the cores, at least 2), and chunks are
consumed in the order they were handed out.  Every draw is a hash of
the record and the epoch (``io/augment.py``), so the batches are
bit-equal to the serial chain's at any worker count, chunk size, depth
or mid-epoch rewind.

Workers decode and augment; for encoded images with no affine warp and
no full-size mean they decode, crop and flip with PIL only, and the
float tail runs vectorized on the consumer (``augment_pil`` /
``augment_tail``).  A worker's decode failure is relayed to the consumer,
which quarantines it in record order; any other error is raised by the
consumer's ``next()``.  A hung pool trips the port's ``Watchdog``
(``watchdog_timeout_s``) with the workers' stacks; the ``pipeline.worker``
fault site is visited once a chunk.  ``close()`` stops and joins the
workers.  With ``num_decode_workers <= 1`` (the default) the stage passes
the serial chain through.

The pool resizes live (``request_workers``, ``set_queue_depth``, the
knobs ``tune/`` turns under ``controller = 1``): new workers start at
once and surplus ones retire on a token, so the record order and the
augmentation stream stay bit-equal across a resize; a serial chain grows
its pool at the next ``before_first``.  The stages time themselves into
``utils.profiler.pipeline_stats()``: ``decode`` (the PIL workers' chunk,
or each record's ``decode_record``) and ``augment`` (a chunk's augment
or the consumer's float tail).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
import traceback
from typing import List, Optional

from ..obs import events as obs_events
from ..utils import faults
from ..utils.faults import Watchdog, WatchdogError
from ..utils.profiler import pipeline_stats
from .augment import AugmentIterator
from .batch import DataInst, InstIterator


class _BadRecord:
    """A worker's decode failure, quarantined by the consumer."""

    __slots__ = ("source", "offset", "exc")

    def __init__(self, source, offset, exc) -> None:
        self.source = source
        self.offset = offset
        self.exc = exc


class _WorkerError:
    """Any other failure in a worker, raised by the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class ParallelAugmentIterator(InstIterator):
    """Ordered decode and augment pool over an :class:`AugmentIterator`.

    Raw mode (the augmenter's base has ``next_raw``: the imgbin reader):
    workers decode and augment.  Instance mode (any other base, such as
    ``iter = img``): records come decoded and workers augment them."""

    def supports_dist_shard(self) -> bool:
        return self.aug.supports_dist_shard()

    def __init__(self, aug: AugmentIterator) -> None:
        self.aug = aug
        self._yielded = 0  # decoded records this epoch (epoch_cap)
        self.num_workers = 0
        self.chunk_size = 24
        self.queue_depth = 0
        self.watchdog_timeout_s = 600.0
        self.silent = 0
        self._threads: List[threading.Thread] = []
        self._in_q: Optional[queue.Queue] = None
        self._results = {}
        self._cond = threading.Condition()
        self._stop = False
        self._gen = 0
        self._seq_submit = 0
        self._seq_take = 0
        self._exhausted = False
        self._pending: List[object] = []
        self._pending_pos = 0
        self._raw_source = None
        self._pil_mode = False
        self._watchdog: Optional[Watchdog] = None
        self._out: Optional[DataInst] = None
        self._closed = False
        self._init_done = False
        self._pool_started = False
        self._pool_lock = threading.Lock()  # guards _threads membership
        self._worker_seq = 0                # worker name ids
        self._poison_pending = 0            # retire tokens in flight

    def set_param(self, name, val):
        self.aug.set_param(name, val)
        if name == "num_decode_workers":
            self.num_workers = int(val)
        elif name == "decode_chunk":
            self.chunk_size = max(1, int(val))
        elif name == "decode_queue_depth":
            self.queue_depth = int(val)
        elif name == "watchdog_timeout_s":
            self.watchdog_timeout_s = float(val)
        elif name == "silent":
            self.silent = int(val)

    def init(self):
        self.aug.init()
        self._init_done = True
        if self.num_workers > 1:
            self._start_pool()

    # ------------------------------------------------------------------
    # live resize (the tuner's knobs)
    def request_workers(self, n: int) -> int:
        """Set the pool's worker target (thread-safe).  A running pool
        resizes at once: new threads start, surplus ones retire on a
        token; the record order and the stream do not change (chunks
        are consumed by sequence number, draws are per record).  A
        serial chain grows its pool at the next :meth:`before_first`
        (mid-epoch the consumer owns the source's cursor).  A pool never
        goes back to the serial path: a target of 1 runs one worker,
        which is bit-equal to it."""
        n = max(1, int(n))
        self.num_workers = n
        if self._closed:
            return n
        if self._pool_started:
            self._reconcile_pool()
        from ..tune.controller import set_effective

        set_effective("num_decode_workers", n)
        return n

    def set_queue_depth(self, n: int) -> int:
        """Set the in-flight chunk window (read at every refill; a
        window below the chunks in flight pauses handing out work until
        they are consumed)."""
        n = max(1, int(n))
        self.queue_depth = n
        from ..tune.controller import set_effective

        set_effective("decode_queue_depth", n)
        return n

    def effective_workers(self) -> int:
        """Worker threads alive now."""
        with self._pool_lock:
            return sum(1 for t in self._threads if t.is_alive())

    def _spawn_worker(self) -> None:
        t = threading.Thread(target=self._worker, daemon=True,
                             name=f"decode-worker-{self._worker_seq}")
        self._worker_seq += 1
        t.start()
        self._threads.append(t)

    def _reconcile_pool(self) -> None:
        """Bring the live workers to ``num_workers``: start the
        shortfall, send a retire token for each surplus one.  Tokens in
        flight count against the surplus (back-to-back shrinks would
        otherwise retire every worker), and tokens a rewind drained are
        credited back there."""
        with self._pool_lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            target = max(1, self.num_workers)
            effective = len(self._threads) - self._poison_pending
            if effective < target:
                for _ in range(target - effective):
                    self._spawn_worker()
            else:
                for _ in range(effective - target):
                    self._in_q.put(None)
                    self._poison_pending += 1

    def _start_pool(self):
        src = self.aug.base
        if (getattr(src, "next_raw", None) is not None
                and src.raw_available()):
            self._raw_source = src
        self._pil_mode = (self._raw_source is not None
                          and src.pil_available()
                          and self.aug.pil_path_ok())
        if self.queue_depth <= 0:
            self.queue_depth = max(
                2, min(self.num_workers, os.cpu_count() or self.num_workers))
        self._in_q = queue.Queue()
        self._watchdog = Watchdog(what="decode pool",
                                  timeout_s=self.watchdog_timeout_s)
        with self._pool_lock:
            for _ in range(self.num_workers):
                self._spawn_worker()
        self._pool_started = True
        from ..tune.controller import set_effective

        set_effective("num_decode_workers", self.num_workers)
        set_effective("decode_queue_depth", self.queue_depth)
        if not self.silent:
            mode = ("decode+crop (split float tail)" if self._pil_mode
                    else "decode+augment" if self._raw_source
                    else "augment")
            print(f"ParallelAugmentIterator: {self.num_workers} workers "
                  f"({mode}), chunk={self.chunk_size}, "
                  f"window={self.queue_depth} chunks")

    # ------------------------------------------------------------------
    # worker side
    def _worker(self) -> None:
        while True:
            task = self._in_q.get()
            if task is None:
                # a retire token (or close()): the count and this
                # thread's membership change together under the lock,
                # so a concurrent reconcile never over-retires
                with self._pool_lock:
                    self._poison_pending = max(0, self._poison_pending - 1)
                    try:
                        self._threads.remove(threading.current_thread())
                    except ValueError:
                        pass
                return
            gen, seq, epoch, mode, items = task
            try:
                faults.fault_point("pipeline.worker")
                result = self._process(epoch, mode, items)
            except BaseException as e:  # noqa: BLE001 - relayed
                result = _WorkerError(e)
            with self._cond:
                if gen == self._gen and not self._stop:
                    self._results[seq] = result
                    self._watchdog.beat()
                    self._cond.notify_all()

    def _process(self, epoch: int, mode: str, items):
        """One chunk, in record order; decode failures become
        :class:`_BadRecord` in place.  ``("tail", ...)``: the consumer
        still owes the records the float tail."""
        src = self._raw_source
        if mode == "pil":
            out: List[object] = []
            t0 = time.perf_counter()
            for rec in items:
                try:
                    im = src.decode_pil(rec)
                except Exception as e:  # noqa: BLE001 - untrusted bytes
                    out.append(_BadRecord(rec.source, rec.offset, e))
                    continue
                out.append(self.aug.augment_pil(im, rec.index, rec.labels,
                                                epoch))
            pipeline_stats().add("decode", time.perf_counter() - t0,
                                 rows=len(items))
            return ("tail", epoch, out)
        if mode == "raw":
            decoded: List[object] = []
            for rec in items:
                try:
                    decoded.append(DataInst(rec.index, src.decode_record(rec),
                                            rec.labels))
                except Exception as e:  # noqa: BLE001 - untrusted bytes
                    decoded.append(_BadRecord(rec.source, rec.offset, e))
        else:
            decoded = list(items)
        ok = [d for d in decoded if isinstance(d, DataInst)]
        t0 = time.perf_counter()
        augmented = iter(self.aug.augment_insts(ok, epoch, apply_mean=True))
        pipeline_stats().add("augment", time.perf_counter() - t0,
                             rows=len(ok))
        return ("final", epoch,
                [next(augmented) if isinstance(d, DataInst) else d
                 for d in decoded])

    # ------------------------------------------------------------------
    # consumer side
    def _fetch_chunk(self):
        """Up to ``chunk_size`` work items from the source, in epoch
        order: ``(mode, items)``, or None at the end."""
        if self._raw_source is not None:
            items = self._raw_source.next_raw_block(self.chunk_size)
            if len(items) < self.chunk_size:
                self._exhausted = True
            return ("pil" if self._pil_mode else "raw", items) if items \
                else None
        items = []
        src = self.aug.base
        while len(items) < self.chunk_size:
            if not src.next():
                self._exhausted = True
                break
            items.append(src.value())
        return ("inst", items) if items else None

    def _refill(self) -> None:
        while (not self._exhausted
               and self._seq_submit - self._seq_take < self.queue_depth):
            chunk = self._fetch_chunk()
            if chunk is None:
                break
            mode, items = chunk
            self._in_q.put((self._gen, self._seq_submit, self.aug.epoch,
                            mode, items))
            self._seq_submit += 1
        self._watchdog.beat()  # handing out work is progress too

    def _stall_diagnostic(self, dt: float) -> str:
        msg = self._watchdog.diagnostic(dt)
        frames = sys._current_frames()
        for t in self._threads:
            if not t.is_alive():
                msg += f"\nworker {t.name!r} is DEAD"
                continue
            frame = frames.get(t.ident)
            if frame is not None:
                msg += (f"\nworker {t.name!r} stack:\n"
                        + "".join(traceback.format_stack(frame)))
        return msg

    def _wait_result(self, seq: int):
        """Chunk ``seq``'s result, raising on a stalled pool."""
        wd = self._watchdog
        since = time.monotonic()
        with self._cond:
            while seq not in self._results:
                self._cond.wait(0.2)
                if wd.enabled:
                    dt = min(wd.stalled_for(), time.monotonic() - since)
                    if dt > wd.timeout_s:
                        obs_events.emit("watchdog.fire", what=wd.what,
                                        stalled_s=dt, timeout_s=wd.timeout_s)
                        raise WatchdogError(self._stall_diagnostic(dt))
            return self._results.pop(seq)

    def _reset_pool(self) -> None:
        """Forget the chunks of the old epoch, done or queued; credit
        back the retire tokens drained with them, then apply a pending
        resize."""
        with self._cond:
            self._gen += 1
            self._results.clear()
        drained_tokens = 0
        try:
            while True:
                if self._in_q.get_nowait() is None:
                    drained_tokens += 1
        except queue.Empty:
            pass
        if drained_tokens:
            with self._pool_lock:
                self._poison_pending = max(
                    0, self._poison_pending - drained_tokens)
        self._reconcile_pool()
        self._seq_submit = self._seq_take = 0
        self._exhausted = False
        self._pending, self._pending_pos = [], 0
        self._yielded = 0  # decoded records this epoch (epoch_cap)

    def before_first(self):
        if (not self._pool_started and self.num_workers > 1
                and self._init_done and not self._closed):
            # a request_workers() on a serial chain: the epoch boundary
            # is where the pool can take over the source's cursor
            self._start_pool()
        if self._pool_started:
            self._reset_pool()
        self.aug.before_first()
        if self._pool_started:
            self._watchdog.beat()

    def resume_epoch(self):
        self.aug.resume_epoch()

    def next(self) -> bool:
        if not self._pool_started:
            if not self.aug.next():
                return False
            self._out = self.aug.value()
            return True
        cap = getattr(self._raw_source, "epoch_cap", 0)
        while True:
            if cap and self._yielded >= cap:
                return False  # a worker shard's equal-steps cap
            if self._pending_pos < len(self._pending):
                item = self._pending[self._pending_pos]
                self._pending_pos += 1
                if isinstance(item, _BadRecord):
                    self._raw_source.record_bad(item.source, item.offset,
                                                item.exc)
                    continue
                self._out = item
                self._yielded += 1
                return True
            self._refill()
            if self._seq_take >= self._seq_submit:
                # drained: every worker failure has been recorded
                if self._raw_source is not None:
                    self._raw_source.note_epoch_end()
                return False
            result = self._wait_result(self._seq_take)
            self._seq_take += 1
            self._refill()  # a window slot freed: keep the workers busy
            if isinstance(result, _WorkerError):
                raise result.exc
            kind, chunk_epoch, records = result
            if kind == "tail":
                ok = [d for d in records if isinstance(d, DataInst)]
                t0 = time.perf_counter()
                done = iter(self.aug.augment_tail(ok, chunk_epoch))
                pipeline_stats().add("augment", time.perf_counter() - t0,
                                     rows=len(ok))
                records = [next(done) if isinstance(d, DataInst) else d
                           for d in records]
            self._pending, self._pending_pos = records, 0

    def value(self) -> DataInst:
        if self._out is None:
            raise RuntimeError(
                "ParallelAugmentIterator: value() before next()")
        return self._out

    def close(self) -> None:
        """Stop and join the workers, then close the chain below."""
        if self._closed:
            return
        self._closed = True
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        with self._pool_lock:
            threads = list(self._threads)
        for _ in threads:
            self._in_q.put(None)
        for t in threads:
            t.join(timeout=2.0)
        self._threads = []
        self.aug.close()
