"""Dynamic micro-batching with backpressure.

The port's copy of ``cxxnet_tpu/serve/batcher.py``, unchanged in
behaviour.  One worker thread runs every batch, so every kernel of a
forward launches on that thread's current CUDA stream.

The serving analog of the training side's ``scan_steps`` insight
(doc/performance.md): per-dispatch host cost dominates small programs,
so work must be coalesced before it reaches the device.  Training can
stage a fixed K ahead of time; serving cannot — requests arrive when
they arrive — so the batcher coalesces *dynamically*: the worker picks
the oldest request, then holds the batch open for at most
``batch_timeout_ms`` while compatible requests (same kind / node / row
shape / dtype) join, up to ``max_batch_size`` rows, and executes them
as ONE forward call.  Results are split back per request.

Backpressure is explicit rather than emergent (TensorFlow's production
lesson, arXiv:1605.08695: unbounded queues turn overload into latency
collapse):

* the queue is bounded (``queue_limit`` requests) — a full queue sheds
  the new request immediately with :class:`OverloadError` (HTTP 429),
  keeping queueing delay bounded for the requests already admitted;
* each request may carry a deadline — requests whose deadline passes
  while still queued are expired with :class:`DeadlineError` instead of
  wasting device time on an answer nobody is waiting for (the deadline
  is checked at dequeue time; a request that starts executing runs to
  completion).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils.faults import Watchdog

__all__ = [
    "ServeError", "OverloadError", "DeadlineError", "ClosedError",
    "MicroBatcher",
]


class ServeError(RuntimeError):
    """Base class for serving-path failures; carries an HTTP status."""

    http_status = 500


class OverloadError(ServeError):
    """Load shed: the request queue is full."""

    http_status = 429


class DeadlineError(ServeError):
    """The request's deadline passed before execution started."""

    http_status = 504


class ClosedError(ServeError):
    """The engine is shutting down."""

    http_status = 503


@dataclasses.dataclass
class _Request:
    kind: str                      # "out" | "extract"
    node: Optional[str]            # feature node name for extract
    data: np.ndarray               # (n, ...) rows
    enqueue_t: float
    deadline_t: Optional[float]    # absolute monotonic deadline, or None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None

    def group_key(self) -> Tuple:
        return (self.kind, self.node, self.data.shape[1:],
                str(self.data.dtype))

    def resolve(self, result=None, error=None) -> None:
        self.result, self.error = result, error
        self.done.set()


class MicroBatcher:
    """Coalesces concurrent requests into bucket-sized device calls.

    ``runner(kind, node, data)`` executes one coalesced batch (the
    engine binds this to its bucket cache) and returns the result rows
    aligned with ``data``.  One worker thread owns all execution, so
    forward calls are naturally serialized.
    """

    def __init__(
        self,
        runner: Callable[[str, Optional[str], np.ndarray], np.ndarray],
        max_batch_size: int = 64,
        batch_timeout_ms: float = 2.0,
        queue_limit: int = 128,
        stats=None,
        watchdog_timeout_s: float = 600.0,
    ) -> None:
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._runner = runner
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout = max(0.0, float(batch_timeout_ms)) / 1e3
        self.queue_limit = int(queue_limit)
        self._stats = stats
        self._queue: List[_Request] = []
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        if stats is not None:
            stats.bind_queue_depth(self.pending_count)
        # batch-assembly staging buffers, one per (row shape, dtype):
        # coalesced requests are sliced into a preallocated buffer
        # instead of np.concatenate allocating a fresh batch array per
        # dispatch.  Owned exclusively by the worker thread; reuse
        # across batches is safe because the runner (the engine's
        # bucket cache) copies the result to the host before returning, so the
        # device has consumed the rows before the next batch assembles.
        self._staging: dict = {}
        self._worker = threading.Thread(
            target=self._loop, name="cxxnet-serve-batcher", daemon=True
        )
        # a worker hung inside the runner (device stall, injected hang)
        # would otherwise leave every submitter blocked forever; the
        # watchdog turns that into a fail-fast WatchdogError carrying
        # the worker's stack.  0 disables.  The timeout is generous by
        # default because the first batch of a cold bucket legitimately
        # sits behind the kernel build and cuDNN's first-call setup.
        self.watchdog = Watchdog(
            what="serve batcher worker",
            timeout_s=watchdog_timeout_s,
            thread=self._worker,
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # live knobs (the tuner's setters): the worker reads both at the top
    # of every coalesced batch, so a change applies from the next batch
    def set_max_batch_size(self, n: int) -> int:
        """Set the coalescing limit.  The batch in progress finishes
        under the old limit; a request larger than the new limit still
        runs alone (the oldest request is always taken)."""
        self.max_batch_size = max(1, int(n))
        return self.max_batch_size

    def set_batch_timeout_ms(self, ms: float) -> float:
        """Set the batch-open window (from the next batch on)."""
        self.batch_timeout = max(0.0, float(ms)) / 1e3
        return self.batch_timeout * 1e3

    def pending_count(self) -> int:
        with self._lock:
            return len(self._queue)

    def submit(
        self,
        data: np.ndarray,
        kind: str = "out",
        node: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ) -> np.ndarray:
        """Enqueue ``data`` and block until its rows come back.

        Raises :class:`OverloadError` immediately when the queue is
        full, :class:`DeadlineError` when the deadline expired before
        execution, :class:`ClosedError` on shutdown; any exception the
        model raised is re-raised here."""
        now = time.monotonic()
        req = _Request(
            kind=kind, node=node, data=data, enqueue_t=now,
            deadline_t=(now + deadline_ms / 1e3)
            if deadline_ms and deadline_ms > 0 else None,
        )
        with self._nonempty:
            if self._closed:
                raise ClosedError("serving engine is shut down")
            if len(self._queue) >= self.queue_limit:
                raise OverloadError(
                    f"request queue full ({self.queue_limit} pending); "
                    "load shed — retry with backoff"
                )
            self._queue.append(req)
            self._nonempty.notify()
        # stall window anchored at THIS request's enqueue: an idle-
        # before-this worker isn't mistaken for hung, and (critically)
        # submitters never touch the worker's beat clock — steady
        # traffic must not mask a genuinely hung worker
        self.watchdog.wait(req.done, since=req.enqueue_t)
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        """Pop the oldest request plus every compatible one that arrives
        within the batch window, dropping expired requests as seen."""
        with self._nonempty:
            while not self._queue and not self._closed:
                self._nonempty.wait()
            if not self._queue:
                return []
            first = self._queue.pop(0)
        if (first.deadline_t is not None
                and time.monotonic() > first.deadline_t):
            first.resolve(error=DeadlineError(
                "deadline expired while queued"
            ))
            return []
        batch = [first]
        key = first.group_key()
        rows = first.data.shape[0]
        # the live knobs, read once a batch: a concurrent change applies
        # whole at the next batch
        limit = self.max_batch_size
        window_end = time.monotonic() + self.batch_timeout
        while rows < limit:
            with self._nonempty:
                # sweep the queue for compatible, unexpired requests
                i = 0
                while i < len(self._queue) and rows < limit:
                    r = self._queue[i]
                    if (r.deadline_t is not None
                            and time.monotonic() > r.deadline_t):
                        self._queue.pop(i)
                        r.resolve(error=DeadlineError(
                            "deadline expired while queued"
                        ))
                        continue
                    if (r.group_key() == key
                            and rows + r.data.shape[0] <= limit):
                        self._queue.pop(i)
                        batch.append(r)
                        rows += r.data.shape[0]
                        continue
                    i += 1
                if rows >= limit or self._closed:
                    break
                remain = window_end - time.monotonic()
                if remain <= 0:
                    break
                self._nonempty.wait(timeout=remain)
        return batch

    def _assemble(self, batch: List[_Request]) -> np.ndarray:
        """Copy each request's rows into the per-shape staging buffer
        (worker-thread only).  A single-request batch never reaches
        here — it passes its array through untouched."""
        first = batch[0].data
        rows = sum(r.data.shape[0] for r in batch)
        key = (first.shape[1:], first.dtype.str)
        buf = self._staging.get(key)
        if buf is None or buf.shape[0] < rows:
            cap = max(rows, self.max_batch_size)
            buf = np.empty((cap,) + first.shape[1:], dtype=first.dtype)
            self._staging[key] = buf
        ofs = 0
        for r in batch:
            n = r.data.shape[0]
            buf[ofs:ofs + n] = r.data
            ofs += n
        return buf[:rows]

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._closed and not self._queue:
                    return
            batch = self._take_batch()
            if not batch:
                continue
            self.watchdog.beat()
            try:
                data = (batch[0].data if len(batch) == 1
                        else self._assemble(batch))
                out = self._runner(batch[0].kind, batch[0].node, data)
            except BaseException as e:  # noqa: BLE001 - relayed per request
                for r in batch:
                    r.resolve(error=e)
                continue
            finally:
                self.watchdog.beat()
            ofs = 0
            for r in batch:
                n = r.data.shape[0]
                r.resolve(result=out[ofs:ofs + n])
                ofs += n

    # ------------------------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, fail pending requests, join the worker."""
        with self._nonempty:
            self._closed = True
            pending, self._queue = self._queue, []
            self._nonempty.notify_all()
        for r in pending:
            r.resolve(error=ClosedError("serving engine is shut down"))
        self._worker.join(timeout=timeout)
