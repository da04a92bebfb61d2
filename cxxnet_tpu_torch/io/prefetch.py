"""Threaded batch prefetch (``iter = threadbuffer``).

The port's copy of ``cxxnet_tpu/io/prefetch.py``: a producer thread
pulls batches from the wrapped iterator into a bounded queue, so
host-side batch assembly overlaps the device's step.  The producer
visits the ``prefetch.producer`` fault site before each batch.

Epoch restarts use a generation counter: ``before_first`` bumps it, the
producer restarts the wrapped iterator when it sees a new generation,
and the consumer discards queue entries of stale generations.  An
exception in the wrapped iterator is relayed to the consumer's
``next()``; a producer stuck inside the wrapped iterator trips the
:class:`~cxxnet_tpu_torch.utils.faults.Watchdog` after
``watchdog_timeout_s`` (default 600, 0 disables).  ``close()`` stops and
joins the producer.

A key of ``DEFERRED_KEYS`` (io/data.py) is not passed down when it is
set: it travels with the next rewind's generation, and the producer
hands it to the wrapped chain just before that generation's
``before_first()``.  A rewind on the producer's thread can thus never
race it: round r draws the augmentation epoch the CLI anchored, as the
plain chain does.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ..utils import faults
from ..utils.faults import Watchdog, WatchdogError
from .data import DEFERRED_KEYS, DataBatch, DataIter

_END = object()


class _ProducerError:
    """Queue wrapper for an exception raised inside the producer thread."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class ThreadBufferIterator(DataIter):
    def supports_dist_shard(self) -> bool:
        return self.base.supports_dist_shard()

    def __init__(self, base: DataIter) -> None:
        self.base = base
        self.buffer_size = 2
        self.silent = 0
        self.watchdog_timeout_s = 600.0
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[Watchdog] = None
        self._cur: Optional[DataBatch] = None
        self._gen = 0                      # consumer's current epoch
        self._gen_lock = threading.Condition()
        self._stop = False
        self._closed = False
        self._deferred = {}   # DEFERRED_KEYS set since the last rewind
        self._by_gen = {}     # generation -> the keys it passes down

    def set_param(self, name, val):
        if name in DEFERRED_KEYS:
            self._deferred[name] = val
            return
        self.base.set_param(name, val)
        if name == "buffer_size":
            self.buffer_size = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "watchdog_timeout_s":
            self.watchdog_timeout_s = float(val)

    def init(self):
        self.base.init()
        self._q = queue.Queue(maxsize=self.buffer_size)
        self._gen = 0
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="threadbuffer")
        self._watchdog = Watchdog(what="prefetch producer",
                                  timeout_s=self.watchdog_timeout_s,
                                  thread=self._thread)
        self._thread.start()
        if not self.silent:
            print(f"ThreadBufferIterator: buffer_size={self.buffer_size}")

    # ------------------------------------------------------------------
    def _producer(self):
        # production starts at the consumer's first before_first()
        # (generation 1): producing generation 0 eagerly would race it
        served = 0  # last generation fully produced
        wd = self._watchdog
        while True:
            with self._gen_lock:
                while not self._stop and self._gen <= served:
                    wd.beat()  # idle-waiting for a rewind is progress
                    self._gen_lock.wait(timeout=0.5)
                if self._stop:
                    return
                gen = self._gen
                deferred = self._by_gen.pop(gen, {})
                self._by_gen = {g: d for g, d in self._by_gen.items()
                                if g > gen}
            try:
                for name, val in deferred.items():
                    self.base.set_param(name, val)
                self.base.before_first()
                while True:
                    with self._gen_lock:
                        if self._stop:
                            return
                        if self._gen != gen:
                            break  # consumer rewound; restart epoch
                    wd.beat()
                    faults.fault_point("prefetch.producer")
                    if not self.base.next():
                        self._put((gen, _END))
                        break
                    self._put((gen, self.base.value()))
                    wd.beat()
            except Exception as e:  # noqa: BLE001 - relayed to consumer
                self._put((gen, _ProducerError(e)))
                self._put((gen, _END))
            served = gen

    def _put(self, item) -> None:
        # bounded put that gives up if the consumer rewound or stopped
        gen = item[0]
        while True:
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                with self._gen_lock:
                    if self._stop or self._gen != gen:
                        return

    # ------------------------------------------------------------------
    def before_first(self):
        if self._q is None:
            raise RuntimeError("ThreadBufferIterator: init() not called")
        with self._gen_lock:
            self._gen += 1
            if self._deferred:
                self._by_gen[self._gen] = self._deferred
                self._deferred = {}
            self._gen_lock.notify_all()

    def next(self) -> bool:
        if self._q is None:
            raise RuntimeError("ThreadBufferIterator: init() not called")
        while True:
            try:
                gen, item = self._q.get(timeout=0.2)
            except queue.Empty:
                t = self._thread
                if t is not None and not t.is_alive() and self._q.empty():
                    raise WatchdogError(
                        "prefetch producer thread died without delivering "
                        "a result; the input pipeline cannot continue"
                    ) from None
                self._watchdog.check()  # raises on a hung producer
                continue
            if gen != self._gen:
                continue  # stale epoch
            if item is _END:
                return False
            if isinstance(item, _ProducerError):
                raise item.exc
            self._cur = item
            return True

    def value(self) -> DataBatch:
        if self._cur is None:
            raise RuntimeError("ThreadBufferIterator: value() before next()")
        return self._cur

    def close(self):
        """Stop and join the producer, then close the wrapped iterator.
        Draining the queue unblocks a producer waiting in ``put``."""
        if self._closed:
            return
        self._closed = True
        with self._gen_lock:
            self._stop = True
            self._gen_lock.notify_all()
        thread, self._thread = self._thread, None
        if self._q is not None:
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        self.base.close()
