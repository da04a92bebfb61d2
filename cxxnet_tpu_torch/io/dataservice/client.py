"""``iter = service``: the data-service client iterator.

Slots into the ordered chain factory as a base iterator — any trainer,
tenant loop, or eval conf becomes service-fed by replacing its local
decode chain with::

    data = train
    iter = service
    data_service_addr = 127.0.0.1:9040
    iter = end

The stream is addressed, not positional: the client's durable cursor is
``(epoch, local block k)``, advanced only when block ``k`` has been
delivered to the consumer.  An RPC worker thread keeps up to
``data_service_window`` GETs pipelined on one TCP session and feeds a
bounded queue (the ``threadbuffer`` discipline: generation counter for
rewinds, producer errors relayed into the consumer's ``next()``, a
:class:`~cxxnet_tpu_torch.utils.faults.Watchdog` so a wedged server fails
fast instead of hanging the train loop).  Every RPC passes the
``dataservice.rpc`` fault site.

Recovery: any transport error — including a server SIGKILL mid-epoch —
drops the connection, reconnects with bounded retries, re-OPENs, and
re-requests from the cursor; because the server deals a deterministic
addressed stream, the resumed bytes are identical to the uninterrupted
ones (``chip_smoke.py``'s phase 25c holds this end to end with
checkpoint CRCs).  The OPENED fingerprint is pinned at the first handshake: a
reconnect landing on a server with different data fails loudly instead
of silently splicing two datasets into one run.

Epoch anchoring: the port's CLI sets ``augment_epoch_next = N`` before
each round's ``before_first()`` (``threadbuffer`` hands it down with
that rewind), which keys the round's GETs by epoch N; the JAX package's
``before_first()`` + ``set_param("augment_epoch", N)`` pins it too.
Plain ``for batch in it`` loops advance epochs 0, 1, 2, ... on their
own.  The port's copy of ``cxxnet_tpu/io/dataservice/client.py``.
"""

from __future__ import annotations

import collections
import queue
import socket
import threading
import time
from typing import Deque, Optional

from ...obs.registry import registry as obs_registry
from ...utils import faults
from ...utils.faults import Watchdog, WatchdogError
from ..augment import ANCHOR_KEY
from ..data import DataBatch, DataIter
from . import wire

__all__ = ["ServiceIterator"]

_END = object()


class _WorkerError:
    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class ServiceIterator(DataIter):
    """Client end of the data service (``iter = service``)."""

    def __init__(self) -> None:
        self.addr = ""
        self.batch_size = 0
        self.rank = 0
        self.nworker = 1
        self.silent = 0
        self.window = 2
        self.retries = 60
        self.retry_delay_s = 0.5
        self.connect_timeout_s = 5.0
        self.watchdog_timeout_s = 600.0
        self._epoch = -1
        self._pin = False            # augment_epoch pinned for next pass
        self._anchor: Optional[int] = None  # augment_epoch_next
        self._started = False
        self._gen = 0
        self._gen_lock = threading.Condition()
        self._stop = False
        self._closed = False
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[Watchdog] = None
        self._cur: Optional[DataBatch] = None
        self._conn: Optional[socket.socket] = None
        self._conn_lock = threading.Lock()
        self._fingerprint: Optional[str] = None
        self.reconnects = 0
        self._m_reconnects = None
        self._m_stall = None

    def supports_dist_shard(self) -> bool:
        return True

    def set_param(self, name: str, val: str) -> None:
        if name == "data_service_addr":
            self.addr = val
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "dist_worker_rank":
            self.rank = int(val)
        elif name == "dist_num_worker":
            self.nworker = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "data_service_window":
            self.window = max(1, int(val))
        elif name == "data_service_retries":
            self.retries = int(val)
        elif name == "data_service_retry_delay_s":
            self.retry_delay_s = float(val)
        elif name == "data_service_connect_timeout_s":
            self.connect_timeout_s = float(val)
        elif name in ("data_service_timeout_s", "watchdog_timeout_s"):
            self.watchdog_timeout_s = float(val)
        elif name == ANCHOR_KEY:
            with self._gen_lock:
                self._anchor = int(val)
        elif name == "augment_epoch":
            e = int(val)
            with self._gen_lock:
                if e != self._epoch:
                    self._epoch = e
                    if self._started:
                        # the live pass was keyed by the wrong epoch:
                        # restart the generation on the corrected one
                        self._gen += 1
                        self._gen_lock.notify_all()
                self._pin = True

    def init(self) -> None:
        if not self.addr or ":" not in self.addr:
            raise ValueError(
                "iter=service needs data_service_addr = host:port")
        if self.batch_size <= 0:
            raise ValueError("iter=service needs batch_size")
        host, port = self.addr.rsplit(":", 1)
        self._host, self._port = host, int(port)
        reg = obs_registry()
        self._m_reconnects = reg.counter(
            "dataservice_reconnects_total",
            "Client reconnect+resume cycles against the data service.")
        self._m_stall = reg.histogram(
            "dataservice_client_stall_seconds",
            "Consumer time blocked waiting for the service stream.")
        self._q = queue.Queue(maxsize=self.window)
        self._thread = threading.Thread(
            target=self._worker, name="dataservice-client", daemon=True)
        self._watchdog = Watchdog(
            what="data service client",
            timeout_s=self.watchdog_timeout_s,
            thread=self._thread,
        )
        self._thread.start()
        if not self.silent:
            print(f"ServiceIterator: {self.addr} window={self.window} "
                  f"rank={self.rank}/{self.nworker}", flush=True)

    # ------------------------------------------------------------------
    # connection management (worker thread only, except close())
    def _ensure_conn(self) -> socket.socket:
        with self._conn_lock:
            if self._conn is not None:
                return self._conn
        sock = socket.create_connection(
            (self._host, self._port), timeout=self.connect_timeout_s)
        try:
            sock.settimeout(None)
            wire.write_frame(sock, wire.encode_open(
                self.batch_size, self.rank, self.nworker, self.window))
            body = wire.read_frame(sock)
            if body is None:
                raise ConnectionError("server closed during OPEN")
            kind, payload = wire.decode_kind(body)
            if kind == wire.ERR:
                doc = wire.decode_json(payload)
                raise wire.ServiceError(doc.get("reason", "internal"),
                                        doc.get("detail", ""))
            if kind != wire.OPENED:
                raise wire.WireError(
                    "bad_kind", f"expected OPENED, got kind {kind}")
            doc = wire.decode_json(payload)
            fp = str(doc.get("fingerprint", ""))
            if self._fingerprint is None:
                self._fingerprint = fp
            elif fp != self._fingerprint:
                raise RuntimeError(
                    "data_service: dataset fingerprint changed across "
                    f"reconnect ({self._fingerprint} -> {fp}); refusing "
                    "to splice two datasets into one deterministic run")
        except BaseException:
            sock.close()
            raise
        with self._conn_lock:
            self._conn = sock
        return sock

    def _drop_conn(self) -> None:
        with self._conn_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------------
    # worker
    def _stale(self, gen: int) -> bool:
        with self._gen_lock:
            return self._stop or self._gen != gen

    def _put(self, item) -> bool:
        gen = item[0]
        while True:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if self._stale(gen):
                    return False

    def _worker(self) -> None:
        served = 0
        wd = self._watchdog
        try:
            while True:
                with self._gen_lock:
                    while not self._stop and self._gen <= served:
                        wd.beat()  # idling for a rewind is progress
                        self._gen_lock.wait(timeout=0.5)
                    if self._stop:
                        return
                    gen, epoch = self._gen, self._epoch
                # a fresh generation must not receive frames pipelined
                # for the previous one: start from a clean session
                self._drop_conn()
                try:
                    self._serve_gen(gen, epoch)
                except Exception as e:  # noqa: BLE001 - relayed
                    self._put((gen, _WorkerError(e)))
                    self._put((gen, _END))
                    self._drop_conn()
                served = gen
        finally:
            with self._conn_lock:
                conn, self._conn = self._conn, None
            if conn is not None:
                try:
                    wire.write_frame(conn, wire.encode_close())
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass

    def _serve_gen(self, gen: int, epoch: int) -> None:
        wd = self._watchdog
        k_done = 0                 # durable cursor: blocks delivered
        k_send = 0
        outstanding: Deque[int] = collections.deque()
        got_eoe = False
        attempts = 0
        while True:
            if self._stale(gen):
                self._drop_conn()
                return
            try:
                # every wire interaction passes the chaos site: an
                # injected ioerror exercises the same reconnect+resume
                # path a SIGKILLed server does
                faults.fault_point("dataservice.rpc")
                conn = self._ensure_conn()
                while not got_eoe and len(outstanding) < self.window:
                    wire.write_frame(conn, wire.encode_get(epoch, k_send))
                    outstanding.append(k_send)
                    k_send += 1
                if not outstanding:
                    self._put((gen, _END))
                    return
                body = wire.read_frame(conn)
                if body is None:
                    raise ConnectionError("server closed the stream")
                kind, payload = wire.decode_kind(body)
                expect = outstanding[0]
                if kind == wire.BATCH:
                    ep, blk, _hit, data, label, inst, padd = \
                        wire.decode_batch(payload)
                    if ep != epoch or blk != expect:
                        raise ConnectionError(
                            f"stream desync: got ({ep},{blk}), "
                            f"want ({epoch},{expect})")
                    outstanding.popleft()
                    wd.beat()
                    if not self._put((gen, DataBatch(
                            data=data, label=label, inst_index=inst,
                            num_batch_padd=padd))):
                        self._drop_conn()
                        return  # consumer rewound or stopped
                    k_done += 1
                    attempts = 0
                    wd.beat()
                elif kind == wire.EOE:
                    ep, _nblocks = wire.decode_eoe(payload)
                    if ep != epoch:
                        raise ConnectionError(
                            f"stream desync: EOE for epoch {ep}, "
                            f"want {epoch}")
                    outstanding.popleft()
                    got_eoe = True
                    wd.beat()
                elif kind == wire.ERR:
                    doc = wire.decode_json(payload)
                    raise wire.ServiceError(
                        doc.get("reason", "internal"),
                        doc.get("detail", ""))
                else:
                    raise wire.WireError(
                        "bad_kind",
                        f"unexpected kind {kind} inside a session")
            except wire.ServiceError as e:
                if e.reason != "overloaded":
                    raise
                # 429-style shed: back off and retry the admission
                self._recover(gen, epoch)
                attempts += 1
                if attempts > self.retries:
                    raise
                outstanding.clear()
                k_send = k_done
                got_eoe = False
                time.sleep(self.retry_delay_s)
            except OSError as e:
                # transport loss (incl. injected faults and a killed
                # server): reconnect and resume from the durable cursor
                attempts += 1
                if attempts > self.retries:
                    raise ConnectionError(
                        f"data_service at {self.addr} unreachable after "
                        f"{self.retries} reconnect attempts: "
                        f"{type(e).__name__}: {e}") from e
                self._recover(gen, epoch)
                outstanding.clear()
                k_send = k_done
                got_eoe = False
                time.sleep(self.retry_delay_s)

    def _recover(self, gen: int, epoch: int) -> None:
        self._drop_conn()
        self.reconnects += 1
        if self._m_reconnects is not None:
            self._m_reconnects.inc()
        if not self.silent:
            print(f"ServiceIterator: connection lost, resuming "
                  f"epoch {epoch} (reconnect #{self.reconnects})",
                  flush=True)

    # ------------------------------------------------------------------
    # consumer protocol
    def before_first(self) -> None:
        assert self._q is not None, "init() not called"
        with self._gen_lock:
            if self._anchor is not None:
                self._epoch, self._anchor = self._anchor, None
                self._pin = False
            elif self._pin:
                self._pin = False
            else:
                self._epoch += 1
            self._started = True
            self._gen += 1
            self._gen_lock.notify_all()

    def next(self) -> bool:
        assert self._q is not None, "init() not called"
        wd = self._watchdog
        t0 = time.monotonic()
        try:
            while True:
                try:
                    gen, item = self._q.get(timeout=0.2)
                except queue.Empty:
                    t = self._thread
                    if (t is not None and not t.is_alive()
                            and self._q.empty()):
                        raise WatchdogError(
                            "data service client worker died without "
                            "delivering a result") from None
                    if wd is not None:
                        wd.check()
                    continue
                if gen != self._gen:
                    continue  # stale generation
                if item is _END:
                    return False
                if isinstance(item, _WorkerError):
                    raise item.exc
                self._cur = item
                return True
        finally:
            if self._m_stall is not None:
                self._m_stall.observe(time.monotonic() - t0)

    def value(self) -> DataBatch:
        assert self._cur is not None
        return self._cur

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._gen_lock:
            self._stop = True
            self._gen_lock.notify_all()
        # unblock a worker parked in recv: shut the socket down under
        # it (the worker owns the close)
        with self._conn_lock:
            if self._conn is not None:
                try:
                    self._conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        thread, self._thread = self._thread, None
        if self._q is not None:
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    def __del__(self):  # pragma: no cover - GC-order dependent
        try:
            self.close()
        except Exception:
            pass
