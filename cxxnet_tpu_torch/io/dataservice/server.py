"""Data-service server: a shared decode/augment fleet member.

The port's copy of ``cxxnet_tpu/io/dataservice/server.py``; it deals
the port's own ``create_iterator`` chain.

``task=data_service`` hosts the conf's ``data`` section iterator chain
(the SAME ``create_iterator`` chain a local trainer would build) behind
the ``CXD1`` protocol, so N trainers/tenants/eval jobs on one pool
decode each block once instead of N times (the disaggregated input
pipeline of the TensorFlow-systems design, arXiv 1605.08695 — and the
off-accelerator-host placement 1901.05803 argues for).

Determinism contract: the stream is addressed, not positional.  A GET
names ``(epoch, local block k)``; the server maps it to global block
``j = k * nworker + rank`` of the epoch's stream and produces it by
rewinding its chain (``before_first`` + ``augment_epoch``) and stepping
forward — legal because the chains are epoch-keyed and history-free
(one-shot shuffle at ``init``; pure-hash augmentation draws keyed by
``(epoch, record index)``, ``io/augment.py``).  Two consequences the tests pin
down: a client that reconnects after a server SIGKILL re-requests its
cursor and receives byte-identical rows, and the global stream dealt
across ``nworker`` clients is exactly the ``dist_shard = block`` deal a
local multi-process run performs — so service-fed training is bitwise
equal (checkpoint CRCs) to local-pipeline training.

An epoch's local length is ``epoch_len // nworker`` for every rank
(floor), matching ``shard_rows``'s equal-length contract; a GET at or
past it answers EOE.

Admission: at most ``max_sessions`` concurrent sessions — the
``max_sessions + 1``-th OPEN is shed with an ``overloaded`` ERR (the
429 analog of the serving plane); per-session pipelining is bounded by
the OPENED-clamped window.  Decoded blocks land in a byte-bounded LRU
(:mod:`.cache`) keyed ``(dataset_fingerprint, epoch, global block)``;
the fingerprint covers the section entries AND the referenced files'
sizes, so a dataset swap under a running server changes the key space
instead of serving stale rows.

Observability: ``dataservice_sessions``, ``dataservice_batches_total
{hit}``, ``dataservice_cache_bytes``, ``dataservice_shed_total``,
``dataservice_produce_seconds``, ``dataservice_queue_wait_seconds``;
an HTTP sidecar serves ``/healthz``, ``/statsz`` and ``/metricsz``.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ...config import cfg_get
from ...obs import events as obs_events
from ...obs.registry import registry as obs_registry
from ..augment import ANCHOR_KEY
from ..data import ConfigEntry, create_iterator
from . import wire
from .cache import CachedBlock, ChunkCache

__all__ = ["dataset_fingerprint", "BatchPlant", "DataServiceServer"]


def dataset_fingerprint(entries) -> str:
    """Identity of the dataset+chain config this server deals.

    crc32 over the ordered section entries plus the byte size of every
    entry value that is an existing file — enough to distinguish "same
    conf, different files" (regenerated data) from the stream a client
    checkpointed against, cheap enough to compute at every OPEN."""
    h = 0
    for name, val in entries:
        h = zlib.crc32(f"{name}={val}\n".encode("utf-8"), h)
        if val and os.path.isfile(val):
            h = zlib.crc32(
                f"{name}:{os.path.getsize(val)}\n".encode("utf-8"), h)
    return f"{h & 0xFFFFFFFF:08x}"


class _Session:
    __slots__ = ("sid", "rank", "nworker", "window", "epoch", "block",
                 "batches", "peer")

    def __init__(self, sid: int, rank: int, nworker: int, window: int,
                 peer: str) -> None:
        self.sid = sid
        self.rank = rank
        self.nworker = nworker
        self.window = window
        self.peer = peer
        self.epoch = -1   # last cursor served
        self.block = -1
        self.batches = 0


class BatchPlant:
    """The server's single decode/augment chain plus the block cache.

    One chain, one lock: block production is serialized (the chain is a
    stateful single-threaded object), cache hits bypass the lock
    entirely — that is where the multi-tenant concurrency comes from.
    """

    def __init__(self, section_entries: List[ConfigEntry],
                 global_entries: List[ConfigEntry],
                 cache_bytes: int, silent: bool = False) -> None:
        self.section_entries = list(section_entries)
        self.global_entries = list(global_entries)
        self.silent = silent
        self.fingerprint = dataset_fingerprint(self.section_entries)
        bs = cfg_get(self.global_entries + self.section_entries,
                     "batch_size")
        if bs is None:
            raise ValueError("data_service: the conf must set batch_size "
                             "(the block size the stream is dealt in)")
        self.batch_size = int(bs)
        self.cache = ChunkCache(cache_bytes)
        self._lock = threading.Lock()
        self._chain = None
        self._epoch = -1          # epoch the chain is positioned in
        self._pos = 0             # next global block the chain produces
        self._lens: Dict[int, int] = {}   # epoch -> global block count
        self.blocks_produced = 0
        reg = obs_registry()
        self._m_batches = reg.counter(
            "dataservice_batches_total",
            "Blocks served by the data service.", labelnames=("hit",))
        reg.gauge(
            "dataservice_cache_bytes",
            "Decoded bytes held by the data-service chunk cache.",
        ).set_function(lambda: float(self.cache.bytes))
        self._m_produce = reg.histogram(
            "dataservice_produce_seconds",
            "Wall time decoding+augmenting one block on a cache miss.")
        self._m_wait = reg.histogram(
            "dataservice_queue_wait_seconds",
            "Time a request waited for the plant chain on a cache miss.")

    def init(self) -> None:
        """Build and init the chain exactly as a local trainer would:
        section entries at construction, global entries via set_param,
        then ``init()`` (mirrors ``cli._create_iterators``)."""
        self._chain = create_iterator(self.section_entries)
        for n, v in self.global_entries:
            self._chain.set_param(n, v)
        self._chain.init()

    def close(self) -> None:
        if self._chain is not None:
            self._chain.close()
            self._chain = None

    # ------------------------------------------------------------------
    def _rewind(self, epoch: int) -> None:
        # the anchor then before_first() — the per-round sequence the
        # port's CLI train loop issues (threadbuffer hands the anchor to
        # its producer with the rewind), so the chain's epoch-keyed
        # state matches a local run of epoch N whatever this chain
        # served before
        self._chain.set_param(ANCHOR_KEY, str(epoch))
        self._chain.before_first()
        self._epoch = epoch
        self._pos = 0

    def _produce_up_to(self, epoch: int, j: int) -> Optional[CachedBlock]:
        """Step the chain to global block ``j`` of ``epoch``, caching
        every block on the way; None when the epoch ends first (the
        epoch's length is recorded as a side effect)."""
        if self._chain is None:
            raise RuntimeError("BatchPlant.init() not called")
        if epoch != self._epoch or j < self._pos:
            self._rewind(epoch)
        out: Optional[CachedBlock] = None
        while self._pos <= j:
            if not self._chain.next():
                self._lens[epoch] = self._pos
                return None
            b = self._chain.value()
            blk = CachedBlock(b.data, b.label, b.inst_index,
                              b.num_batch_padd)
            self.cache.put((self.fingerprint, epoch, self._pos), blk)
            self.blocks_produced += 1
            self._pos += 1
            out = blk
        return out

    def deal(self, epoch: int, k: int, rank: int,
             nworker: int) -> Tuple[str, object, bool]:
        """Serve local block ``k`` of ``epoch`` for ``(rank, nworker)``.

        Returns ``("batch", CachedBlock, cache_hit)`` or
        ``("eoe", local_block_count, False)``."""
        L = self._lens.get(epoch)
        if L is not None and k >= L // nworker:
            return "eoe", L // nworker, False
        j = k * nworker + rank
        key = (self.fingerprint, epoch, j)
        blk = self.cache.get(key, record=False)
        if blk is not None:
            self.cache.note_hit()
            self._m_batches.labels(hit="hit").inc()
            return "batch", blk, True
        t0 = time.monotonic()
        with self._lock:
            self._m_wait.observe(time.monotonic() - t0)
            # a concurrent producer may have filled the block while we
            # waited for the chain
            blk = self.cache.get(key, record=False)
            if blk is not None:
                self.cache.note_hit()
                self._m_batches.labels(hit="hit").inc()
                return "batch", blk, True
            t1 = time.monotonic()
            blk = self._produce_up_to(epoch, j)
            self._m_produce.observe(time.monotonic() - t1)
            if blk is None:
                L = self._lens[epoch]
                return "eoe", L // nworker, False
            self.cache.note_miss()
        self._m_batches.labels(hit="miss").inc()
        return "batch", blk, False

    def stats(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "batch_size": self.batch_size,
            "blocks_produced": self.blocks_produced,
            "epoch_lens": dict(self._lens),
            "cache": self.cache.stats(),
        }


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # close() force-drops live session sockets itself (the SIGKILL
    # analog tests rely on); joining handler threads here would
    # deadlock against a still-connected client
    block_on_close = False


class DataServiceServer:
    """One data-service process: TCP batch plane + HTTP health plane.

    Tests drive it in-process via :meth:`start` / :meth:`close`; the
    CLI task blocks in :meth:`serve_forever` and stops it from a signal
    handler via :meth:`shutdown`."""

    def __init__(self, section_entries, global_entries, host="127.0.0.1",
                 port: int = 0, http_port: int = 0, max_sessions: int = 64,
                 cache_bytes: int = 256 << 20, window: int = 4,
                 ready_file: str = "", silent: bool = False) -> None:
        self.plant = BatchPlant(section_entries, global_entries,
                                cache_bytes, silent=silent)
        self.host = host
        self.port = port
        self.http_port = http_port
        self.max_sessions = int(max_sessions)
        self.window = int(window)
        self.ready_file = ready_file
        self.silent = silent
        self._sessions: Dict[int, _Session] = {}
        self._conns: set = set()   # live session sockets, for close()
        self._next_sid = 1
        self._lock = threading.Lock()
        self._tcp: Optional[_TCPServer] = None
        self._http: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()
        self._closed = False
        reg = obs_registry()
        self._m_sessions = reg.gauge(
            "dataservice_sessions",
            "Live data-service client sessions.")
        self._m_shed = reg.counter(
            "dataservice_shed_total",
            "Data-service admission refusals.", labelnames=("reason",))

    # ------------------------------------------------------------------
    # session plumbing
    def _admit(self, doc: dict, peer: str):
        try:
            bs = int(doc["batch_size"])
            rank = int(doc.get("rank", 0))
            nworker = int(doc.get("nworker", 1))
            window = int(doc.get("window", self.window))
        except (KeyError, TypeError, ValueError):
            return None, wire.encode_err(
                "bad_request", f"malformed OPEN params {doc!r}")
        if nworker < 1 or not 0 <= rank < nworker:
            return None, wire.encode_err(
                "bad_request", f"rank {rank} outside nworker {nworker}")
        if bs != self.plant.batch_size:
            return None, wire.encode_err(
                "batch_size_mismatch",
                f"client batch_size {bs} != service block size "
                f"{self.plant.batch_size}; point the service conf at "
                "the client's LOCAL batch size")
        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                self._m_shed.labels(reason="overloaded").inc()
                return None, wire.encode_err(
                    "overloaded",
                    f"{len(self._sessions)} sessions at the "
                    f"max_sessions={self.max_sessions} ceiling")
            sid = self._next_sid
            self._next_sid += 1
            s = _Session(sid, rank, nworker,
                         max(1, min(window, self.window)), peer)
            self._sessions[sid] = s
            self._m_sessions.set(float(len(self._sessions)))
        obs_events.emit("dataservice.open", session=sid, peer=peer,
                        rank=rank, nworker=nworker)
        return s, None

    def _evict(self, s: _Session) -> None:
        with self._lock:
            self._sessions.pop(s.sid, None)
            self._m_sessions.set(float(len(self._sessions)))
        obs_events.emit("dataservice.close", session=s.sid,
                        batches=s.batches)

    def _handle_conn(self, sock: socket.socket, peer: str) -> None:
        session: Optional[_Session] = None
        with self._lock:
            self._conns.add(sock)
        try:
            body = wire.read_frame(sock)
            if body is None:
                return
            kind, payload = wire.decode_kind(body)
            if kind != wire.OPEN:
                wire.write_frame(sock, wire.encode_err(
                    "bad_request", "first frame must be OPEN"))
                return
            session, err = self._admit(wire.decode_json(payload), peer)
            if session is None:
                wire.write_frame(sock, err)
                return
            wire.write_frame(sock, wire.encode_opened(
                session.sid, self.plant.fingerprint, session.window))
            while True:
                body = wire.read_frame(sock)
                if body is None:
                    return  # client gone: EOF is a teardown signal
                kind, payload = wire.decode_kind(body)
                if kind == wire.CLOSE:
                    return
                if kind != wire.GET:
                    wire.write_frame(sock, wire.encode_err(
                        "bad_request",
                        f"unexpected frame kind {kind} in session"))
                    return
                epoch, k = wire.decode_get(payload)
                what, obj, hit = self.plant.deal(
                    epoch, k, session.rank, session.nworker)
                if what == "eoe":
                    wire.write_frame(sock, wire.encode_eoe(epoch, obj))
                else:
                    session.epoch, session.block = epoch, k
                    session.batches += 1
                    wire.write_frame(sock, wire.encode_batch(
                        obj.data, obj.label, obj.inst_index,
                        obj.num_batch_padd, epoch, k, hit))
        except (wire.WireError, ConnectionError, BrokenPipeError,
                OSError) as e:
            if not self.silent:
                print(f"data_service: session "
                      f"{session.sid if session else '?'} from {peer} "
                      f"dropped: {type(e).__name__}: {e}", flush=True)
            if isinstance(e, wire.WireError):
                try:
                    wire.write_frame(sock, wire.encode_err(
                        e.reason, str(e)))
                except OSError:
                    pass
        finally:
            with self._lock:
                self._conns.discard(sock)
            if session is not None:
                self._evict(session)

    # ------------------------------------------------------------------
    # lifecycle
    def start(self) -> None:
        """Init the plant, bind both planes, start serving in daemon
        threads, write the ready file; returns immediately."""
        self.plant.init()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                outer._handle_conn(self.request,
                                   f"{self.client_address[0]}:"
                                   f"{self.client_address[1]}")

        self._tcp = _TCPServer((self.host, self.port), _Handler)
        self.port = self._tcp.server_address[1]

        class _HTTP(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet health probes
                pass

            def do_GET(self) -> None:
                if self.path == "/healthz":
                    body = json.dumps(outer.healthz()).encode()
                    ctype = "application/json"
                elif self.path == "/statsz":
                    body = json.dumps(outer.statsz(), sort_keys=True,
                                      default=str).encode()
                    ctype = "application/json"
                elif self.path == "/metricsz":
                    body = obs_registry().render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._http = ThreadingHTTPServer((self.host, self.http_port),
                                         _HTTP)
        self._http.daemon_threads = True
        self._http.block_on_close = False
        self.http_port = self._http.server_address[1]
        for srv, name in ((self._tcp, "dataservice-tcp"),
                          (self._http, "dataservice-http")):
            t = threading.Thread(target=srv.serve_forever,
                                 name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if self.ready_file:
            # tmp+rename: a poller never reads a half-written doc
            tmp = self.ready_file + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"host": self.host, "port": self.port,
                           "http_port": self.http_port,
                           "fingerprint": self.plant.fingerprint,
                           "pid": os.getpid()}, f)
            os.replace(tmp, self.ready_file)
        if not self.silent:
            print(f"data_service: dealing fp "
                  f"{self.plant.fingerprint} blocks of "
                  f"{self.plant.batch_size} on {self.host}:{self.port} "
                  f"(http {self.http_port})", flush=True)

    def serve_forever(self) -> None:
        self.start()
        self._stopped.wait()

    def shutdown(self) -> None:
        """Stop both planes; safe from any thread (including a signal
        handler's helper thread)."""
        self._stopped.set()
        for srv in (self._tcp, self._http):
            if srv is not None:
                srv.shutdown()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.shutdown()
        # drop live sessions dead, like a SIGKILL would: clients must
        # see a broken pipe and take the reconnect-resume path
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for srv in (self._tcp, self._http):
            if srv is not None:
                srv.server_close()
        for t in self._threads:
            t.join(timeout=5.0)
        self.plant.close()

    # ------------------------------------------------------------------
    # health plane
    def healthz(self) -> dict:
        return {"status": "ok", "sessions": len(self._sessions),
                "fingerprint": self.plant.fingerprint}

    def statsz(self) -> dict:
        with self._lock:
            sessions = [{
                "session": s.sid, "peer": s.peer, "rank": s.rank,
                "nworker": s.nworker, "epoch": s.epoch, "block": s.block,
                "batches": s.batches,
            } for s in self._sessions.values()]
        st = self.plant.stats()
        st.update({
            "sessions": sessions,
            "max_sessions": self.max_sessions,
            "window": self.window,
            "port": self.port,
            "http_port": self.http_port,
        })
        return st
