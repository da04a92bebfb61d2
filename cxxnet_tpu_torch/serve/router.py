"""Fleet front end: priority admission control + least-loaded dispatch.

The port's copy of ``cxxnet_tpu/serve/router.py``.  Its first part,
:class:`UnknownModelError` and :class:`ModelRouter`, is per-model
dispatch inside one process: the HTTP front end (``serve/server.py``,
``router=``) and the multi-tenant loop manager (``loop/tenant.py``,
``task=loop_fleet``) resolve a request's ``model`` field through it.

The rest is the single front door over a
:class:`~cxxnet_tpu_torch.serve.fleet.ServingFleet`.  Every request
flows: **classify** (priority ``interactive`` | ``batch``, from the JSON
``priority`` field or the ``X-Priority`` header; a ``CXB1`` frame's
header) → **admit** → **dispatch** (least-loaded healthy replica, with
failover) → **relay** (the replica's status and body pass through
unchanged).

Admission control: capacity is ``fleet_replica_inflight ×
replicas-in-rotation`` — it SHRINKS when replicas die, so overload
surfaces as explicit 429 shed instead of queueing collapse.  Batch
traffic sheds first: above ``fleet_batch_shed_ratio`` of capacity,
``batch`` requests get 429 while ``interactive`` requests are still
admitted up to the full bound.

Deadline budget: a request's ``deadline_ms`` covers route AND execute.
The router tracks the absolute deadline from arrival; at each dispatch
attempt it forwards only the REMAINING budget to the replica (whose
engine 504s work it cannot finish in time) and 504s locally when the
budget is gone before any replica could be reached.

Failover: predict/extract are idempotent, so a dispatch that dies at
the network layer (the replica was SIGKILLed mid-flight) retries on a
DIFFERENT replica up to ``fleet_dispatch_retries`` times within the
deadline — this is what makes kill-one-of-N invisible to non-shed
requests.  ``/feedback`` appends are NOT retried (a retry could
double-append); they relay a 502 and the client's own retry applies.

Canary routing: while a canary is evaluating, a ``canary_slice``
fraction of live ``/predict`` traffic is served BY the canary (its
latency leg), and a ``canary_sample`` fraction of baseline responses
is mirrored to it in the background for row-level agreement — the
measurement the promote/rollback decision reads
(``serve/fleet.py::CanaryController``).  JSON mirrors compare ``pred``
lists; binary mirrors compare the raw f32 score rows bit for bit, so an
int8 canary agrees with an f32 baseline only on the JSON leg.

Transport: dispatch runs over a bounded per-replica pool of persistent
HTTP/1.1 connections (:class:`_ReplicaPool`).  A pooled connection that
went stale while idle gets exactly one fresh-connection retry against
the SAME replica — except ``/feedback``, whose send may already have
landed and is therefore never replayed.  Pools are retired wholesale
when a replica is ejected or reloaded.

Binary frames (``Content-Type: application/x-cxb``) take the same front
door: they are classified from the frame header (``wire.peek_header``),
pass the same admission, priority and deadline machinery, and relay
OPAQUELY — the router patches the remaining deadline budget in place
(``wire.patch_deadline``) per dispatch attempt and never decodes the
payload.
"""

from __future__ import annotations

import http.client
import json
import queue
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import alerts as obs_alerts
from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from . import wire
from .fleet import Replica, fleet_metrics

__all__ = ["FleetRouter", "FleetStats", "ModelRouter",
           "UnknownModelError", "PRIORITIES"]

PRIORITIES = ("interactive", "batch")
# the single-engine server's cap (a full-width JSON request of 32 rows
# is ~50 MB of text); a binary frame is held to wire.MAX_PAYLOAD_BYTES
MAX_BODY_BYTES = 512 << 20


class UnknownModelError(KeyError):
    """A request named a model no route serves.  ``reason`` is the
    stable machine-readable token clients and supervisors key on (the
    HTTP layer maps this to a 404 carrying it)."""

    reason = "unknown_model"

    def __init__(self, model, known) -> None:
        self.model = model
        self.known = sorted(known)
        super().__init__(
            f"unknown model {model!r}; serving: "
            f"{', '.join(self.known) or '(none)'}")

    def __str__(self) -> str:  # KeyError.__str__ repr()s its arg
        return self.args[0]


class ModelRouter:
    """Per-model dispatch: a request's ``model`` field → the named
    tenant's engine and feedback log.

    A model-less request takes the DEFAULT route — the first model
    registered, or the one flagged ``default`` — so single-model
    clients keep working against a multi-model server.  Routes are
    fixed after startup, so resolution takes no lock."""

    def __init__(self) -> None:
        self._routes: Dict[str, Tuple[object, object]] = {}
        self._default: Optional[str] = None

    def add(self, name: str, engine, feedback=None,
            default: bool = False) -> "ModelRouter":
        if not name:
            raise ValueError("a model route needs a non-empty name")
        if name in self._routes:
            raise ValueError(f"duplicate model route {name!r}")
        self._routes[name] = (engine, feedback)
        if default or self._default is None:
            self._default = name
        return self

    def resolve(self, model=None) -> Tuple[str, object, object]:
        """``(name, engine, feedback)`` for a request's ``model`` field
        (None or empty → the default route).  Raises
        :class:`UnknownModelError` for a name no route serves."""
        if model in (None, ""):
            model = self._default
        if model not in self._routes:
            raise UnknownModelError(model, self._routes.keys())
        engine, feedback = self._routes[model]
        return str(model), engine, feedback

    def models(self) -> List[str]:
        return sorted(self._routes)

    def engines(self) -> List[object]:
        return [e for e, _fb in self._routes.values()]

    def healthz_models(self) -> Dict[str, dict]:
        """Per-model identity block for the front-end's ``/healthz``."""
        out = {}
        for name, (engine, _fb) in sorted(self._routes.items()):
            h = engine.healthz()
            out[name] = {"status": h.get("status"),
                         "round": h.get("round"),
                         "model_crc32": h.get("model_crc32"),
                         "default": name == self._default}
        return out


#: network-layer dispatch failures that trigger failover (a replica
#: HTTP error response is NOT one of these — it relays)
_DISPATCH_ERRORS = (http.client.HTTPException, ConnectionError, OSError,
                    TimeoutError)


def _jbody(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


class _ReplicaPool:
    """Bounded idle-connection pool to ONE replica address.

    ``acquire`` hands back an idle keep-alive connection when one is
    parked (``reused=True``) or a fresh unconnected one otherwise;
    ``release`` parks it again up to ``size`` idle connections (beyond
    that the connection closes — the bound is on PARKED sockets, not
    concurrency, which the admission layer already caps).  All methods
    are thread-safe; the connections themselves are owned by exactly
    one dispatch between acquire and release."""

    def __init__(self, address: str, size: int) -> None:
        self.address = address
        host, _, port = address.rpartition(":")
        self.host = host
        self.port = int(port)
        self.size = max(1, int(size))
        self._lock = threading.Lock()
        self._idle: List[http.client.HTTPConnection] = []

    def acquire(self, timeout_s: float
                ) -> Tuple[http.client.HTTPConnection, bool]:
        with self._lock:
            conn = self._idle.pop() if self._idle else None
        if conn is not None:
            # per-request timeout on a long-lived socket
            conn.timeout = timeout_s
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)
            return conn, True
        return http.client.HTTPConnection(
            self.host, self.port, timeout=timeout_s), False

    def release(self, conn: http.client.HTTPConnection) -> bool:
        """Park ``conn`` for reuse; False when the pool is full (the
        connection is closed instead)."""
        with self._lock:
            if len(self._idle) < self.size:
                self._idle.append(conn)
                return True
        conn.close()
        return False

    def retire_all(self) -> int:
        """Close every parked connection (replica ejected/reloaded)."""
        with self._lock:
            idle, self._idle = self._idle, []
        for c in idle:
            c.close()
        return len(idle)

    def idle_count(self) -> int:
        with self._lock:
            return len(self._idle)


class FleetStats:
    """Thread-safe request accounting for the front-end (``/statsz``)
    plus the drain condition shutdown waits on.  ``requests`` counts
    ARRIVALS by priority (shed included — the same semantics as the
    ``fleet_requests_total`` family; admitted = requests - shed)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self.inflight = 0
        self.requests: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.shed: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.expired = 0
        self.failovers = 0
        self.unroutable = 0
        self.relayed_5xx = 0

    def try_enter(self, priority: str, capacity: int,
                  shed_ratio: float) -> Optional[str]:
        """Atomic admit-or-shed: the occupancy check and the slot
        reservation happen under ONE lock, so concurrent arrivals can
        never all pass a stale check and overshoot the capacity bound
        (which would also invert batch-sheds-first ordering).  Returns
        None when a slot was reserved, else the shed reason."""
        with self._lock:
            self.requests[priority] = self.requests.get(priority, 0) + 1
            cur = self.inflight
            if cur >= capacity:
                self.shed[priority] = self.shed.get(priority, 0) + 1
                return f"at capacity ({cur}/{capacity} in flight)"
            if priority == "batch" and cur >= shed_ratio * capacity:
                self.shed[priority] = self.shed.get(priority, 0) + 1
                return (f"batch shed under pressure ({cur}/{capacity} "
                        f"in flight, batch sheds above {shed_ratio:g} "
                        f"of capacity)")
            self.inflight += 1
            return None

    def leave(self) -> None:
        with self._idle:
            self.inflight -= 1
            if self.inflight == 0:
                self._idle.notify_all()

    def wait_idle(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self.inflight > 0:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._idle.wait(timeout=remain)
        return True

    def count(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "inflight": self.inflight,
                "requests": dict(self.requests),
                "shed": dict(self.shed),
                "expired": self.expired,
                "failovers": self.failovers,
                "unroutable": self.unroutable,
                "relayed_5xx": self.relayed_5xx,
            }


class FleetRouter:
    """The dispatch brain; ``make_httpd`` binds the HTTP surface."""

    def __init__(self, fleet, default_deadline_ms: float = 0.0) -> None:
        self.fleet = fleet
        self.opts = fleet.opts
        self.sup = fleet.supervisor
        self.default_deadline_ms = float(default_deadline_ms)
        self.stats = FleetStats()
        self._metrics = fleet_metrics()  # hot path: no singleton lock
        self._lock = threading.Lock()       # replica inflight counters
        self._rng = random.Random(0xF1EE7)  # slice/sample draws
        self._rng_lock = threading.Lock()
        # persistent-connection pools, one per replica address (created
        # lazily on first dispatch, retired on eject/reload)
        self._pools: Dict[str, _ReplicaPool] = {}
        self._pools_lock = threading.Lock()
        self.pool_size = int(getattr(self.opts, "pool_size", 8))
        # live idle-connection gauge (last router bound wins, matching
        # the serve-side queue_depth convention)
        self._metrics.pool_idle.set_function(
            lambda: sum(p.idle_count() for p in self._pool_list()))
        # mirror lane: bounded + lossy — shadow comparisons must never
        # apply backpressure to live traffic
        self._mirror_q: "queue.Queue[tuple]" = queue.Queue(maxsize=256)
        self._mirror_stop = threading.Event()
        self._mirror_thread: Optional[threading.Thread] = None
        if self.fleet.canary is not None:
            self._mirror_thread = threading.Thread(
                target=self._mirror_loop, name="cxxnet-fleet-mirror",
                daemon=True)
            self._mirror_thread.start()

    # ------------------------------------------------------------------
    # admission control
    def capacity(self) -> int:
        return self.opts.replica_inflight * max(
            1, len(self.sup.rotation()))

    def admit(self, priority: str) -> Optional[str]:
        """Admit-or-shed (atomic — see :meth:`FleetStats.try_enter`);
        an admitted caller owns a slot and must ``stats.leave()``.
        Batch sheds first: the 429 surface under pressure, interactive
        up to the full capacity bound."""
        return self.stats.try_enter(priority, self.capacity(),
                                    self.opts.batch_shed_ratio)

    # ------------------------------------------------------------------
    # replica selection
    def _canary_live(self) -> bool:
        c = self.fleet.canary
        return c is not None and c.state == "evaluating"

    def pick_replica(self, exclude=(),
                     want_canary: bool = False) -> Optional[Replica]:
        """Least-loaded healthy replica (ties break on index).  While a
        canary is evaluating it only receives its slice
        (``want_canary``); once promoted it serves at full weight."""
        rotation = self.sup.rotation()
        evaluating = self._canary_live()
        if want_canary:
            pool = [r for r in rotation if r.role == "canary"]
        elif evaluating:
            pool = [r for r in rotation if r.role != "canary"]
        else:
            pool = rotation
        pool = [r for r in pool if r not in exclude]
        if not pool:
            return None
        with self._lock:
            return min(pool, key=lambda r: (r.inflight, r.idx))

    def _draw(self, prob: float) -> bool:
        if prob <= 0.0:
            return False
        with self._rng_lock:
            return self._rng.random() < prob

    # ------------------------------------------------------------------
    # connection pools
    def _pool(self, r: Replica) -> _ReplicaPool:
        with self._pools_lock:
            p = self._pools.get(r.address)
            if p is None:
                p = _ReplicaPool(r.address, self.pool_size)
                self._pools[r.address] = p
            return p

    def _pool_list(self) -> List[_ReplicaPool]:
        with self._pools_lock:
            return list(self._pools.values())

    def retire_replica_pool(self, address: str) -> int:
        """Close every parked connection to ``address`` — the fleet
        calls this when the replica is ejected or reloaded, so no
        dispatch ever rides a socket into a dead or swapped process."""
        with self._pools_lock:
            p = self._pools.get(address)
        if p is None:
            return 0
        n = p.retire_all()
        if n:
            self._metrics.pool_retired.inc(n)
        return n

    def pool_stats(self) -> Dict[str, int]:
        """Idle keep-alive connections per replica address."""
        return {p.address: p.idle_count() for p in self._pool_list()}

    # ------------------------------------------------------------------
    # dispatch
    def _post_replica(
        self, r: Replica, path: str, body, timeout_s: float,
        content_type: str = "application/json",
    ) -> Tuple[int, bytes, str]:
        """POST ``body`` bytes over a pooled keep-alive connection;
        returns ``(status, raw_body, content_type)``.  A replica ERROR
        RESPONSE (429/500/504...) relays as-is — only network-layer
        failures raise (and trigger failover in the caller).  A pooled
        connection that went stale while parked gets ONE retry on a
        fresh connection to the same replica; ``/feedback`` never does
        (the stale send may have reached the replica)."""
        pool = self._pool(r)
        for attempt in (0, 1):
            conn, reused = pool.acquire(timeout_s)
            if not reused:
                self._metrics.pool_connects.inc()
            try:
                conn.request("POST", path, body=body,
                             headers={"Content-Type": content_type})
                resp = conn.getresponse()
                raw = resp.read()
            except _DISPATCH_ERRORS:
                conn.close()
                self._metrics.pool_retired.inc()
                if reused and attempt == 0 and path != "/feedback":
                    continue  # stale keep-alive: one fresh retry
                raise
            rtype = (resp.getheader("Content-Type") or
                     "application/json").split(";")[0].strip()
            if resp.will_close:
                conn.close()
                self._metrics.pool_retired.inc()
            else:
                pool.release(conn)
            return resp.status, raw, rtype
        raise ConnectionError("unreachable")  # loop always returns/raises

    def route(self, path: str, obj: dict,
              priority: str = "interactive") -> Tuple[int, dict]:
        """Admission + dispatch + failover for one request; returns
        ``(http_status, body)``.  The embeddable API the HTTP handler
        (and the tests) call."""
        m = self._metrics
        m.requests.labels(priority=priority).inc()
        reason = self.admit(priority)
        if reason is not None:
            m.shed.labels(priority=priority).inc()
            return 429, {"error": f"load shed: {reason}",
                         "priority": priority}
        m.inflight.set(self.stats.inflight)
        try:
            return self._dispatch(path, obj)
        finally:
            self.stats.leave()
            m.inflight.set(self.stats.inflight)

    def route_wire(self, path: str, frame, priority: str = "interactive",
                   deadline_ms: float = 0.0) -> Tuple[int, bytes, str]:
        """Binary twin of :meth:`route`: identical admission, priority
        shedding, deadline budget, failover and canary accounting; the
        frame relays opaquely (only its deadline field is patched per
        attempt).  Returns ``(status, body_bytes, content_type)`` —
        success bodies are ``CXR1`` frames straight off the replica,
        error bodies stay JSON so any client can read them."""
        m = self._metrics
        m.requests.labels(priority=priority).inc()
        reason = self.admit(priority)
        if reason is not None:
            m.shed.labels(priority=priority).inc()
            return 429, _jbody({"error": f"load shed: {reason}",
                                "priority": priority}), "application/json"
        m.inflight.set(self.stats.inflight)
        try:
            buf = frame if isinstance(frame, bytearray) else \
                bytearray(frame)
            return self._dispatch_wire(path, buf, deadline_ms)
        finally:
            self.stats.leave()
            m.inflight.set(self.stats.inflight)

    def _dispatch(self, path: str, obj: dict) -> Tuple[int, dict]:
        deadline_ms = obj.get("deadline_ms")
        if deadline_ms is None and self.default_deadline_ms > 0:
            deadline_ms = self.default_deadline_ms
        try:
            deadline_val = (float(deadline_ms)
                            if deadline_ms is not None else 0.0)
        except (TypeError, ValueError):
            # client-input error: 400, matching the single-engine server
            return 400, {"error": f"bad deadline_ms: {deadline_ms!r}"}
        fwd = dict(obj)
        fwd.pop("priority", None)

        def make_body(remaining_ms: Optional[float]) -> bytes:
            if remaining_ms is not None:
                # the execute share of the budget: whatever routing and
                # failover have not already consumed
                fwd["deadline_ms"] = remaining_ms
            return _jbody(fwd)

        def account(r: Replica, raw: bytes, dt: float) -> None:
            self._canary_account(r, dt, lambda: (
                "json", obj.get("data"),
                json.loads(raw.decode("utf-8")).get("pred")))

        status, raw, _rtype = self._dispatch_loop(
            path, deadline_val, make_body, "application/json", account)
        try:
            body = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            body = {"error": "replica returned a non-JSON body"}
        return status, body

    def _dispatch_wire(self, path: str, frame: bytearray,
                       deadline_ms: float) -> Tuple[int, bytes, str]:
        deadline_val = float(deadline_ms or 0.0)
        if deadline_val <= 0 and self.default_deadline_ms > 0:
            deadline_val = self.default_deadline_ms

        def make_body(remaining_ms: Optional[float]):
            if remaining_ms is not None:
                wire.patch_deadline(frame, remaining_ms)
            return frame

        def account(r: Replica, raw: bytes, dt: float) -> None:
            self._canary_account(
                r, dt, lambda: ("wire", bytes(frame), bytes(raw)))

        return self._dispatch_loop(path, deadline_val, make_body,
                                   wire.CONTENT_TYPE, account)

    def _dispatch_loop(
        self, path: str, deadline_val: float,
        make_body: Callable[[Optional[float]], object],
        content_type: str,
        account: Callable[[Replica, bytes, float], None],
    ) -> Tuple[int, bytes, str]:
        """The shared least-loaded + failover loop under both wire
        formats.  ``make_body(remaining_ms)`` builds each attempt's
        request body (JSON re-encodes the forwarded object; binary
        patches the frame's deadline field in place); ``account`` runs
        on a 200 ``/predict`` relay for canary latency/mirroring."""
        t0 = time.monotonic()
        m = self._metrics
        deadline_t = (t0 + deadline_val / 1e3
                      if deadline_val > 0 else None)
        is_predict = path == "/predict"
        want_canary = (is_predict and self._canary_live()
                       and self._draw(self.opts.canary_slice))
        tried: set = set()
        failures = 0
        while True:
            remaining_ms = None
            if deadline_t is not None:
                remaining_ms = (deadline_t - time.monotonic()) * 1e3
                if remaining_ms <= 0:
                    self.stats.count("expired")
                    return 504, _jbody(
                        {"error": "deadline expired before a replica "
                                  "could answer"}), "application/json"
            r = self.pick_replica(exclude=tried, want_canary=want_canary)
            if r is None and want_canary:
                want_canary = False  # canary unavailable: baseline serves
                continue
            if r is None:
                self.stats.count("unroutable")
                return 503, _jbody(
                    {"error": "no healthy replica available"}), \
                    "application/json"
            timeout_s = self.opts.dispatch_timeout_s
            if remaining_ms is not None:
                timeout_s = min(timeout_s, remaining_ms / 1e3 + 1.0)
            body = make_body(remaining_ms)
            with self._lock:
                r.inflight += 1
            t_send = time.monotonic()
            try:
                status, raw, rtype = self._post_replica(
                    r, path, body, timeout_s, content_type)
            except _DISPATCH_ERRORS as e:
                tried.add(r)
                failures += 1
                self.sup.note_dispatch_failure(r)
                if path == "/feedback":
                    # appends are not idempotent — never replayed
                    return 502, _jbody(
                        {"error": f"replica dispatch failed "
                                  f"({type(e).__name__}: {e}); "
                                  "feedback is not retried"}), \
                        "application/json"
                if failures > self.opts.dispatch_retries:
                    return 502, _jbody(
                        {"error": f"dispatch failed on {failures} "
                                  f"replica(s) "
                                  f"({type(e).__name__}: {e})"}), \
                        "application/json"
                # only an actual retry counts as a failover
                self.stats.count("failovers")
                m.failovers.inc()
                continue
            finally:
                with self._lock:
                    r.inflight -= 1
            dt = time.monotonic() - t_send
            with self._lock:
                r.dispatched += 1
            m.dispatch.labels(replica=str(r.idx)).inc()
            if status >= 500:
                self.stats.count("relayed_5xx")
            if is_predict and status == 200:
                account(r, raw, dt)
            return status, raw, rtype

    # ------------------------------------------------------------------
    # canary measurement
    def _canary_account(self, r: Replica, dt_s: float,
                        item_fn: Callable[[], Optional[tuple]]) -> None:
        """Latency legs + mirror sampling for one 200 ``/predict``.
        ``item_fn`` lazily builds the mirror-queue entry — ``("json",
        data, base_pred)`` or ``("wire", frame_bytes, base_response)``
        — so the baseline body is only decoded on a sampled draw."""
        c = self.fleet.canary
        if c is None or c.state != "evaluating":
            return
        m = self._metrics
        if r.role == "canary":
            m.canary_requests.labels(leg="slice").inc()
            c.record_latency("canary", dt_s)
            return
        c.record_latency("baseline", dt_s)
        if self._draw(self.opts.canary_sample):
            try:
                item = item_fn()
            except Exception:  # noqa: BLE001 - shadow path never raises
                return
            if item is None:
                return
            try:
                self._mirror_q.put_nowait(item)
            except queue.Full:
                pass  # lossy by design: shadow work never backpressures

    def _mirror_loop(self) -> None:
        while not self._mirror_stop.is_set():
            try:
                item = self._mirror_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._mirror_once(item)
            except Exception:  # noqa: BLE001 - shadow lane never dies
                pass

    def _mirror_once(self, item: tuple) -> None:
        """Replay one sampled baseline request against the canary and
        record row-level agreement.  JSON entries compare ``pred``
        lists; wire entries re-post the original frame (deadline
        zeroed — shadow work has no budget) and compare the raw f32
        response payloads row-wise."""
        leg, payload, base = item
        c = self.fleet.canary
        if c is None or c.state != "evaluating" or base is None:
            return
        canary = self.pick_replica(want_canary=True)
        if canary is None:
            return
        m = self._metrics
        if leg == "wire":
            frame = bytearray(payload)
            wire.patch_deadline(frame, 0)
            body, ctype = frame, wire.CONTENT_TYPE
        else:
            body, ctype = _jbody({"data": payload}), "application/json"
        t0 = time.monotonic()
        try:
            status, raw, rtype = self._post_replica(
                canary, "/predict", body, self.opts.dispatch_timeout_s,
                content_type=ctype)
        except _DISPATCH_ERRORS:
            self.sup.note_dispatch_failure(canary)
            return
        m.canary_requests.labels(leg="mirror").inc()
        if status != 200:
            return
        c.record_latency("canary", time.monotonic() - t0)
        if leg == "wire":
            try:
                _k, _rid, can_rows = wire.decode_response(raw)
                _k, _rid, base_rows = wire.decode_response(base)
            except wire.WireError:
                return
            total = min(base_rows.shape[0], can_rows.shape[0])
            b = np.asarray(base_rows[:total]).reshape(total, -1)
            cn = np.asarray(can_rows[:total]).reshape(total, -1)
            equal = int((b == cn).all(axis=1).sum())
        else:
            try:
                can_pred = json.loads(raw.decode("utf-8")).get("pred")
            except (ValueError, UnicodeDecodeError):
                return
            if not isinstance(can_pred, list):
                return
            base_l = list(base) if isinstance(base, list) else [base]
            total = min(len(base_l), len(can_pred))
            equal = sum(1 for a, b in zip(base_l, can_pred) if a == b)
        c.record_compare(equal, total)

    # ------------------------------------------------------------------
    # HTTP surface
    def make_httpd(self, host: str, port: int) -> ThreadingHTTPServer:
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # noqa: N802 - stdlib name
                pass

            def _reply(self, status: int, payload) -> None:
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload).encode("utf-8"))
                self.send_response(status)
                ctype = ("text/plain; version=0.0.4; charset=utf-8"
                         if isinstance(payload, bytes)
                         else "application/json")
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - stdlib name
                if self.path == "/healthz":
                    self._reply(200, router.fleet.healthz())
                elif self.path == "/statsz":
                    self._reply(200, router.fleet.statsz())
                elif self.path == "/metricsz":
                    self._reply(200, obs_registry()
                                .render_prometheus().encode("utf-8"))
                elif self.path == "/alertz":
                    self._reply(200, obs_alerts.evaluator().status())
                else:
                    self._reply(404,
                                {"error": f"unknown route {self.path}"})

            def _post_wire(self, length: int) -> None:
                """Binary-frame data plane: read the frame into ONE
                mutable buffer, classify from its header, relay through
                the same admission machinery as JSON."""
                frame = bytearray(length)
                got, view = 0, memoryview(frame)
                while got < length:
                    n = self.rfile.readinto(view[got:])
                    if not n:
                        break
                    got += n
                del view
                if got < length:
                    # can't resync a half-read keep-alive stream
                    self.close_connection = True
                    self._reply(400, {"error": "frame body shorter than "
                                               "Content-Length",
                                      "reason": "truncated_body"})
                    return
                if self.path == "/feedback":
                    self._reply(400, {
                        "error": "binary frames are not accepted on "
                                 "/feedback; use JSON",
                        "reason": "wire_unsupported_route"})
                    return
                try:
                    _kind, _model, priority, deadline_ms, _nbytes = \
                        wire.peek_header(frame)
                except wire.WireError as e:
                    self._reply(400, {"error": str(e),
                                      "reason": e.reason})
                    return
                try:
                    status, body, rctype = router.route_wire(
                        self.path, frame, priority, deadline_ms or 0.0)
                except Exception as e:  # noqa: BLE001 - served as a 500
                    status, body, rctype = 500, _jbody(
                        {"error": f"{type(e).__name__}: {e}"}), \
                        "application/json"
                self.send_response(status)
                self.send_header("Content-Type", rctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 - stdlib name
                if self.path not in ("/predict", "/extract", "/feedback"):
                    self._reply(404,
                                {"error": f"unknown route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = 0
                if length <= 0 or length > MAX_BODY_BYTES:
                    # the unread body would desync the keep-alive stream
                    self.close_connection = True
                    self._reply(400,
                                {"error": "missing or oversized body"})
                    return
                ctype = (self.headers.get("Content-Type") or "") \
                    .split(";")[0].strip().lower()
                if ctype == wire.CONTENT_TYPE:
                    self._post_wire(length)
                    return
                try:
                    obj = json.loads(self.rfile.read(length)
                                     .decode("utf-8"))
                except (ValueError, UnicodeDecodeError) as e:
                    self._reply(400, {"error": f"bad JSON: {e}"})
                    return
                if not isinstance(obj, dict) or "data" not in obj:
                    self._reply(400,
                                {"error": 'body must be {"data": [...]}'})
                    return
                priority = str(obj.get("priority")
                               or self.headers.get("X-Priority")
                               or "interactive")
                if priority not in PRIORITIES:
                    self._reply(400, {
                        "error": f"unknown priority {priority!r}; want "
                                 f"one of {'/'.join(PRIORITIES)}"})
                    return
                try:
                    status, body = router.route(self.path, obj, priority)
                except Exception as e:  # noqa: BLE001 - served as a 500
                    status, body = 500, {
                        "error": f"{type(e).__name__}: {e}"}
                self._reply(status, body)

        class _FrontDoor(ThreadingHTTPServer):
            daemon_threads = True
            # a client fleet opening hundreds of keep-alive
            # connections at once overflows the stdlib default listen
            # backlog of 5 into connection-refused errors
            request_queue_size = 128

        httpd = _FrontDoor((host, port), Handler)
        obs_events.emit("fleet.router_up", host=host,
                        port=httpd.server_port)
        return httpd

    def close(self, drain_timeout_s: float = 5.0) -> None:
        if drain_timeout_s > 0 and not self.stats.wait_idle(
                drain_timeout_s):
            obs_events.emit("fleet.drain_timeout",
                            inflight=self.stats.inflight)
        self._mirror_stop.set()
        if self._mirror_thread is not None:
            self._mirror_thread.join(timeout=5.0)
            self._mirror_thread = None
        for p in self._pool_list():
            p.retire_all()
