"""The elastic pod: survive a replica's loss and resize the group mid-run.

The port's ``cxxnet_tpu/parallel/elastic.py``, with the same names and
the same wire.  This module is the membership and liveness half; the
rebuild half (tear the ``torch.distributed`` group down, join the next
generation's group, reload the round every survivor holds) is
``cli.py``'s ``_elastic_rebuild`` over
``distributed.shutdown_distributed(graceful=False)`` and the round
consensus of ``_locate_agreed_checkpoint``.

* :class:`ElasticCoordinator`: a small stdlib TCP service of JSON lines
  (one request a connection) inside the rank-0 process.  It tracks the
  members' heartbeats, tells a slow replica (a few beats missed:
  ``mesh.replica_slow``) from a lost one (silent past
  ``elastic_timeout_s``: ``mesh.replica_lost`` and a new membership
  generation), admits waiting processes to grow the group, and gives
  every generation a fresh address for its group's ``TCPStore``.  On
  the wire that address is the key ``jax_coordinator``, so a port
  member works against the JAX package's coordinator and the reverse.
* :class:`ElasticMember`: each process's client: a heartbeat thread, a
  ``lost_event`` the collective deadline polls, and the blocking plan
  and ack calls of the rebuild rendezvous.
* :class:`ReplicaLossError`: what a dead peer surfaces as, instead of a
  hang inside a collective.
* :func:`guarded_call`: the collective deadline.  It runs a blocking
  call on a worker thread and raises :class:`ReplicaLossError` once the
  monitor confirms a lost peer (or, past ``collective_timeout_s``,
  suspects one); a slow peer only emits ``mesh.collective_slow``.
* :func:`classify_failure`: which collective failures are a replica's
  loss (gloo's transport errors, the group store's, NCCL's
  communicator errors, the ``mesh.replica`` fault site) and which are
  not.
* :func:`rebuild_in_progress`: the process-wide flag a colocated
  serving engine reads to degrade ``/healthz`` while the trainer
  rebuilds.

Rank 0 hosts the coordinator and the group's store, so the loss of
rank 0 ends the job.  The survivors keep their relative order, so rank
0 stays rank 0 in every generation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import socketserver
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import emit as obs_emit
from ..obs.registry import registry as obs_registry

ConfigEntry = Tuple[str, str]

__all__ = [
    "ReplicaLossError",
    "ElasticOptions",
    "ElasticCoordinator",
    "ElasticMember",
    "GenerationPlan",
    "guarded_call",
    "classify_failure",
    "rebuild_in_progress",
    "set_rebuilding",
    "free_port",
]


class ReplicaLossError(RuntimeError):
    """A peer of the group is gone (confirmed by the liveness monitor,
    or presumed past the collective deadline with missed heartbeats).

    ``fatal=True`` means the job cannot go on (the survivors are below
    ``elastic_min_replicas``, or the coordinator is unreachable): the
    CLI raises instead of rebuilding."""

    def __init__(self, message: str, lost: Sequence[int] = (),
                 generation: int = 0, presumed: bool = False,
                 fatal: bool = False) -> None:
        super().__init__(message)
        self.lost = list(lost)
        self.generation = int(generation)
        self.presumed = bool(presumed)
        self.fatal = bool(fatal)


# ----------------------------------------------------------------------
# the /healthz degrade flag (serve/engine.py reads it)
_REBUILDING = threading.Event()


def rebuild_in_progress() -> bool:
    """True while a trainer of this process rebuilds its group."""
    return _REBUILDING.is_set()


def set_rebuilding(active: bool) -> None:
    if active:
        _REBUILDING.set()
    else:
        _REBUILDING.clear()


# ----------------------------------------------------------------------
@dataclasses.dataclass
class ElasticOptions:
    """The ``elastic_*`` keys and ``collective_timeout_s``."""

    elastic: bool = False
    min_replicas: int = 1
    rejoin_s: float = 120.0       # a joiner's wait for admission
    heartbeat_s: float = 0.5
    timeout_s: float = 5.0        # silent this long: the replica is lost
    collective_timeout_s: float = 30.0
    coordinator: str = ""         # host:port; default the dist port + 1
    drop_at: int = 0              # a planned shrink's boundary (0: off)
    join: bool = False            # this process waits to join
    join_at: int = 0              # pins the grow boundary (0: the next)

    @classmethod
    def from_cfg(cls, cfg: Sequence[ConfigEntry]) -> "ElasticOptions":
        o = cls()
        for name, val in cfg:
            if name == "elastic":
                o.elastic = bool(int(val))
            elif name == "elastic_min_replicas":
                o.min_replicas = int(val)
            elif name == "elastic_rejoin_s":
                o.rejoin_s = float(val)
            elif name == "elastic_heartbeat_s":
                o.heartbeat_s = float(val)
            elif name == "elastic_timeout_s":
                o.timeout_s = float(val)
            elif name == "collective_timeout_s":
                o.collective_timeout_s = float(val)
            elif name == "elastic_coordinator":
                o.coordinator = val
            elif name == "elastic_drop_at":
                o.drop_at = int(val)
            elif name == "elastic_join":
                o.join = bool(int(val))
            elif name == "elastic_join_at":
                o.join_at = int(val)
        if o.min_replicas < 1:
            raise ValueError("elastic_min_replicas must be >= 1")
        return o

    def resolve_coordinator(self, dist_coordinator: str) -> str:
        """The coordinator's address: the key, else the group store's
        host at its port + 1 (rank 0's machine)."""
        if self.coordinator:
            return self.coordinator
        host, port = dist_coordinator.rsplit(":", 1)
        return f"{host}:{int(port) + 1}"


@dataclasses.dataclass
class GenerationPlan:
    """One membership transition, as one member sees it.
    ``jax_coordinator`` (the wire's name) is the address of the next
    generation's group store."""

    generation: int
    reason: str                  # replica_lost | planned_shrink | grow
    num: int                     # | integrity_evict
    rank: Optional[int]          # None: this member leaves
    jax_coordinator: str
    at_round: Optional[int]      # None: at once (a loss)
    lost_ranks: List[int] = dataclasses.field(default_factory=list)
    abort: str = ""

    @classmethod
    def from_wire(cls, d: dict) -> "GenerationPlan":
        return cls(
            generation=int(d["gen"]), reason=str(d["reason"]),
            num=int(d["num"]), rank=d.get("rank"),
            jax_coordinator=str(d.get("jax_coordinator", "")),
            at_round=d.get("at_round"),
            lost_ranks=list(d.get("lost_ranks", ())),
            abort=str(d.get("abort", "")),
        )


def free_port() -> int:
    """An OS-assigned free TCP port (bind to 0, close; the usual race
    applies, so callers bind promptly).  The port's one copy: the
    coordinator's per-generation store ports, the serving fleet and
    the lane tools use it."""
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _replica_gauge(state: str, value: float) -> None:
    try:
        obs_registry().gauge(
            "mesh_replicas",
            "Elastic-mesh replica counts by state.",
            labelnames=("state",),
        ).labels(state=state).set(float(value))
    except Exception:  # noqa: BLE001 - telemetry never raises
        pass


# ----------------------------------------------------------------------
class _MemberInfo:
    __slots__ = ("mid", "rank", "last_beat", "round", "gen", "suspect")

    def __init__(self, mid: str, rank: int) -> None:
        self.mid = mid
        self.rank = rank
        self.last_beat = time.monotonic()
        self.round = -1
        self.gen = 1
        self.suspect = False


class ElasticCoordinator:
    """The membership service, inside the rank-0 process.

    One TCP connection a request, one JSON line each way.  Ops:
    ``hello`` (register), ``beat`` (liveness, and the generation poll),
    ``join`` (a waiter's poll), ``plan_shrink`` / ``plan_grow`` (the
    boundary rendezvous; one generation per ``(kind, round)``),
    ``evict`` (the integrity quarantine; one per ``(rank, round)``),
    ``ack`` (a member rebuilt onto a generation), ``status``."""

    def __init__(self, bind: str, jax_host: str, num: int,
                 opts: ElasticOptions) -> None:
        self.opts = opts
        self.jax_host = jax_host
        self._lock = threading.Lock()
        self._members: Dict[str, _MemberInfo] = {}
        # mid -> {"join_at": int (0: the next), "last": monotonic}: the
        # join poll is also the waiter's liveness, so a joiner that died
        # while waiting is not admitted (the grow rendezvous would wait
        # for a process that never comes)
        self._waiters: Dict[str, dict] = {}
        self._gen = 1
        self._expected = num
        self._plans: Dict[int, dict] = {}    # gen -> wire plan + members
        self._plan_keys: Dict[tuple, int] = {}  # (kind, round) -> gen
        self._grow_at: Optional[int] = None
        self._abort = ""
        self._lost_total = 0
        self._rejoined_total = 0
        self._stop = threading.Event()
        host, port = bind.rsplit(":", 1)

        coord = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:  # noqa: D401
                try:
                    line = self.rfile.readline(1 << 16)
                    req = json.loads(line.decode("utf-8"))
                    resp = coord._dispatch(req)
                except Exception as e:  # noqa: BLE001 - reply, don't die
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                try:
                    self.wfile.write(
                        (json.dumps(resp, separators=(",", ":")) + "\n")
                        .encode("utf-8"))
                except OSError:
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host or "", int(port)), Handler)
        self.address = (
            f"{host or 'localhost'}:{self._server.server_address[1]}")
        self._threads = [
            threading.Thread(target=self._server.serve_forever,
                             name="cxxnet-elastic-coord", daemon=True),
            threading.Thread(target=self._monitor,
                             name="cxxnet-elastic-monitor", daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _monitor(self) -> None:
        """Slow (about 2 beats missed) emits one ``mesh.replica_slow``
        an episode; lost (silent past ``elastic_timeout_s``) makes a
        shrink generation."""
        hb = self.opts.heartbeat_s
        while not self._stop.wait(hb):
            now = time.monotonic()
            lost: List[_MemberInfo] = []
            with self._lock:
                self._prune_waiters_locked(now)
                for m in list(self._members.values()):
                    silent = now - m.last_beat
                    if silent > self.opts.timeout_s:
                        lost.append(m)
                    elif silent > 2.5 * hb:
                        if not m.suspect:
                            m.suspect = True
                            obs_emit("mesh.replica_slow", rank=m.rank,
                                     member=m.mid, silent_s=round(silent, 3))
                    else:
                        m.suspect = False
            for m in lost:
                self._on_lost(m)

    def _prune_waiters_locked(self, now: float) -> None:
        """Drop the waiters whose join polls stopped; unschedule the
        grow when none is left."""
        stale = [mid for mid, w in self._waiters.items()
                 if now - w["last"] > self.opts.timeout_s]
        for mid in stale:
            del self._waiters[mid]
            obs_emit("mesh.rejoin_abandoned", member=mid)
        if stale and not self._waiters:
            self._grow_at = None

    def _on_lost(self, m: _MemberInfo) -> None:
        with self._lock:
            if m.mid not in self._members:
                return  # another trigger came first
            del self._members[m.mid]
            self._lost_total += 1
            obs_emit("mesh.replica_lost", rank=m.rank, member=m.mid,
                     generation=self._gen)
            self._bump_generation_locked(
                reason="replica_lost", at_round=None, lost_ranks=[m.rank])
        _replica_gauge("lost", self._lost_total)

    # ------------------------------------------------------------------
    def _bump_generation_locked(self, reason: str,
                                at_round: Optional[int],
                                lost_ranks: Sequence[int] = (),
                                drop_ranks: Sequence[int] = (),
                                admit_waiters: bool = False) -> dict:
        """The next membership generation (the caller holds the lock).

        The survivors keep their relative order (rank 0 stays 0); a
        dropped rank leaves with ``rank = None``; admitted waiters join
        at the tail.  Every plan carries a FRESH store port: the old
        generation's store may still hold the old one."""
        survivors = sorted(self._members.values(), key=lambda m: m.rank)
        dropped = [m for m in survivors if m.rank in set(drop_ranks)]
        survivors = [m for m in survivors if m.rank not in set(drop_ranks)]
        admitted: List[str] = []
        if admit_waiters:
            self._prune_waiters_locked(time.monotonic())
            admitted = sorted(self._waiters)
            self._waiters.clear()
        num = len(survivors) + len(admitted)
        self._gen += 1
        gen = self._gen
        abort = ""
        if num < self.opts.min_replicas:
            abort = (f"{num} survivor(s) below elastic_min_replicas="
                     f"{self.opts.min_replicas}")
            self._abort = abort
        assignments: Dict[str, Optional[int]] = {}
        for i, m in enumerate(survivors):
            assignments[m.mid] = i
            # m.gen stays at the member's last ACKED generation: the
            # beat delivers this plan while m.gen lags
            m.rank = i
        for j, mid in enumerate(admitted):
            rank = len(survivors) + j
            assignments[mid] = rank
            info = _MemberInfo(mid, rank)
            info.gen = gen
            self._members[mid] = info
            self._rejoined_total += 1
        for m in dropped:
            assignments[m.mid] = None
            del self._members[m.mid]
        plan = {
            "gen": gen, "reason": reason, "num": num,
            "jax_coordinator": f"{self.jax_host}:{free_port()}",
            "at_round": at_round,
            "lost_ranks": list(lost_ranks),
            "abort": abort,
            "assignments": assignments,
        }
        self._plans[gen] = plan
        old_grow = self._grow_at
        self._grow_at = None
        if self._waiters:
            # a shrink must not orphan the pending joiners: the grow
            # moves past the transition just planned
            rounds = [m.round for m in self._members.values()]
            base = (max(rounds) if rounds else 0) + 2
            self._grow_at = max(
                base, old_grow or 0,
                max((w["join_at"] for w in self._waiters.values()),
                    default=0))
        obs_emit("mesh.shrink" if reason != "grow" else "mesh.grow",
                 generation=gen, reason=reason, num=num,
                 at_round=at_round, lost_ranks=list(lost_ranks))
        _replica_gauge("alive", len(self._members))
        _replica_gauge("rejoined", self._rejoined_total)
        return plan

    def _plan_for(self, plan: dict, mid: str) -> dict:
        out = {k: v for k, v in plan.items() if k != "assignments"}
        out["rank"] = plan["assignments"].get(mid)
        return out

    # ------------------------------------------------------------------
    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        mid = str(req.get("member", ""))
        if op == "hello":
            with self._lock:
                info = _MemberInfo(mid, int(req["rank"]))
                info.gen = self._gen
                self._members[mid] = info
                alive = len(self._members)
            _replica_gauge("alive", alive)
            return {"ok": True, "gen": self._gen}
        if op == "beat":
            with self._lock:
                m = self._members.get(mid)
                if m is None:
                    # declared lost already: too late, it must rejoin
                    # as a waiter
                    return {"ok": True, "gen": self._gen, "evicted": True,
                            "abort": self._abort}
                m.last_beat = time.monotonic()
                m.round = int(req.get("round", m.round))
                change = None
                if m.gen < self._gen:
                    change = self._plan_for(self._plans[self._gen], mid)
                return {"ok": True, "gen": self._gen,
                        "grow_at": self._grow_at,
                        "suspects": [x.rank for x in self._members.values()
                                     if x.suspect],
                        "change": change, "abort": self._abort}
        if op == "join":
            join_at = int(req.get("join_at", 0) or 0)
            with self._lock:
                # admitted by a grow plan already?  The poll is also
                # liveness: the joiner's beat starts only once it knows
                # its rank, and its rendezvous can outlast the timeout
                mem = self._members.get(mid)
                if mem is not None:
                    mem.last_beat = time.monotonic()
                for gen in sorted(self._plans, reverse=True):
                    plan = self._plans[gen]
                    if plan["assignments"].get(mid) is not None:
                        return {"ok": True,
                                "admitted": self._plan_for(plan, mid)}
                first = mid not in self._waiters
                self._waiters[mid] = {"join_at": join_at,
                                      "last": time.monotonic()}
                if self._grow_at is None:
                    rounds = [m.round for m in self._members.values()]
                    nxt = (max(rounds) if rounds else 0) + 2
                    self._grow_at = max(join_at, nxt)
                if first:  # one announcement, not one a poll
                    obs_emit("mesh.rejoin_waiting", member=mid,
                             grow_at=self._grow_at)
                return {"ok": True, "admitted": None,
                        "grow_at": self._grow_at}
        if op in ("plan_shrink", "plan_grow"):
            round_ = int(req["round"])
            kind = "shrink" if op == "plan_shrink" else "grow"
            with self._lock:
                # a member one boundary late gets the EXISTING plan: a
                # second generation for one transition would split the
                # rendezvous
                mem = self._members.get(mid)
                latest = self._plans.get(self._gen)
                if (latest is not None and mem is not None
                        and mem.gen < self._gen
                        and (latest["reason"] == "grow") == (kind == "grow")):
                    return {"ok": True, "plan": self._plan_for(latest, mid)}
                key = (kind, round_)
                if key not in self._plan_keys:
                    if kind == "shrink":
                        drop = max(m.rank for m in self._members.values())
                        plan = self._bump_generation_locked(
                            reason="planned_shrink", at_round=round_,
                            drop_ranks=[drop])
                    else:
                        self._prune_waiters_locked(time.monotonic())
                        if not self._waiters:
                            # every joiner gave up: growing to the same
                            # membership would be a needless rebuild
                            return {"ok": True, "plan": None}
                        plan = self._bump_generation_locked(
                            reason="grow", at_round=round_,
                            admit_waiters=True)
                    self._plan_keys[key] = plan["gen"]
                plan = self._plans[self._plan_keys[key]]
                return {"ok": True, "plan": self._plan_for(plan, mid)}
        if op == "evict":
            # the integrity quarantine: every survivor reports the SAME
            # (rank, round) verdict; the first mints the generation
            rank = int(req["rank"])
            round_ = int(req["round"])
            with self._lock:
                key = ("evict", rank, round_)
                if key not in self._plan_keys:
                    target = [m for m in self._members.values()
                              if m.rank == rank]
                    if not target:
                        # the quarantined rank left and the monitor
                        # dropped it: the current generation stands
                        latest = self._plans.get(self._gen)
                        if latest is None:
                            raise ValueError(
                                f"evict: rank {rank} unknown and no "
                                "generation plan exists")
                        self._plan_keys[key] = latest["gen"]
                    else:
                        obs_emit("mesh.integrity_evict", rank=rank,
                                 round=round_, generation=self._gen)
                        plan = self._bump_generation_locked(
                            reason="integrity_evict", at_round=round_,
                            drop_ranks=[rank])
                        self._plan_keys[key] = plan["gen"]
                plan = self._plans[self._plan_keys[key]]
                return {"ok": True, "plan": self._plan_for(plan, mid)}
        if op == "ack":
            with self._lock:
                m = self._members.get(mid)
                if m is not None:
                    m.gen = int(req["gen"])
                    m.last_beat = time.monotonic()
            return {"ok": True}
        if op == "status":
            with self._lock:
                return {
                    "ok": True, "gen": self._gen,
                    "members": {m.mid: {"rank": m.rank, "round": m.round,
                                        "gen": m.gen, "suspect": m.suspect}
                                for m in self._members.values()},
                    "waiters": sorted(self._waiters),
                    "grow_at": self._grow_at,
                    "lost_total": self._lost_total,
                    "rejoined_total": self._rejoined_total,
                    "abort": self._abort,
                }
        raise ValueError(f"unknown op {op!r}")


# ----------------------------------------------------------------------
class ElasticMember:
    """A process's client: heartbeats and the rebuild rendezvous.

    ``lost_event`` is set as soon as a beat's reply announces a
    generation made by a loss (or the coordinator has been unreachable
    past ``elastic_timeout_s``); :func:`guarded_call` polls it."""

    def __init__(self, coordinator_addr: str, rank: int,
                 opts: ElasticOptions,
                 host_coordinator: bool = False,
                 num: int = 0, jax_host: str = "localhost") -> None:
        self.opts = opts
        self.addr = coordinator_addr
        self.rank = rank
        self.mid = f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:6]}"
        self.coordinator: Optional[ElasticCoordinator] = None
        if host_coordinator:
            self.coordinator = ElasticCoordinator(
                coordinator_addr, jax_host, num, opts)
            self.addr = self.coordinator.address
        self.generation = 1
        self.lost_event = threading.Event()
        self.abort_reason = ""
        self._pending: Optional[GenerationPlan] = None
        self._grow_at: Optional[int] = None
        self._suspects: List[int] = []
        self._round = -1
        self._coord_silent_since: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._beat_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _rpc(self, req: dict, timeout: Optional[float] = None) -> dict:
        timeout = timeout or max(self.opts.timeout_s, 2.0)
        req = {**req, "member": self.mid}
        host, port = self.addr.rsplit(":", 1)
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as s:
            s.sendall((json.dumps(req, separators=(",", ":")) + "\n")
                      .encode("utf-8"))
            f = s.makefile("rb")
            line = f.readline(1 << 16)
        resp = json.loads(line.decode("utf-8"))
        if not resp.get("ok"):
            raise RuntimeError(
                f"elastic coordinator rejected {req.get('op')}: "
                f"{resp.get('error')}")
        return resp

    # ------------------------------------------------------------------
    def start(self) -> "ElasticMember":
        # rank 0 binds the coordinator about when the peers say hello:
        # refused connections are retried for a few seconds
        deadline = time.monotonic() + 10.0
        while True:
            try:
                self._rpc({"op": "hello", "rank": self.rank})
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name="cxxnet-elastic-beat", daemon=True)
        self._beat_thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._beat_thread is not None:
            self._beat_thread.join(timeout=2.0)
        if self.coordinator is not None:
            self.coordinator.close()

    # ------------------------------------------------------------------
    def report_round(self, round_: int) -> None:
        self._round = int(round_)

    def poll_now(self) -> None:
        """One beat now: the round boundaries call it, so every rank
        reads the SAME coordinator state at the same boundary instead of
        racing the heartbeat thread."""
        resp = self._rpc({"op": "beat", "round": self._round})
        self._process_beat(resp)

    def _process_beat(self, resp: dict) -> None:
        with self._lock:
            if resp.get("evicted"):
                # declared lost while it stalled: the group re-formed
                # without it.  Fail fast (fatal) rather than wait in a
                # collective no peer joins; capacity comes back through
                # elastic_join
                if not self.abort_reason:
                    self.abort_reason = (
                        "this rank was evicted from the mesh (declared "
                        "lost while stalled); restart with "
                        "elastic_join=1 to rejoin")
                self.lost_event.set()
                return
            self._suspects = list(resp.get("suspects", ()))
            self._grow_at = resp.get("grow_at")
            if resp.get("abort"):
                self.abort_reason = str(resp["abort"])
                self.lost_event.set()
            change = resp.get("change")
            if change is not None:
                plan = GenerationPlan.from_wire(change)
                if plan.generation > self.generation:
                    self._pending = plan
                    if plan.at_round is None:  # a loss: act now
                        self.lost_event.set()

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.opts.heartbeat_s):
            try:
                resp = self._rpc({"op": "beat", "round": self._round},
                                 timeout=max(self.opts.heartbeat_s * 4, 1.0))
            except (OSError, ValueError, RuntimeError) as e:
                # any one bad exchange (a RuntimeError is an ok=false
                # reply) must not end the heartbeat, or a healthy rank
                # is evicted; past elastic_timeout_s of silence the
                # coordinator's host, rank 0, is presumed gone
                now = time.monotonic()
                if self._coord_silent_since is None:
                    self._coord_silent_since = now
                elif now - self._coord_silent_since > self.opts.timeout_s:
                    with self._lock:
                        if not self.abort_reason:
                            self.abort_reason = (
                                f"elastic coordinator {self.addr} "
                                f"unreachable ({type(e).__name__}: {e}) — "
                                "rank 0 presumed lost")
                    self.lost_event.set()
                continue
            self._coord_silent_since = None
            self._process_beat(resp)

    # ------------------------------------------------------------------
    def suspects(self) -> List[int]:
        with self._lock:
            return list(self._suspects)

    def pending_plan(self) -> Optional[GenerationPlan]:
        with self._lock:
            return self._pending

    def grow_round(self) -> Optional[int]:
        with self._lock:
            return self._grow_at

    def plan_shrink(self, round_: int) -> GenerationPlan:
        resp = self._rpc({"op": "plan_shrink", "round": int(round_)})
        return GenerationPlan.from_wire(resp["plan"])

    def plan_evict(self, rank: int, round_: int) -> GenerationPlan:
        """The quarantine's plan: drop ``rank``, named corrupt by the
        integrity vote at ``round_``.  Every survivor calls it with the
        same verdict and gets the same generation."""
        resp = self._rpc({"op": "evict", "rank": int(rank),
                          "round": int(round_)})
        return GenerationPlan.from_wire(resp["plan"])

    def plan_grow(self, round_: int) -> Optional[GenerationPlan]:
        """None when every waiter gave up before the boundary: the
        group stays as it is."""
        resp = self._rpc({"op": "plan_grow", "round": int(round_)})
        if resp.get("plan") is None:
            return None
        return GenerationPlan.from_wire(resp["plan"])

    def ack_generation(self, plan: GenerationPlan,
                       rank: Optional[int] = None) -> None:
        """Adopt a generation once its rendezvous succeeded."""
        with self._lock:
            self.generation = plan.generation
            if rank is not None:
                self.rank = rank
            self._pending = None
            self.lost_event.clear()
        try:
            self._rpc({"op": "ack", "gen": plan.generation})
        except (OSError, ValueError):
            pass  # the next beat catches up

    def join(self, timeout_s: Optional[float] = None) -> GenerationPlan:
        """A waiter's admission: poll until a grow generation gives
        this member a rank (``elastic_rejoin_s`` bounds the wait)."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.opts.rejoin_s)
        join_at = self.opts.join_at
        while True:
            try:
                resp = self._rpc({"op": "join", "join_at": join_at})
            except OSError:
                # the coordinator (rank 0) may not be up yet: a waiter
                # started beside (or before) the job keeps polling
                if time.monotonic() > deadline:
                    raise
                time.sleep(self.opts.heartbeat_s)
                continue
            admitted = resp.get("admitted")
            if admitted is not None:
                plan = GenerationPlan.from_wire(admitted)
                self.generation = plan.generation
                self.rank = plan.rank if plan.rank is not None else -1
                return plan
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic join: not admitted within "
                    f"{self.opts.rejoin_s:g}s (grow_at="
                    f"{resp.get('grow_at')})")
            time.sleep(self.opts.heartbeat_s)


# ----------------------------------------------------------------------
def guarded_call(fn, member: Optional[ElasticMember],
                 timeout_s: float = 30.0, what: str = "collective"):
    """Run a blocking call that holds collectives under the deadline.

    A confirmed loss (``member.lost_event``) raises
    :class:`ReplicaLossError` at once; past ``timeout_s`` a peer the
    monitor only *suspects* (beats missed, not yet evicted) is presumed
    lost; a slow group that is alive only logs ``mesh.collective_slow``
    and goes on waiting.  The worker thread is a daemon: with a dead
    peer gloo errors it out within milliseconds (the TCP pairs close),
    and the rebuild joins it with a grace before it tears the group
    down.  ``fn`` runs on that thread: a caller on a card binds the
    thread's device and stream inside ``fn``."""
    if member is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def run() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, name=f"cxxnet-guarded-{what}",
                         daemon=True)
    t.start()
    guarded_call.last_thread = t  # the rebuild joins it with a grace
    t0 = time.monotonic()
    warned = False
    while not done.wait(0.05):
        if member.lost_event.is_set():
            # a moment for the call to raise its own (richer) error
            done.wait(0.5)
            if not done.is_set():
                plan = member.pending_plan()
                raise ReplicaLossError(
                    f"replica lost during {what}"
                    + (f" ({member.abort_reason})" if member.abort_reason
                       else ""),
                    lost=plan.lost_ranks if plan else (),
                    generation=plan.generation if plan else 0,
                    fatal=bool(member.abort_reason),
                )
        elapsed = time.monotonic() - t0
        if elapsed > timeout_s:
            suspects = member.suspects()
            if suspects:
                raise ReplicaLossError(
                    f"{what} exceeded collective_timeout_s="
                    f"{timeout_s:g}s with unresponsive replica(s) "
                    f"{suspects} — presumed lost", lost=suspects,
                    presumed=True,
                )
            if not warned:
                warned = True
                obs_emit("mesh.collective_slow", what=what,
                         elapsed_s=round(elapsed, 3),
                         timeout_s=timeout_s)
    if "error" in box:
        raise box["error"]
    return box.get("value")


guarded_call.last_thread = None

#: what a replica's loss reads as inside gloo's errors, as torch 2.11
#: to 2.13 raise them (a SIGKILLed peer: ``[.../gloo/transport/tcp/
#: pair.cc:...] Connection closed by peer [host]:port``; a wedged one
#: past ``dist_timeout_s``: ``[.../unbound_buffer.cc:...] Timed out
#: waiting 3000ms for recv operation to complete``)
_GLOO_TRANSPORT = ("Connection closed by peer", "Connection reset",
                   "Timed out waiting", "Socket closed")
#: torch.distributed's own error types: the group store's and NCCL's
_DIST_STORE_TYPES = ("DistStoreError", "DistNetworkError")
_NCCL_TEXT = ("ncclRemoteError", "ncclSystemError", "ncclInternalError",
              "NCCL communicator", "Watchdog caught collective operation "
              "timeout", "was aborted")


def _reads_as_loss(exc: BaseException) -> bool:
    """True for the errors a peer's loss raises: gloo's transport
    errors (the text names gloo and a closed, reset or timed-out pair),
    the group store's (``DistStoreError``, ``DistNetworkError``),
    NCCL's communicator errors, and the ``mesh.replica`` fault site.
    Deliberately narrow: a plain ``ConnectionError`` of a data source or
    an HTTP dependency is not a replica's loss and must not start a
    rebuild loop."""
    text = f"{type(exc).__name__}: {exc}"
    kinds = {c.__name__ for c in type(exc).__mro__}
    if "mesh.replica" in text:
        return True
    if kinds.intersection(_DIST_STORE_TYPES):
        return True
    if "gloo" in text.lower() and any(m in text for m in _GLOO_TRANSPORT):
        return True
    return "NCCL" in text and ("DistBackendError" in kinds
                               or any(m in text for m in _NCCL_TEXT))


def classify_failure(exc: BaseException,
                     member: Optional[ElasticMember],
                     confirm_s: float = 5.0) -> Optional[ReplicaLossError]:
    """A collective's failure as :class:`ReplicaLossError`, or None when
    it is not a replica's loss (it is raised where it happened).

    A SIGKILLed peer surfaces as gloo's ``Connection closed by peer``
    within milliseconds, before the liveness monitor evicts it: wait up
    to ``confirm_s`` for the monitor to agree, then classify."""
    if isinstance(exc, ReplicaLossError):
        return exc
    if member is None or not _reads_as_loss(exc):
        return None
    text = f"{type(exc).__name__}: {exc}"
    confirmed = member.lost_event.wait(timeout=confirm_s)
    plan = member.pending_plan()
    return ReplicaLossError(
        f"collective failed ({text[:300]}); replica loss "
        + ("confirmed" if confirmed else "presumed"),
        lost=plan.lost_ranks if plan else (),
        generation=plan.generation if plan else 0,
        presumed=not confirmed,
        fatal=bool(member.abort_reason),
    )
