"""``task = serve`` over a device range: one engine, its forwards split
over the ranks.

The JAX package serves a device range as one program: the engine's
forward is ``_run_sharded`` over the mesh.  The port runs one process
per device (``parallel/distributed.py``), so rank 0 (the leader) runs
the server, the batcher and the engine, and the other ranks (the
followers) only compute.  For every batch the engine forms, the leader
posts a header on the group's ``TCPStore`` (``cxn_serve/{seq}``: the
checkpoint the batch's trainer loaded, the node, the batch's shape and
its bucket), broadcasts the rows, and every rank runs its block of them
(``NetTrainer.run_sharded``); the blocks are all-gathered back in rank
order.  A follower waits for the next header by polling the store, not
inside a collective, so an idle server outlives ``dist_timeout_s``; it
loads the checkpoint a header names the first time it sees it (a reload
on the leader thus loads the same round on every rank) and keeps the
last two.  Each follower stamps ``cxn_serve/beat/{rank}`` every
``BEAT_S``; the leader's ``/healthz`` turns ``degraded``
(``range_follower_lost``) when a stamp stops moving for ``STALE_S``.
Ending the leader (SIGTERM) posts a ``stop`` header, which ends the
followers; a follower whose leader is gone (the store with it) exits
with an error.  A follower ignores SIGTERM for up to ``STALE_S`` while
it waits for the leader's ``stop``.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel import distributed as pdist

BEAT_S = 0.5
STALE_S = 5.0
_PREFIX = "cxn_serve/"

#: the leader of this process (rank 0 of a serving range), for /healthz
_LEADER: List[Optional["RangeLeader"]] = [None]


class RangeLeader:
    """Rank 0's side: ``announce`` before each sharded forward (under
    ``lock``, so the headers and the collectives keep one order)."""

    def __init__(self, store, world: int) -> None:
        self.store = store
        self.world = world
        self.lock = threading.Lock()
        self.seq = 0
        # follower -> (last stamp seen, when it last moved, locally)
        self._beats: Dict[int, tuple] = {}
        self._beat_lock = threading.Lock()

    def announce(self, trainer, node_id: int, data, pad_to) -> np.ndarray:
        """Post the header of the next forward and broadcast its rows;
        returns the rows every rank then holds (f32)."""
        data = np.ascontiguousarray(data, np.float32)
        if self.seq:
            self.store.delete_key(f"{_PREFIX}{self.seq - 1}")
        self.store.set(f"{_PREFIX}{self.seq}", json.dumps({
            "model": trainer.model_path, "node": int(node_id),
            "shape": list(data.shape),
            "pad_to": None if pad_to is None else int(pad_to)}))
        self.seq += 1
        t = torch.from_numpy(data).to(pdist._comm_device())
        pdist.broadcast_(t, 0)
        return data

    def stop(self) -> None:
        """Tell the followers to end (after the last forward)."""
        with self.lock:
            self.store.set(f"{_PREFIX}{self.seq}", json.dumps({"stop": True}))
            self.seq += 1

    def lost(self) -> List[int]:
        """The followers whose beat has not moved for ``STALE_S``."""
        now = time.monotonic()
        out = []
        with self._beat_lock:
            for r in range(1, self.world):
                try:
                    stamp = self.store.get(f"{_PREFIX}beat/{r}")
                except Exception:  # noqa: BLE001 - no stamp (yet): lost
                    stamp = b""
                last, moved = self._beats.get(r, (None, now))
                if stamp != last:
                    moved = now
                self._beats[r] = (stamp, moved)
                if not stamp or now - moved > STALE_S:
                    out.append(r)
        return out


def start_leader(world: int) -> RangeLeader:
    """Make this process the serving range's leader: every forward of
    the serving cache (:func:`forward_of`) goes through it."""
    leader = RangeLeader(pdist.store(), world)
    _LEADER[0] = leader
    return leader


def end_leader() -> None:
    leader, _LEADER[0] = _LEADER[0], None
    if leader is not None:
        leader.stop()


def forward_of(trainer, node_id: Optional[int]):
    """The serving cache's forward of node ``node_id`` (None: the
    output): ``trainer.predict_fn(node_id)``, on a serving range's
    leader under its ``lock`` and after the header and the rows that
    set the followers on the same batch (``RangeLeader.announce``)."""
    f = trainer.predict_fn(node_id)
    leader = _LEADER[0]
    if leader is None:
        return f
    node = trainer.net.out_node_index() if node_id is None else node_id

    def announced(params, aux, data, extras=(), pad_to=None):
        with leader.lock:
            data = leader.announce(trainer, node, data, pad_to)
            return f(params, aux, data, extras, pad_to)

    return announced


def health_reasons() -> List[str]:
    """``range_follower_lost`` while a follower of this leader is
    silent (``/healthz``); nothing outside a serving range."""
    leader = _LEADER[0]
    if leader is None or leader.world < 2:
        return []
    return ["range_follower_lost"] if leader.lost() else []


def follow(make_trainer: Callable[[str], object], rank: int,
           silent: bool = False) -> int:
    """A follower's loop: beat, wait for the next header, run its block
    of the batch on the trainer of the checkpoint it names
    (``make_trainer(path)``), until the leader's ``stop``.  Returns 0
    on ``stop``; raises when the leader is gone."""
    store = pdist.store()
    done = threading.Event()
    termed = [0.0]

    def beat():
        n = 0
        while not done.is_set():
            try:
                store.set(f"{_PREFIX}beat/{rank}", str(n))
            except Exception:  # noqa: BLE001 - the leader's store is gone
                return
            n += 1
            done.wait(BEAT_S)

    def on_term(signum, frame):
        termed[0] = time.monotonic()

    threading.Thread(target=beat, daemon=True, name="range-beat").start()
    prev = {}
    if threading.current_thread() is threading.main_thread():
        prev = {s: signal.signal(s, on_term)
                for s in (signal.SIGTERM, signal.SIGINT)}
    trainers: Dict[str, object] = {}
    seq, forwards = 0, 0
    try:
        while True:
            key = f"{_PREFIX}{seq}"
            wait = 0.0005
            while not store.check([key]):
                if termed[0] and time.monotonic() - termed[0] > STALE_S:
                    raise RuntimeError(
                        "serving range: SIGTERM and no stop from the "
                        "leader")
                time.sleep(wait)
                wait = min(wait * 2, 0.02)
            hdr = json.loads(store.get(key))
            seq += 1
            if hdr.get("stop"):
                break
            path = hdr["model"]
            if path not in trainers:
                if len(trainers) >= 2:
                    trainers.pop(next(iter(trainers)))
                trainers[path] = make_trainer(path)
                if not silent:
                    print(f"serving range: rank {rank} loaded {path}",
                          flush=True)
            tr = trainers[path]
            t = torch.empty(hdr["shape"], dtype=torch.float32,
                            device=pdist._comm_device())
            pdist.broadcast_(t, 0)
            tr.run_sharded(hdr["node"], t.cpu().numpy(), (), hdr["pad_to"])
            forwards += 1
    finally:
        done.set()
        for s, h in prev.items():
            signal.signal(s, h)
    if not silent:
        print(f"serving range: rank {rank} stopped after {forwards} "
              "forward(s)", flush=True)
    return 0
