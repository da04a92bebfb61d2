"""Replica voting over state fingerprints, and the shadow-step audit.

The port's copy of ``cxxnet_tpu/integrity/plane.py``.  Every
``integrity_every`` rounds the trainer's live state — params and, under
``save_ustate``, the updater state (``ust:`` leaves) — is digested per
leaf with :mod:`.fingerprint` on the device that holds it, and the
digests are voted within each (leaf, slice) replica group.  A strict
majority names the corrupt minority replica; the verdict is a typed
:class:`IntegrityError{rank, tensor, kind}`.  There is no tolerance
knob: any disagreement is corruption.

One process holds one replica of every leaf, so its groups are
single-replica and the vote is always clean, as in the JAX package on
one process.  In a data-parallel group the digest blocks are
all-gathered (the JAX package's ``process_allgather``; every rank holds
the same leaves in the same order), and every rank recomputes its
peers' (leaf, slice) keys from the trainer's placement
(``NetTrainer.held_slice``: a leaf cut over the model ranks, or under
``zero`` over the data ranks, is digested as the rank's slice, its own
group), so a flipped bit on one of three replicas names its rank.

The **shadow-step audit** guards compute rather than state: the
trainer's ``shadow_step`` runs the sampled round's grad step twice on
one probe batch, each leg from a fresh forward and freshly prepared
operands, and compares the loss and every gradient byte for byte; a
mismatch is ``kind="shadow"``.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from .fingerprint import Digest, digest_array, digest_tensor


class IntegrityError(RuntimeError):
    """Silent-data-corruption verdict.

    ``rank`` is the corrupt process index when the vote named one
    (None = ambiguous or local-only), ``tensor`` the first disagreeing
    leaf, ``kind`` one of ``state`` (fingerprint vote), ``shadow``
    (grad-program re-execution mismatch), ``canary`` (serve golden
    probe mismatch)."""

    def __init__(self, message: str, *, kind: str = "state",
                 rank: Optional[int] = None,
                 tensor: Optional[str] = None) -> None:
        super().__init__(message)
        self.kind = kind
        self.rank = rank
        self.tensor = tensor


def _slice_key(index) -> tuple:
    return tuple(
        (s.start, s.stop, s.step) if isinstance(s, slice) else s
        for s in index
    )


def _leaves(trainer):
    """(name, array) over params + updater state, in the sorted order
    every rank reproduces independently (the allgather contract)."""
    for key in sorted(trainer.params):
        for tag in sorted(trainer.params[key]):
            yield f"{key}/{tag}", trainer.params[key][tag]
    if trainer.save_ustate and trainer.ustates:
        for key in sorted(trainer.ustates):
            for tag in sorted(trainer.ustates[key]):
                slots = trainer.ustates[key][tag]
                for slot in sorted(slots):
                    yield f"ust:{key}/{tag}@{slot}", slots[slot]


def _leaf_key(trainer, name: str, shape, rank: int) -> tuple:
    """``(leaf_name, slice_key)`` of rank ``rank``'s copy of a leaf: the
    full extent, or the rank's slice of a leaf cut over the ranks."""
    held = _held(trainer, name, shape, rank)
    if held is None:
        return name, _slice_key(tuple(slice(0, s, None) for s in shape))
    return name, _slice_key(held[0])


def _held(trainer, name: str, shape, rank: int):
    """``(index, whole shape)`` of rank ``rank``'s slice of a cut leaf,
    None for a whole one (``NetTrainer.held_slice``)."""
    held = getattr(trainer, "held_slice", None)
    return held(name, shape, rank) if held is not None else None


def local_fingerprints(trainer, rank: int = 0
                       ) -> Tuple[List[Digest], List[tuple]]:
    """Digest every leaf on its device.  Returns (rows, keys) where
    ``keys[i] = (leaf_name, slice_key)``: the slice of the whole leaf
    that rank ``rank`` holds.  A slice is digested at its place in the
    whole leaf, as the JAX package digests a shard, so the digests of
    one replica of every slice combine (``combine_digests``) into the
    whole leaf's."""
    rows: List[Digest] = []
    keys: List[tuple] = []
    for name, arr in _leaves(trainer):
        torch_leaf = hasattr(arr, "element_size")
        a = arr if torch_leaf else np.asarray(arr)
        shape = tuple(int(s) for s in a.shape)
        held = _held(trainer, name, shape, rank)
        index, whole = held if held is not None else (None, None)
        rows.append(digest_tensor(a, index=index, shape=whole) if torch_leaf
                    else digest_array(a, index=index, shape=whole))
        keys.append(_leaf_key(trainer, name, shape, rank))
    return rows, keys


def vote(groups: Dict[tuple, List[Tuple[int, Digest]]]) -> List[dict]:
    """Majority vote within every (leaf, slice) replica group.

    ``groups[key]`` is ``[(rank, digest), ...]``.  Returns findings:
    one dict per disagreeing group with the named corrupt ``rank``
    (the strict-minority holder) or ``rank=None`` when the group is
    too small or too split to name one (2-way ties, 2-replica groups).
    Single-replica groups are unvotable and always clean."""
    findings: List[dict] = []
    for (name, _sk), members in sorted(groups.items()):
        if len(members) < 2:
            continue
        counts = collections.Counter(d for _r, d in members)
        if len(counts) == 1:
            continue
        top, top_n = counts.most_common(1)[0]
        if top_n * 2 > len(members):
            bad = sorted({r for r, d in members if d != top})
            findings.append({
                "tensor": name,
                "ranks": bad,
                "rank": bad[0] if len(bad) == 1 else None,
                "replicas": len(members),
            })
        else:
            findings.append({
                "tensor": name,
                "ranks": sorted({r for r, _d in members}),
                "rank": None,
                "replicas": len(members),
            })
    return findings


def check_state(trainer) -> dict:
    """One fingerprint sweep + vote.  Returns the verdict dict
    ``{"clean": bool, "findings": [...], "replicas": int,
    "elapsed_s": float}``."""
    from ..parallel import distributed

    t0 = time.perf_counter()
    rank, world = distributed.process_info()
    rows, keys = local_fingerprints(trainer, rank)
    groups: Dict[tuple, List[Tuple[int, Digest]]] = {}
    if world > 1:
        block = distributed.gather_host(np.asarray(rows, np.int64))
        names = [(name, tuple(arr.shape)) for name, arr in _leaves(trainer)]
        for p in range(world):
            for (name, shape), d in zip(names, block[p]):
                groups.setdefault(_leaf_key(trainer, name, shape, p),
                                  []).append((p, (int(d[0]), int(d[1]))))
    else:
        for k, d in zip(keys, rows):
            groups.setdefault(k, []).append((rank, d))
    findings = vote(groups)
    return {
        "clean": not findings,
        "findings": findings,
        "replicas": max((len(g) for g in groups.values()), default=1),
        "elapsed_s": time.perf_counter() - t0,
    }


class IntegrityPlane:
    """Round-boundary integrity checks: cadence, metrics, events, and
    the typed verdict.  One instance per LearnTask; survives trainer
    rebuilds (the trainer is passed per call)."""

    def __init__(self, every: int = 0, shadow: int = 0) -> None:
        self.every = int(every)
        self.shadow = int(shadow)
        #: newest round whose post-round state passed the vote — the
        #: quarantine rollback bound (survivors must NOT resume from a
        #: checkpoint the corrupt rank's gradients already poisoned)
        self.last_clean_round: Optional[int] = None
        self.checks = 0
        self.last_elapsed_s = 0.0

    def due(self, round_: int) -> bool:
        return self.every > 0 and (round_ + 1) % self.every == 0

    # ------------------------------------------------------------------
    def _count(self, kind: str, verdict: str) -> None:
        obs_registry().counter(
            "integrity_checks_total",
            "Integrity-plane checks by kind and verdict.",
            labelnames=("kind", "verdict"),
        ).labels(kind=kind, verdict=verdict).inc()
        if verdict != "clean":
            obs_registry().counter(
                "integrity_failures_total",
                "Integrity-plane corruption verdicts.",
                labelnames=("kind",),
            ).labels(kind=kind).inc()

    def _fail(self, kind: str, round_: int, *, rank=None, tensor=None,
              detail: str = "") -> IntegrityError:
        self._count(kind, "corrupt")
        obs_registry().gauge(
            "integrity_corrupt_rank",
            "Process index named corrupt by the last vote (-1 none).",
        ).set(-1 if rank is None else rank)
        obs_events.emit("integrity.detect", kind=kind, round=round_,
                        rank=rank, tensor=tensor, detail=detail)
        return IntegrityError(
            f"integrity {kind} check failed at round {round_}: "
            f"{detail or 'replica digests disagree'}"
            + (f" (corrupt rank {rank})" if rank is not None else "")
            + (f" tensor {tensor}" if tensor else ""),
            kind=kind, rank=rank, tensor=tensor)

    # ------------------------------------------------------------------
    def check_round(self, trainer, round_: int) -> Optional[dict]:
        """Run the due checks for ``round_``; raises
        :class:`IntegrityError` on a corruption verdict, updates
        ``last_clean_round`` and emits ``integrity.clean`` otherwise."""
        if not self.due(round_):
            return None
        self.checks += 1
        verdict = check_state(trainer)
        self.last_elapsed_s = verdict["elapsed_s"]
        if not verdict["clean"]:
            f = verdict["findings"][0]
            raise self._fail(
                "state", round_, rank=f["rank"], tensor=f["tensor"],
                detail=(f"{len(verdict['findings'])} tensor(s) disagree, "
                        f"first {f['tensor']} ranks {f['ranks']} "
                        f"({f['replicas']} replicas)"))
        self._count("state", "clean")
        if self.shadow:
            mismatch = trainer.shadow_step(round_)
            if mismatch is not None:
                raise self._fail("shadow", round_,
                                 tensor=mismatch.get("tensor"),
                                 detail=mismatch.get("detail", ""))
            self._count("shadow", "clean")
        self.last_clean_round = round_
        obs_registry().gauge(
            "integrity_corrupt_rank",
            "Process index named corrupt by the last vote (-1 none).",
        ).set(-1)
        obs_events.emit("integrity.clean", round=round_,
                        elapsed_s=round(verdict["elapsed_s"], 6),
                        replicas=verdict["replicas"])
        return verdict

    def snapshot(self) -> dict:
        """Telemetry block for the round record."""
        return {
            "every": self.every,
            "checks": self.checks,
            "last_clean_round": self.last_clean_round,
            "last_elapsed_s": round(self.last_elapsed_s, 6),
        }
