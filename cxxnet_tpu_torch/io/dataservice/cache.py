"""Bounded decoded-chunk LRU for the data service.

The port's copy of ``cxxnet_tpu/io/dataservice/cache.py``.

One server feeding N tenants on the same dataset decodes each block
once; the other N-1 reads should be memory reads.  Keys are
``(dataset_fingerprint, epoch, global_block)`` — the exact coordinates
the deterministic stream is addressed by — so a hit is *bitwise* the
batch a miss would have produced, and a fingerprint change (the data
files moved under the server) can never serve stale bytes.

Entries are defensive copies: iterator chains reuse staging buffers
between ``next()`` calls, so caching the live views would let block
k+1's decode scribble over block k's cached rows.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np


class CachedBlock:
    """One decoded block: immutable arrays + padding count."""

    __slots__ = ("data", "label", "inst_index", "num_batch_padd", "nbytes")

    def __init__(self, data: np.ndarray, label: np.ndarray,
                 inst_index: Optional[np.ndarray],
                 num_batch_padd: int) -> None:
        self.data = np.array(data, dtype=np.float32, copy=True)
        self.label = np.array(label, dtype=np.float32, copy=True)
        self.inst_index = (None if inst_index is None
                           else np.array(inst_index, dtype=np.uint32,
                                         copy=True))
        self.num_batch_padd = int(num_batch_padd)
        self.nbytes = (self.data.nbytes + self.label.nbytes
                       + (0 if self.inst_index is None
                          else self.inst_index.nbytes))
        for a in (self.data, self.label, self.inst_index):
            if a is not None:
                a.setflags(write=False)


class ChunkCache:
    """Thread-safe byte-bounded LRU.  ``max_bytes = 0`` disables the
    cache entirely (every get misses, puts are dropped) — the server
    still works, it just decodes per request."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._od: "OrderedDict[Tuple, CachedBlock]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple, record: bool = True) -> Optional[CachedBlock]:
        """Lookup; ``record=False`` leaves the hit/miss counters to the
        caller (the server probes twice per miss — lock-free, then
        under the plant lock — but must account each deal exactly
        once so the reported hit rate stays truthful)."""
        with self._lock:
            blk = self._od.get(key)
            if blk is None:
                if record:
                    self.misses += 1
                return None
            self._od.move_to_end(key)
            if record:
                self.hits += 1
            return blk

    def note_hit(self) -> None:
        with self._lock:
            self.hits += 1

    def note_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def put(self, key: Tuple, blk: CachedBlock) -> None:
        if self.max_bytes <= 0 or blk.nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._od.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._od[key] = blk
            self.bytes += blk.nbytes
            while self.bytes > self.max_bytes and self._od:
                _, victim = self._od.popitem(last=False)
                self.bytes -= victim.nbytes
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._od),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
            }
