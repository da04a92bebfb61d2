"""In-RAM batch cache (``iter = membuffer``).

Counterpart of ``cxxnet_tpu/io/membuffer.py``: at ``init`` it reads the
first ``max_nbatch`` batches of the iterator below it (all of them when
0) and replays them every epoch; small-sample overfit runs use it.
"""

from __future__ import annotations

from typing import List

from .data import DataBatch, DataIter


class MemBufferIterator(DataIter):
    def supports_dist_shard(self) -> bool:
        return self.base.supports_dist_shard()

    def __init__(self, base: DataIter) -> None:
        self.base = base
        self.max_nbatch = 0  # 0 = cache everything
        self.silent = 0
        self._cache: List[DataBatch] = []
        self._pos = 0

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == "max_nbatch":
            self.max_nbatch = int(val)
        elif name == "silent":
            self.silent = int(val)

    def init(self):
        self.base.init()
        self.base.before_first()
        while self.base.next():
            self._cache.append(self.base.value())
            if self.max_nbatch and len(self._cache) >= self.max_nbatch:
                break
        if not self.silent:
            print(f"MemBufferIterator: cached {len(self._cache)} batches")

    def before_first(self):
        self._pos = 0

    def next(self) -> bool:
        if self._pos < len(self._cache):
            self._pos += 1
            return True
        return False

    def value(self) -> DataBatch:
        return self._cache[self._pos - 1]

    def close(self) -> None:
        self.base.close()
