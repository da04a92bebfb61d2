"""Side-feature join iterator (``iter = attachtxt``).

Counterpart of ``cxxnet_tpu/io/attach_txt.py``: each line of
``attach_file`` (or ``filename``) is ``inst_index v1 .. vk``; every batch
of the iterator below gets one more ``extra_data`` matrix ``(N, k)``,
row ``i`` the features of instance ``inst_index[i]`` (zeros for an
instance the file does not list).  Every other field of the batch,
the CSR part included, passes through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .data import DataBatch, DataIter


class AttachTxtIterator(DataIter):
    def supports_dist_shard(self) -> bool:
        return self.base.supports_dist_shard()

    def __init__(self, base: DataIter) -> None:
        self.base = base
        self.filename = ""
        self.silent = 0
        self._table: Dict[int, np.ndarray] = {}
        self._width = 0
        self._cur: Optional[DataBatch] = None

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name in ("attach_file", "filename"):
            self.filename = val
        elif name == "silent":
            self.silent = int(val)

    def init(self):
        self.base.init()
        if not self.filename:
            raise ValueError("AttachTxtIterator: must set attach_file")
        with open(self.filename, "r", encoding="utf-8") as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                self._table[int(float(toks[0]))] = np.asarray(
                    [float(t) for t in toks[1:]], np.float32)
        self._width = (len(next(iter(self._table.values())))
                       if self._table else 0)
        if not self.silent:
            print(f"AttachTxtIterator: {len(self._table)} rows, "
                  f"width={self._width}")

    def before_first(self):
        self.base.before_first()

    def next(self) -> bool:
        if not self.base.next():
            return False
        b = self.base.value()
        extra = np.zeros((b.batch_size, self._width), np.float32)
        if b.inst_index is not None:
            for i, idx in enumerate(b.inst_index):
                row = self._table.get(int(idx))
                if row is not None:
                    extra[i] = row
        self._cur = dataclasses.replace(b, extra_data=b.extra_data + [extra])
        return True

    def value(self) -> DataBatch:
        if self._cur is None:
            raise RuntimeError("AttachTxtIterator: value() before next()")
        return self._cur

    def close(self) -> None:
        self.base.close()
