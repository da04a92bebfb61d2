"""LibSVM-format sparse iterator (``iter = libsvm``): CSR batches.

Counterpart of ``cxxnet_tpu/io/libsvm.py``.  One instance a line,
``label idx:val idx:val ...`` (0-based feature indices; ``label`` may be
``l1,l2,..`` up to ``label_width``).  Each batch carries its rows in CSR
form (``sparse_row_ptr``, ``sparse_index``, ``sparse_value``) and, with
``densify = 1`` (the default), the dense ``(N, num_feature)`` matrix as
``data`` for the net (``num_feature`` 0: the largest index + 1).  The
last batch is always full size: ``round_batch = 1`` (the default) wraps
to the head of the data, 0 repeats the last row; ``num_batch_padd``
counts those rows.  A row that does not parse is skipped and written to
the ``.quarantine`` sidecar under ``max_bad_records``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils import faults
from ..utils.faults import BadRecordBudget, RetryPolicy
from .data import DataBatch, DataIter


class LibSVMIterator(DataIter):
    """In-memory CSR source over a libsvm text file."""

    def __init__(self) -> None:
        self.path: Optional[str] = None
        self.batch_size = 0
        self.num_feature = 0
        self.label_width = 1
        self.round_batch = 1
        self.densify = 1
        self.silent = 0
        self.max_bad_records = 0
        self.quarantine_dir = ""
        self._retry_cfg: List = []
        self._budget: Optional[BadRecordBudget] = None
        self._row_ptr: Optional[np.ndarray] = None
        self._index: Optional[np.ndarray] = None
        self._value: Optional[np.ndarray] = None
        self._label: Optional[np.ndarray] = None
        self._at = 0
        self._batch: Optional[DataBatch] = None

    def set_param(self, name: str, val: str) -> None:
        if name in ("data_path", "path", "data"):
            self.path = val
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "num_feature":
            self.num_feature = int(val)
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "round_batch":
            self.round_batch = int(val)
        elif name == "densify":
            self.densify = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "max_bad_records":
            self.max_bad_records = int(val)
        elif name == "quarantine_dir":
            self.quarantine_dir = val
        elif name in RetryPolicy.CONFIG_KEYS:
            self._retry_cfg.append((name, val))

    def init(self) -> None:
        if not self.path:
            raise ValueError("libsvm: data_path required")
        if self.batch_size <= 0:
            raise ValueError("libsvm: batch_size required")
        self._budget = BadRecordBudget(
            self.max_bad_records, what="libsvm", silent=bool(self.silent),
            quarantine_dir=self.quarantine_dir or None)
        row_ptr: List[int] = [0]
        idx: List[int] = []
        val: List[float] = []
        labels: List[List[float]] = []
        lines = faults.retried_read_lines(self.path, "libsvm.read",
                                          self._retry_cfg,
                                          silent=bool(self.silent))
        for lineno, line in enumerate(lines, start=1):
            line = faults.fault_point("libsvm.row", line)
            toks = line.split()
            if not toks:
                continue
            mark = len(idx)
            try:
                lab = [float(x)
                       for x in toks[0].split(",")][:self.label_width]
                for t in toks[1:]:
                    i, _, v = t.partition(":")
                    fi = int(i)
                    if fi < 0:
                        raise ValueError(f"negative feature index {fi}")
                    idx.append(fi)
                    val.append(float(v))
            except ValueError as e:
                del idx[mark:], val[mark:]  # the row's partial features
                self._budget.record(self.path, f"line{lineno}", e)
                continue
            labels.append(lab)
            row_ptr.append(len(idx))
        if self._budget.epoch_count and not self.silent:
            print(self._budget.summary(), flush=True)
        self._row_ptr = np.asarray(row_ptr, np.int64)
        self._index = np.asarray(idx, np.int32)
        self._value = np.asarray(val, np.float32)
        lab = np.zeros((len(labels), self.label_width), np.float32)
        for r, ls in enumerate(labels):
            lab[r, :len(ls)] = ls
        self._label = lab
        if self.num_feature == 0:
            self.num_feature = int(self._index.max()) + 1 if idx else 1

    @property
    def num_inst(self) -> int:
        return 0 if self._label is None else self._label.shape[0]

    def before_first(self) -> None:
        self._at = 0

    def next(self) -> bool:
        n = self.num_inst
        if self._at >= n:
            return False
        take = min(self.batch_size, n - self._at)
        rows = list(range(self._at, self._at + take))
        padd = 0
        if take < self.batch_size:
            padd = self.batch_size - take
            if self.round_batch:
                rows += [i % n for i in range(padd)]
            else:
                rows += [rows[-1]] * padd
        self._at += take
        self._batch = self._slice(rows, padd)
        return True

    def _slice(self, rows: List[int], padd: int) -> DataBatch:
        counts = self._row_ptr[1:] - self._row_ptr[:-1]
        row_ptr = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(counts[rows], out=row_ptr[1:])
        index = np.concatenate(
            [self._index[self._row_ptr[r]:self._row_ptr[r + 1]] for r in rows])
        value = np.concatenate(
            [self._value[self._row_ptr[r]:self._row_ptr[r + 1]] for r in rows])
        if self.densify:
            dense = np.zeros((len(rows), self.num_feature), np.float32)
            for k in range(len(rows)):
                lo, hi = row_ptr[k], row_ptr[k + 1]
                dense[k, index[lo:hi]] = value[lo:hi]
        else:
            dense = np.zeros((len(rows), 0), np.float32)
        return DataBatch(data=dense, label=self._label[rows],
                         inst_index=np.asarray(rows, np.int64),
                         num_batch_padd=padd, sparse_row_ptr=row_ptr,
                         sparse_index=index, sparse_value=value)

    def value(self) -> DataBatch:
        if self._batch is None:
            raise RuntimeError("libsvm: value() before next()")
        return self._batch
