"""CSV instance iterator (``iter = csv``, under ``BatchAdaptIterator``).

Counterpart of ``cxxnet_tpu/io/csv.py``: each row is ``label_width``
labels, then ``prod(input_shape)`` features, comma-separated;
``has_header = 1`` skips the first line and ``#`` starts a comment
(``np.loadtxt``'s rules).  An instance is flat when C and H are 1, else
an HWC image (the row holds it CHW).

The file read is retried under :class:`~..utils.faults.RetryPolicy`
(the ``retry_*`` keys).  With ``max_bad_records > 0`` a row that does
not parse (a bad number, the wrong column count) is skipped and written
to the ``.quarantine`` sidecar, and more than that many abort the read;
the default 0 reads with ``np.loadtxt``, and the first bad row aborts.
``dist_num_worker`` / ``dist_worker_rank`` keep this worker's equal
share of the rows (``rank::n``, ``data.shard_rows``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils import faults
from ..utils.faults import BadRecordBudget, RetryPolicy
from .batch import DataInst, InstIterator
from .data import shard_rows


class CSVIterator(InstIterator):
    def supports_dist_shard(self) -> bool:
        return True

    def __init__(self) -> None:
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.filename = ""
        self.label_width = 1
        self.has_header = 0
        self.silent = 0
        self.input_shape = (1, 1, 0)
        self.max_bad_records = 0
        self.quarantine_dir = ""
        self._retry_cfg: List[Tuple[str, str]] = []
        self._budget: Optional[BadRecordBudget] = None
        self._rows: Optional[np.ndarray] = None
        self._pos = 0

    def set_param(self, name, val):
        if name == "filename":
            self.filename = val
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "has_header":
            self.has_header = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "input_shape":
            c, h, w = (int(t) for t in val.split(","))
            self.input_shape = (c, h, w)
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        elif name == "max_bad_records":
            self.max_bad_records = int(val)
        elif name == "quarantine_dir":
            self.quarantine_dir = val
        elif name in RetryPolicy.CONFIG_KEYS:
            self._retry_cfg.append((name, val))

    def _load_strict(self, want: int) -> np.ndarray:
        """``np.loadtxt``'s reader: the first bad row aborts."""
        def _read():
            faults.fault_point("csv.read")
            return np.loadtxt(self.filename, delimiter=",",
                              skiprows=1 if self.has_header else 0,
                              dtype=np.float32, ndmin=2)

        rows = RetryPolicy.from_cfg(self._retry_cfg).run(
            _read, what=f"reading {self.filename}", silent=bool(self.silent))
        if rows.shape[1] != want:
            raise ValueError(
                f"CSVIterator: row has {rows.shape[1]} columns, expected "
                f"{want} (label_width + input size)")
        return rows

    def _load_tolerant(self, want: int) -> np.ndarray:
        """Row by row, a bad row skipped and quarantined under the
        budget."""
        lines = faults.retried_read_lines(
            self.filename, "csv.read", self._retry_cfg,
            silent=bool(self.silent))
        parsed: List[np.ndarray] = []
        for lineno, line in enumerate(lines, start=1):
            if self.has_header and lineno == 1:
                continue
            line = line.split("#", 1)[0]
            if not line.strip():
                continue
            line = faults.fault_point("csv.row", line)
            try:
                row = np.asarray([float(t) for t in line.strip().split(",")],
                                 np.float32)
                if row.shape[0] != want:
                    raise ValueError(
                        f"row has {row.shape[0]} columns, expected {want} "
                        "(label_width + input size)")
            except ValueError as e:
                self._budget.record(self.filename, f"line{lineno}", e)
                continue
            parsed.append(row)
        if not parsed:
            raise ValueError(f"CSVIterator: {self.filename} has no usable rows")
        return np.stack(parsed)

    def init(self):
        c, h, w = self.input_shape
        if c * h * w <= 0:
            raise ValueError("CSVIterator: input_shape must be set")
        want = self.label_width + c * h * w
        self._budget = BadRecordBudget(
            self.max_bad_records, what="csv", silent=bool(self.silent),
            quarantine_dir=self.quarantine_dir or None)
        # per-row reading only where a row can be skipped or corrupted
        if (self.max_bad_records == 0
                and not faults.injector().armed("csv.row")):
            self._rows = self._load_strict(want)
        else:
            self._rows = self._load_tolerant(want)
        if self.dist_num_worker > 1:
            self._rows = self._rows[shard_rows(
                len(self._rows), self.dist_worker_rank,
                self.dist_num_worker)]
        if not self.silent:
            print(f"CSVIterator: filename={self.filename}, "
                  f"{len(self._rows)} rows")
            if self._budget.epoch_count:
                print(self._budget.summary(), flush=True)

    def before_first(self):
        self._pos = 0

    def next(self) -> bool:
        if self._rows is None:
            raise RuntimeError("CSVIterator: init() not called")
        if self._pos < len(self._rows):
            self._pos += 1
            return True
        return False

    def value(self) -> DataInst:
        row = self._rows[self._pos - 1]
        c, h, w = self.input_shape
        feats = row[self.label_width:]
        data = (feats.reshape(-1) if (c == 1 and h == 1)
                else feats.reshape(c, h, w).transpose(1, 2, 0))
        return DataInst(index=self._pos - 1, data=data,
                        label=row[:self.label_width])
