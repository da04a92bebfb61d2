"""Byte-level text iterator for language modeling.

Counterpart of ``cxxnet_tpu/io/text.py``.  ``iter = text`` config keys:

* ``filename`` — text or binary file; tokens are raw bytes (vocab 256)
* ``seq_len`` — window length T; each instance is ``T`` input ids with
  the next byte at every position as the label (``label_width = T``)
* ``batch_size``
* ``stride`` — window start spacing (default ``seq_len``)
* ``shuffle`` / ``seed_data`` — one-shot window shuffle with
  ``np.random.RandomState(42 + seed_data)``, so the windows come out in
  the JAX package's order
* ``dist_num_worker`` / ``dist_worker_rank`` — equal-truncated window
  sharding: worker ``rank`` takes windows ``rank::nworker`` truncated to
  ``n // nworker``, so every worker takes the same number of steps
* ``round_batch`` — the final partial batch wraps to the leading
  windows and flags them as padding (``num_batch_padd``); 0 drops it

Emits ``data (N, T)`` and ``label (N, T)`` float32 byte ids.  The file
is read through ``RetryPolicy`` (the ``retry_*`` keys) and the
``text.read`` fault site, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import faults
from ..utils.faults import RetryPolicy
from .data import DataBatch, DataIter


class TextIterator(DataIter):
    def supports_dist_shard(self) -> bool:
        return True

    def __init__(self) -> None:
        self.filename = ""
        self.seq_len = 0
        self.batch_size = 0
        self.stride = 0
        self.shuffle = 0
        self.seed = 0
        self.silent = 0
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.round_batch = 1
        self._raw: Optional[np.ndarray] = None
        self._starts: Optional[np.ndarray] = None
        self._loc = 0
        self._padd = 0
        self._retry_cfg: list = []

    def set_param(self, name, val):
        if name == "filename":
            self.filename = val
        elif name == "seq_len":
            self.seq_len = int(val)
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "stride":
            self.stride = int(val)
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        elif name == "round_batch":
            self.round_batch = int(val)
        elif name in RetryPolicy.CONFIG_KEYS:
            self._retry_cfg.append((name, val))

    def init(self):
        if self.seq_len <= 0 or self.batch_size <= 0:
            raise ValueError("text: set seq_len and batch_size")

        def _read():
            faults.fault_point("text.read")
            with open(self.filename, "rb") as f:
                return np.frombuffer(f.read(), np.uint8)

        raw = RetryPolicy.from_cfg(self._retry_cfg).run(
            _read, what=f"reading {self.filename}",
            silent=bool(self.silent))
        t = self.seq_len
        stride = self.stride or t
        starts = np.arange(0, len(raw) - t, stride, dtype=np.int64)
        if len(starts) == 0:
            raise ValueError(
                f"text: {self.filename} has {len(raw)} bytes, need more "
                f"than seq_len={t}")
        if self.shuffle:
            rng = np.random.RandomState(42 + self.seed)
            starts = starts[rng.permutation(len(starts))]
        if self.dist_num_worker > 1:
            per = len(starts) // self.dist_num_worker
            if per == 0:
                raise ValueError(f"text: cannot shard {len(starts)} windows "
                                 f"over {self.dist_num_worker} workers")
            starts = starts[self.dist_worker_rank::self.dist_num_worker][:per]
        # windows are cut per batch in value(): only the bytes and the
        # start offsets are kept
        self._raw = raw
        self._starts = starts
        if not self.silent:
            print(f"TextIterator: {self.filename}: {len(raw)} bytes -> "
                  f"{len(starts)} windows of T={t}")

    def before_first(self):
        self._loc = 0
        self._padd = 0

    def next(self) -> bool:
        assert self._raw is not None, "init() not called"
        n = len(self._starts)
        if self._loc + self.batch_size <= n:
            self._loc += self.batch_size
            self._padd = 0
            return True
        if self.round_batch and self._loc < n:
            # final partial batch: wrap to fill, flag the padding
            self._padd = self._loc + self.batch_size - n
            self._loc = n
            return True
        return False

    def value(self) -> DataBatch:
        lo, hi = self._loc - self.batch_size + self._padd, self._loc
        t = self.seq_len
        take = self._starts[lo:hi]
        if self._padd:
            take = np.concatenate([take, self._starts[: self._padd]])
        idx = take[:, None] + np.arange(t + 1)[None, :]
        win = self._raw[idx].astype(np.float32)
        # inst_index mirrors `take`: wrapped pad rows reuse the leading ids
        inst = np.arange(lo, hi, dtype=np.uint32)
        if self._padd:
            inst = np.concatenate([inst, np.arange(self._padd,
                                                   dtype=np.uint32)])
        return DataBatch(data=win[:, :-1], label=win[:, 1:], inst_index=inst,
                         num_batch_padd=self._padd)
