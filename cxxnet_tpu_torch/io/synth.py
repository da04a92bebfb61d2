"""Synthetic data iterator (``iter = synthetic``).

The port's copy of ``cxxnet_tpu/io/synth.py``: a deterministic random
dataset in RAM, labelled by a fixed linear teacher over the inputs so
that a model can learn it.  The stream is the JAX package's exactly
(``np.random.RandomState(1234 + seed_data)``: the data first, then the
teacher), so both packages train on the same rows.

Config keys: ``nsample`` (default 512), ``input_shape`` (``C,H,W``),
``nclass`` (default 10), ``label_width`` (default 1; class id in column
0), ``batch_size`` (required), ``seed_data``, ``layout`` (``seq`` for
``(N, T, D)`` batches), ``dist_num_worker`` / ``dist_worker_rank``:
worker ``r > 0`` draws its own rows from ``RandomState(1234 + seed_data
+ 7919 r)`` labelled by the same teacher, and worker 0 keeps the
single-process stream.
"""

from __future__ import annotations

import numpy as np

from .data import DataBatch, DataIter


class SyntheticIterator(DataIter):
    def supports_dist_shard(self) -> bool:
        return True

    def __init__(self) -> None:
        self.nsample = 512
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.input_shape = (1, 1, 16)
        self.nclass = 10
        self.label_width = 1
        self.layout = "auto"
        self.batch_size = 0
        self.seed = 0
        self._loc = 0
        self._data: np.ndarray | None = None
        self._label: np.ndarray | None = None

    def set_param(self, name, val):
        if name == "nsample":
            self.nsample = int(val)
        elif name == "input_shape":
            z, y, x = (int(t) for t in val.split(","))
            self.input_shape = (z, y, x)
        elif name == "nclass":
            self.nclass = int(val)
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "batch_size":
            self.batch_size = int(val)
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "layout":
            self.layout = val
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)

    def init(self):
        if self.batch_size <= 0:
            raise ValueError("SyntheticIterator: batch_size must be set")
        rng = np.random.RandomState(1234 + self.seed)
        c, h, w = self.input_shape
        if self.layout == "seq":
            shape = (self.nsample, h, w)
        elif c == 1 and h == 1:
            shape = (self.nsample, w)
        else:
            shape = (self.nsample, h, w, c)
        self._data = rng.randn(*shape).astype(np.float32)
        flat = self._data.reshape(self.nsample, -1)
        teacher = rng.randn(flat.shape[1], self.nclass).astype(np.float32)
        if self.dist_num_worker > 1 and self.dist_worker_rank > 0:
            rng_k = np.random.RandomState(
                1234 + self.seed + 7919 * self.dist_worker_rank)
            self._data = rng_k.randn(*shape).astype(np.float32)
            flat = self._data.reshape(self.nsample, -1)
        cls = (flat @ teacher).argmax(-1).astype(np.float32)
        lab = np.zeros((self.nsample, self.label_width), np.float32)
        lab[:, 0] = cls
        self._label = lab

    def before_first(self):
        self._loc = 0

    def next(self) -> bool:
        if self._data is None:
            raise RuntimeError("SyntheticIterator: init() not called")
        if self._loc + self.batch_size <= self.nsample:
            self._loc += self.batch_size
            return True
        return False

    def value(self) -> DataBatch:
        lo, hi = self._loc - self.batch_size, self._loc
        return DataBatch(
            data=self._data[lo:hi],
            label=self._label[lo:hi],
            inst_index=np.arange(lo, hi, dtype=np.uint32),
        )
