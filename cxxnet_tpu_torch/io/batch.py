"""Instances collated into batches, with round-batch semantics.

The port's copy of ``cxxnet_tpu/io/batch.py``:

* ``BatchAdaptIterator`` collates the ``DataInst`` of the instance
  iterator below it into batches of ``batch_size`` (NHWC float32, or
  flat ``(N, D)`` when the input shape's C and H are 1);
* ``round_batch = 1``: the short last batch wraps to the head of the
  data, ``num_batch_padd`` counts the wrapped instances, and the next
  epoch continues from the wrap point instead of rewinding;
* ``round_batch = 0``: the short batch is padded with what the buffer
  held, ``num_batch_padd`` counts the missing rows;
* ``test_skipread = 1``: after the first batch ``next()`` returns the
  same batch again without reading (the input's speed alone).

When the batch layer continues an epoch from its wrap point it calls
``resume_epoch()`` down the chain in place of ``before_first()``: the
augmenter takes a pending epoch anchor there (``io/augment.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..utils.profiler import pipeline_stats
from .data import DataBatch, DataIter


@dataclasses.dataclass
class DataInst:
    """One instance."""

    index: int
    data: np.ndarray     # HWC image or flat vector
    label: np.ndarray    # (label_width,)


class InstIterator:
    """The instance-level iterator protocol."""

    def supports_dist_shard(self) -> bool:
        """See ``data.DataIter.supports_dist_shard``."""
        return False

    def set_param(self, name: str, val: str) -> None:
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def resume_epoch(self) -> None:
        """The batch layer goes on from its wrap point instead of
        rewinding; wrappers pass it down."""

    def next(self) -> bool:
        raise NotImplementedError

    def value(self) -> DataInst:
        raise NotImplementedError

    def close(self) -> None:
        """Release resources; wrappers delegate down the chain."""


class BatchAdaptIterator(DataIter):
    def supports_dist_shard(self) -> bool:
        return self.base.supports_dist_shard()

    def __init__(self, base: InstIterator) -> None:
        self.base = base
        self.batch_size = 0
        self.label_width = 1
        self.round_batch = 0
        self.test_skipread = 0
        self._shape: Optional[tuple] = None  # (C, H, W)
        self._num_overflow = 0
        self._t_build = 0.0
        self._head = 1
        self._out: Optional[DataBatch] = None

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "label_width":
            self.label_width = int(val)
        elif name == "round_batch":
            self.round_batch = int(val)
        elif name == "test_skipread":
            self.test_skipread = int(val)
        elif name == "input_shape":
            c, h, w = (int(t) for t in val.split(","))
            self._shape = (c, h, w)

    def init(self):
        if self.batch_size <= 0:
            raise ValueError("BatchAdaptIterator: batch_size must be set")
        if self._shape is None:
            raise ValueError("BatchAdaptIterator: input_shape must be set")
        self.base.init()
        c, h, w = self._shape
        dshape = ((self.batch_size, w) if (c == 1 and h == 1)
                  else (self.batch_size, h, w, c))
        self._data = np.zeros(dshape, np.float32)
        self._label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        self._inst = np.zeros(self.batch_size, np.uint32)

    def before_first(self):
        if self.round_batch == 0 or self._num_overflow == 0:
            self.base.before_first()
        else:
            self._num_overflow = 0
            self.base.resume_epoch()
        self._head = 1

    def _store(self, top: int, d: DataInst) -> None:
        x = d.data
        if self._data.ndim == 2:
            x = x.reshape(-1)
        self._data[top] = x
        self._label[top] = np.asarray(
            d.label, np.float32).reshape(-1)[: self.label_width]
        self._inst[top] = d.index

    def next(self) -> bool:
        if self.test_skipread and self._head == 0:
            return True
        self._head = 0
        if self._num_overflow:
            return False
        # the batch stage's time: collating instances into the buffers
        # and the batch's copy, not the pulls below (decode/augment)
        self._t_build = 0.0
        top = 0
        while self.base.next():
            t0 = time.perf_counter()
            self._store(top, self.base.value())
            self._t_build += time.perf_counter() - t0
            top += 1
            if top >= self.batch_size:
                self._emit(0)
                return True
        if top == 0:
            return False
        if self.round_batch:
            self._num_overflow = 0
            self.base.before_first()
            while top < self.batch_size:
                if not self.base.next():
                    raise ValueError(
                        "number of instances must exceed batch size")
                t0 = time.perf_counter()
                self._store(top, self.base.value())
                self._t_build += time.perf_counter() - t0
                top += 1
                self._num_overflow += 1
            self._emit(self._num_overflow)
        else:
            self._emit(self.batch_size - top)
        return True

    def _emit(self, padd: int) -> None:
        t0 = time.perf_counter()
        self._out = DataBatch(data=self._data.copy(),
                              label=self._label.copy(),
                              inst_index=self._inst.copy(),
                              num_batch_padd=padd)
        pipeline_stats().add(
            "batch", self._t_build + (time.perf_counter() - t0),
            rows=self.batch_size)

    def value(self) -> DataBatch:
        if self._head != 0 or self._out is None:
            raise RuntimeError("BatchAdaptIterator: value() before next()")
        return self._out

    def close(self) -> None:
        self.base.close()
