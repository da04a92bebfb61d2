"""MNIST idx-format iterator (``iter = mnist``).

The port's copy of ``cxxnet_tpu/io/mnist.py``: the idx images and
labels are loaded into RAM, pixels scaled by 1/256; ``shuffle = 1``
permutes the rows once with ``np.random.RandomState(42 + seed_data)``,
so both packages draw the same batches; ``input_flat`` chooses flat
``(N, H*W)`` rows or NHWC images with C = 1; ``index_offset`` shifts the
instance ids; the last partial batch is dropped.  The idx writers let
tools and tests make their own files.

Config keys: ``path_img``, ``path_label``, ``batch_size`` (required),
``input_flat`` (default 1), ``shuffle``, ``seed_data``,
``index_offset``, ``silent``, and the worker shard of a data-parallel
job: ``dist_num_worker`` / ``dist_worker_rank`` take this worker's
equal share of the rows after the shuffle (``data.shard_rows``),
``dist_shard = interleave`` (rows ``rank::n``) or ``block`` (whole local
batches dealt round-robin, so the ranks' batches together are the
single-process run's global batch, row for row).
"""

from __future__ import annotations

import struct

import numpy as np

from .data import DataBatch, DataIter, shard_rows

_IDX_IMAGES = 0x803
_IDX_LABELS = 0x801


def read_idx_images(path: str) -> np.ndarray:
    """``(count, rows, cols)`` uint8 from an idx3 file."""
    with open(path, "rb") as f:
        _magic, count, rows, cols = struct.unpack(">iiii", f.read(16))
        buf = f.read(count * rows * cols)
    return np.frombuffer(buf, np.uint8).reshape(count, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """``(count,)`` uint8 from an idx1 file."""
    with open(path, "rb") as f:
        _magic, count = struct.unpack(">ii", f.read(8))
        buf = f.read(count)
    return np.frombuffer(buf, np.uint8)


def write_idx_images(path: str, imgs: np.ndarray) -> None:
    """idx3 writer: ``imgs`` is ``(n, rows, cols)``, stored as uint8."""
    n, r, c = imgs.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">iiii", _IDX_IMAGES, n, r, c))
        f.write(imgs.astype(np.uint8).tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    """idx1 writer: ``labels`` stored as uint8."""
    with open(path, "wb") as f:
        f.write(struct.pack(">ii", _IDX_LABELS, len(labels)))
        f.write(labels.astype(np.uint8).tobytes())


class MNISTIterator(DataIter):
    def supports_dist_shard(self) -> bool:
        return True

    def __init__(self) -> None:
        self.batch_size = 0
        self.input_flat = 1
        self.shuffle = 0
        self.index_offset = 0
        self.silent = 0
        self.path_img = ""
        self.path_label = ""
        self.seed = 0
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.dist_shard = "interleave"  # or "block": contiguous batches
        self._loc = 0
        self._img: np.ndarray | None = None
        self._label: np.ndarray | None = None
        self._inst: np.ndarray | None = None

    def set_param(self, name, val):
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "input_flat":
            self.input_flat = int(val)
        elif name == "shuffle":
            self.shuffle = int(val)
        elif name == "index_offset":
            self.index_offset = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "path_img":
            self.path_img = val
        elif name == "path_label":
            self.path_label = val
        elif name == "seed_data":
            self.seed = int(val)
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        elif name == "dist_shard":
            if val not in ("interleave", "block"):
                raise ValueError(
                    f"dist_shard={val!r}: must be interleave or block")
            self.dist_shard = val

    def init(self):
        if self.batch_size <= 0:
            raise ValueError("MNISTIterator: batch_size must be set")
        imgs = read_idx_images(self.path_img).astype(np.float32) / 256.0
        labels = read_idx_labels(self.path_label).astype(np.float32)
        inst = np.arange(len(labels), dtype=np.uint32) + self.index_offset
        if self.shuffle:
            perm = np.random.RandomState(42 + self.seed).permutation(
                len(labels))
            imgs, labels, inst = imgs[perm], labels[perm], inst[perm]
        if self.dist_num_worker > 1:
            sl = shard_rows(
                len(labels), self.dist_worker_rank, self.dist_num_worker,
                block=(self.batch_size if self.dist_shard == "block"
                       else 1))
            imgs, labels, inst = imgs[sl], labels[sl], inst[sl]
        if self.input_flat:
            self._img = imgs.reshape(len(labels), -1)
        else:
            self._img = imgs[..., None]  # NHWC with C = 1
        self._label = labels[:, None]
        self._inst = inst
        if not self.silent:
            print(f"MNISTIterator: load {len(labels)} images, "
                  f"shuffle={self.shuffle}, shape={self._img.shape}")

    def before_first(self):
        self._loc = 0

    def next(self) -> bool:
        if self._img is None:
            raise RuntimeError("MNISTIterator: init() not called")
        if self._loc + self.batch_size <= self._img.shape[0]:
            self._loc += self.batch_size
            return True
        return False

    def value(self) -> DataBatch:
        lo, hi = self._loc - self.batch_size, self._loc
        return DataBatch(data=self._img[lo:hi], label=self._label[lo:hi],
                         inst_index=self._inst[lo:hi])
