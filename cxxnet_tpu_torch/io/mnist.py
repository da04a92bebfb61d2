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
``index_offset``, ``silent``.  ``dist_num_worker > 1`` raises: sharding
the data over processes is multi-device work (ROADMAP.md queue A item
6).
"""

from __future__ import annotations

import struct

import numpy as np

from .data import DataBatch, DataIter

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
    def __init__(self) -> None:
        self.batch_size = 0
        self.input_flat = 1
        self.shuffle = 0
        self.index_offset = 0
        self.silent = 0
        self.path_img = ""
        self.path_label = ""
        self.seed = 0
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
        elif name == "dist_num_worker" and int(val) > 1:
            raise NotImplementedError(
                "dist_num_worker > 1: multi-process data sharding is not "
                "ported yet (ROADMAP.md queue A item 6)")

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
