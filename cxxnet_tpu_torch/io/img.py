"""Image files, one per record (``iter = img``).

The port's copy of ``cxxnet_tpu/io/img.py``: the ``.lst`` file of
``image_list`` (``index \\t labels \\t filename``) names each image,
read from ``image_root + filename`` with PIL as HWC RGB float32 in
0..255.  Without PIL the iterator refuses at ``init()``, naming
``iter = img``.  ``dist_num_worker`` / ``dist_worker_rank`` keep this
worker's equal share of the records (``data.shard_rows``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .batch import DataInst, InstIterator
from .data import shard_rows
from .imgbin import parse_lst_line, pil_image


class ImageIterator(InstIterator):
    def supports_dist_shard(self) -> bool:
        return True

    def __init__(self) -> None:
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.image_list = ""
        self.image_root = ""
        self.silent = 0
        self._recs: List[Tuple[int, np.ndarray, str]] = []
        self._pos = 0
        self._out: Optional[DataInst] = None

    def set_param(self, name, val):
        if name == "image_list":
            self.image_list = val
        elif name == "image_root":
            self.image_root = val
        elif name == "silent":
            self.silent = int(val)
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)

    def init(self):
        pil_image("iter = img")
        if not self.image_list:
            raise ValueError("ImageIterator: must set image_list")
        with open(self.image_list, "r", encoding="utf-8") as f:
            self._recs = [parse_lst_line(l) for l in f if l.strip()]
        if self.dist_num_worker > 1:
            keep = shard_rows(len(self._recs), self.dist_worker_rank,
                              self.dist_num_worker)
            self._recs = [self._recs[i] for i in keep]
        if not self.silent:
            print(f"ImageIterator: {len(self._recs)} images from "
                  f"{self.image_list}")

    def before_first(self):
        self._pos = 0

    def next(self) -> bool:
        if self._pos >= len(self._recs):
            return False
        idx, labels, fname = self._recs[self._pos]
        self._pos += 1
        img = pil_image("iter = img").open(self.image_root + fname)
        if img.mode != "RGB":
            img = img.convert("RGB")
        self._out = DataInst(idx, np.asarray(img, np.float32), labels)
        return True

    def value(self) -> DataInst:
        if self._out is None:
            raise RuntimeError("ImageIterator: value() before next()")
        return self._out
