"""Image files, one per record (``iter = img``).

The port's copy of ``cxxnet_tpu/io/img.py``: the ``.lst`` file of
``image_list`` (``index \\t labels \\t filename``) names each image,
read from ``image_root + filename`` with PIL as HWC RGB float32 in
0..255.  Without PIL the iterator refuses at ``init()``, naming
``iter = img``.  ``dist_num_worker > 1`` raises (ROADMAP.md queue A
item 6).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .batch import DataInst, InstIterator
from .imgbin import parse_lst_line, pil_image


class ImageIterator(InstIterator):
    def __init__(self) -> None:
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
        elif name == "dist_num_worker" and int(val) > 1:
            raise NotImplementedError(
                "dist_num_worker > 1: multi-process data sharding is not "
                "ported yet (ROADMAP.md queue A item 6)")

    def init(self):
        pil_image("iter = img")
        if not self.image_list:
            raise ValueError("ImageIterator: must set image_list")
        with open(self.image_list, "r", encoding="utf-8") as f:
            self._recs = [parse_lst_line(l) for l in f if l.strip()]
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
