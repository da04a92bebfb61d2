"""Write real handwritten digits as MNIST idx files.

    python -m cxxnet_tpu_torch.tools.make_digits_idx <outdir> [n_test]

The port's counterpart of ``tools/make_digits_idx.py``, and its files
are byte for byte that tool's: the 1797 8x8 scans of the UCI ML
hand-written digits set (Optical Recognition of Handwritten Digits,
E. Alpaydin and C. Kaynak, UCI Machine Learning Repository, CC BY 4.0),
as scikit-learn 1.9.0 bundles them, permuted by
``np.random.RandomState(0)``, the first ``n_test`` (297) rows written as
``digits-t10k-*`` and the other 1500 as ``digits-train-*``.  The set
sits beside this file as ``digits_uci.npz`` (``images``: uint8 (1797,
8, 8), already ``clip(pixels * 16, 0, 255)``; ``labels``: uint8), so
the tool needs neither scikit-learn nor a download.
``example/MNIST/digits.conf`` and ``digits_conv.conf`` read the files
from ``./data``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.mnist import write_idx_images, write_idx_labels

DIGITS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits_uci.npz")


def write_digits_idx(outdir: str, n_test: int = 297) -> None:
    with np.load(DIGITS_NPZ) as d:
        imgs, labels = d["images"], d["labels"]
    perm = np.random.RandomState(0).permutation(len(labels))
    imgs, labels = imgs[perm], labels[perm]
    os.makedirs(outdir, exist_ok=True)
    for split, rows in (("train", slice(n_test, None)),
                        ("t10k", slice(None, n_test))):
        write_idx_images(os.path.join(
            outdir, f"digits-{split}-images-idx3-ubyte"), imgs[rows])
        write_idx_labels(os.path.join(
            outdir, f"digits-{split}-labels-idx1-ubyte"), labels[rows])
    print(f"wrote {len(labels) - n_test} train / {n_test} test real "
          f"handwritten digits (8x8 idx) to {outdir}")


if __name__ == "__main__":
    write_digits_idx(sys.argv[1] if len(sys.argv) > 1 else "example/MNIST/data",
                     int(sys.argv[2]) if len(sys.argv) > 2 else 297)
