"""Shape-bucketed predict runner.

Counterpart of ``cxxnet_tpu/serve/cache.py``.  A request of ``n`` rows
is zero-padded up to the next power-of-two bucket, runs through the
trainer's predict function at that bucket, and the padded rows are
trimmed off the result (on a serving range's leader the followers are
told of the batch first, ``serve/range.py``).  PyTorch runs eagerly and compiles nothing, but
the buckets still bound the set of batch shapes the device sees (cuDNN
picks its algorithms per shape, and a later CUDA-graph capture will be
one graph per bucket), and they keep the served answers equal to the
JAX package's for the same request.  Hits and misses are counted by
``(net_fingerprint, kind, node, bucket, row_shape, dtype, quant
scheme)``: an f32 model and its int8 export share a net fingerprint, so
the scheme, the last component, keeps their entries apart.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from ..ops import quant as opsq
from . import range as serve_range

__all__ = ["bucket_size", "ShapeBucketCache"]


def bucket_size(n: int) -> int:
    """Smallest power of two >= ``n``."""
    if n <= 0:
        raise ValueError(f"bucket_size: need at least one row, got {n}")
    return 1 << (int(n - 1).bit_length())


class ShapeBucketCache:
    """Bucketed eval-forward runner over one :class:`NetTrainer`."""

    def __init__(self, trainer) -> None:
        self._trainer = trainer
        self._keys: Dict[tuple, int] = {}
        self._net_fp: Optional[str] = None
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def net_fp(self) -> str:
        if self._net_fp is None:
            self._net_fp = self._trainer.net_fp()
        return self._net_fp

    def quant_scheme(self) -> str:
        """The served weights' scheme: ``"int8"`` / ``"bf16"`` for a
        quantized model, ``""`` for f32."""
        return opsq.scheme_of(self._trainer)

    def bucket_for(self, n: int) -> int:
        return bucket_size(n)

    def _run(self, kind: str, node_id: Optional[int],
             data: np.ndarray) -> np.ndarray:
        """Pad ``data`` to its bucket, run the predict fn, trim.  The
        pad rows are made on the device (``predict_fn``'s ``pad_to``):
        a padded array on the host would cost a fresh bucket-sized
        allocation, and its first touch, on every batch."""
        tr = self._trainer
        data = np.ascontiguousarray(data, np.float32)
        if data.ndim < 2:
            raise ValueError(
                f"predict input must be a (N, ...) batch, got shape "
                f"{data.shape}")
        n = data.shape[0]
        bucket = self.bucket_for(n)
        key = (self.net_fp(), kind, node_id, bucket, data.shape[1:],
               str(data.dtype), self.quant_scheme())
        with self._lock:
            if key in self._keys:
                self._keys[key] += 1
                self.hits += 1
            else:
                self._keys[key] = 1
                self.misses += 1
        if not data.flags.writeable:
            # a binary frame's rows alias the request body (read-only);
            # torch must never wrap that buffer
            data = data.copy()
        # a flat (N, D) request is the wrapper spelling of the native row
        data = data.reshape((n,) + tr.net.input_node_shape(1)[1:])
        out = serve_range.forward_of(tr, node_id)(tr.params, tr.aux, data,
                                                  (), pad_to=bucket)
        return out.cpu().numpy()[:n]

    def scores(self, data: np.ndarray) -> np.ndarray:
        """Raw f32 out-node rows for ``data`` (no argmax)."""
        return self._run("out", None, data)

    def predict(self, data: np.ndarray) -> np.ndarray:
        """Per-instance predictions (trainer argmax semantics)."""
        return self._trainer.predict_from_scores(self._run("out", None, data))

    def extract(self, data: np.ndarray, node_name: str) -> np.ndarray:
        node_id = self._trainer.resolve_feature_node(node_name)
        return self._run("extract", node_id, data)

    def keys_snapshot(self) -> list:
        """A copy of the keys served so far (the reload's warm list;
        request threads keep adding keys while it is read)."""
        with self._lock:
            return list(self._keys)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"buckets": len(self._keys), "hits": self.hits,
                    "misses": self.misses}
