"""Serving golden canary: a manifest-committed probe batch whose score
CRC must stay stable for the lifetime of a loaded model.

The port's copy of ``cxxnet_tpu/integrity/canary.py``.  At model load
the engine scores the probe batch committed in the checkpoint manifest
(the ``probe`` block: a seed, a row count and a row shape, plus the CRC
the trainer recorded at save time) and records the CRC of the scores;
from then on each re-score must reproduce that CRC bit for bit.  The
model bytes and the forward are frozen between reloads, so any drift is
memory or compute corruption, and ``/healthz`` degrades with the
``integrity_failed`` reason.

The trainer's golden binds only when the engine scores through the same
pipeline class: the same backend (``"gpu"`` on a card, ``"cpu"`` on the
CPU: the names ``jax.default_backend()`` gives, so a manifest reads the
same in both packages) and unquantized weights.  Otherwise the engine
rebases the golden to its own load-time score instead of raising a
false alarm.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["probe_batch", "scores_crc", "make_probe_block",
           "block_matches_pipeline", "backend_of"]


def backend_of(device) -> str:
    """The manifest's backend name for a torch device: ``"gpu"`` for a
    CUDA device, ``"cpu"`` for the CPU."""
    return "gpu" if getattr(device, "type", str(device)) == "cuda" else "cpu"


def probe_batch(seed: int, rows: int, shape: Tuple[int, ...]) -> np.ndarray:
    """The deterministic probe: ``rows`` samples of per-example
    ``shape``, uniform [0, 1) f32 from a seeded ``RandomState``,
    reproducible from the (seed, rows, shape) triple alone, which is all
    the manifest commits."""
    rng = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    return rng.random_sample((int(rows),) + tuple(shape)).astype(np.float32)


def scores_crc(scores: np.ndarray) -> int:
    """CRC32 over the score tensor's shape header and little-endian f32
    bytes: bit-exact and shape-sensitive."""
    a = np.ascontiguousarray(np.asarray(scores, np.float32))
    head = ("x".join(str(int(d)) for d in a.shape) + ":").encode()
    return zlib.crc32(a.tobytes(), zlib.crc32(head)) & 0xFFFFFFFF


def make_probe_block(seed: int, rows: int, shape: Tuple[int, ...],
                     crc: Optional[int], backend: str) -> dict:
    """The manifest ``probe`` block (written at save under
    ``integrity_probe = 1``)."""
    block = {
        "seed": int(seed),
        "rows": int(rows),
        "shape": [int(d) for d in shape],
        "backend": backend,
    }
    if crc is not None:
        block["crc32"] = int(crc) & 0xFFFFFFFF
    return block


def block_matches_pipeline(block: dict, *, backend: str,
                           quant: bool) -> bool:
    """Does the trainer's golden bind this engine's scoring pipeline?
    Another backend or quantized weights change the scores legitimately:
    rebase instead of alarm."""
    return (not quant) and block.get("backend") == backend \
        and block.get("crc32") is not None
