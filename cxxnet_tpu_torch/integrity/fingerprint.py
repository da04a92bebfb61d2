"""Order-independent per-tensor digests for corruption detection.

The port's copy of ``cxxnet_tpu/integrity/fingerprint.py``: the same
digest, word for word, so a tensor digests to the same two words in
both packages.

1. **Sensitivity**: any single flipped bit changes it.  ``s1`` is a
   plain modular word sum, so a one-bit flip shifts it by exactly
   ``±2^b mod 2^32 != 0`` — no single-bit flip can cancel.
2. **Layout invariance**: ``s2`` weights each word by its *global* flat
   index, so per-block partial digests (a block at slice ``index`` of a
   logical ``shape``) combine by plain modular addition.
3. **Cheapness**: :func:`digest_tensor` reduces on the device that holds
   the tensor; only two words cross to the host.

Definition (little-endian canonical element encoding, C order):

* ``word[i]`` = the ``i``-th machine word of the tensor, widened to
  u32: the u32 bit pattern for 4-byte dtypes, the u16 pattern for
  2-byte dtypes, the byte for 1-byte dtypes, and an (lo, hi) u32 pair
  for 8-byte dtypes (words-per-element ``wpe = max(1, itemsize//4)``
  for >=4-byte dtypes).
* global word index ``g(i) = element_global_flat_index * wpe + k``.
* ``s1 = sum_i word[i] mod 2^32``
* ``s2 = sum_i word[i] * (g(i) + 1 mod 2^32) mod 2^32``

:func:`digest_array` is the numpy oracle (u64 intermediates reduced mod
2^32).  :func:`digest_tensor` computes the same in ``int64`` on the
tensor's device: PyTorch's CUDA arithmetic on ``uint32`` is incomplete
and ``w * (g + 1)`` overflows ``int64`` once both factors pass 2^31, so
each word is split into 16-bit halves, each half's product (< 2^48) is
reduced mod 2^32, and the sums run over chunks short enough that no
partial sum passes 2^63.  The words come from bitcasts (``view``) and
masks, never through a float.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

Digest = Tuple[int, int]

_M32 = np.uint64(0xFFFFFFFF)


def _as_words(a: np.ndarray) -> Tuple[np.ndarray, int]:
    """Flat u64-widened machine words of ``a`` plus words-per-element."""
    a = np.ascontiguousarray(a)
    itemsize = a.dtype.itemsize
    if itemsize == 4:
        w, wpe = a.view(np.uint32), 1
    elif itemsize == 2:
        w, wpe = a.view(np.uint16), 1
    elif itemsize == 1:
        w, wpe = a.view(np.uint8), 1
    elif itemsize == 8:
        w, wpe = a.view(np.uint32), 2  # little-endian (lo, hi) pairs
    else:
        raise TypeError(f"digest: unsupported itemsize {itemsize} "
                        f"(dtype {a.dtype})")
    return w.reshape(-1).astype(np.uint64), wpe


def _global_word_index(shape: Sequence[int], index, wpe: int) -> np.ndarray:
    """u64 global word indices for the local block ``index`` (a tuple of
    slices into an array of logical ``shape``), C order."""
    shape = tuple(int(s) for s in shape)
    strides = np.ones(len(shape), np.uint64)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * np.uint64(shape[d + 1])
    gi = np.zeros((), np.uint64)
    for d, sl in enumerate(index):
        start = np.uint64(sl.start or 0)
        stop = sl.stop if sl.stop is not None else shape[d]
        n = int(stop) - int(sl.start or 0)
        offs = (start + np.arange(n, dtype=np.uint64)) * strides[d]
        gi = gi[..., None] + offs.reshape((1,) * d + (n,))
    if wpe == 1:
        return gi.reshape(-1)
    gi = gi.reshape(-1, 1) * np.uint64(wpe) + np.arange(wpe, dtype=np.uint64)
    return gi.reshape(-1)


def digest_array(a: np.ndarray, index=None, shape=None) -> Digest:
    """Numpy oracle: digest of ``a``, or of the local block ``a`` sitting
    at slice ``index`` of a logical tensor of ``shape``."""
    a = np.asarray(a)
    words, wpe = _as_words(a)
    if index is None:
        gi = np.arange(words.size, dtype=np.uint64)
    else:
        gi = _global_word_index(shape if shape is not None else a.shape,
                                index, wpe)
        if gi.size != words.size:
            raise ValueError(
                f"digest: block {a.shape} does not match slice {index} "
                f"of {shape}")
    s1 = int(words.sum() & _M32)
    s2 = int((words * ((gi & _M32) + np.uint64(1) & _M32) & _M32).sum()
             & _M32)
    return (s1, s2)


def combine_digests(parts: Iterable[Digest]) -> Digest:
    """Combine per-shard partial digests of ONE tensor (each computed
    with its own global offsets) into the full-tensor digest."""
    s1 = s2 = 0
    for p1, p2 in parts:
        s1 = (s1 + p1) & 0xFFFFFFFF
        s2 = (s2 + p2) & 0xFFFFFFFF
    return (s1, s2)


# ----------------------------------------------------------------------
# the digest on the tensor's device

_CHUNK = 1 << 26  # words a partial sum covers: 2^26 * 2^32 < 2^63


def _tensor_words(t):
    """Flat ``int64`` words of ``t`` (each in [0, 2^32)) and the words
    per element, by bitcast and mask on ``t``'s device."""
    import torch

    x = t.detach().contiguous().reshape(-1)
    itemsize = x.element_size()
    if itemsize == 4:
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, 1
    if itemsize == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF, 1
    if itemsize == 1:
        return x.view(torch.uint8).to(torch.int64), 1
    if itemsize == 8:
        # little-endian (lo, hi) pairs
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, 2
    raise TypeError(f"digest: unsupported itemsize {itemsize} "
                    f"(dtype {t.dtype})")


def _tensor_gi(shape, index, wpe: int, device):
    """``int64`` global word indices (C order) of the block at slice
    ``index`` of a logical tensor of ``shape``."""
    import torch

    shape = tuple(int(s) for s in shape)
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    gi = torch.zeros((), dtype=torch.int64, device=device)
    for d, sl in enumerate(index):
        start = int(sl.start or 0)
        stop = int(sl.stop) if sl.stop is not None else shape[d]
        offs = (start + torch.arange(stop - start, dtype=torch.int64,
                                     device=device)) * strides[d]
        gi = gi.unsqueeze(-1) + offs.reshape((1,) * d + (-1,))
    gi = gi.reshape(-1)
    if wpe == 2:
        gi = (gi.unsqueeze(-1) * 2 + torch.arange(
            2, dtype=torch.int64, device=device)).reshape(-1)
    return gi


def _weighted_mod32(w, g):
    """``(w * g) mod 2^32`` elementwise for ``w, g`` in [0, 2^32), in
    ``int64`` with no intermediate past 2^48: ``w = hi * 2^16 + lo``."""
    lo = w & 0xFFFF
    hi = w >> 16
    return ((lo * g) + (((hi * g) & 0xFFFF) << 16)) & 0xFFFFFFFF


def digest_tensor(t, index=None, shape=None) -> Digest:
    """The digest of a torch tensor, computed on its device (a CUDA
    tensor is never copied to the host: two words come back).  ``index``
    / ``shape`` place the tensor as a block inside a logical tensor
    (omit for a whole tensor).  Bit-equal to :func:`digest_array` of the
    same bytes."""
    import torch

    words, wpe = _tensor_words(t)
    n = words.numel()
    gi = None
    if index is not None:
        gi = _tensor_gi(shape if shape is not None else t.shape, index,
                        wpe, words.device)
        if gi.numel() != n:
            raise ValueError(
                f"digest: block {tuple(t.shape)} does not match slice "
                f"{index} of {shape}")
    s1 = torch.zeros((), dtype=torch.int64, device=words.device)
    s2 = torch.zeros((), dtype=torch.int64, device=words.device)
    for a in range(0, n, _CHUNK):
        w = words[a:a + _CHUNK]
        if gi is None:
            g = torch.arange(a, a + w.numel(), dtype=torch.int64,
                             device=w.device)
        else:
            g = gi[a:a + _CHUNK]
        g = ((g & 0xFFFFFFFF) + 1) & 0xFFFFFFFF
        s1 = (s1 + w.sum()) & 0xFFFFFFFF
        s2 = (s2 + _weighted_mod32(w, g).sum()) & 0xFFFFFFFF
    out = torch.stack([s1, s2]).cpu()
    return (int(out[0]), int(out[1]))
