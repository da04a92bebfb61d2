"""int8 GEMM with the per-channel rescale in its epilogue: the CUDA
kernel and its plain PyTorch version.

Counterpart of ``cxxnet_tpu/ops/kernels/int8_gemm.py``.  The quantized
``fullc`` and 1x1 conv (``ops/quant.py``) contract the activations with
the RAW int8 codes, f32 accumulation, and fold the per-output-channel
rescale and the f32 bias into one epilogue:

    y = relu?((x2d @ q.T) * scale + bias), rounded once to x2d's dtype

``x2d`` is ``(M, K)`` float32 or bfloat16, ``q`` ``(O, K)`` int8 (the
fullc layout; the weights stay one byte an element on the card),
``scale`` ``(O,)`` float32, ``bias`` ``(O,)`` float32 or None.

``int8_gemm_rescale`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches ``csrc/int8_gemm.cu`` or raises.  In
bfloat16 the source has two kernels, chosen by ``takes_wgmma``'s rule
and never by a failure: the main path on ``wgmma`` and TMA for K a
multiple of 16, O a multiple of 8, M, K and O above 0 and X and q
16-byte aligned (every layer of the quantized GoogLeNet), and the
``mma.sync`` edge path for any other shape or alignment.
``KERNEL.by_symbol`` counts each.  Where the main path's output tiles
are too few to busy the card, ``k_splits`` cuts K into parts summed by
blocks of their own and added up in a fixed order by a second kernel
of the same C entry (the classifier's one row tile).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build

KERNEL = _build.Kernel(
    "int8_gemm", "cxxnet_tpu/ops/kernels/int8_gemm.py:32 _int8_kernel")

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the main path's entry also takes the split count and its workspace
_WGMMA_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
               + [ctypes.c_void_p] * 2)
WGMMA = "int8_gemm_bf16"  # the bf16 main path's C entry
EDGE = "int8_gemm_bf16_mma"  # the bf16 edge path's
SPLIT_MAX = 8  # parts of K at most, each a (M, O) f32 slab of workspace
SPLIT_SLICES = 4  # 64-deep K slices a part at least


def k_splits(m: int, k: int, o: int, sms: int) -> int:
    """How many parts the main path cuts K into, a pure function of the
    shape and the card's SM count: 1 where the output tiles (128 rows by
    64 columns; 32 where O <= 32, one column tile either way) number
    more than half the SMs, else as many parts as leave each SM one work
    item, at most ``SPLIT_MAX`` and with ``SPLIT_SLICES`` 64-deep K
    slices a part at least.  The classifier (128, 1024, 1000) has 16
    tiles and 16 slices: 4 parts on 132 SMs, which an H100 ran in 8.2 µs
    against 10.8 at 1 part, 9.5 at 2 and 8.8 at 8 (PERF.md)."""
    tiles = -(-m // 128) * -(-o // 64)
    if 2 * tiles > sms:
        return 1
    return max(1, min(SPLIT_MAX, sms // tiles, -(-k // 64) // SPLIT_SLICES))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def takes_wgmma(x2d: torch.Tensor, q: torch.Tensor) -> bool:
    """The rule for the bf16 main path: K a multiple of 16 (q's rows are
    read 16 codes at a time), O a multiple of 8 (Y's rows are stored
    16 bytes at a time), M, K and O above 0, and X and q 16-byte
    aligned; ``Y`` is allocated aligned."""
    m, k = x2d.shape
    o = q.shape[0]
    return (x2d.dtype == torch.bfloat16 and m > 0 and k > 0 and o > 0
            and k % 16 == 0 and o % 8 == 0 and x2d.data_ptr() % 16 == 0
            and q.data_ptr() % 16 == 0)


def probe(x=None, q=None) -> Optional[str]:
    """None when the kernel takes these operands, else the reason."""
    if x is not None and x.dtype not in (torch.float32, torch.bfloat16):
        return f"unsupported activation dtype {x.dtype}"
    if q is not None and q.dtype != torch.int8:
        return f"codes must be int8, got {q.dtype}"
    return None


def int8_gemm_plain(x2d: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """The plain version: f32 product over the codes, times the scale,
    plus the bias, relu if asked, one rounding to ``x2d``'s dtype."""
    y = (x2d.float() @ q.float().t()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x2d.dtype)


def int8_gemm_rescale(x2d: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      relu: bool = False) -> torch.Tensor:
    """``relu?((x2d @ q.T) * scale + bias)`` in ``x2d``'s dtype: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x2d.dim() != 2 or q.dim() != 2 or x2d.shape[1] != q.shape[1]:
        raise ValueError(f"int8_gemm_rescale: x {tuple(x2d.shape)} and q "
                         f"{tuple(q.shape)} are not (M, K) and (O, K)")
    reason = probe(x2d, q)
    if reason is not None:
        raise TypeError(f"int8_gemm_rescale: {reason}")
    if x2d.device.type == "cpu":
        return int8_gemm_plain(x2d, q, scale, bias, relu)
    m, k = x2d.shape
    o = q.shape[0]
    _build.check_cuda("int8_gemm x", x2d, 2)
    _build.check_cuda("int8_gemm q", q, 2, torch.int8)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        _build.check_cuda(f"int8_gemm {name}", t, 1, torch.float32)
        if t.shape[0] != o:
            raise ValueError(f"int8_gemm_rescale: {name} has {t.shape[0]} "
                             f"entries for {o} outputs")
    if x2d.dtype != torch.bfloat16:
        symbol = f"int8_gemm_{_build.dtype_suffix(x2d)}"
    else:
        symbol = WGMMA if takes_wgmma(x2d, q) else EDGE
    return launch(symbol, x2d, q, scale, bias, relu)


def launch(symbol: str, x2d: torch.Tensor, q: torch.Tensor,
           scale: torch.Tensor, bias: Optional[torch.Tensor], relu: bool,
           splits: Optional[int] = None) -> torch.Tensor:
    """Launch one C entry of the source on checked CUDA operands (the
    smoke test times the edge path, and the main path at other split
    counts than ``k_splits``', at the main path's shapes with it)."""
    m, k = x2d.shape
    o = q.shape[0]
    y = torch.empty((m, o), dtype=x2d.dtype, device=x2d.device)
    args = (x2d.data_ptr(), q.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(), m,
            k, o, int(relu))
    if symbol != WGMMA:
        KERNEL.launch(symbol, _ARGS, *args, _build.stream_of(x2d))
        return y
    if splits is None:
        splits = k_splits(m, k, o, _sm_count(x2d.device.index))
    work = None
    if splits > 1:  # freed at return: the allocator orders its reuse
        work = torch.empty(splits * m * o, dtype=torch.float32,
                           device=x2d.device)
    KERNEL.launch(symbol, _WGMMA_ARGS, *args, splits,
                  work.data_ptr() if work is not None else None,
                  _build.stream_of(x2d))
    return y
