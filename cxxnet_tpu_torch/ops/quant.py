"""Reduced-precision inference: int8 weights, the rescale folded out.

Counterpart of ``cxxnet_tpu/ops/quant.py``: the scheme's math, shared by
the exporter (``nnet/quant.py``), the net's quantized dispatch
(``nnet/net.py``) and the tests.

* **Per-output-channel symmetric scales.**  Output channel ``o`` of a
  conv (HWIO, axis 3) or fullc (``(nout, nin)``, axis 0) kernel gets
  ``scale[o] = max|w[..., o]| / 127``; the codes are ``round(w / scale)``
  clipped to ``[-127, 127]`` (zero-point 0).  ``quantize_weight`` is
  numpy with ``np.rint``, as in the JAX package, so the codes and scales
  of one kernel are bit-equal in both packages.
* **Dequant-free application.**  The scale is constant along every
  contracted axis, so ``x @ (q * s) == (x @ q) * s``: the contraction
  reads the raw codes and the rescale joins the f32 bias add.  A 2-D
  ``fullc`` and a 1x1 / pad-0 / ungrouped conv (a strided one subsamples
  its input first) run the int8 GEMM kernel (``kernels/int8_gemm.py``,
  K7), whose epilogue holds the whole chain.  A K x K conv runs the
  library conv over the codes cast to the activation dtype (exact:
  |code| <= 127 fits bf16's mantissa), then the rescale and bias in
  f32.  A 3-D ``fullc`` input takes the plain f32 product.
* **bf16 fallback.**  A layer whose error breaks the accuracy budget
  keeps a bfloat16 ``wmat``; the plain layer path casts it as usual.

Param-dict convention: a quantized layer's entry holds ``wmat_q8`` (int8
codes, the kernel's own layout), ``wscale`` (f32, ``(nout,)``) and the
f32 ``bias``; ``is_quantized`` keys on ``wmat_q8``.  ``prepare_q`` adds
the prepared operand ``wmat_q8_oi``: a 1x1 conv's codes as ``(O, I)``,
built once per load.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import int8_gemm as _k7

__all__ = [
    "QKEY", "SKEY", "QMAX",
    "quantize_weight", "dequantize_weight", "quant_error",
    "is_quantized", "effective_wmat", "prepare_q",
    "fc_apply_q", "conv_apply_q",
    "weight_bytes", "scheme_of",
]

QKEY = "wmat_q8"   # int8 codes (kernel layout preserved)
SKEY = "wscale"    # f32 per-output-channel scales, shape (nout,)
QMAX = 127.0       # symmetric range: [-127, 127], zero-point 0
OIKEY = "wmat_q8_oi"  # prepared: a 1x1 conv's codes as (O, I)


def _scale_shape(ndim: int, out_axis: int) -> Tuple[int, ...]:
    shape = [1] * ndim
    shape[out_axis] = -1
    return tuple(shape)


def quantize_weight(w, out_axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(codes int8, scales f32)`` for one kernel, per output channel,
    symmetric.  ``out_axis`` is 3 for HWIO conv kernels, 0 for
    ``(nout, nin)`` fullc kernels.  An all-zero channel gets scale 1."""
    w = np.asarray(w, np.float32)
    out_axis = out_axis % w.ndim
    reduce_axes = tuple(a for a in range(w.ndim) if a != out_axis)
    absmax = np.abs(w).max(axis=reduce_axes)
    scale = np.where(absmax > 0, absmax / QMAX, 1.0).astype(np.float32)
    sb = scale.reshape(_scale_shape(w.ndim, out_axis))
    q = np.clip(np.rint(w / sb), -QMAX, QMAX).astype(np.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, out_axis: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Codes and scales back to a dense kernel in ``dtype`` (the product
    in f32, then one rounding).  Not the serving path: the sibling-1x1
    groups assemble their kernels from it per forward."""
    sb = scale.float().reshape(_scale_shape(q.dim(), out_axis % q.dim()))
    return (q.float() * sb).to(dtype)


def quant_error(w, out_axis: int) -> float:
    """Relative L2 quantization error of one kernel: the exporter's
    fallback ranking (the worst error reverts to bf16 first)."""
    w = np.asarray(w, np.float32)
    q, s = quantize_weight(w, out_axis)
    dq = q.astype(np.float32) * s.reshape(_scale_shape(w.ndim,
                                                       out_axis % w.ndim))
    denom = float(np.linalg.norm(w))
    if denom == 0.0:
        return 0.0
    return float(np.linalg.norm(w - dq) / denom)


def is_quantized(lparams) -> bool:
    return bool(lparams) and QKEY in lparams


def effective_wmat(lparams, dtype) -> torch.Tensor:
    """The layer's kernel in ``dtype`` whatever its storage: dequantized
    codes (HWIO, output channels last) for an int8 entry, the usual cast
    otherwise."""
    if is_quantized(lparams):
        return dequantize_weight(lparams[QKEY], lparams[SKEY], -1, dtype)
    return lparams["wmat"].to(dtype)


def prepare_q(lparams) -> dict:
    """A quantized entry's forward operands: the codes stay int8 and the
    scales and bias f32 (nothing is cast); a 1x1 conv's HWIO codes are
    also kept as the contiguous ``(O, I)`` matrix K7 reads."""
    out = dict(lparams)
    q = lparams[QKEY]
    if q.dim() == 4 and tuple(q.shape[:2]) == (1, 1):
        out[OIKEY] = q.reshape(q.shape[2], q.shape[3]).t().contiguous()
    return out


def _rescale_bias(y: torch.Tensor, lparams, out_dtype) -> torch.Tensor:
    """The per-channel rescale and bias on the contraction's output, in
    f32 (one pass: the f32 scale promotes a bf16 ``y``), then the dtype
    downstream layers expect."""
    if "bias" in lparams:
        y = torch.addcmul(lparams["bias"], y, lparams[SKEY])
    else:
        y = y * lparams[SKEY]
    return y.to(out_dtype)


def fc_apply_q(lparams, x: torch.Tensor) -> torch.Tensor:
    """Quantized ``fullc``: ``(x @ q.T) * scale + bias`` with ``q``
    ``(nout, nin)`` int8.  A 2-D input runs K7; a 3-D one the plain f32
    product."""
    q = lparams[QKEY]
    if x.dim() == 2:
        return _k7.int8_gemm_rescale(x, q, lparams[SKEY], lparams.get("bias"))
    return _rescale_bias(x.float() @ q.float().t(), lparams, x.dtype)


def conv_apply_q(lparams, x: torch.Tensor, stride: int, pad_y: int,
                 pad_x: int, groups: int = 1) -> torch.Tensor:
    """Quantized conv over NHWC ``x`` with HWIO int8 codes (``lparams``
    from ``prepare_q``).  A 1x1 / pad-0 / ungrouped conv is K7 over the
    flattened pixels (a strided one subsamples first: output ``(i, j)``
    reads only ``x[i*s, j*s]``); others run the library conv on the
    codes cast to ``x``'s dtype, then the rescale and the bias in f32."""
    q = lparams[QKEY]
    if groups == 1 and pad_y == 0 and pad_x == 0 and tuple(
            q.shape[:2]) == (1, 1):
        if stride > 1:
            x = x[:, ::stride, ::stride, :]
        n, h, w, cin = x.shape
        y = _k7.int8_gemm_rescale(x.contiguous().reshape(-1, cin),
                                  lparams[OIKEY], lparams[SKEY],
                                  lparams.get("bias"))
        return y.reshape(n, h, w, -1)
    wk = q.permute(3, 2, 0, 1).to(x.dtype).contiguous(
        memory_format=torch.channels_last)  # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), wk, None, stride=stride,
                 padding=(pad_y, pad_x), groups=groups)
    return _rescale_bias(y.permute(0, 2, 3, 1), lparams,
                         x.dtype).contiguous()


def weight_bytes(params) -> Tuple[int, int]:
    """``(actual, f32_equiv)``: the bytes the weights take at rest as
    stored, and what the same tensors take as dense f32 (the scales are
    billed to ``actual`` only: the f32 model has none)."""
    actual = 0
    f32_equiv = 0
    for tags in (params or {}).values():
        for tag, w in tags.items():
            actual += w.numel() * w.element_size()
            if tag != SKEY:
                f32_equiv += 4 * w.numel()
    return actual, f32_equiv


def scheme_of(trainer) -> str:
    """The trainer's quant scheme: ``"int8"`` / ``"bf16"`` when
    quantized, ``""`` for the plain f32 model."""
    return getattr(trainer, "quant_scheme", "") or ""
