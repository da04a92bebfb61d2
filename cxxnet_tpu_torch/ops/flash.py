"""Flash attention, forward and backward: two CUDA kernels and their
plain PyTorch versions.

Counterpart of ``cxxnet_tpu/ops/flash.py``.  Layouts are the JAX
package's: ``q`` is ``(B, T, H, Dh)``, ``k`` and ``v`` ``(B, Tk, H,
Dh)``; the per-row log-sum-exp is kept as ``(B, H, T)`` f32 inside and
handed out as ``(B, T, H)``.  With ``scale = 1/sqrt(Dh)`` and key ``j``
visible to query ``i`` unless ``causal`` and ``q_off + i < k_off + j``:

* forward: scores in f32 from q and k cast to f32, an f32 softmax, the
  probabilities rounded to ``v``'s dtype before the product with ``v``;
  ``o = acc / max(l, 1e-30)`` and ``lse = m + log(max(l, 1e-30))``, so a
  row with no visible key gives ``o = 0`` and ``lse = -1e30``;
* backward: ``p = exp(s - lse)``, ``ds = p * (dO.v - dl)``, ``dq =
  scale * ds.k``, ``dk = scale * ds^T.q``, ``dv = p^T.dO``, where ``dl =
  delta - dlse``, ``delta = rowsum(dO * O)`` in f32 (a torch op here, an
  XLA op in the JAX package) and ``dlse`` the cotangent of
  ``flash_mha_lse``'s LSE, so the same kernels serve both entry points.
  In bf16, ``p`` and ``ds`` are rounded to bf16 before the three
  gradient products (the tensor cores' operand type; the JAX package's
  Pallas kernels keep them f32); in f32 nothing is rounded.

* ``flash_fwd`` (K9, ``csrc/flash_fwd.cu``) and ``flash_bwd`` (K10,
  ``csrc/flash_bwd.cu``: the dQ kernel and the dK/dV kernel, launched
  together; bf16 on the tensor cores, f32 on the CUDA cores) take the
  plain version only for tensors on the CPU; for
  CUDA tensors they launch their kernels or raise.  The kernels read
  strided ``(B, T, H, Dh)`` views in place (the q, k, v slices of a
  fused qkv projection), refuse a layout they cannot read that way, and
  mask their own ragged edges, so any T works;
  the head dim must be 16, 32 or 64.
* ``flash_mha`` / ``flash_mha_lse``: the differentiable entries, one
  ``torch.autograd.Function`` with K9 forward and K10 backward.  The
  offsets are host integers (the JAX package's are traced scalars for
  its ring hops; the ring itself is ROADMAP.md item A6).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF, causal_mask

FWD_KERNEL = _build.Kernel("flash_fwd",
                           "cxxnet_tpu/ops/flash.py:71 _fwd_kernel")
BWD_KERNEL = _build.Kernel(
    "flash_bwd", "cxxnet_tpu/ops/flash.py:126 _dq_kernel, :171 _dkv_kernel")

HEAD_DIMS = (16, 32, 64)  # the head dims the kernels are built for

_FWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


# ----------------------------------------------------------------------
# the plain versions
def _visible(q: torch.Tensor, k: torch.Tensor, causal: bool, q_off: int,
             k_off: int) -> Optional[torch.Tensor]:
    if not causal:
        return None
    return causal_mask(q.shape[1], k.shape[1], q_off, k_off, q.device)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_off: int = 0, k_off: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the whole masked score matrix in f32, P rounded to
    ``v``'s dtype before P.V; ``o`` ``(B, T, H, Dh)`` in ``q``'s dtype,
    ``lse`` ``(B, H, T)`` f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = _visible(q, k, causal, q_off, k_off)
    if vis is not None:
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:  # masked entries, and every entry of a dead row
        p = torch.where(vis, p, torch.zeros_like(p))
    lf = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = (pv / lf).permute(0, 2, 1, 3).to(q.dtype).contiguous()
    return o, (m + torch.log(lf))[..., 0]


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, dl: torch.Tensor,
                    causal: bool = False, q_off: int = 0, k_off: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` by the explicit formulas (not autograd), from
    the forward's ``lse`` and ``dl = delta - dlse``, both ``(B, H, T)``
    f32; each gradient in its input's dtype.  ``p`` and ``ds`` are
    rounded to the input dtype before the three gradient products, as
    the bf16 kernel's tensor cores take them (a no-op in f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    vis = _visible(q, k, causal, q_off, k_off)
    if vis is not None:
        p = torch.where(vis, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dl[..., None])
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# the kernel wrappers
def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless ``t`` is a CUDA ``(B, T, H, Dh)`` operand the kernels
    read in place: the dtype of ``q``, unit stride over Dh, 16-byte
    aligned rows (8 elements a thread).  A contiguous tensor, and each
    q/k/v slice of a fused ``(B, T, 3, H, Dh)`` projection, is one."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (B, T, H, Dh), got "
                         f"{tuple(t.shape)}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name}: expected {like.dtype}, got {t.dtype}")
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(s % 8 for s in t.stride()[:3])):
        raise ValueError(
            f"{name}: strides {t.stride()} at byte offset "
            f"{t.data_ptr() % 16} mod 16; the kernels need unit stride over "
            "Dh, the other strides multiples of 8 and 16-byte alignment")


def _geometry(q, k, v):
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash: head dim {d}; the CUDA kernels are built for "
            f"{HEAD_DIMS}")
    return b, t, h, d, k.shape[1]


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, q_off: int = 0, k_off: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of the forward: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, q_off, k_off)
    for n, x in (("q", q), ("k", k), ("v", v)):
        _check(f"flash_fwd {n}", x, q)
    b, t, h, d, tk = _geometry(q, k, v)
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    FWD_KERNEL.launch(
        f"flash_fwd_{_build.dtype_suffix(q)}", _FWD_ARGS, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, t,
        tk, d, *_strides(q, k, v), int(q_off), int(k_off), int(bool(causal)),
        1.0 / math.sqrt(d), _build.stream_of(q))
    return o, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, dl: torch.Tensor,
              causal: bool = False, q_off: int = 0, k_off: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the two CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, dl, causal, q_off, k_off)
    for n, x in (("q", q), ("k", k), ("v", v), ("dO", do)):
        _check(f"flash_bwd {n}", x, q)
    b, t, h, d, tk = _geometry(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"flash_bwd: dO {tuple(do.shape)} vs q "
                         f"{tuple(q.shape)}")
    for name, r in (("lse", lse), ("dl", dl)):
        _build.check_cuda(f"flash_bwd {name}", r, 3, torch.float32)
        if r.shape != (b, h, t):
            raise ValueError(f"flash_bwd: {name} {tuple(r.shape)}, "
                             f"expected {(b, h, t)}")
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, do))
    BWD_KERNEL.launch(
        f"flash_bwd_{_build.dtype_suffix(q)}", _BWD_ARGS, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dl.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t,
        tk, d, ctypes.cast(strides, ctypes.c_void_p), int(q_off), int(k_off),
        int(bool(causal)), 1.0 / math.sqrt(d), _build.stream_of(q))
    return dq, dk, dv


# ----------------------------------------------------------------------
# the differentiable entries
class _FlashAttention(torch.autograd.Function):
    """K9 forward saving (q, k, v, o, lse); K10 backward with the LSE
    cotangent folded into ``dl``."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, causal):
        o, lse = flash_fwd(q, k, v, causal, q_off, k_off)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_off, k_off)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, q_off, k_off = ctx.args
        if g is None:
            g = torch.zeros_like(o)
        # the output's gradient comes in the layout its consumer made
        # (the attention layer's projection gives a dense one)
        g = g.contiguous()
        dl = (g.float() * o.float()).sum(-1).permute(0, 2, 1)
        if g_lse is not None:
            dl = dl - g_lse.float()
        dq, dk, dv = flash_bwd(q, k, v, g, lse, dl.contiguous(), causal,
                               q_off, k_off)
        return dq, dk, dv, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """Flash attention on ``(B, T, H, Dh)`` tensors, a drop-in for
    ``attention.mha``."""
    return _FlashAttention.apply(q, k, v, 0, 0, bool(causal))[0]


def flash_mha_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_off: int = 0, k_off: int = 0, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` with position offsets for the causal mask; ``lse`` is
    ``(B, T, H)`` f32 and takes a cotangent of its own."""
    o, lse = _FlashAttention.apply(q, k, v, int(q_off), int(k_off),
                                   bool(causal))
    return o, lse.permute(0, 2, 1)
