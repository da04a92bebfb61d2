"""Plain multi-head attention: the dense golden function.

Counterpart of ``mha`` in ``cxxnet_tpu/ops/attention.py``: the full
``(B, H, Tq, Tk)`` score matrix in f32, softmax, probabilities rounded
to ``v``'s dtype before the product with ``v``, f32 accumulation, the
result in ``v``'s dtype.  Layouts are the JAX package's: ``q, k, v`` are
``(B, T, H, Dh)``.

The attention layer runs this on the CPU (``attn_impl = xla`` or
``auto``) and, on a card, for the head dims the flash kernels
(``ops/flash.py``) are not built for; ``pipe_transformer``'s blocks run
it everywhere, as the JAX package's do.  The ring and all-to-all
variants are multi-device (ROADMAP.md item A6).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,Tq,H,D),(B,Tk,H,D) -> (B,H,Tq,Tk) scaled dot product (f32)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s * (1.0 / torch.sqrt(torch.tensor(float(d))))


def causal_mask(tq: int, tk: int, q_off: int, k_off: int,
                device=None) -> torch.Tensor:
    """True where query position >= key position (may attend)."""
    qi = q_off + torch.arange(tq, device=device)[:, None]
    ki = k_off + torch.arange(tk, device=device)[None, :]
    return qi >= ki


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = False) -> torch.Tensor:
    """Plain softmax attention."""
    s = _scores(q, k)
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], 0, 0, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)
