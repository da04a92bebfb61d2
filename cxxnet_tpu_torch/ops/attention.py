"""Multi-head attention: the dense golden function, and the ring and
all-to-all (sequence-parallel) variants over the model axis.

Counterpart of ``cxxnet_tpu/ops/attention.py``.  ``mha``: the full
``(B, H, Tq, Tk)`` score matrix in f32, softmax, probabilities rounded
to ``v``'s dtype before the product with ``v``, f32 accumulation, the
result in ``v``'s dtype.  Layouts are the JAX package's: ``q, k, v`` are
``(B, T, H, Dh)``.

The attention layer runs ``mha`` on the CPU (``attn_impl = xla`` or
``auto``) and, on a card, for the head dims the flash kernels
(``ops/flash.py``) are not built for; ``pipe_transformer``'s blocks run
it everywhere, as the JAX package's do.

The sequence-parallel forms run over a model sub-group of ``n`` ranks
(``parallel/distributed.py``).  ``ring_attention``,
``ring_attention_flash`` and ``a2a_attention`` are the per-rank
computations the JAX package runs under ``shard_map`` with T sharded on
``"model"``: each rank holds ``(B, T/n, H, Dh)`` blocks.  The ring
makes ``n - 1`` rotations of the K/V block with
``distributed.ppermute`` (hop 0 is the rank's own block) and merges
each hop by the streaming softmax, or, in the flash form, the hop's
``(o, lse)`` from ``flash_mha_lse`` (K9 forward, K10 backward, once a
hop, with this rank's query offset and the hop's key offset) in f32
by ``logaddexp``; a hop wholly in the future gives ``lse = -1e30`` and
washes out.  The all-to-all form swaps the T split for a head split
(``distributed.all_to_all``), attends over the whole sequence locally,
and swaps back.  The ``*_self_attention*`` wrappers take every model
rank's whole ``(B, T, H, Dh)`` tensors (the same on each: outside the
attention the model ranks compute alike) through :func:`scatter_t`,
whose backward all-gathers the gradient slices, and give the whole
output through :func:`gather_t`, whose backward keeps this rank's slice
of the gradient (every model rank holds the same loss: nothing is
summed).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel import distributed as pdist

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


# ----------------------------------------------------------------------
# sequence parallelism over a model sub-group
def _place(group):
    """``(index, n)`` of this rank in the sub-group ``group``."""
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


class _ScatterT(torch.autograd.Function):
    """This rank's ``T/n`` slice of a tensor every rank holds whole; the
    backward all-gathers the slices' gradients over the group."""

    @staticmethod
    def forward(ctx, x, group):
        idx, n = _place(group)
        ctx.group = group
        tl = x.shape[1] // n
        return x.narrow(1, idx * tl, tl).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(pdist.all_gather(g.contiguous(), ctx.group),
                         dim=1), None


class _GatherT(torch.autograd.Function):
    """The whole tensor from every rank's ``T/n`` slice; the backward
    keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        idx, n = _place(group)
        ctx.place = (idx, x.shape[1])
        return torch.cat(pdist.all_gather(x.contiguous(), group), dim=1)

    @staticmethod
    def backward(ctx, g):
        idx, tl = ctx.place
        return g.narrow(1, idx * tl, tl).contiguous(), None


def scatter_t(x: torch.Tensor, group) -> torch.Tensor:
    return _ScatterT.apply(x, group)


def gather_t(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherT.apply(x, group)


def _rotate(kb: torch.Tensor, vb: torch.Tensor, n: int, group):
    """One ring hop: K and V move together to the next rank."""
    perm = [(i, (i + 1) % n) for i in range(n)]
    kv = pdist.ppermute(torch.stack([kb, vb]), perm, group)
    return kv[0], kv[1]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = False) -> torch.Tensor:
    """Blockwise ring attention on this rank's ``(B, T/n, H, Dh)``
    blocks: the K/V block makes ``n - 1`` rotations and each arrival
    merges by the streaming softmax (f32); the output stays here."""
    idx, n = _place(group)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    qf = q.float()
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)

    def merge(o, m, l, kb, vb, hop):
        src = (idx - hop) % n
        s = _scores(qf, kb.float())
        mask = None
        if causal:
            mask = causal_mask(tq, tk, idx * tq, src * tk, q.device)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask, p, torch.zeros_like(p))
        l_new = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vb.float())
        return o * corr.transpose(1, 2)[..., None] + pv, m_new, l_new

    o, m, l = merge(o, m, l, k, v, 0)
    kb, vb = k, v
    for hop in range(1, n):
        kb, vb = _rotate(kb, vb, n, group)
        o, m, l = merge(o, m, l, kb, vb, hop)
    l = torch.clamp_min(l, 1e-30)  # fully masked rows
    return (o / l.transpose(1, 2)[..., None]).to(v.dtype)


def ring_attention_flash(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, group,
                         causal: bool = False) -> torch.Tensor:
    """Ring attention whose hops run the flash kernels: each hop's
    ``(o, lse)`` from ``flash_mha_lse`` with this rank's query offset
    ``idx * tq`` and the hop's key offset ``src * tk``, merged in f32:
    ``lse' = logaddexp(lse, lse_h)``, outputs reweighted by ``exp(lse -
    lse')`` and ``exp(lse_h - lse')``."""
    from .flash import flash_mha_lse

    idx, n = _place(group)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, tq, h), NEG_INF, dtype=torch.float32,
                     device=q.device)

    def hop(o, lse, kb, vb, hop_i):
        src = (idx - hop_i) % n
        o_h, lse_h = flash_mha_lse(q, kb, vb, idx * tq, src * tk, causal)
        lse_new = torch.logaddexp(lse, lse_h)
        w_old = torch.exp(lse - lse_new)[..., None]
        w_new = torch.exp(lse_h - lse_new)[..., None]
        return o * w_old + o_h.float() * w_new, lse_new

    o, lse = hop(o, lse, k, v, 0)
    kb, vb = k, v
    for hop_i in range(1, n):
        kb, vb = _rotate(kb, vb, n, group)
        o, lse = hop(o, lse, kb, vb, hop_i)
    return o.to(v.dtype)


def a2a_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  group, causal: bool = False,
                  attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Ulysses-style all-to-all sequence parallelism on this rank's
    ``(B, T/n, H, Dh)`` blocks: the T split becomes a head split
    ``(B, T, H/n, Dh)``, ``attn_fn`` (``mha`` by default) attends over
    the whole sequence, and the output goes back to the T split."""
    def swap(x, fwd: bool):
        return pdist.all_to_all(x, 2 if fwd else 1, 1 if fwd else 2, group)

    local = attn_fn if attn_fn is not None else mha
    o = local(swap(q, True), swap(k, True), swap(v, True), causal)
    return swap(o, False)


def _self(fn, x_q, x_k, x_v, group, **kw):
    return gather_t(fn(scatter_t(x_q, group), scatter_t(x_k, group),
                       scatter_t(x_v, group), group, **kw), group)


def ring_self_attention(x_q, x_k, x_v, group, causal: bool = False):
    """:func:`ring_attention` on every model rank's whole ``(B, T, H,
    Dh)`` tensors; returns the whole output."""
    return _self(ring_attention, x_q, x_k, x_v, group, causal=causal)


def ring_self_attention_flash(x_q, x_k, x_v, group, causal: bool = False):
    """:func:`ring_attention_flash` on whole tensors."""
    return _self(ring_attention_flash, x_q, x_k, x_v, group, causal=causal)


def a2a_self_attention(x_q, x_k, x_v, group, causal: bool = False,
                       attn_fn: Optional[Callable] = None):
    """:func:`a2a_attention` on whole tensors."""
    return _self(a2a_attention, x_q, x_k, x_v, group, causal=causal,
                 attn_fn=attn_fn)
