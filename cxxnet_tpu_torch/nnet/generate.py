"""Autoregressive byte generation from a trained language model.

Counterpart of ``cxxnet_tpu/nnet/generate.py``, used by ``task =
generate``.  Two decode paths over the same trained parameters:

* **KV-cache incremental decoding** (``cache=True``, the default): a
  decode twin of the trained net (the same structure and parameter
  tensors, input ``(1, 1)``, ``decode = 1`` so the embedding and the
  attention layers use absolute positions and per-layer key/value
  caches held as layer state) runs one single-token step per position.
  Used when prompt + gen_len fit the training window.
* **Sliding window** (``cache=False``, or the fallback when the net has
  no cache-capable layer or the request is longer than the window): the
  full ``T`` forward re-runs per token with the context left-aligned —
  on a card that forward's attention is the flash kernel (K9).

Both give the same greedy output inside the window.  The JAX package
jit-compiles the decode step; here every step is an eager call.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


class NoDecodeSupport(Exception):
    """The decode twin grew no KV caches — fall back to windows."""


def sample_token(p_row: np.ndarray, rng: np.random.RandomState,
                 temp: float, topk: int = 0, topp: float = 0.0) -> int:
    """Greedy (``temp == 0``) or log-space temperature sampling,
    optionally truncated to the ``topk`` most probable tokens and/or the
    ``topp`` nucleus; the draws are the JAX package's for one ``rng``."""
    if temp <= 0:
        return int(np.argmax(p_row))
    lp = np.log(np.maximum(np.asarray(p_row, np.float64), 1e-300)) / temp
    lp -= lp.max()
    pe = np.exp(lp)
    pe /= pe.sum()
    if topk and topk < len(pe):
        cut = np.argsort(pe)[:-topk]
        pe[cut] = 0.0
        pe /= pe.sum()
    if 0.0 < topp < 1.0:
        order = np.argsort(-pe)
        csum = np.cumsum(pe[order])
        keep_n = int(np.searchsorted(csum, topp) + 1)
        pe[order[keep_n:]] = 0.0
        pe /= pe.sum()
    return int(rng.choice(len(pe), p=pe))


def window_probs(tr, ctx: List[int]) -> np.ndarray:
    """The next-byte probability row after ``ctx`` from the trained
    net's full forward (the last ``T`` bytes of ``ctx`` at positions
    ``0..L-1``; causal masking hides the zero tail)."""
    from ..io.data import DataBatch

    t = tr.graph.input_shape[-1]
    window = ctx[-t:]
    data = np.zeros((1, t), np.float32)
    data[0, :len(window)] = window
    return tr.extract_feature(DataBatch(data=data, label=None),
                              "top[-1]")[0, len(window) - 1]


def generate_windowed(tr, ctx: List[int], gen_len: int, temp: float,
                      rng: np.random.RandomState, topk: int = 0,
                      topp: float = 0.0) -> str:
    """Sliding-window generation: one full forward per token."""
    ctx = list(ctx)
    out_bytes = []
    for _ in range(gen_len):
        nxt = sample_token(window_probs(tr, ctx), rng, temp, topk, topp)
        ctx.append(nxt)
        out_bytes.append(nxt)
    return bytes(out_bytes).decode("utf-8", "replace")


def _decode_twin(tr):
    """The decode trainer (``decode = 1``, input ``(1, 1)``) sharing
    ``tr``'s parameter tensors; cached on ``tr`` until its params object
    changes (a load)."""
    from .trainer import NetTrainer

    cached = getattr(tr, "_decode_twin_cache", None)
    if cached is not None and cached[0] is tr.params:
        return cached[1]

    t_train = tr.graph.input_shape[-1]
    batch1 = {"input_shape": "1,1,1", "batch_size": "1"}
    dec_cfg = [(n, batch1.get(n, v)) for n, v in tr.cfg]
    dec_cfg += [("decode", "1"), ("decode_window", str(t_train))]
    dec = NetTrainer()
    dec.set_params(dec_cfg)
    try:
        dec.init_model()
    except ValueError as e:
        # e.g. non-causal attention cannot decode incrementally
        raise NoDecodeSupport(str(e)) from e
    for key in dec.params:
        if key not in tr.params:
            raise ValueError(f"decode net key {key} missing from model")
        dec.params[key] = tr.params[key]
    if not dec.net.init_aux(1, dec.device):
        raise NoDecodeSupport("net has no KV-cache-capable layers")
    tr._decode_twin_cache = (tr.params, dec)
    return dec


def decode_step(dec, aux, tok: int, pos: int) -> np.ndarray:
    """One single-token step of the decode twin at position ``pos``
    (``aux`` updated in place); returns the f32 probability row."""
    net = dec.net
    x = torch.tensor([[float(tok)]], dtype=torch.float32, device=dec.device)
    with torch.no_grad():
        nodes = net.forward(dec._prepared_for(dec.params), x, aux=aux,
                            step=pos)
    return nodes[net.out_node_index()].float()[0, 0].cpu().numpy()


def generate_cached(tr, ctx: List[int], gen_len: int, temp: float,
                    rng: np.random.RandomState, topk: int = 0,
                    topp: float = 0.0) -> str:
    """KV-cache incremental decoding; raises :class:`NoDecodeSupport`
    when the net cannot run it."""
    dec = _decode_twin(tr)
    # the shared tensors may have been updated in place since the twin
    # prepared its operands
    dec._invalidate_prepared()
    aux = dec.net.init_aux(1, dec.device)
    out_bytes = []
    probs = None
    for pos, tok in enumerate(ctx):
        probs = decode_step(dec, aux, tok, pos)
    pos = len(ctx)
    for _ in range(gen_len):
        nxt = sample_token(probs, rng, temp, topk, topp)
        out_bytes.append(nxt)
        if len(out_bytes) == gen_len:
            break
        probs = decode_step(dec, aux, nxt, pos)
        pos += 1
    return bytes(out_bytes).decode("utf-8", "replace")


def generate(tr, prompt: str = "", gen_len: int = 256, temp: float = 0.0,
             cache: bool = True, seed: Optional[int] = None,
             topk: int = 0, topp: float = 0.0, silent: bool = True) -> str:
    """Generate ``gen_len`` bytes continuing ``prompt`` from a trained
    byte-level language model (``tr``: a NetTrainer with a loaded or
    trained model).  The KV-cache path serves requests that fit the
    training window (prompt + gen_len <= T); longer ones take the
    sliding window, so ``gen_len`` is always honored."""
    if tr.graph is None:
        raise ValueError("generate: init_model/load_model first")
    ctx = list(prompt.encode("utf-8")) or [ord("\n")]
    rng = np.random.RandomState(tr.seed if seed is None else seed)
    t_train = tr.graph.input_shape[-1]
    if cache and len(ctx) + gen_len <= t_train:
        try:
            return generate_cached(tr, ctx, gen_len, temp, rng, topk, topp)
        except NoDecodeSupport as e:
            if not silent:
                print(f"gen_cache: {e or 'not supported by this net'}; "
                      "using the sliding-window path")
    elif cache and not silent:
        print(f"gen_cache: prompt ({len(ctx)}) + gen_len ({gen_len}) "
              f"exceeds the KV window ({t_train}); using the "
              "sliding-window path (set gen_cache = 0 to silence this)")
    return generate_windowed(tr, ctx, gen_len, temp, rng, topk, topp)
