"""Block stacks: the homogeneous stacks that ``pipe_mlp`` and
``pipe_transformer`` run, and GPipe over the stages of a model axis.

Counterpart of ``cxxnet_tpu/ops/pipeline.py``.  A stack is
``block_fn(params, x) -> y`` applied ``L`` times with stacked params
(leading dim ``L``).  ``_stage_apply`` runs it as a Python loop over the
``L`` slices (the JAX package's ``lax.scan``); autograd differentiates
through the slices back to the stacked masters.

:func:`gpipe` is the JAX package's tick schedule over the ``S`` ranks
of a model sub-group, stage ``s`` holding blocks ``[s*L/S, (s+1)*L/S)``
(its slice of the stack, cut by ``MeshPlan.model_dim``): for ``T + S -
1`` ticks each stage runs its blocks on the activation it holds, stage
0 feeding microbatch ``k`` at tick ``k`` and the last stage storing
microbatch ``k - (S - 1)``; between ticks the activations hop one stage
on by ``distributed._ppermute``.  A tick in which a stage holds no
microbatch (the bubble, ``(S - 1) / (T + S - 1)`` of the ticks) runs no
block and passes zeros: it stores nothing, as in the JAX package where
such a tick's values never reach the output.  A final sum over the
model sub-group (``distributed.model_sum``, whose backward hands every
stage the output's gradient once) replicates the output.

The backward is the schedule transposed, written out
(:class:`_GPipe`): the forward keeps each tick's graph of its own
blocks, and the backward walks the ticks in reverse, takes the
gradient of the tick's output from the next stage by the inverse hop,
adds the stored microbatch's gradient on the last stage, and runs
``torch.autograd.grad`` through the tick's blocks.  Every stage issues
the same hops in the same order, so the collectives pair up whatever
order autograd visits the rest of the graph in.  The stage's input
``x`` is replicated on the model ranks and only stage 0 reads it, so
the caller passes it through ``distributed.model_input`` (the
gradient summed over the sub-group).

:func:`pipeline_apply` keeps the JAX package's checks and messages, on
the global batch (a rank of a data-parallel group holds ``1 / n_data``
of its rows: the microbatches are cut from the rank's own rows, which
the row-independent blocks make the same function).  Over one stage the
pipeline is the plain stack.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..parallel import distributed as pdist


def _stage_apply(block_fn: Callable, stage_params: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Run the stack's blocks in order on one activation."""
    n = next(iter(stage_params.values())).shape[0]
    for i in range(n):
        x = block_fn({t: v[i] for t, v in stage_params.items()}, x)
    return x


def _hop(t: torch.Tensor, n_stage: int, group, inverse: bool = False):
    """One tick's hop: stage ``s`` receives stage ``s - 1``'s tensor
    (``inverse``: ``s + 1``'s), zeros at the end of the line."""
    perm = [(i, i + 1) for i in range(n_stage - 1)]
    if inverse:
        perm = [(d, s) for s, d in perm]
    return pdist._ppermute(t, perm, group)


def _schedule(block_fn, stage, x_mb, group, keep: bool):
    """The forward ticks of :func:`gpipe` on this stage; returns the
    stored outputs ``(T, mb, ...)`` (zeros but on the last stage) and,
    with ``keep``, each tick's ``(input, output)`` graph by tick."""
    n_stage, idx = pdist._size(group), pdist.dist.get_rank(group)
    t = x_mb.shape[0]
    n_tick = t + n_stage - 1
    out = torch.zeros_like(x_mb)
    graphs = {}
    reg = torch.zeros_like(x_mb[0])
    for k in range(n_tick):
        mb = k - idx
        if idx == 0 and k < t:
            reg = x_mb[k]
        if 0 <= mb < t:
            if keep:
                inp = reg.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = _stage_apply(block_fn, stage, inp)
                graphs[k] = (inp, y)
                y = y.detach()
            else:
                y = _stage_apply(block_fn, stage, reg)
            if idx == n_stage - 1:
                out[mb] = y
        else:
            y = torch.zeros_like(reg)
        if k < n_tick - 1:
            reg = _hop(y, n_stage, group)
    return out, graphs


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_fn, names, group, x_mb, *leaves):
        stage = {n: v.detach().requires_grad_(v.requires_grad)
                 for n, v in zip(names, leaves)}
        out, graphs = _schedule(block_fn, stage, x_mb, group, keep=True)
        ctx.group, ctx.graphs = group, graphs
        ctx.stage = [stage[n] for n in names]
        ctx.x_shape = (x_mb.shape, x_mb.dtype, x_mb.device)
        return out

    @staticmethod
    def backward(ctx, g_out):
        group, graphs = ctx.group, ctx.graphs
        n_stage, idx = pdist._size(group), pdist.dist.get_rank(group)
        shape, dtype, device = ctx.x_shape
        t = shape[0]
        n_tick = t + n_stage - 1
        train = [v for v in ctx.stage if v.requires_grad]
        g_stage = [None] * len(train)
        g_x = torch.zeros(shape, dtype=dtype, device=device)
        g_send = torch.zeros(shape[1:], dtype=dtype, device=device)
        for k in reversed(range(n_tick)):
            if k < n_tick - 1:  # the gradient of this tick's output
                g_y = _hop(g_send, n_stage, group, inverse=True)
            else:
                g_y = torch.zeros_like(g_send)
            g_send = torch.zeros_like(g_send)
            mb = k - idx
            if not 0 <= mb < t:
                continue
            if idx == n_stage - 1:
                g_y = g_y + g_out[mb]
            inp, y = graphs.pop(k)
            grads = torch.autograd.grad(y, [inp] + train, g_y,
                                        allow_unused=True)
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    g_stage[i] = g if g_stage[i] is None else g_stage[i] + g
            if idx == 0:
                g_x[mb] = grads[0]
            else:
                g_send = grads[0]
        it = iter(g_stage)
        g_leaves = [next(it) if v.requires_grad else None
                    for v in ctx.stage]
        return (None, None, None, g_x, *g_leaves)


def gpipe(block_fn: Callable, stage_params: Dict[str, torch.Tensor],
          x_mb: torch.Tensor, group) -> torch.Tensor:
    """The pipelined stack over the model sub-group ``group``:
    ``stage_params`` is this rank's ``(L/S, ...)`` stage, ``x_mb`` the
    ``(T, mb, ...)`` microbatches, the same on every stage.  Returns the
    ``(T, mb, ...)`` outputs, replicated (``T + S - 1`` ticks)."""
    names = list(stage_params)
    leaves = [stage_params[n] for n in names]
    if torch.is_grad_enabled() and (
            x_mb.requires_grad or any(v.requires_grad for v in leaves)):
        out = _GPipe.apply(block_fn, names, group, x_mb, *leaves)
    else:
        out = _schedule(block_fn, stage_params, x_mb, group, keep=False)[0]
    return pdist.model_sum(out, group)


def pipeline_apply(block_fn: Callable,
                   params_stacked: Dict[str, torch.Tensor],
                   x: torch.Tensor, plan=None, *, n_microbatch: int,
                   n_block: Optional[int] = None) -> torch.Tensor:
    """The ``(L, ...)`` stack over the stages of ``plan``'s model axis
    (a ``MeshPlan``; None or a one-rank axis: the plain stack) on this
    rank's ``(b, ...)`` rows cut into ``n_microbatch`` microbatches.
    ``params_stacked`` is this rank's stage of the stack (its
    ``MeshPlan.model_dim`` slice; the whole stack over one stage) and
    ``n_block`` the whole stack's ``L`` (default: the stage's blocks
    times the stages).  The checks are the JAX package's, on the global
    batch (this rank's rows times ``n_data`` inside
    ``distributed.sharded_batch``)."""
    n_stage = plan.n_model if plan is not None else 1
    b = x.shape[0]
    shard = pdist.batch_shard()
    b_global = b * shard[1] if shard is not None else b
    if b_global % n_microbatch != 0:
        raise ValueError(
            f"batch {b_global} must divide into {n_microbatch} microbatches")
    held = next(iter(params_stacked.values())).shape[0]
    l = n_block if n_block is not None else held * n_stage
    if l % n_stage != 0:
        raise ValueError(f"{l} blocks must divide over {n_stage} stages")
    if held * n_stage != l:
        raise ValueError(
            f"a stage holds {held} of {l} blocks over {n_stage} stages: "
            f"the stack must be cut one stage a model rank")
    if n_stage == 1:
        return _stage_apply(block_fn, params_stacked, x)
    # the rank's rows in as many equal microbatches as they allow
    t = n_microbatch if b % n_microbatch == 0 else math.gcd(b, n_microbatch)
    x_mb = pdist.model_input(x, plan.model_group)
    x_mb = x_mb.reshape((t, b // t) + tuple(x.shape[1:]))
    out = gpipe(block_fn, params_stacked, x_mb, plan.model_group)
    return out.reshape((b,) + tuple(out.shape[2:]))
