"""Block stacks: the homogeneous stacks that ``pipe_mlp`` and
``pipe_transformer`` run, and the GPipe entry over stages.

Counterpart of ``cxxnet_tpu/ops/pipeline.py``.  A stack is
``block_fn(params, x) -> y`` applied ``L`` times with stacked params
(leading dim ``L``).  ``_stage_apply`` runs it as a Python loop over the
``L`` slices (the JAX package's ``lax.scan``); autograd differentiates
through the slices back to the stacked masters.

``pipeline_apply`` keeps the JAX package's divisibility checks and
messages.  Over one stage the pipeline is the plain stack: the blocks
are row-independent, so the microbatches' outputs are the whole batch's.
The GPipe tick schedule over more than one stage (activations passed
stage to stage by ``ppermute``, one device a stage) is multi-device and
raises ``NotImplementedError`` (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _stage_apply(block_fn: Callable, stage_params: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Run the stack's blocks in order on one activation."""
    n = next(iter(stage_params.values())).shape[0]
    for i in range(n):
        x = block_fn({t: v[i] for t, v in stage_params.items()}, x)
    return x


def pipeline_apply(block_fn: Callable, params_stacked: Dict[str, torch.Tensor],
                   x: torch.Tensor, n_stage: int, *,
                   n_microbatch: int) -> torch.Tensor:
    """The ``(L, ...)`` param stack over ``n_stage`` stages on the
    ``(B, ...)`` batch cut into ``n_microbatch`` microbatches."""
    b = x.shape[0]
    if b % n_microbatch != 0:
        raise ValueError(
            f"batch {b} must divide into {n_microbatch} microbatches")
    l = next(iter(params_stacked.values())).shape[0]
    if l % n_stage != 0:
        raise ValueError(f"{l} blocks must divide over {n_stage} stages")
    if n_stage > 1:
        raise NotImplementedError(
            f"pipeline over {n_stage} stages: the GPipe schedule across "
            "devices is not ported yet (ROADMAP.md queue A item 6, (k2b))")
    return _stage_apply(block_fn, params_stacked, x)
