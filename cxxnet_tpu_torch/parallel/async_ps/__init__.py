"""Async data parallelism: the parameter-server step over the ranks.

The port's ``cxxnet_tpu/parallel/async_ps``.  ``async_overlap = 1``
splits the synchronous step's one gradient exchange into one per
*group* of tensors:

* :mod:`.groups` — the contiguous, parameter-count-balanced partition
  of the tensors (``async_groups``; 0 = ``min(4, n_tensors)``), the
  JAX package's exactly;
* :mod:`.step` — the overlapped step: each rank's backward with no
  collective, then, from the last group to the first, an all-gather of
  the group's flat gradients over the data sub-group, started with
  ``async_op=True`` one group ahead, the rank-order fold ``((g0 + g1) +
  g2) + ...`` and the group's apply (for ``sgd`` one launch of the fused
  SGD kernel over the group's table);
* :mod:`.updater` — the Push / PullReq / PullWait buffers of bounded
  staleness (``staleness = k``) over the trainer's updaters, drained
  every ``async_resync_period`` rounds and before a checkpoint, with
  generation-stamped aggregates.

The contract is the JAX package's: ``staleness = 0`` is bitwise equal
to the ``det_reduce = 1`` step (the same all-gather and fold, the same
updaters, elementwise); ``staleness > 0`` delays each aggregate by that
many steps.
"""

from __future__ import annotations

from .groups import (
    group_param_counts,
    partition_groups,
    subtree,
    tensor_sizes,
    write_back,
)
from .step import AsyncStepper
from .updater import AsyncUpdater

__all__ = [
    "AsyncStepper",
    "AsyncUpdater",
    "group_param_counts",
    "partition_groups",
    "subtree",
    "tensor_sizes",
    "write_back",
]
