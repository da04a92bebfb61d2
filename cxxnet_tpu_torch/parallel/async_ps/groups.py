"""Gradient-exchange groups: partition the parameter tensors.

The port's ``cxxnet_tpu/parallel/async_ps/groups.py``, pure functions
over a ``{key: {tag: tensor}}`` tree whose insertion order is the
net's layer order.  ``partition_groups`` buckets the tensors greedily,
in that order, so every group carries about ``total_params /
n_groups`` parameters; ``async_groups = 0`` (auto) picks ``min(4,
n_tensors)`` groups.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

GroupKey = Tuple[str, str]  # (param key, tag), e.g. ("l0_fc1", "wmat")

DEFAULT_MAX_GROUPS = 4


def tensor_sizes(params: Dict[str, dict]) -> List[Tuple[str, str, int]]:
    """``[(key, tag, n_elements)]`` in the params tree's layer order."""
    out: List[Tuple[str, str, int]] = []
    for key, tags in params.items():
        for tag, w in tags.items():
            out.append((key, tag, int(np.prod(tuple(w.shape),
                                              dtype=np.int64))))
    return out


def partition_groups(params: Dict[str, dict],
                     n_groups: int = 0) -> List[List[GroupKey]]:
    """Contiguous, parameter-count-balanced partition of the tensors.

    ``n_groups <= 0`` = auto (``min(4, n_tensors)``); an explicit count
    is clamped to the tensor count so every group is non-empty.  A
    group closes once its cumulative size reaches the proportional
    target, always leaving at least one tensor for each remaining
    group.
    """
    tensors = tensor_sizes(params)
    if not tensors:
        return []
    n = len(tensors)
    g = min(DEFAULT_MAX_GROUPS, n) if n_groups <= 0 else min(int(n_groups), n)
    total = max(1, sum(s for _, _, s in tensors))
    out: List[List[GroupKey]] = []
    cur: List[GroupKey] = []
    cum = 0
    for idx, (key, tag, size) in enumerate(tensors):
        cur.append((key, tag))
        cum += size
        remaining = n - idx - 1        # tensors after this one
        still_open = g - len(out) - 1  # groups after the current one
        if len(out) < g - 1 and (
                cum * g >= total * (len(out) + 1)
                or remaining <= still_open):
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    assert len(out) == g and all(out), (
        f"partition bug: {len(out)} groups for g={g}")
    return out


def subtree(tree: Dict[str, dict], group: List[GroupKey]) -> Dict[str, dict]:
    """The ``{key: {tag: leaf}}`` sub-tree holding one group's leaves."""
    out: Dict[str, dict] = {}
    for key, tag in group:
        out.setdefault(key, {})[tag] = tree[key][tag]
    return out


def write_back(tree: Dict[str, dict], group: List[GroupKey],
               sub: Dict[str, dict]) -> None:
    """Fold one group's leaves back into the full tree."""
    for key, tag in group:
        tree[key][tag] = sub[key][tag]


def group_param_counts(params: Dict[str, dict],
                       groups: List[List[GroupKey]]) -> List[int]:
    sizes = {(k, t): s for k, t, s in tensor_sizes(params)}
    return [sum(sizes[kt] for kt in grp) for grp in groups]
