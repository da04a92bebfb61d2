"""The device rule and the data-parallel mesh of ``dev=`` strings.

The port's ``cxxnet_tpu/parallel/mesh.py``.  Grammar parity with the
reference device parser: ``dev=gpu`` / ``dev=cpu`` is one device,
``dev=gpu:0-3`` devices 0..3 inclusive, ``dev=gpu:0,2,5`` a list.  The
platform word ``tpu`` / ``gpu`` / ``cuda`` means the card here, ``cpu``
the CPU (never taken unless asked).

The JAX package runs a device range as one SPMD program in one process;
the port runs one process per device (``parallel/distributed.py``), so
a :class:`MeshPlan` is this rank's device plus the group's shape:
``n_data x n_model`` ranks (``model_parallel = n_model``, which must
divide the ranks), laid out as the JAX package's ``reshape(n_data,
n_model)``: rank ``r`` at data index ``r // n_model`` and model index
``r % n_model``; the plan holds this rank's data and model sub-groups,
and everything a trainer reduces over an axis goes over its own plan's
sub-group.  The model axis carries sequence-parallel attention, the
GPipe stages of the block stacks, and the tensor and expert sharding
of :meth:`MeshPlan.model_dim`.  :func:`rank_device` maps a ``dev`` value and the rank to the rank's
``torch.device``: a single ordinal is every rank's (ranks
may share a card), a list as long as the group gives rank ``r`` its
``r``-th entry, a bare platform word gives rank ``r`` the card ``r``
modulo the cards present.  Each ordinal is checked against
``torch.cuda.device_count()`` with the JAX package's message.  In one
process a range raises, naming ``dist_num_proc``: the CLI's
``task=train`` starts one rank per listed device (``cli.py``).

:meth:`MeshPlan.model_dim` is the JAX package's ``param_sharding``
rule as an ownership rule over the model ranks: dim 3 of a 4-D tensor
(a conv's ``cout`` in HWIO), else dim 0 (a ``fullc``'s ``nout``, a
per-channel vector, the expert dim of the MoE stacks, the ``L`` of the
block stacks), cut into ``n_model`` equal slices when it divides, the
rank of model index ``j`` owning the ``j``-th; otherwise the tensor
stays whole on every model rank.  :meth:`MeshPlan.owner_dim` is
``state_sharding`` / ``fsdp_sharding`` on top of it, over the data
ranks: the largest dimension not already cut over the model axis whose
whole (global) size divides by ``n_data``, the first on a tie, cut into
``n_data`` slices, the ranks of data index ``i`` owning the ``i``-th; a
tensor with no such dimension stays whole over the data axis.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from . import distributed


def parse_device(dev: str) -> Tuple[str, List[int]]:
    """``"tpu:0-3"`` → ``("tpu", [0,1,2,3])``; bare platform → ``[0]``."""
    dev = dev.strip()
    if ":" not in dev:
        return dev, [0]
    plat, spec = dev.split(":", 1)
    ids: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            if int(hi) < int(lo):
                raise ValueError(f"dev={dev!r}: reversed range {part!r}")
            ids.extend(range(int(lo), int(hi) + 1))
        elif part:
            ids.append(int(part))
    if not ids:
        raise ValueError(f"dev={dev!r}: empty device list")
    return plat, ids


def check_ordinals(dev: str, ids: Sequence[int]) -> None:
    """Raise as the JAX package does when an ordinal names a card this
    host does not have (a CUDA device must be present)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"dev={dev.strip()} needs a CUDA device and none is available "
            "(set dev=cpu to run on the CPU)")
    n = torch.cuda.device_count()
    if any(i >= n for i in ids):
        raise ValueError(
            f"dev={dev!r} requests device ordinals {list(ids)} but only "
            f"{n} devices are available")


def rank_device(dev: str, rank: int = 0, world: int = 1) -> torch.device:
    """This rank's ``torch.device`` for the conf value ``dev`` (see the
    module docstring); never falls back to the CPU."""
    plat, ids = parse_device(dev.strip().lower())
    bare = ":" not in dev
    if world == 1 and len(ids) > 1:
        raise NotImplementedError(
            f"dev={dev.strip()}: one device per process; a device range "
            "runs as one process per device with dist_num_proc, "
            "dist_proc_id and dist_coordinator on each (the CLI's "
            "task=train starts them for a range)")
    if world > 1 and len(ids) not in (1, world):
        raise ValueError(
            f"dev={dev.strip()}: {len(ids)} devices for {world} processes "
            "(give one device, or one per process)")
    if plat == "cpu":
        return torch.device("cpu")
    if bare and world > 1:
        check_ordinals(dev, [0])
        return torch.device(f"cuda:{rank % torch.cuda.device_count()}")
    ordinal = ids[rank] if len(ids) == world > 1 else ids[0]
    check_ordinals(dev, ids if len(ids) == world else [ordinal])
    return torch.device(f"cuda:{ordinal}")


@dataclasses.dataclass
class MeshPlan:
    """This rank's device, the group's ``(n_data, n_model)`` shape,
    this rank's place in it and its two sub-groups (as
    ``distributed.sub_groups`` gives them: ``None`` the whole job,
    ``distributed.SOLO`` this rank alone)."""

    device: torch.device
    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    backend: str = ""
    data_group: object = None
    model_group: object = distributed.SOLO

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    def model_dim(self, shape: Sequence[int]) -> Optional[int]:
        """The dimension of a tensor of whole ``shape`` cut over the
        model ranks (the JAX ``param_sharding`` rule: dim 3 of a 4-D
        tensor, else dim 0, when it divides by ``n_model``), or None:
        whole on every model rank."""
        if self.n_model == 1 or not shape:
            return None
        axis = 3 if len(shape) == 4 else 0
        return axis if int(shape[axis]) % self.n_model == 0 else None

    def owner_dim(self, shape: Sequence[int]) -> Optional[int]:
        """The dimension cut over the data ranks for a sharded tensor of
        whole ``shape`` (the JAX ``state_sharding`` rule: the largest
        dim not cut by :meth:`model_dim` that divides by ``n_data``,
        the first on a tie), or None: whole over the data axis."""
        if self.n_data == 1 or not shape:
            return None
        skip = self.model_dim(shape)
        best, best_size = None, 0
        for d, size in enumerate(shape):
            if d != skip and size % self.n_data == 0 and size > best_size:
                best, best_size = d, size
        return best

    def slice_bounds(self, shape: Sequence[int], dim: int,
                     rank: Optional[int] = None,
                     axis: str = "data") -> Tuple[int, int]:
        """``(start, length)`` of the slice along ``dim`` of a tensor of
        ``shape`` that index ``rank`` of ``axis`` (``"data"`` or
        ``"model"``) owns: this rank's index by default."""
        if axis == "model":
            parts, mine = self.n_model, self.model_index
        else:
            parts, mine = self.n_data, self.data_index
        n = int(shape[dim]) // parts
        return (mine if rank is None else rank) * n, n

    def describe(self, zero: int = 0) -> str:
        """One-line layout summary shared by the CLI's train-start line
        and ``task=summary``."""
        line = (f"data={self.n_data} model={self.n_model} zero={zero} "
                f"processes={self.n_devices}")
        if self.backend:
            line += f" backend={self.backend}"
        return line

    def check_batch(self, batch_size: int) -> None:
        if batch_size % self.n_data != 0:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the number of "
                f"data-parallel devices ({self.n_data}), as in the reference "
                f"(nnet_impl-inl.hpp:146-151)"
            )


def plan_for(device: torch.device, model_parallel: int = 1) -> MeshPlan:
    """This rank's :class:`MeshPlan` on ``device``, in the process group
    when one was joined, with its data and model sub-groups made
    (``distributed.sub_groups``; raises with the JAX package's message
    when ``model_parallel`` does not divide the ranks)."""
    rank, world = distributed.process_info()
    data_group, model_group = distributed.sub_groups(model_parallel)
    return MeshPlan(device=device, n_data=world // model_parallel,
                    n_model=model_parallel, rank=rank,
                    backend=distributed.backend(), data_group=data_group,
                    model_group=model_group)


def make_mesh(dev: str = "tpu", model_parallel: int = 1) -> MeshPlan:
    """:func:`plan_for` the device :func:`rank_device` gives this rank
    for a ``dev=`` string."""
    rank, world = distributed.process_info()
    return plan_for(rank_device(dev, rank, world), model_parallel)
