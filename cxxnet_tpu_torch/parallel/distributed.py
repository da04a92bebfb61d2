"""Multi-process data parallelism on ``torch.distributed``.

The port's ``cxxnet_tpu/parallel/distributed.py``.  The JAX package
joins every process to one ``jax.distributed`` job and runs one SPMD
program over the mesh; here the mesh is a ``torch.distributed`` process
group with one rank per device, and the trainer issues the collectives
itself (``nnet/trainer.py``).

Config keys (set on every process, e.g. by the CLI's device-range
launcher, ``cli.py``):

* ``dist_coordinator = host:port``: rank 0's address, where it hosts
  the group's ``TCPStore``
* ``dist_num_proc``: the number of processes in the job
* ``dist_proc_id``: this process's rank
* ``dist_timeout_s``: the deadline of the rendezvous and of every
  collective (default 300): a rank that dies or hangs brings the others
  down with an error, not a hang

or the environment variables ``CXN_COORDINATOR`` / ``CXN_NUM_PROC`` /
``CXN_PROC_ID`` (``PS_RANK`` for the rank), as in the JAX package.
Without any of them a run is one process and every function here is a
no-op.

**The backend rule** (:func:`backend_for`): ``gloo`` when a rank runs on
the CPU or when two ranks share a card (NCCL refuses two ranks on one
device), ``nccl`` when every rank has a card of its own.  Neither gives
way to the other: an ``init_process_group`` or collective failure
raises.  Gloo takes CUDA tensors for the three collectives this port
uses (:func:`all_reduce_`, :func:`all_gather`, :func:`broadcast_`), so
the tensors stay on the card and go to the backend as they are; a
collective gloo cannot run on them raises.

Under :func:`sharded_batch` (the trainer's training and evaluation
forwards in a group) the layers that see the whole batch see the
GLOBAL one, as under the JAX package's SPMD step: batch norm's sums go
through :func:`all_reduce_sum` (an all-reduce in the forward and in the
backward), and a random layer draws the global shape's mask and takes
its own rows (``layers/elemwise.py`` :func:`uniform`).

**The model axis** (:func:`sub_groups`, ``model_parallel = m``): the
ranks are laid out as the JAX package's ``(n_data, n_model)`` mesh,
rank ``r`` at data index ``r // m`` and model index ``r % m``.  Each
rank belongs to a data sub-group (the ranks of its model index: the
gradient reduction, batch norm's sums, the ZeRO slices, the metrics)
and a model sub-group (the ranks of its data index: sequence-parallel
attention, the GPipe stages, the tensor and expert slices), both made
with ``new_group`` on every rank in one order.
A trainer's ``MeshPlan`` (``parallel/mesh.py``) carries its two
sub-groups and hands them to every collective it runs: ``None`` is the
whole job, :data:`SOLO` a sub-group of this rank alone.
:func:`ppermute` and :func:`all_to_all` are the differentiable
``lax.ppermute`` / ``lax.all_to_all`` over a sub-group.  ``ppermute``
is an all-gather of the sub-group from which each rank takes the block
it is owed, under either backend (gloo's ``send`` of a CUDA tensor
aborts the process on torch 2.11; at two ranks the gather moves the
bytes the sends would).  The all-to-all is ``all_to_all_single``, which
gloo runs on CUDA tensors (its list form ``all_to_all`` it refuses
there).

The tensor and expert sharding over the model axis (``nnet/net.py``,
``layers/sequence.py``) runs on four differentiable collectives of the
model sub-group, Megatron's pair and their two relatives.  Outside
them every model rank computes the same values from the same rows, so
each holds the same loss and the same gradient of every replicated
value: :func:`model_input` is the identity whose backward sums the
ranks' partial input gradients; :func:`model_gather` all-gathers the
ranks' slices along a dimension, its backward keeping this rank's
slice of the gradient (behind :func:`model_input`, for a gathered
value each rank then uses differently, the ranks' gradients are summed
first);
:func:`model_sum` all-reduces the ranks' partial results, its backward
the identity; :func:`gather_leaves` gathers many weight slices in one
all-gather, each weight's backward keeping its own slice.

Not ported here: the JAX package's ``_enable_cpu_collectives`` (a JAX
CPU-backend switch; gloo is this port's CPU path), and the resilient
coordination client and its graceful/abandoning teardown, which belong
to the elastic pod (``parallel/elastic.py``, ROADMAP.md item (k4)).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

ConfigEntry = Tuple[str, str]

DEFAULT_TIMEOUT_S = 300.0

_state: Dict[str, object] = {"initialized": False, "backend": "",
                             "device": None, "timeout_s": DEFAULT_TIMEOUT_S}


class _Solo:
    """A sub-group of this rank alone (an axis of one rank): every
    collective over it returns its input."""

    def __repr__(self) -> str:
        return "SOLO"


SOLO = _Solo()

#: the ``(data, model)`` sub-groups of each ``n_model`` asked for, made
#: once a job (:func:`sub_groups`)
_groups: Dict[int, Tuple[object, object]] = {}
#: the group's collective traffic since the last :func:`reset_stats`:
#: calls, bytes handed to the backend, and the host seconds spent in the
#: calls
STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}
#: sharded_batch's (data index, n_data, data sub-group)
_shard: List[Optional[Tuple[int, int, object]]] = [None]


def distributed_spec(
    cfg: Sequence[ConfigEntry],
) -> Optional[Tuple[str, int, int]]:
    """Extract (coordinator, num_proc, proc_id) from config or env."""
    coord = os.environ.get("CXN_COORDINATOR")
    num = os.environ.get("CXN_NUM_PROC")
    pid = os.environ.get("CXN_PROC_ID", os.environ.get("PS_RANK"))
    for name, val in cfg:
        if name == "dist_coordinator":
            coord = val
        elif name == "dist_num_proc":
            num = val
        elif name == "dist_proc_id":
            pid = val
    if coord is None and num is None:
        return None
    if coord is None or num is None or pid is None:
        raise ValueError(
            "distributed run needs all of dist_coordinator, dist_num_proc, "
            "dist_proc_id (or CXN_COORDINATOR/CXN_NUM_PROC/CXN_PROC_ID)"
        )
    return coord, int(num), int(pid)


def _last(cfg: Sequence[ConfigEntry], name: str, default: str) -> str:
    val = default
    for n, v in cfg:
        if n == name:
            val = v
    return val


def maybe_init_distributed(cfg: Sequence[ConfigEntry]) -> bool:
    """Join the process group if the config asks for one.

    Idempotent; returns True when running multi-process.  Call it before
    anything touches the card: it binds this rank's device.  ``elastic``
    and ``elastic_join`` are the elastic pod's (ROADMAP.md item (k4))
    and raise."""
    spec = distributed_spec(cfg)
    if spec is None:
        return False
    for key in ("elastic", "elastic_join"):
        if _last(cfg, key, "0") not in ("", "0"):
            raise NotImplementedError(
                f"{key}: the elastic pod is not ported yet (ROADMAP.md "
                "queue A item 6, (k4))")
    if _state["initialized"]:
        return True
    coord, num, pid = spec
    init_distributed(coord, num, pid, dev=_last(cfg, "dev", "tpu"),
                     timeout_s=float(_last(cfg, "dist_timeout_s",
                                           str(DEFAULT_TIMEOUT_S))))
    return True


def backend_for(devices: Sequence[str]) -> str:
    """The group's backend from every rank's device (``str`` of a
    ``torch.device``): ``gloo`` on the CPU or when two ranks share a
    card, ``nccl`` when every rank has a card of its own."""
    if any(not d.startswith("cuda") for d in devices):
        return "gloo"
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


def init_distributed(coordinator: str, num: int, pid: int,
                     dev: str = "tpu", timeout_s: float = DEFAULT_TIMEOUT_S,
                     backend: str = "") -> None:
    """Join the group with explicit arguments: rank 0 hosts a
    ``TCPStore`` at ``coordinator``, every rank publishes its device
    there, the backend follows :func:`backend_for` (or ``backend``), and
    ``init_process_group`` runs over that store.  Every wait carries
    ``timeout_s``."""
    from .mesh import rank_device

    if not 0 <= pid < num:
        raise ValueError(f"dist_proc_id={pid} must lie in [0, {num})")
    device = rank_device(dev, pid, num)
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num, pid == 0, timeout=timeout)
    store.set(f"cxn_device/{pid}", str(device))
    devices = [store.get(f"cxn_device/{r}").decode() for r in range(num)]
    backend = backend or backend_for(devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=pid, world_size=num,
                            timeout=timeout)
    _state.update(initialized=True, backend=backend, device=device,
                  timeout_s=timeout_s)


def shutdown_distributed() -> bool:
    """Leave the group (``destroy_process_group``); the next
    :func:`maybe_init_distributed` may join again.  True when a group
    was torn down."""
    was = bool(_state["initialized"])
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, backend="", device=None)
    _groups.clear()
    return was


def distributed_initialized() -> bool:
    return bool(_state["initialized"])


def backend() -> str:
    """The group's backend (``gloo`` / ``nccl``), ``""`` without one."""
    return str(_state["backend"])


def process_info() -> Tuple[int, int]:
    """(process_id, process_count): (0, 1) for single-process runs."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sub_groups(n_model: int = 1) -> Tuple[object, object]:
    """This rank's ``(data sub-group, model sub-group)`` of the
    ``(n_data, n_model)`` layout (see the module docstring): ``None``
    for the whole job, :data:`SOLO` for an axis of one rank.
    Collective the first time a job asks for a given ``n_model > 1``
    (every rank makes every sub-group, in one order).  Raises with the
    JAX package's message when ``n_model`` does not divide the ranks."""
    rank, world = process_info()
    if n_model < 1 or world % n_model != 0:
        raise ValueError(
            f"model_parallel={n_model} must divide the device count {world}")
    if n_model == 1:
        return None, SOLO
    if n_model not in _groups:
        timeout = datetime.timedelta(seconds=float(_state["timeout_s"]))
        mine = {}
        n_data = world // n_model
        layouts = [("data", [list(range(j, world, n_model))
                             for j in range(n_model)]),
                   ("model", [list(range(i * n_model, (i + 1) * n_model))
                              for i in range(n_data)])]
        for axis, lists in layouts:
            for ranks in lists:
                g = (dist.new_group(ranks, timeout=timeout)
                     if len(ranks) > 1 else SOLO)
                if rank in ranks:
                    mine[axis] = g
        _groups[n_model] = (mine["data"], mine["model"])
    return _groups[n_model]


def _size(group) -> int:
    """The ranks in ``group`` (``None``: the whole job)."""
    if group is SOLO:
        return 1
    if group is None:
        return process_info()[1]
    return dist.get_world_size(group)


def is_primary() -> bool:
    """True on the process that owns checkpoint writes (rank 0)."""
    return process_info()[0] == 0


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)


# ----------------------------------------------------------------------
# the collectives: every call of the port goes through these three
def _account(t, t0: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["seconds"] += time.perf_counter() - t0


def all_reduce_(t, group=None):
    """Sum ``t`` over the job (or a sub-group), in place; returns
    ``t``."""
    if _size(group) == 1:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    _account(t, t0)
    return t


def all_gather(t, group=None) -> list:
    """Every rank's ``t`` (same shape and dtype on every rank) over the
    job (or a sub-group), in rank order."""
    if _size(group) == 1:
        return [t]
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t, group=group)
    _account(t, t0)
    return parts


def all_gather_async(t, group=None):
    """Start :func:`all_gather` with ``async_op=True``: returns ``(work,
    parts)``, ``parts`` valid once ``work.wait()`` returned (``work`` is
    None when there is nothing to exchange)."""
    if _size(group) == 1:
        return None, [t]
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    work = dist.all_gather(parts, t, group=group, async_op=True)
    _account(t, t0)
    return work, parts


def broadcast_(t, src: int = 0):
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    if process_info()[1] == 1:
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, src)
    _account(t, t0)
    return t


def _comm_device():
    """Where small host values travel: the CPU under gloo, the rank's
    card under NCCL (which takes CUDA tensors only)."""
    if _state["backend"] == "nccl":
        return _state["device"]
    return torch.device("cpu")


def gather_host(arr: np.ndarray, group=None) -> np.ndarray:
    """Every rank's numpy ``arr`` (same shape and dtype on every rank),
    stacked in rank order: ``[world, *arr.shape]`` (over a sub-group:
    its ranks).  Exact for any dtype: the bytes travel as int64
    words."""
    a = np.ascontiguousarray(arr)
    raw = a.view(np.uint8).reshape(-1)
    pad = (-raw.size) % 8
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    t = torch.from_numpy(raw.view(np.int64).copy()).to(_comm_device())
    parts = all_gather(t, group)
    out = [p.cpu().numpy().view(np.uint8)[:a.nbytes].view(a.dtype)
           .reshape(a.shape) for p in parts]
    return np.stack(out)


def agree_on_value(val: int, reduce: str = "min") -> int:
    """Cross-process integer agreement (allgather + min/max reduce).

    Single-process runs return ``val`` unchanged.  Every process resumes
    from the SAME round (``min``) and a flag set on any process stops
    the whole job (``max``)."""
    if process_info()[1] == 1:
        return int(val)
    vals = gather_host(np.asarray([val], np.int64)).reshape(-1)
    return int(vals.min() if reduce == "min" else vals.max())


def agree_on_round(local_round: int) -> int:
    """Resume-round consensus: the newest round EVERY process holds a
    valid checkpoint for (-1 when any process has none)."""
    return agree_on_value(local_round, reduce="min")


def any_process_flag(flag: bool) -> bool:
    """True when the flag is set on ANY process (collective)."""
    return bool(agree_on_value(int(bool(flag)), reduce="max"))


def barrier(name: str = "cxxnet_barrier") -> None:
    """Block until every process reaches this point (no-op single-proc).
    ``name`` labels the wait in errors."""
    if process_info()[1] == 1:
        return
    try:
        agree_on_value(0)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name}: {e}") from e


def fetch_array(x, dim: Optional[int] = None) -> np.ndarray:
    """A tensor as a full host ndarray.  ``dim`` names the dimension
    along which ``x`` is this rank's equal slice of a sharded array
    (the trainer's ZeRO placement): the slices are all-gathered first
    (collective)."""
    if dim is None or process_info()[1] == 1:
        return x.detach().cpu().numpy()
    return torch.cat(all_gather(x.detach()), dim=dim).cpu().numpy()


def fetch_local_rows(x, axis: int = 0) -> np.ndarray:
    """This process's rows of a batch-major array.  Each rank of the
    port feeds and computes only its own rows, so they are ``x``
    itself; kept for the JAX package's API."""
    del axis
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def global_batch_parts(n: int) -> List[int]:
    """Deterministic split of a global batch over processes (equal shards)."""
    _, count = process_info()
    if n % count != 0:
        raise ValueError(
            f"global batch {n} must divide process count {count}"
        )
    return [n // count] * count


# ----------------------------------------------------------------------
# the layers that see the whole batch
@contextlib.contextmanager
def sharded_batch(plan, active: bool = True):
    """Within this block a forward's batch is this rank's rows of the
    global batch of ``plan`` (a ``MeshPlan``): :func:`batch_shard`
    returns ``(data index, n_data)`` and :func:`all_reduce_sum` sums
    over ``plan``'s data sub-group.  A no-op on one data index.
    Process-wide, not per thread: a card's backward (and a ``remat``
    recompute in it) runs on autograd's device thread and must see the
    same shard."""
    prev = _shard[0]
    _shard[0] = ((plan.data_index, plan.n_data, plan.data_group)
                 if active and plan.n_data > 1 else None)
    try:
        yield
    finally:
        _shard[0] = prev


def batch_shard() -> Optional[Tuple[int, int]]:
    """``(data index, n_data)`` inside :func:`sharded_batch` over more
    than one data index, else None."""
    return None if _shard[0] is None else _shard[0][:2]


def all_reduce_sum(t):
    """The sum of ``t`` over the data sub-group of the enclosing
    :func:`sharded_batch`, with a gradient: an all-reduce in the
    forward, and in the backward (each rank's loss reads the sum, so
    the gradient of every rank's input is the sum of the ranks'
    gradients of the output)."""
    return _AllReduceSum.apply(t, _shard[0][2])


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


# ----------------------------------------------------------------------
# the model axis: lax.ppermute and lax.all_to_all over a sub-group
def _ppermute(t, perm: Sequence[Tuple[int, int]], group):
    """``lax.ppermute`` over ``group``'s ranks: the result is what the
    rank ``src`` of this rank's ``(src, me)`` pair holds, zeros where no
    pair names this rank as a destination.  One all-gather of the
    sub-group carries it (see the module docstring)."""
    me = dist.get_rank(group)
    src = next((s_ for s_, d in perm if d == me), None)
    t = t.contiguous()
    t0 = time.perf_counter()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t, group=group)
    out = parts[src] if src is not None else torch.zeros_like(t)
    _account(t, t0)
    return out


def _all_to_all(t, split_dim: int, concat_dim: int, group):
    """Tiled ``lax.all_to_all``: ``t`` cut into ``n`` equal chunks along
    ``split_dim``, chunk ``j`` to group rank ``j``; the chunks received
    joined along ``concat_dim`` in group-rank order."""
    n = _size(group)
    t0 = time.perf_counter()
    blocks = torch.stack(t.chunk(n, split_dim)).contiguous()  # (n, ...)
    out = torch.empty(blocks.shape, dtype=blocks.dtype, device=blocks.device)
    dist.all_to_all_single(out, blocks, group=group)
    _account(blocks, t0)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s_) for s_, d in ctx.perm]
        return _ppermute(g, inverse, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None,
                None, None)


def ppermute(t, perm: Sequence[Tuple[int, int]], group):
    """Differentiable ``lax.ppermute`` over ``group`` (a model
    sub-group): ``perm`` pairs ``(src, dst)`` of group ranks; the
    backward sends the gradient back along the inverse permutation."""
    return _PPermute.apply(t, [tuple(p) for p in perm], group)


def all_to_all(t, split_dim: int, concat_dim: int, group):
    """Differentiable tiled ``lax.all_to_all`` over ``group``; the
    backward is the inverse exchange (split and concat swapped)."""
    return _AllToAll.apply(t, split_dim, concat_dim, group)


# ----------------------------------------------------------------------
# the tensor and expert slices over a model sub-group
def _sum_f32(t, group):
    """``t`` summed over ``group`` in f32 (a copy), in ``t``'s dtype."""
    return all_reduce_(t.to(torch.float32, copy=True), group).to(t.dtype)


class _ModelInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.n = x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.n, ctx.n).contiguous(), None, None


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLeaves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dims, *ts):
        ctx.group, ctx.dims = group, dims
        ctx.shapes = [t.shape for t in ts]
        flat = torch.cat([t.reshape(-1) for t in ts])
        parts = all_gather(flat, group)
        out, off = [], 0
        for t, d in zip(ts, dims):
            n = t.numel()
            out.append(torch.cat([p[off:off + n].view(t.shape)
                                  for p in parts], dim=d))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        me = dist.get_rank(ctx.group)
        out = []
        for g, d, shape in zip(gs, ctx.dims, ctx.shapes):
            n = shape[d]
            out.append(None if g is None
                       else g.narrow(d, me * n, n).contiguous())
        return (None, None, *out)


def model_input(x, group):
    """``x``, replicated on the model ranks, as the input of a sliced
    computation: the identity, whose backward sums the ranks' partial
    gradients over ``group`` (in f32)."""
    if _size(group) == 1:
        return x
    return _ModelInput.apply(x, group)


def model_gather(x, dim: int, group):
    """The model ranks' equal slices of one tensor joined along ``dim``
    in rank order (an all-gather of ``group``); the backward keeps this
    rank's slice of the gradient."""
    if _size(group) == 1:
        return x
    return _ModelGather.apply(x, dim, group)


def model_sum(x, group):
    """The sum of the model ranks' partial ``x`` over ``group`` (in
    f32, an all-reduce); the backward passes the replicated gradient to
    every rank's part as it is."""
    if _size(group) == 1:
        return x
    return _ModelSum.apply(x, group)


def gather_leaves(ts: Sequence, dims: Sequence[int], group) -> list:
    """Whole weights from this rank's slices ``ts`` (cut along ``dims``)
    in one all-gather of ``group``, packed flat (every tensor one
    dtype); each weight's backward keeps this rank's slice of its
    gradient."""
    if not ts or _size(group) == 1:
        return list(ts)
    return list(_GatherLeaves.apply(group, tuple(dims), *ts))
