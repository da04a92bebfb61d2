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
raises.  Gloo takes CUDA tensors for the collectives this port uses
(:func:`all_reduce_`, :func:`all_gather`, :func:`broadcast_`,
:func:`reduce_scatter`: torch 2.11's gloo runs ``reduce_scatter_tensor``
on them too), so the tensors stay on the card and go to the backend as
they are; a collective gloo cannot run on them raises.  :data:`STATS`
counts every call, its bytes (``by_op``: by collective) and its host
seconds.

ZeRO over the data sub-group: :func:`reduce_scatter` leaves each rank
its slice of a packed gradient buffer (:func:`pack_by_rank`), and
:func:`gather_slices` (``GatherSlice``) gathers a layer's weights at use,
its backward the reduce-scatter of their gradient; under
:func:`saved_whole_hooks` what autograd saves of such a whole weight is
a recipe (:func:`register_regen`), gathered again when the backward
needs it.  :data:`GATHERED` is the most whole-weight bytes alive at
once.

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

**The elastic pod** (``parallel/elastic.py``): ``elastic = 1`` joins
as usual (``resilient``, which only marks the process for the CLI's hard
exit); ``elastic_join = 1`` joins nothing, since a waiting joiner has
no group until a grow admits it.  A rebuild tears the group down with
:func:`shutdown_distributed` ``(graceful=False)``: no barrier and no
collective (a dead peer would never answer), the group destroyed
locally, the sub-groups, the batch shard and :data:`STATS` cleared, and
the old generation's ``TCPStore`` dropped with it, so rank 0's store
server does not outlive its generation.  Then every rank joins the next
generation's group at the plan's fresh address.  A group that a thread
is still inside (a collective wedged on a live peer) is abandoned: its
objects are kept referenced, so nothing frees them under the thread,
and ``mesh.guard_thread_abandoned`` says so.  Under NCCL a dead peer
hangs a collective rather than failing it, so the teardown aborts the
communicator first (written, never run: one card).

Not ported here: the JAX package's ``_enable_cpu_collectives`` (a JAX
CPU-backend switch; gloo is this port's CPU path).
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

ConfigEntry = Tuple[str, str]

DEFAULT_TIMEOUT_S = 300.0

_state: Dict[str, object] = {"initialized": False, "backend": "",
                             "device": None, "timeout_s": DEFAULT_TIMEOUT_S,
                             "resilient": False}
#: groups abandoned by an elastic teardown while a thread was still
#: inside one of their collectives: kept referenced so that nothing
#: frees them under that thread (the process ends with a hard exit)
_abandoned: List[object] = []


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
STATS: Dict[str, object] = {"calls": 0, "bytes": 0, "seconds": 0.0,
                             "by_op": {}}
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
    anything touches the card: it binds this rank's device.  With
    ``elastic_join = 1`` it joins nothing and returns False: a waiting
    joiner has no group until the coordinator admits it (the CLI's
    ``_elastic_join_setup``).  ``elastic = 1`` joins as ``resilient``."""
    if _last(cfg, "elastic_join", "0") not in ("", "0"):
        return False
    spec = distributed_spec(cfg)
    if spec is None:
        return False
    if _state["initialized"]:
        return True
    coord, num, pid = spec
    init_distributed(coord, num, pid, dev=_last(cfg, "dev", "tpu"),
                     timeout_s=float(_last(cfg, "dist_timeout_s",
                                           str(DEFAULT_TIMEOUT_S))),
                     resilient=_last(cfg, "elastic", "0") not in ("", "0"))
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
                     backend: str = "", resilient: bool = False) -> None:
    """Join the group with explicit arguments: rank 0 hosts a
    ``TCPStore`` at ``coordinator``, every rank publishes its device
    there, the backend follows :func:`backend_for` (or ``backend``), and
    ``init_process_group`` runs over that store.  Every wait carries
    ``timeout_s``.  After :func:`shutdown_distributed` it joins again:
    the elastic rebuild's rendezvous, which blocks until all ``num``
    ranks arrive.  ``resilient`` marks the process as an elastic one
    (:func:`resilient_client_used`)."""
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
                  timeout_s=timeout_s, store=store)
    if resilient:
        _state["resilient"] = True
        from ..obs import emit as obs_emit

        obs_emit("mesh.dist_init", coordinator=coordinator, num=num,
                 rank=pid, resilient=True)


def resilient_client_used() -> bool:
    """Did this process ever join a group as an elastic one?  A group
    abandoned under a wedged thread cannot be freed, so the CLI ends
    such a process with a hard exit after a clean flush rather than
    run the interpreter's teardown."""
    return bool(_state["resilient"])


def _abort_nccl(pg) -> None:
    """Abort a NCCL group's communicators (a dead peer hangs a NCCL
    collective instead of failing it).  Written for the API of torch
    2.11 to 2.13; never run: the card's machine has one card."""
    try:
        backend_ = pg._get_backend(torch.device("cuda"))
    except Exception:  # noqa: BLE001 - no NCCL backend on this group
        return
    for name in ("abort", "_abort"):
        fn = getattr(backend_, name, None)
        if fn is not None:
            fn()
            return


def shutdown_distributed(graceful: bool = True,
                         abandon: bool = False) -> bool:
    """Leave the group; the next :func:`init_distributed` may join
    again.  True when a group was torn down.

    ``graceful=True``: every peer is known alive; the group is
    destroyed.  ``graceful=False`` (the elastic rebuild): no barrier and
    no collective, since a dead peer never answers one; under NCCL the
    communicators are aborted first.  ``abandon=True``: a thread is
    still inside one of the group's collectives, so the group objects
    are kept referenced (:data:`_abandoned`) and nothing frees them
    under it.  Either way the group is destroyed locally, the
    sub-groups, the batch shard and :data:`STATS` are cleared, and the
    generation's ``TCPStore`` goes with its last reference (rank 0's
    store server with it)."""
    was = bool(_state["initialized"])
    if dist.is_available() and dist.is_initialized():
        world = dist.group.WORLD
        if abandon:
            _abandoned.extend([world, *(g for pair in _groups.values()
                                        for g in pair if g is not SOLO)])
        if not graceful and _state["backend"] == "nccl":
            _abort_nccl(world)
        del world
        dist.destroy_process_group()
    _state.update(initialized=False, backend="", device=None, store=None)
    _groups.clear()
    _shard[0] = None
    reset_stats()
    if not graceful:
        from ..obs import emit as obs_emit

        if was:
            obs_emit("mesh.dist_teardown", graceful=False,
                     abandoned=len(_abandoned))
        gc.collect()  # the store's last reference: its server stops here
    return was


def distributed_initialized() -> bool:
    return bool(_state["initialized"])


def group_device():
    """This rank's ``torch.device`` in the live group (None without
    one)."""
    return _state["device"]


def store():
    """The live group's ``TCPStore`` (rank 0 hosts it; None without a
    group): the serving range's control channel (``serve/range.py``)."""
    return _state.get("store")


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
    STATS.update(calls=0, bytes=0, seconds=0.0, by_op={})


# ----------------------------------------------------------------------
# the collectives: every call of the port goes through these
def _account(t, t0: float, op: str) -> None:
    """Count one collective: ``t`` is what this rank hands the backend
    (a reduce-scatter counts the rank's share of its input, as an
    all-gather counts its input), also by ``op`` in ``by_op``."""
    nbytes = t.numel() * t.element_size()
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    STATS["seconds"] += time.perf_counter() - t0
    by_op = STATS["by_op"]
    by_op[op] = by_op.get(op, 0) + nbytes


def all_reduce_(t, group=None):
    """Sum ``t`` over the job (or a sub-group), in place; returns
    ``t``."""
    if _size(group) == 1:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    _account(t, t0, "all_reduce")
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
    _account(t, t0, "all_gather")
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
    _account(t, t0, "all_gather")
    return work, parts


def broadcast_(t, src: int = 0):
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    if process_info()[1] == 1:
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, src)
    _account(t, t0, "broadcast")
    return t


def rank_order_fold(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``((p0 + p1) + p2) + ...``: the ranks' tensors added in rank
    order, one fixed order whatever the backend (``det_reduce`` and the
    async exchange, ``parallel/async_ps``)."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc.add_(p)
    return acc


def reduce_scatter(buf, group=None, det: bool = False):
    """This rank's share of the sum of ``buf`` over the job (or a
    sub-group): ``buf`` (1-D, its length a multiple of the ranks) cut
    into one equal chunk per rank, rank ``i`` keeping the sum of every
    rank's ``i``-th chunk (``reduce_scatter_tensor``; gloo and NCCL both
    run it on CPU and CUDA tensors).  ``det``: all-gather the buffers
    and add them in rank order (:func:`rank_order_fold`), then slice,
    so the bits do not depend on the backend."""
    n = _size(group)
    if n == 1:
        return buf
    chunk = buf.numel() // n
    if det:
        return rank_order_fold(all_gather(buf, group)).narrow(
            0, _group_rank(group) * chunk, chunk)
    t0 = time.perf_counter()
    buf = buf.contiguous()
    out = torch.empty(chunk, dtype=buf.dtype, device=buf.device)
    dist.reduce_scatter_tensor(out, buf, group=group)
    _account(out, t0, "reduce_scatter")
    return out


def _group_rank(group) -> int:
    """This rank's index in ``group`` (``None``: the whole job)."""
    if group is SOLO:
        return 0
    return dist.get_rank(group) if group is not None else dist.get_rank()


def pack_by_rank(ts: Sequence[torch.Tensor], dims: Sequence[int],
                 n: int) -> torch.Tensor:
    """The flat buffer whose ``i``-th of ``n`` equal chunks holds, for
    every whole tensor of ``ts`` in order, its ``i``-th slice along its
    dim of ``dims``: what :func:`reduce_scatter` cuts so that each rank
    keeps its slice of each tensor."""
    return torch.cat([t.narrow(d, r * (t.shape[d] // n),
                               t.shape[d] // n).reshape(-1)
                      for r in range(n) for t, d in zip(ts, dims)])


def unpack_slices(flat: torch.Tensor, shapes: Sequence[Sequence[int]]
                  ) -> List[torch.Tensor]:
    """``flat`` (one rank's chunk of :func:`pack_by_rank`) as views of
    the slices' ``shapes``, in order."""
    out, off = [], 0
    for shape in shapes:
        k = int(np.prod(shape))
        out.append(flat[off:off + k].view(tuple(shape)))
        off += k
    return out


#: the ZeRO-3 gather's watermark: the bytes of whole weights (gathered
#: from slices, or derived from gathered ones) alive at once, and the
#: most seen since :func:`reset_gathered_peak`
GATHERED = {"live": 0, "peak": 0}


def track_gathered(t) -> None:
    """Count ``t``'s bytes in :data:`GATHERED` until ``t`` is freed."""
    import weakref

    nbytes = t.numel() * t.element_size()
    GATHERED["live"] += nbytes
    GATHERED["peak"] = max(GATHERED["peak"], GATHERED["live"])
    weakref.finalize(t, _untrack, nbytes)


def _untrack(nbytes: int) -> None:
    GATHERED["live"] -= nbytes


def reset_gathered_peak() -> None:
    GATHERED["peak"] = GATHERED["live"]


#: storage address -> how to make that storage's whole weight again:
#: ``(regen, dtype)`` for every whole weight alive that was gathered at
#: use (or derived from one), so that autograd keeps a recipe, not the
#: tensor (:func:`saved_whole_hooks`)
_REGEN: Dict[int, tuple] = {}


def register_regen(t, regen) -> None:
    """Let :func:`saved_whole_hooks` save ``t`` (a whole weight made at
    use, a fresh tensor) as ``regen``, a callable that makes it again
    (collective), for as long as ``t`` lives."""
    import weakref

    if t.numel() == 0 or t.storage_offset() != 0 or t._base is not None:
        return
    ptr = t.untyped_storage().data_ptr()
    if ptr in _REGEN:
        return
    _REGEN[ptr] = (regen, t.dtype)
    weakref.finalize(t, _REGEN.pop, ptr, None)


class _Regen:
    """A saved tensor stood in for by its recipe: a view of the whole
    weight that ``regen`` makes again."""

    __slots__ = ("regen", "size", "stride", "offset")

    def __init__(self, regen, t) -> None:
        self.regen = regen
        self.size, self.stride = tuple(t.shape), tuple(t.stride())
        self.offset = t.storage_offset()


def _pack(t):
    if t.numel() == 0:
        return t
    entry = _REGEN.get(t.untyped_storage().data_ptr())
    if entry is None or entry[1] != t.dtype:
        return t
    return _Regen(entry[0], t)


def _unpack(p):
    if not isinstance(p, _Regen):
        return p
    return p.regen().as_strided(p.size, p.stride, p.offset)


def saved_whole_hooks():
    """The ``saved_tensors_hooks`` pair of a ZeRO-3 forward: a tensor
    autograd saves that is (a view of) a whole weight made at use is
    kept as its recipe, and the backward gathers it again when it needs
    it, so the backward holds no whole weight from the forward.  Every
    rank unpacks in one order (the graphs are the same), which the
    gathers need."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


class GatherSlice(torch.autograd.Function):
    """Whole tensors from the ranks' equal slices (one all-gather of the
    slices packed flat); the backward hands each slice the rank's share
    of the summed gradient (one reduce-scatter, or under ``det`` the
    rank-order fold)."""

    @staticmethod
    def forward(ctx, group, dims, det, *ts):
        ctx.group, ctx.dims, ctx.det = group, dims, det
        ctx.shapes = [tuple(t.shape) for t in ts]
        ctx.device = ts[0].device
        return tuple(_gather_whole(ts, dims, group))

    @staticmethod
    def backward(ctx, *gs):
        n = _size(ctx.group)
        whole = []
        for g, d, shape in zip(gs, ctx.dims, ctx.shapes):
            if g is None:
                full = list(shape)
                full[d] *= n
                g = torch.zeros(full, dtype=torch.float32,
                                device=ctx.device)
            whole.append(g)
        buf = pack_by_rank(whole, ctx.dims, n)
        mine = reduce_scatter(buf, ctx.group, det=ctx.det)
        return (None, None, None, *unpack_slices(mine, ctx.shapes))


def _gather_whole(ts: Sequence, dims: Sequence[int], group,
                  track: bool = True) -> list:
    """The whole tensors of the ranks' slices ``ts`` (one all-gather of
    them packed flat), with ``track`` each counted in :data:`GATHERED`."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    parts = all_gather(flat, group)
    out, off = [], 0
    for t, d in zip(ts, dims):
        k = t.numel()
        w = torch.cat([p[off:off + k].view(t.shape) for p in parts], dim=d)
        if track:
            track_gathered(w)
        out.append(w)
        off += k
    return out


def gather_slices(ts: Sequence, dims: Sequence[int], group,
                  det: bool = False) -> list:
    """ZeRO-3's gather at use: the whole weights of this rank's slices
    ``ts`` (cut along ``dims`` over the data sub-group ``group``), in
    one all-gather; their backward is the reduce-scatter that leaves
    each slice this rank's share of the gradient summed over the group
    (``det``: the rank-order fold).  Without autograd it is the gather
    alone."""
    if not ts or _size(group) == 1:
        return list(ts)
    if not torch.is_grad_enabled() or not any(t.requires_grad for t in ts):
        return _gather_whole(ts, dims, group)
    return list(GatherSlice.apply(group, tuple(dims), bool(det), *ts))


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
    _account(t, t0, "all_gather")
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
    _account(blocks, t0, "all_to_all")
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
        return tuple(_gather_whole(ts, dims, group, track=False))

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
