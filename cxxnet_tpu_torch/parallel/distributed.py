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
                             "device": None}
#: the group's collective traffic since the last :func:`reset_stats`:
#: calls, bytes handed to the backend, and the host seconds spent in the
#: calls
STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}
_shard: List[Optional[Tuple[int, int]]] = [None]  # sharded_batch's


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
    _state.update(initialized=True, backend=backend, device=device)


def shutdown_distributed() -> bool:
    """Leave the group (``destroy_process_group``); the next
    :func:`maybe_init_distributed` may join again.  True when a group
    was torn down."""
    was = bool(_state["initialized"])
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, backend="", device=None)
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


def all_reduce_(t):
    """Sum ``t`` over the group, in place; returns ``t``."""
    if process_info()[1] == 1:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t)
    _account(t, t0)
    return t


def all_gather(t) -> list:
    """Every rank's ``t`` (same shape and dtype on every rank), in rank
    order."""
    world = process_info()[1]
    if world == 1:
        return [t]
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    _account(t, t0)
    return parts


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


def gather_host(arr: np.ndarray) -> np.ndarray:
    """Every rank's numpy ``arr`` (same shape and dtype on every rank),
    stacked in rank order: ``[world, *arr.shape]``.  Exact for any
    dtype: the bytes travel as int64 words."""
    a = np.ascontiguousarray(arr)
    raw = a.view(np.uint8).reshape(-1)
    pad = (-raw.size) % 8
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    t = torch.from_numpy(raw.view(np.int64).copy()).to(_comm_device())
    parts = all_gather(t)
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
def sharded_batch(active: bool = True):
    """Within this block a forward's batch is this rank's rows of the
    group's global batch: :func:`batch_shard` returns ``(rank, world)``.
    A no-op without a group.  Process-wide, not per thread: a card's
    backward (and a ``remat`` recompute in it) runs on autograd's
    device thread and must see the same shard."""
    prev = _shard[0]
    rank, world = process_info()
    _shard[0] = (rank, world) if active and world > 1 else None
    try:
        yield
    finally:
        _shard[0] = prev


def batch_shard() -> Optional[Tuple[int, int]]:
    """``(rank, world)`` inside :func:`sharded_batch` in a group, else
    None."""
    return _shard[0]


def all_reduce_sum(t):
    """The group's sum of ``t`` with a gradient: an all-reduce in the
    forward, and in the backward (each rank's loss reads the sum, so
    the gradient of every rank's input is the sum of the ranks'
    gradients of the output)."""
    return _AllReduceSum.apply(t)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())
