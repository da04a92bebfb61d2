"""NetTrainer: conf, model init, checkpoints, predict, and training.

Counterpart of ``cxxnet_tpu/nnet/trainer.py``: ``set_params``,
``init_model``, ``checkpoint_bytes`` / ``save_model``,
``_read_model_file`` / ``load_model``, ``predict_fn``,
``predict_from_scores``, ``resolve_feature_node``, ``extract_feature``,
``net_fp``, ``copy_model_from`` (finetune), and training: ``update``
(one micro-batch: forward, backward, then
the updater — the fused SGD kernel, or one of the plain-PyTorch
updaters — on every tensor), ``update_all``, ``start_round`` and
``evaluate`` with the train and eval metrics.  The
checkpoint container is the JAX package's, so a model written by one
package loads into the other: the parameters, the layer state
(``aux:{key}/{tag}`` entries, batch norm's running statistics) and,
with ``save_ustate = 1``, the updater state (``ust:{key}/{tag}@{slot}``
entries), which ``load_model`` restores where the shapes match the
rebuilt updaters, so a resumed run continues exactly.

The layer state (``aux``, from ``FunctionalNet.init_aux``) is threaded
through every forward: the train forward replaces it with the step's
new state, the eval forwards read it.  The update writes the f32
masters in place, so it drops the operands ``predict`` prepared from
the old weights (``_invalidate_prepared``).

``update_period = N > 1`` accumulates N micro-batches' f32 gradients
(the loss already carries ``1 / (batch_size * N)``) and applies the
updaters once per N micro-batches, to the sum; ``epoch_counter``, the
updaters' schedule clock, advances only then, while the layer state
(batch norm's running statistics) and the train metrics update on every
micro-batch, as in the JAX package.  The training forward gets the
update counter as ``step`` (``insanity``'s anneal).

Data parallelism (``parallel/``): in a ``torch.distributed`` group of N
ranks, one per device, each rank feeds ``batch_size / N`` rows (the
conf's ``batch_size`` is global, and the loss still carries ``1 /
(batch_size * update_period)``), and the f32 gradients are summed over
the ranks with one all-reduce a step, after the local accumulation of
``update_period`` micro-batches.  The forwards run under
``distributed.sharded_batch``, so batch norm's statistics are the global
batch's and a random layer's mask is drawn for the global shape.
``zero = 1`` (``update_on_server``, ``shard_weight_update``) keeps each
rank's slice of the updater state only (``MeshPlan.owner_dim``): each
rank updates its slice of every weight (the fused SGD kernel over the
slices) and the ranks all-gather the weights; ``zero = 3`` (``fsdp``)
keeps the weights as slices too, gathered layer by layer at use
(``FunctionalNet.bind_data_slices``: one all-gather per layer or
sibling-1x1 group in the forward, batch norm's vectors in the layer's
before them, again in the backward where autograd needs a matrix, and
a reduce-scatter of the gradients into the slices),
so no step holds the whole net; ``zero_gathered_peak_bytes`` is the most
whole-weight bytes a rank held at once.  Under ``zero >= 1`` the sharded
tensors' gradients are reduce-scattered to each rank's slice (under
``zero = 3`` inside the backward) and only the whole tensors and the
loss are all-reduced.  ``lars`` and ``lamb`` state is cut too: their
trust ratio's squared norms are summed over the data sub-group (and the
model sub-group where the tensor is cut there as well).  A tensor with
no dimension divisible by N stays whole.  Under ``model_parallel > 1``
``zero = 3`` gathers the data slices at a step's start, as before.
``det_reduce = 1`` all-gathers the ranks' gradients and adds them in
rank order, so the sum's bits do not depend on the backend.
Checkpoints hold gathered full arrays (every rank calls
``checkpoint_bytes``) and load onto any number of ranks;
``check_weight_sync`` compares the ranks' weights.

A net with ``extra_data`` nodes takes the batch's ``extra_data`` in
``update`` (padded like ``data`` for a short batch), ``predict``,
``extract_feature`` and ``evaluate``.

The library API's surface (``wrapper.py``): ``get_weight`` /
``set_weight`` in the reference visitor's 2-D views (a conv ``wmat`` is
``(cout, cin*kh*kw)``, ``(cin, kh, kw)`` minor), ``set_weight`` writing
in place and dropping the prepared operands; ``update_scan`` runs K
``update`` steps on batches staged on the device once (the JAX package
runs them as one device program) and refuses what the JAX trainer
refuses.  The observability plane (``obs/``): ``device_sample_every =
N`` makes every Nth update wait for the card into
``train_step_device_seconds``; placing the state publishes
``train_state_shard_bytes`` and plugs the card's memory watermarks into
``/metricsz``; an ungated quantize on load emits ``quant.on_load``.

The divergence guard (``divergence_policy = abort|rollback``; off by
default) reads each micro-batch's loss back to the host, one sync a
step, and raises :class:`~..utils.checkpoint.DivergenceError` on a
non-finite loss or, with ``divergence_loss_ratio``, on a finite loss
past that ratio times the median of the last 32 (armed after 8).  As in
the JAX package it reads the loss after the update when
``update_period == 1`` (so the weights a trip leaves are poisoned, and
the CLI's rollback reloads), and before the micro-batch's gradient
joins the sum on the accumulation path.  ``inject_nan_step`` /
``inject_spike_step`` turn the loss at that update into a NaN or a
finite spike once.  The response (abort, or rollback with a learning
rate back-off) is the CLI's (``cli.py``).

Quantized models (``nnet/quant.py``): a checkpoint whose header carries
``quant`` loads as it was exported (int8 codes stay int8, bf16 kernels
bf16, on the device too) and ``quant = int8|bf16`` on a plain checkpoint
quantizes it at load, ungated (``_maybe_quantize``).  Such a trainer
serves only: ``update`` raises.

Device rule (``parallel/mesh.py``): ``dev = cpu`` runs on the CPU, and
only when asked; every other value means the card: ``gpu``, ``cuda``,
``tpu`` (the default) ``cuda:0``, ``gpu:k`` ``cuda:k``, raising when
there is no CUDA device or no card ``k``.  A device range in one process
raises, naming ``dist_num_proc``.

The model axis (``model_parallel = m``, ``parallel/mesh.py``): the
ranks form an ``(n_data, m)`` mesh; every collective above runs over
the data sub-group, and the model ranks of one data index feed the
same rows.  Each model rank holds only its slice of every tensor the
JAX package's ``param_sharding`` cuts (``MeshPlan.model_dim``: a
conv's ``cout``, a ``fullc``'s ``nout``, the per-channel vectors, the
MoE experts, the ``L`` of the block stacks), and its updaters, their
state and the fused SGD kernel's table run over those slices (the
whole-tensor norms of ``lars`` and ``lamb`` summed over the model
sub-group).  The net computes on the slices (``nnet/net.py``,
``layers/sequence.py``: the output channels of a conv or ``fullc``,
the MoE experts, the GPipe stages) or gathers them at use, and outside
those collectives every model rank computes the same values, so it
holds the same loss and the whole gradient of each of its slices:
nothing is reduced over the model axis (sequence-parallel attention
keeps the tokens whole outside the attention too).  ``zero`` cuts a
model slice further over the data axis along ``MeshPlan.owner_dim``.
Checkpoints, ``get_weight`` and ``copy_model_from`` gather whole
tensors over the model sub-group and a load or ``set_weight`` slices
them, so a checkpoint is the same file whatever the mesh.  The
checkpoint's CRC agreement, the integrity vote and the group save stay
over every rank.

``async_overlap = 1`` (``parallel/async_ps``): the rank's backward with
no collective, then per group of tensors an all-gather over the data
sub-group, the rank-order fold and the group's apply, through bounded
staleness buffers (``staleness``, ``async_resync_period``); a
checkpoint drains them first.  ``async_round_end``, ``async_abandon``
and ``async_snapshot`` are the CLI's hooks.
"""

from __future__ import annotations

import contextlib
import io as _io
import json
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.data import DataBatch
from ..obs import device as obs_device
from ..obs import events as obs_events
from ..ops import kernels as _klib
from ..parallel import distributed as pdist
from ..parallel.distributed import rank_order_fold
from ..parallel.mesh import MeshPlan, plan_for, rank_device
from ..updater import Updater, apply_all, create_updater
from ..utils import checkpoint as ckpt
from ..utils.checkpoint import MODEL_MAGIC, DivergenceError
from ..utils.metric import MetricSet
from ..utils.profiler import pipeline_stats
from .graph import NetGraph
from .net import FunctionalNet

_BF16_SUFFIX = "~bf16"  # npz name suffix of a bf16 array, as uint16 words
_KEEP_DTYPES = (torch.int8, torch.bfloat16)  # a quantized model's leaves


def resolve_device(dev: str) -> torch.device:
    """The ``dev`` conf value as this rank's ``torch.device`` (see the
    module docstring); never falls back to the CPU."""
    rank, world = pdist.process_info()
    return rank_device(dev, rank, world)


def params_from_numpy(raw: Dict[str, Dict[str, np.ndarray]],
                      device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """``{key: {tag: ndarray}}`` -> ``{key: {tag: Tensor}}`` on
    ``device``, same layouts (HWIO conv, (nout, nin) fullc).  A leaf that
    is already a tensor (a quantized file's bf16 kernel) moves as is."""
    def tensor(w):
        if isinstance(w, torch.Tensor):
            return w.to(device)
        return torch.from_numpy(np.array(w, copy=True)).to(device)

    return {key: {tag: tensor(w) for tag, w in tags.items()}
            for key, tags in raw.items()}


def params_to_numpy(params: Dict[str, Dict[str, torch.Tensor]]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`params_from_numpy`."""
    return {key: {tag: w.detach().cpu().numpy() for tag, w in tags.items()}
            for key, tags in params.items()}


class NetTrainer:
    def __init__(self) -> None:
        self.cfg: List[Tuple[str, str]] = []
        self.net: Optional[FunctionalNet] = None
        self.graph: Optional[NetGraph] = None
        self.params: Optional[Dict[str, dict]] = None
        self.ustates: Optional[Dict[str, dict]] = None
        self.updaters: Dict[Tuple[str, str], Updater] = {}
        self.aux: Dict[str, dict] = {}
        self.epoch_counter = 0
        self.sample_counter = 0  # micro-batches into this update period
        self._grad_accum: Optional[List[torch.Tensor]] = None
        self.round = 0
        self.batch_size = 0
        self.update_period = 1
        self.silent = 0
        self.eval_train = 1
        self.save_ustate = 0
        self.seed = 0
        self.dev = "tpu"
        self.device: Optional[torch.device] = None
        self.mesh_plan: Optional[MeshPlan] = None
        self.model_parallel = 1
        self.update_on_server = 0
        self.zero = 0
        self.det_reduce = 0
        # async data parallelism (parallel/async_ps)
        self.async_overlap = 0
        self.async_groups = 0
        self.staleness = 0
        self.async_resync_period = 1
        self._async = None  # the AsyncStepper, built at the first step
        # (key, tag) -> the dimension cut over the data ranks (zero >= 1)
        self._dims: Dict[Tuple[str, str], int] = {}
        # (key, tag) -> the dimension cut over the model ranks
        self._mdims: Dict[Tuple[str, str], int] = {}
        self._gathered: Optional[Dict[str, dict]] = None  # zero = 3
        self.metric = MetricSet()
        self.train_metric = MetricSet()
        self.last_loss: Optional[torch.Tensor] = None  # of the last step
        self._prep_lock = threading.Lock()
        self._prep_src = None
        self._prepared = None
        self.quant_scheme = ""  # "int8" / "bf16": inference-only params
        self.quant_plan: Optional[Dict[str, str]] = None
        self._quant_requested = ""
        self.divergence_policy = ""  # "" off | "abort" | "rollback"
        self.divergence_loss_ratio = 0.0  # the finite spike gate; 0 off
        self.inject_nan_step = -1  # fault injection (tests): NaN once
        self.inject_spike_step = -1  # fault injection (tests): spike once
        self.inject_shadow_mismatch = 0  # one-shot shadow-audit hook
        self._loss_window: List[float] = []  # recent finite losses
        self.model_path: Optional[str] = None  # the checkpoint loaded

    # ------------------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "update_period":
            self.update_period = int(val)
        elif name == "eval_train":
            self.eval_train = int(val)
        elif name == "save_ustate":
            self.save_ustate = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "divergence_policy":
            # the loss guard; the response lives in the CLI,
            # which catches DivergenceError
            if val not in ("", "off", "abort", "rollback"):
                raise ValueError(
                    f"divergence_policy={val!r}: must be abort or rollback")
            self.divergence_policy = "" if val == "off" else val
        elif name == "divergence_loss_ratio":
            r = float(val)
            if r and r <= 1.0:
                raise ValueError(f"divergence_loss_ratio={val}: must be > 1 "
                                 "(or 0 to disable)")
            self.divergence_loss_ratio = r
        elif name == "inject_nan_step":
            self.inject_nan_step = int(val)
        elif name == "inject_spike_step":
            self.inject_spike_step = int(val)
        elif name == "inject_shadow_mismatch":
            # perturb the shadow audit's next comparison (one-shot)
            self.inject_shadow_mismatch = int(val)
        elif name == "compile_cache_dir":
            # the kernel build cache moves before this trainer's first
            # kernel loads (utils/compile_cache.py)
            from ..utils import compile_cache

            compile_cache.enable(val, silent=bool(self.silent))
        elif name == "seed":
            self.seed = int(val)
        elif name == "dev":
            self.dev = val
        elif name == "model_parallel":
            if int(val) < 1:
                raise ValueError(f"model_parallel={val} must be >= 1")
            self.model_parallel = int(val)
        elif name == "update_on_server":
            # the reference's SGD on the parameter server: the updater
            # state sharded over the ranks (zero = 1)
            self.update_on_server = int(val)
        elif name == "det_reduce":
            if int(val) not in (0, 1):
                raise ValueError(f"det_reduce={val}: must be 0 or 1")
            self.det_reduce = int(val)
        elif name == "async_overlap":
            if int(val) not in (0, 1):
                raise ValueError(f"async_overlap={val}: must be 0 or 1")
            self.async_overlap = int(val)
        elif name == "async_groups":
            if int(val) < 0:
                raise ValueError(
                    f"async_groups={val}: must be >= 0 (0 = auto)")
            self.async_groups = int(val)
        elif name == "staleness":
            if int(val) < 0:
                raise ValueError(f"staleness={val}: must be >= 0")
            self.staleness = int(val)
        elif name == "async_resync_period":
            if int(val) < 1:
                raise ValueError(
                    f"async_resync_period={val}: must be >= 1")
            self.async_resync_period = int(val)
        elif name in ("zero", "fsdp", "shard_weight_update"):
            # zero = 1: the updater state sharded over the ranks; zero =
            # 3 / fsdp = 1: the weights too; shard_weight_update = 1 is
            # zero = 1's conf name.  ZeRO-2 has no distinct meaning here
            # (the gradients live only inside a step), so 2 is refused
            if name == "fsdp":
                if int(val) not in (0, 1):
                    raise ValueError(f"fsdp={val}: must be 0 or 1")
                z = 3 if int(val) else 0
            elif name == "shard_weight_update":
                if int(val) not in (0, 1):
                    raise ValueError(
                        f"shard_weight_update={val}: must be 0 or 1")
                z = 1 if int(val) else 0
            else:
                z = int(val)
            if z not in (0, 1, 3):
                raise ValueError(
                    f"{name}={val}: supported levels are 0, 1 "
                    "(state sharding) and 3 (FSDP param sharding)"
                )
            self.zero = z
        elif name == "kernel_lib":
            _klib.parse_mode(val)
        elif name == "quant":
            # the inference weight precision; a .quant.model artifact
            # carries its own, and this key quantizes a plain checkpoint
            # at load, ungated (task=export_quant gates)
            if val in ("", "0", "off", "none"):
                self._quant_requested = ""
            elif val in ("int8", "bf16"):
                self._quant_requested = val
            else:
                raise ValueError(
                    f"quant={val!r}: supported schemes are int8 and "
                    "bf16 (0/off disables)")
        if self.metric.try_add_from_config(name, val):
            self.train_metric.try_add_from_config(name, val)
        self.cfg.append((name, val))

    def set_params(self, entries: Sequence[Tuple[str, str]]) -> None:
        for n, v in entries:
            if v == "default":
                continue
            self.set_param(n, v)

    # ------------------------------------------------------------------
    def _build_net(self, graph: Optional[NetGraph] = None) -> None:
        self.device = resolve_device(self.dev)
        self.mesh_plan = plan_for(self.device, self.model_parallel)
        self._gathered = None
        self._async = None
        if graph is None:
            graph = NetGraph()
        graph.configure(self.cfg)
        self.graph = graph
        self.net = FunctionalNet(graph)
        # the layers that run their own collectives over the model axis
        # (sequence-parallel attention, the MoE experts, the GPipe stacks)
        for lay in self.net.layer_objs:
            if hasattr(lay, "bind_mesh"):
                lay.bind_mesh(self.mesh_plan)
        if self.net.batch_size:
            self.batch_size = self.net.batch_size
        else:
            self.net.batch_size = self.batch_size
        self.update_period = max(self.update_period, self.net.update_period)
        self.net.update_period = self.update_period
        if self.batch_size:
            self.mesh_plan.check_batch(self.batch_size)
        self._check_metric_nodes()

    def _check_metric_nodes(self) -> None:
        """Fail at build time on a ``metric[field,node]`` node name the
        graph does not have."""
        for mset in (self.metric, self.train_metric):
            for node in mset.nodes:
                if node is None:
                    continue
                try:
                    self.graph.node_index_of(node)
                except (KeyError, ValueError) as e:
                    raise ValueError(
                        f"metric[...,{node}]: cannot find node name "
                        f"{node!r} in the net graph") from e

    def _set_master(self, params: Dict[str, dict], quant_scheme: str = "",
                    quant_plan: Optional[Dict[str, str]] = None,
                    ust: Optional[Dict[str, dict]] = None,
                    place: bool = True) -> None:
        """``params`` on the device: the f32 masters and their updaters
        (the state of ``ust``, a checkpoint's ``ust:`` entries, restored
        where it fits), or with ``quant_scheme`` a quantized model's
        leaves, whose int8 codes and bf16 kernels keep their dtype, and
        no updaters (the trainer is then inference-only).  Over a model
        axis only this rank's slice of each tensor it cuts
        (:meth:`_model_cuts`) is kept, and the updater state is built
        (and restored from ``ust``) over the slices.  With ``place`` the
        state then takes its place over the data ranks
        (:meth:`_place_state`)."""
        self.quant_scheme, self.quant_plan = quant_scheme, quant_plan
        self._mdims = {} if quant_scheme else self._model_cuts(params)
        self.params = {
            k: {t: w.to(self.device) if w.dtype in _KEEP_DTYPES
                else self._model_slice(w, self._mdims.get((k, t))).to(
                    self.device, torch.float32)
                for t, w in tags.items()}
            for k, tags in params.items()}
        self.sample_counter, self._grad_accum = 0, None
        self._invalidate_prepared()
        if quant_scheme:
            self.updaters, self.ustates = {}, {}
        else:
            self._build_updaters()
            if ust:
                self._restore_ustates(ust)
        dims: Dict[str, dict] = {}
        for (k, t), d in self._mdims.items():
            dims.setdefault(k, dict.fromkeys(self.params[k]))[t] = d
        self.net.bind_model_slices(self.mesh_plan, dims)
        self._dims = {}
        if place:
            self._place_state()

    # ------------------------------------------------------------------
    # the model axis (parallel/mesh.py MeshPlan.model_dim)
    def _model_cuts(self, params: Dict[str, dict]) -> Dict[Tuple[str, str],
                                                           int]:
        """``(key, tag) -> dim`` of every whole tensor of ``params`` cut
        over the model ranks: the ``MeshPlan.model_dim`` rule."""
        plan = self.mesh_plan
        if plan is None or plan.n_model == 1:
            return {}
        cuts = {}
        for i, spec in enumerate(self.graph.layers):
            key = self.net.param_key[i]
            if spec.type_name == "shared" or key not in params:
                continue
            for tag, w in params[key].items():
                d = plan.model_dim(tuple(w.shape))
                if d is not None:
                    cuts[(key, tag)] = d
        return cuts

    def _model_slice(self, t: torch.Tensor, dim: Optional[int]
                     ) -> torch.Tensor:
        """This rank's model slice of the whole ``t`` along ``dim`` (a
        contiguous copy; ``t`` itself when ``dim`` is None)."""
        if dim is None:
            return t
        start, n = self.mesh_plan.slice_bounds(tuple(t.shape), dim,
                                               axis="model")
        return t.narrow(dim, start, n).clone(
            memory_format=torch.contiguous_format)

    def _whole_shape(self, key: str, tag: str, shape=None) -> tuple:
        """The whole shape of ``(key, tag)`` from the shape this rank
        holds (``shape``, its model slice, by default the master's; under
        ``zero = 3`` the master is cut over the data ranks too)."""
        plan = self.mesh_plan
        if shape is None:
            shape = self.params[key][tag].shape
            d = self._dims.get((key, tag))
            if self.zero >= 3 and d is not None:
                shape = list(shape)
                shape[d] *= plan.n_data
        shape = list(shape)
        d = self._mdims.get((key, tag))
        if d is not None:
            shape[d] *= plan.n_model
        return tuple(shape)

    # ------------------------------------------------------------------
    # data parallelism over the process group (parallel/)
    def _zero_level(self) -> int:
        return max(self.zero, 1 if self.update_on_server else 0)

    def _place_state(self) -> None:
        """Under ``zero >= 1`` on more than one rank, keep this rank's
        slice of each shardable tensor's updater state (and under ``zero
        = 3`` of the weight itself), cut along ``MeshPlan.owner_dim``;
        then publish the state's bytes.  Placement only: the training
        math is the same bits."""
        plan = self.mesh_plan
        self._gathered = None
        if (not self._dims and plan is not None and plan.n_data > 1 and self._zero_level()
                and not self.quant_scheme):
            for key, tags in self.params.items():
                for tag, w in tags.items():
                    up = self.updaters.get((key, tag))
                    d = plan.owner_dim(self._whole_shape(key, tag, w.shape))
                    if up is None or d is None:
                        continue
                    self._dims[(key, tag)] = d
                    if not up.elementwise:
                        # the trust ratio's norms: summed over the data
                        # ranks' slices (and the model ranks')
                        up.norm_groups = tuple(up.norm_groups) + (
                            plan.data_group,)
                    state = self.ustates[key][tag]
                    for slot, v in state.items():
                        state[slot] = self._my_slice(v, d)
                    if self.zero >= 3:
                        tags[tag] = self._my_slice(w, d)
        self._bind_zero()
        self._export_state_bytes()

    def _jit_gather(self) -> bool:
        """Does ``zero = 3`` gather each layer's weights at use?  (Over a
        model axis the data slices are gathered at a step's start.)"""
        return bool(self.zero >= 3 and self._dims
                    and self.mesh_plan.n_model == 1)

    def _bind_zero(self) -> None:
        """Hand the net the data cuts it gathers at use (``zero = 3``,
        no model axis), or none."""
        dims: Dict[str, Dict[str, int]] = {}
        if self._jit_gather():
            for (k, t), d in self._dims.items():
                dims.setdefault(k, {})[t] = d
        vectors = {k for k, tags in dims.items()
                   if all(self.params[k][t].dim() == 1 for t in tags)}
        self.net.bind_data_slices(self.mesh_plan.data_group, dims,
                                  det=self._det_active(), vectors=vectors)

    def zero_snapshot(self) -> Optional[dict]:
        """``zero = 3``'s gather at use: the most whole-weight bytes this
        rank held at once since the process began
        (``zero_gathered_peak_bytes``), the largest group gathered at
        once, and the whole net's weight bytes; None when the weights
        are not gathered at use."""
        if not self._jit_gather():
            return None
        whole = {k: {t: self._whole_shape(k, t) for t in tags}
                 for k, tags in self.params.items()}

        def nbytes(key, only_cut=True):
            return sum(4 * int(np.prod(shape))
                       for t, shape in whole[key].items()
                       if not only_cut or (key, t) in self._dims)

        return {"zero_gathered_peak_bytes": int(pdist.GATHERED["peak"]),
                "largest_group_bytes": max(
                    sum(nbytes(k) for k in unit)
                    for unit in self.net.zero_units()),
                "whole_weight_bytes": sum(nbytes(k, False) for k in whole)}

    def _my_slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A contiguous copy of this rank's slice of ``t`` along ``dim``
        (a copy, so the whole tensor's storage is freed)."""
        start, n = self.mesh_plan.slice_bounds(tuple(t.shape), dim)
        return t.narrow(dim, start, n).clone(
            memory_format=torch.contiguous_format)

    def _gather_slices(self, slices: Sequence[torch.Tensor],
                       dims: Sequence[int], axis: str = "data"
                       ) -> List[torch.Tensor]:
        """The whole tensors of the ``axis`` ranks' equal ``slices`` (cut
        along ``dims``): one all-gather of all of them packed flat over
        the data (or model) sub-group."""
        group = (self.mesh_plan.model_group if axis == "model"
                 else self.mesh_plan.data_group)
        with torch.no_grad():
            return pdist.gather_leaves(slices, dims, group)

    def _full_params(self) -> Dict[str, dict]:
        """The whole weights: :meth:`_data_whole_params` with the model
        slices gathered over the model sub-group (collective)."""
        params = self._data_whole_params()
        if not self._mdims:
            return params
        names = sorted(self._mdims)
        whole = self._gather_slices([params[k][t] for k, t in names],
                                    [self._mdims[n] for n in names],
                                    axis="model")
        out = {k: dict(tags) for k, tags in params.items()}
        for (k, t), w in zip(names, whole):
            out[k][t] = w
        return out

    def _compute_params(self) -> Dict[str, dict]:
        """The weights the forward runs on: ``self.params`` (this rank's
        model slices; under ``zero = 3`` its data slices, which the net
        gathers layer by layer), or under ``zero = 3`` over a model axis
        the data slices gathered (:meth:`_data_whole_params`)."""
        if self._jit_gather():
            return self.params
        return self._data_whole_params()

    def _data_whole_params(self) -> Dict[str, dict]:
        """``self.params`` with the data slices of ``zero = 3`` gathered
        whole (collective; kept until :meth:`_invalidate_prepared`): the
        checkpoints, ``get_weight`` and the integrity plane's legs."""
        if self.zero < 3 or not self._dims:
            return self.params
        if self._gathered is None:
            names = list(self._dims)
            full = self._gather_slices([self.params[k][t] for k, t in names],
                                       [self._dims[n] for n in names])
            gathered = {k: dict(tags) for k, tags in self.params.items()}
            for (k, t), w in zip(names, full):
                gathered[k][t] = w
            self._gathered = gathered
        return self._gathered

    def _full_ustate(self, key: str, tag: str) -> dict:
        """The updater state of ``(key, tag)``, gathered over the data
        and the model ranks where it is cut (collective)."""
        state = self.ustates[key][tag]
        slots = sorted(state)
        for axis, d in (("data", self._dims.get((key, tag))),
                        ("model", self._mdims.get((key, tag)))):
            if d is not None:
                state = dict(zip(slots, self._gather_slices(
                    [state[sl] for sl in slots], [d] * len(slots), axis)))
        return state

    def held_slice(self, name: str, shape, rank: int
                   ) -> Optional[Tuple[tuple, tuple]]:
        """``(index, whole shape)``: the slices of the whole leaf that
        rank ``rank`` holds of a leaf named as the integrity plane names
        it (``key/tag`` or ``ust:key/tag@slot``), ``shape`` being the
        shape each rank holds; None for a leaf every rank holds whole."""
        ust = name.startswith("ust:")
        base = name[4:].split("@", 1)[0] if ust else name
        key, tag = base.rsplit("/", 1)
        plan = self.mesh_plan
        cuts = []  # (dim, this rank's index on the axis, the axis's size)
        d = self._dims.get((key, tag))
        if d is not None and (ust or self.zero >= 3):
            cuts.append((d, rank // plan.n_model, plan.n_data))
        d = self._mdims.get((key, tag))
        if d is not None:
            cuts.append((d, rank % plan.n_model, plan.n_model))
        if not cuts:
            return None
        index = [slice(0, int(s), None) for s in shape]
        whole = [int(s) for s in shape]
        for d, i, parts in cuts:
            n = int(shape[d])
            index[d] = slice(i * n, (i + 1) * n, None)
            whole[d] = n * parts
        return tuple(index), tuple(whole)

    def state_shard_bytes(self) -> Tuple[Dict[str, int], int]:
        """``(per_device, total)``: the bytes of params + updater state
        this rank holds (under its mesh position, ``type:rank`` in a
        group), and what one whole replica costs."""
        held = total = 0
        for tree in (self.params, self.ustates):
            for key, tags in (tree or {}).items():
                for tag, leaf in tags.items():
                    for w in (leaf.values() if isinstance(leaf, dict)
                              else (leaf,)):
                        held += int(w.nbytes)
                        grow = (self.mesh_plan.n_data
                                if (key, tag) in self._dims and (
                                    isinstance(leaf, dict) or self.zero >= 3)
                                else 1)
                        if (key, tag) in self._mdims:
                            grow *= self.mesh_plan.n_model
                        total += int(w.nbytes) * grow
        dev = self.device
        plan = self.mesh_plan
        pos = plan.rank if plan is not None and plan.n_data > 1 else (
            dev.index or 0)
        return {f"{dev.type}:{pos}": held}, total

    def _export_state_bytes(self) -> None:
        """Publish ``train_state_shard_bytes{device}`` and
        ``train_state_total_bytes`` (params + updater state) and plug the
        card's memory watermarks into ``/metricsz``, as the JAX trainer
        does when it places its state."""
        per_device, total = self.state_shard_bytes()
        obs_device.set_train_state_bytes(per_device, total)
        if obs_device.enabled():
            obs_device.register_memory_collector()

    def mesh_manifest(self) -> Optional[dict]:
        """The layout that writes checkpoints (the manifest's ``mesh``
        field): informational, since the payload always holds gathered
        whole arrays and a load places them on the current group."""
        if self.mesh_plan is None:
            return None
        return {"n_data": self.mesh_plan.n_data,
                "n_model": self.mesh_plan.n_model,
                "zero": self._zero_level(),
                "processes": self.mesh_plan.n_devices}

    def _det_active(self) -> bool:
        """Is the rank-order gradient fold in effect?  On one rank there
        is no reduction to pin: the key is a no-op there."""
        return bool(self.det_reduce and self.mesh_plan is not None
                    and self.mesh_plan.n_devices > 1)

    def _async_active(self) -> bool:
        """``async_overlap = 1`` over more than one rank (the same
        one-rank no-op as ``det_reduce``)."""
        return bool(self.async_overlap and self.mesh_plan is not None
                    and self.mesh_plan.n_devices > 1
                    and not self.quant_scheme)

    def _row_separable_problems(self) -> list:
        """What ``det_reduce`` (and ``async_overlap``) cannot take, with
        the JAX package's words: the per-rank gradient of the rank's
        rows' summed loss must be the whole step's share."""
        problems = []
        if self.model_parallel != 1:
            problems.append(f"model_parallel={self.model_parallel} "
                            "(needs pure data parallelism)")
        if self.zero or self.update_on_server:
            problems.append(f"zero={self.zero} (needs replicated state)")
        if self.update_period != 1:
            problems.append(f"update_period={self.update_period} "
                            "(needs the fused single-update step)")
        if self.graph.extra_data_num:
            problems.append("extra data nodes")
        if self.aux:
            problems.append("aux (batch-norm style) layer state — "
                            "per-shard batch statistics would diverge")
        stochastic = sorted({
            spec.type_name for spec in self.graph.layers
            if spec.type_name in ("dropout", "insanity",
                                  "insanity_max_pooling")
        })
        if stochastic:
            problems.append(
                f"stochastic layers {stochastic} (per-shard rng would "
                "correlate noise masks across data shards)")
        return problems

    def _validate_parallel(self) -> None:
        """The ``det_reduce`` and ``async_overlap`` constraints, checked
        when the model is built, as the JAX package does."""
        if self._det_active():
            problems = self._row_separable_problems()
            if problems:
                raise ValueError(
                    "det_reduce=1 is incompatible with: "
                    + "; ".join(problems)
                    + " (doc/parallel.md 'Determinism contract')")
        if self.staleness and not self.async_overlap:
            raise ValueError(
                f"staleness={self.staleness} requires async_overlap=1 "
                "(the synchronous step has no aggregate buffer to "
                "delay; doc/parallel.md 'Async data-parallel')")
        if not self._async_active():
            return
        problems = self._row_separable_problems()
        if problems:
            raise ValueError(
                "async_overlap=1 is incompatible with: "
                + "; ".join(problems)
                + " (doc/parallel.md 'Async data-parallel')")

    def _maybe_quantize(self) -> None:
        """Apply the conf's ``quant`` scheme to freshly loaded or drawn
        f32 params: the ungated on-load path (a serving process has no
        held-out data to gate on; ``task=export_quant`` gates)."""
        if not self._quant_requested or self.quant_scheme:
            return
        from . import quant as nquant

        plan = nquant.build_plan(self, self._quant_requested)
        if not plan:
            return
        nquant.apply_plan(self, plan, self._quant_requested)
        obs_events.emit("quant.on_load", scheme=self.quant_scheme,
                        layers=len(plan), gated=False)

    def _invalidate_prepared(self) -> None:
        """Drop the operands prepared from the current weights: after a
        load, and after every update (which writes the masters in place,
        so the params dict stays the same object)."""
        with self._prep_lock:
            self._prep_src, self._prepared = None, None
        self._gathered = None

    def _new_updater(self, i: int, tag: str) -> Updater:
        """The updater of layer ``i``'s ``tag``: the conf's global keys
        first, then the layer's own section."""
        up = create_updater(self.graph.updater_type, tag)
        for n, v in self.graph.defcfg:
            up.set_param(n, v)
        for n, v in self.graph.layercfg[i]:
            up.set_param(n, v)
        return up

    def _build_updaters(self) -> None:
        """One updater per ``(param key, tag)``, momentum state zeroed
        (over the tensor this rank holds; a model-cut tensor's norms are
        taken over the model sub-group)."""
        self.updaters, self.ustates = {}, {}
        for i, spec in enumerate(self.graph.layers):
            key = self.net.param_key[i]
            if spec.type_name == "shared" or key not in self.params:
                continue
            self.ustates[key] = {}
            for tag, w in self.params[key].items():
                up = self._new_updater(i, tag)
                if (key, tag) in self._mdims:
                    up.norm_groups = (self.mesh_plan.model_group,)
                self.updaters[(key, tag)] = up
                self.ustates[key][tag] = up.init_state(w)

    def init_model(self) -> None:
        """Build the net from the conf and draw fresh weights from a
        ``torch.Generator`` seeded with ``seed`` (on the CPU, so a seed
        gives the same weights whatever the device)."""
        self._init_unplaced()
        self._place_state()

    def _init_unplaced(self) -> None:
        self._build_net()
        gen = torch.Generator().manual_seed(self.seed)
        self._set_master(self.net.init_params(gen, self.batch_size),
                         place=False)
        self.aux = self.net.init_aux(self.batch_size, self.device)
        self.epoch_counter = 0
        self._validate_parallel()
        self._maybe_quantize()

    # ------------------------------------------------------------------
    # checkpoints: magic | u32 header length | json header | npz params
    @classmethod
    def _read_model_file(cls, path: str):
        """Parse a checkpoint -> ``(header, params, aux, ust)``: params
        and aux ``{key: {tag: ndarray}}``, and ust (the ``ust:`` entries
        of ``save_ustate=1`` checkpoints) ``{key: {tag: {slot:
        ndarray}}}``.  A bf16 leaf (``~bf16`` uint16 words) widens
        exactly to f32 in a plain checkpoint and stays a
        ``torch.bfloat16`` tensor in a quantized one, whose fallback
        kernels are bf16 by design."""
        with open(path, "rb") as f:
            if f.read(8) != MODEL_MAGIC:
                raise ValueError(f"{path}: not a cxxnet-tpu model file")
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen).decode("utf-8"))
            blob = f.read()
        quant = bool(header.get("quant"))
        npz = np.load(_io.BytesIO(blob))
        params: Dict[str, dict] = {}
        aux: Dict[str, dict] = {}
        ust: Dict[str, dict] = {}
        for k in npz.files:
            arr = npz[k]
            if k.endswith(_BF16_SUFFIX):
                k = k[:-len(_BF16_SUFFIX)]
                if quant:
                    arr = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:  # the uint16 words widen exactly to f32
                    arr = (arr.astype(np.uint32) << 16).view(np.float32)
            key, tag = k.rsplit("/", 1)
            if key.startswith("ust:"):
                tag, slot = tag.split("@", 1)
                ust.setdefault(key[4:], {}).setdefault(tag, {})[slot] = arr
            elif key.startswith("aux:"):
                aux.setdefault(key[4:], {})[tag] = arr
            else:
                params.setdefault(key, {})[tag] = arr
        return header, params, aux, ust

    def checkpoint_bytes(self) -> bytes:
        """The full checkpoint as one byte string: the f32 masters, or a
        quantized model's leaves with the ``quant`` header block and bf16
        kernels as ``~bf16`` uint16 words; then the layer state, and with
        ``save_ustate`` the updater state.  In async mode every pending
        aggregate is applied first and each group waited for, so a
        checkpoint is always a synchronous state."""
        if self._async is not None:
            up = self._async.updater
            up.drain()
            for gid in range(len(up.groups)):
                up.pull_wait(gid)
        header = {
            "structure": json.loads(self.graph.structure_to_json()),
            "epoch_counter": self.epoch_counter,
        }
        if self.quant_scheme:
            header["quant"] = {"scheme": self.quant_scheme,
                               "scales_dtype": "float32",
                               "layers": dict(self.quant_plan or {})}
        hjson = json.dumps(header).encode("utf-8")
        flat = {}

        def store(name: str, w: torch.Tensor) -> None:
            w = w.detach().cpu()
            if w.dtype == torch.bfloat16:
                flat[name + _BF16_SUFFIX] = (
                    w.view(torch.int16).numpy().view(np.uint16))
            else:
                flat[name] = w.numpy()

        for key, tags in self._full_params().items():
            for tag, w in tags.items():
                store(f"{key}/{tag}", w)
        for key, tags in self.aux.items():
            for tag, w in tags.items():
                store(f"aux:{key}/{tag}", w)
        if self.save_ustate:
            for key, tags in self.ustates.items():
                for tag in tags:
                    for slot, w in self._full_ustate(key, tag).items():
                        store(f"ust:{key}/{tag}@{slot}", w)
        buf = _io.BytesIO()
        np.savez(buf, **flat)
        return (MODEL_MAGIC + struct.pack("<I", len(hjson)) + hjson
                + buf.getvalue())

    def net_fp(self) -> str:
        """Fingerprint of the current net structure (manifest field)."""
        return ckpt.net_fingerprint(self.graph.structure_to_json())

    def save_model(self, path: str, round_: Optional[int] = None,
                   manifest: bool = True, probe: Optional[dict] = None) -> None:
        """Atomic checkpoint write plus the sidecar manifest (with the
        canary's ``probe`` block when given).

        In a data-parallel group every rank calls it (collective): each
        assembles the checkpoint (gathering any sharded state), the
        ranks' CRCs must agree, and rank 0 alone writes it.  Rank 0's
        outcome is shared before the closing barrier, so a raise there
        raises on every rank instead of stranding the others in it."""
        blob = self.checkpoint_bytes()
        group = pdist.process_info()[1] > 1
        if group:
            crcs = pdist.gather_host(
                np.asarray([ckpt.crc32_of(blob)], np.int64)).reshape(-1)
            if len(set(crcs.tolist())) != 1:
                raise ckpt.CheckpointError(
                    f"checkpoint {path}: the ranks' bytes differ (CRC32 by "
                    f"rank {[f'{int(c):#010x}' for c in crcs]})")
        err = None
        if pdist.is_primary():
            try:
                self._write_model(path, blob, round_, manifest, probe)
            except Exception as e:  # noqa: BLE001 - shared with the ranks
                if not group:
                    raise
                err = e
        if group:
            if pdist.any_process_flag(err is not None):
                if err is not None:
                    raise err
                raise ckpt.CheckpointError(
                    f"checkpoint {path} failed to write on the primary "
                    "process")
            pdist.barrier("save_model")

    def _write_model(self, path: str, blob: bytes, round_: Optional[int],
                     manifest: bool, probe: Optional[dict]) -> None:
        if not manifest:
            ckpt.atomic_write_bytes(path, blob)
            return
        quant = None
        if self.quant_scheme:
            kinds = list((self.quant_plan or {}).values())
            quant = {"scheme": self.quant_scheme,
                     "scales_dtype": "float32",
                     "int8_layers": kinds.count("int8"),
                     "bf16_layers": kinds.count("bf16")}
        ckpt.write_checkpoint(
            path, blob, round_=self.round if round_ is None else round_,
            net_fp=self.net_fp(), quant=quant, probe=probe,
            mesh=self.mesh_manifest())

    def load_model(self, path: str) -> None:
        if not any(n == "netconfig" for n, _ in self.cfg):
            raise ValueError(
                "load_model: set the model conf first (checkpoints store "
                "the net STRUCTURE; layer settings come from the conf)")
        header, raw, raw_aux, raw_ust = self._read_model_file(path)
        graph = NetGraph.structure_from_json(json.dumps(header["structure"]))
        self._build_net(graph)
        self.model_path = path
        self.epoch_counter = int(header["epoch_counter"])
        q = header.get("quant")
        if q:  # an exported artifact: its leaves ARE the serving params
            self._set_master(params_from_numpy(raw),
                             str(q.get("scheme", "int8")),
                             dict(q.get("layers") or {}))
        else:
            self._set_master(params_from_numpy(raw), ust=raw_ust,
                             place=False)
        self.aux = self.net.init_aux(self.batch_size, self.device)
        for key, tags in raw_aux.items():
            if key in self.aux:
                self.aux[key] = {t: torch.from_numpy(np.array(w)).to(
                    self.device) for t, w in tags.items()}
        self._validate_parallel()
        if not q:
            self._maybe_quantize()
        self._place_state()
        self.net.infer_shapes(self.batch_size)

    def _restore_ustates(self, raw_ust: Dict[str, dict]) -> None:
        """The updater state of a ``save_ustate=1`` checkpoint, where its
        slots and shapes match the rebuilt updaters' (the rest stays
        zero, as in the JAX package); over a model axis, this rank's
        slices of it."""
        for key, tags in raw_ust.items():
            for tag, slots in tags.items():
                cur = self.ustates.get(key, {}).get(tag)
                d = self._mdims.get((key, tag))
                if cur is None or set(slots) != set(cur) or any(
                        self._whole_shape(key, tag, cur[sl].shape)
                        != tuple(slots[sl].shape) for sl in slots):
                    continue
                for sl, w in slots.items():
                    cur[sl].copy_(self._model_slice(torch.from_numpy(
                        np.asarray(w, np.float32)), d))

    def copy_model_from(self, path: str) -> None:
        """Finetune: a fresh init from the conf, then the weights of every
        layer of the checkpoint at ``path`` (written by either package)
        whose name matches a layer of this net and whose every tag has
        the same shape; ``epoch_counter`` starts again at 0."""
        self._init_unplaced()
        header, old_params, _aux, _ust = self._read_model_file(path)
        old = NetGraph.structure_from_json(json.dumps(header["structure"]))
        old_keys = {spec.name: f"l{i}_{spec.name}"
                    for i, spec in enumerate(old.layers) if spec.name}
        for j, spec in enumerate(self.graph.layers):
            okey = old_keys.get(spec.name)
            nkey = self.net.param_key[j]
            if okey not in old_params or nkey not in self.params:
                continue
            src, dst = old_params[okey], self.params[nkey]
            if all(tag in src and tuple(np.shape(src[tag]))
                   == self._whole_shape(nkey, tag) for tag in dst):
                if not self.silent:
                    print(f"Copying layer {spec.name}")
                for tag, w in dst.items():
                    w.copy_(self._model_slice(torch.as_tensor(
                        np.asarray(src[tag], np.float32)),
                        self._mdims.get((nkey, tag))))
        self._invalidate_prepared()
        self.epoch_counter = 0
        self._place_state()

    # ------------------------------------------------------------------
    # predict
    def _prepared_for(self, params) -> dict:
        """The forward's operands for ``params`` (compute dtype, cuDNN
        layouts, fused 1x1 groups), built once per params object."""
        with self._prep_lock:
            if self._prep_src is not params:
                self._prepared = self.net.prepare(params)
                self._prep_src = params
            return self._prepared

    def _forward_fn(self, node_id: int):
        net, dev = self.net, self.device

        def f(params, aux, data, extras=(), pad_to=None):
            t0 = time.perf_counter()  # the h2d stage, as the update's
            x = torch.as_tensor(data, dtype=torch.float32)
            if pad_to is not None and pad_to > x.shape[0]:
                # zero rows up to ``pad_to`` on the device: the host
                # copies the request's rows and allocates nothing
                xp = torch.zeros((pad_to,) + tuple(x.shape[1:]),
                                 dtype=torch.float32, device=dev)
                xp[:x.shape[0]].copy_(x)
                x = xp
            else:
                x = x.to(dev)
            ex = [torch.as_tensor(e, dtype=torch.float32).to(dev)
                  for e in extras]
            pipeline_stats().add("h2d", time.perf_counter() - t0,
                                 rows=int(x.shape[0]))
            prepared = self._prepared_for(params)
            with torch.inference_mode():
                # the eval forward reads the layer state, never keeps it
                return net.forward(prepared, x, aux=dict(aux) if aux
                                   else None, extras=ex)[node_id].float()

        return f

    def predict_fn(self, node_id: Optional[int] = None):
        """The pure inference function the serving cache calls:
        ``f(params, aux, data, extras, pad_to=None) -> f32 out rows`` (a
        tensor on the trainer's device) with eval forward semantics;
        ``pad_to`` zero-pads ``data`` (not ``extras``) to that many rows
        on the device.  ``node_id`` selects a feature node
        (``resolve_feature_node``); ``None`` is the final output.  Over
        more than one data rank the rows are split over the ranks
        (:meth:`run_sharded`, collective)."""
        node = self.net.out_node_index() if node_id is None else node_id
        if self.mesh_plan is None or self.mesh_plan.n_data == 1:
            return self._forward_fn(node)

        def sharded(params, aux, data, extras=(), pad_to=None):
            return self.run_sharded(node, data, extras, pad_to)

        return sharded

    def run_sharded(self, node_id: int, data: np.ndarray, extras=(),
                    pad_to: Optional[int] = None) -> torch.Tensor:
        """The eval forward of node ``node_id`` over the data ranks, as
        the JAX package's ``_run_sharded`` runs a device range: the
        batch (zero-padded to ``pad_to`` rows, then to a multiple of the
        ranks) cut into one block of rows per data index, each rank's
        forward on its block (batch norm's batch statistics the whole
        padded batch's, ``distributed.sharded_batch``), the blocks
        all-gathered in rank order and trimmed to the batch's rows.
        Collective: every rank calls it with the same ``data``."""
        plan = self.mesh_plan
        n = int(data.shape[0])
        total = max(n, int(pad_to or 0))
        total += (-total) % plan.n_data
        per = total // plan.n_data
        lo = plan.data_index * per
        rows = data[lo:min(lo + per, n)]
        ex = []
        for e in extras:
            e = np.asarray(e)
            block = np.zeros((per,) + e.shape[1:], e.dtype)
            part = e[lo:min(lo + per, n)]
            block[:len(part)] = part
            ex.append(block)
        f = self._forward_fn(node_id)
        with pdist.sharded_batch(plan):
            out = f(self._compute_params(), self.aux, rows, ex, pad_to=per)
            parts = pdist.all_gather(out.contiguous(), plan.data_group)
        return torch.cat(parts)[:n]

    def resolve_feature_node(self, node_name: str) -> int:
        """``top[-k]`` / node-name -> node index (ExtractFeature rules)."""
        g = self.graph
        if node_name.startswith("top[-"):
            offset = int(node_name[len("top[-"):-1])
            if not (1 <= offset <= g.num_nodes):
                raise ValueError("ExtractFeature: offset out of node range")
            return g.num_nodes - offset
        return g.node_index_of(node_name)

    @staticmethod
    def predict_from_scores(out: np.ndarray) -> np.ndarray:
        """Raw out-node rows -> per-instance predictions: argmax
        (multi-column), the raw scalar (1-column), or the per-position
        ``(N, T)`` argmax id matrix for sequence models."""
        if out.ndim == 3:
            return out.argmax(axis=-1).astype(np.float32)
        out2d = out.reshape(out.shape[0], -1)
        if out2d.shape[1] == 1:
            return out2d[:, 0]
        return out2d.argmax(axis=1).astype(np.float32)

    def extract_feature(self, batch: DataBatch, node_name: str) -> np.ndarray:
        """The eval-forward value of node ``node_name`` (``top[-k]`` or a
        node name) for ``batch.data`` and its ``extra_data``, as f32
        numpy."""
        node = self.resolve_feature_node(node_name)
        return self._node_rows(node, batch.data, batch.extra_data)

    def predict(self, data: np.ndarray, extras: Sequence = ()) -> np.ndarray:
        """Per-instance prediction for a numpy batch (and its side
        inputs, for a net with ``extra_data`` nodes)."""
        out = self._node_rows(self.net.out_node_index(), data, extras)
        return self.predict_from_scores(out)

    def _node_rows(self, node_id: int, data, extras) -> np.ndarray:
        """Node ``node_id``'s eval-forward rows as f32 numpy: over more
        than one data rank split over the ranks (:meth:`run_sharded`,
        collective), else one forward."""
        if self.mesh_plan is not None and self.mesh_plan.n_data > 1:
            return self.run_sharded(node_id, np.asarray(data),
                                    extras).cpu().numpy()
        f = self._forward_fn(node_id)
        return f(self._compute_params(), self.aux, data,
                 extras).cpu().numpy()

    # ------------------------------------------------------------------
    # training
    def start_round(self, round_: int) -> None:
        self.round = round_
        # the live-state fault site: a ``device.state:bitflip`` armed
        # here flips a real bit of a live parameter (inject_bitflip),
        # the corruption the integrity plane's digests must see
        from ..utils.faults import fault_point

        fault_point("device.state", self)

    def inject_bitflip(self, rng) -> dict:
        """Flip one bit of one element of one live parameter tensor, in
        place (the ``device.state:bitflip`` payload hook).  From ``rng``
        (the spec's seeded stream), in the JAX package's order: the leaf
        over the sorted param tree, then the element, then the bit, so
        one seed flips the same bit in both packages."""
        assert self.params is not None, "init_model/load_model first"
        leaves = [(f"{k}/{t}", k, t)
                  for k in sorted(self.params)
                  for t in sorted(self.params[k])]
        name, key, tag = leaves[rng.randrange(len(leaves))]
        w = self.params[key][tag]
        elem = rng.randrange(max(1, w.numel()))
        itembits = w.element_size() * 8
        bit = rng.randrange(min(itembits, 32))
        if not w.is_contiguous():
            raise ValueError(f"inject_bitflip: {name} is not contiguous")
        words = w.detach().view(-1).view(
            {8: torch.int64, 4: torch.int32, 2: torch.int16,
             1: torch.int8}[w.element_size()])
        mask = 1 << bit
        if bit == itembits - 1:
            mask -= 1 << itembits  # the sign bit, as a signed word
        with torch.no_grad():
            words[elem:elem + 1].bitwise_xor_(
                torch.tensor([mask], dtype=words.dtype, device=w.device))
        self._invalidate_prepared()
        rank = pdist.process_info()[0]
        detail = {"tensor": name, "elem": int(elem), "bit": int(bit),
                  "process": rank, "device": str(w.device)}
        if not self.silent:
            print(f"[faults] bitflip injected: tensor={name} "
                  f"elem={elem} bit={bit} device={detail['device']} "
                  f"process={rank}", flush=True)
        return detail

    def _shadow_leg(self, data, labels, mask, round_: int):
        """One leg of the shadow audit: the train forward from the f32
        masters (``forward_train`` prepares the compute-dtype operands
        afresh), a copy of the layer state (the audit keeps nothing),
        the round's generator, and the gradients of every leaf (under
        ``zero = 3`` of the whole weights, gathered first)."""
        params = self._data_whole_params()
        with self._whole_forward():
            return self._shadow_grads(params, data, labels, mask, round_)

    @contextlib.contextmanager
    def _whole_forward(self):
        """The net runs on whole weights inside this block (no gather at
        use), as the integrity plane's legs do under ``zero = 3``."""
        dims, self.net.zero_dims = self.net.zero_dims, {}
        try:
            yield
        finally:
            self.net.zero_dims = dims

    def _shadow_grads(self, params, data, labels, mask, round_: int):
        flat = [(k, t, w) for k in sorted(params)
                for t, w in sorted(params[k].items())]
        leaves = {}
        for k, t, w in flat:
            leaves.setdefault(k, {})[t] = w.detach().requires_grad_(True)
        aux = {k: dict(v) for k, v in self.aux.items()} if self.aux else None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(round_ & 0x7FFFFFFF)
        with torch.enable_grad():
            _nodes, loss = self.net.forward_train(
                leaves, data, labels, mask, gen, aux=aux,
                step=self.epoch_counter, extras=[])
            del _nodes
            grads = torch.autograd.grad(
                loss, [leaves[k][t] for k, t, _ in flat], allow_unused=True)
        return loss.detach(), [(f"{k}/{t}", g) for (k, t, _), g
                               in zip(flat, grads)]

    @staticmethod
    def _bits(t: torch.Tensor) -> torch.Tensor:
        """``t``'s bytes as integers (a bitwise compare, NaN included)."""
        t = t.detach().contiguous()
        return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                       1: torch.int8}[t.element_size()])

    def shadow_step(self, round_: int):
        """Run a sampled grad step twice on one probe batch and compare
        the loss and every gradient bitwise.  None when both legs agree,
        else a ``{"tensor", "detail"}`` record.  Skipped (None) for nets
        with extra input nodes, as in the JAX package.

        The probe batch is the JAX package's: ``random_sample`` from
        ``RandomState((0x5AD0 ^ (round * 2654435761)) & 0x7FFFFFFF)``,
        zero labels, every row weighted.  Each leg builds its forward
        and its prepared operands from the f32 masters, and both run
        with cuDNN deterministic and its autotuner off (the caller's
        settings come back afterwards), so a clean card gives equal
        bytes; no tolerance."""
        assert self.net is not None, "init_model/load_model first"
        if self.graph.extra_data_num:
            return None
        in_shape = self.net.input_node_shape(self.batch_size)
        rows = self.batch_size // self.mesh_plan.n_data
        rng_np = np.random.RandomState(
            (0x5AD0 ^ (round_ * 2654435761)) & 0x7FFFFFFF)
        data_np = rng_np.random_sample(
            (rows,) + tuple(in_shape[1:])).astype(np.float32)
        width = max([1] + [b for _a, b in self._label_ranges().values()])
        dev = self.device
        data = torch.as_tensor(data_np, device=dev)
        labels = torch.zeros((rows, width), dtype=torch.float32, device=dev)
        mask = torch.ones(rows, dtype=torch.float32, device=dev)
        cudnn = torch.backends.cudnn
        saved = (cudnn.deterministic, cudnn.benchmark)
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            loss_a, grads_a = self._shadow_leg(data, labels, mask, round_)
            loss_b, grads_b = self._shadow_leg(data, labels, mask, round_)
        finally:
            cudnn.deterministic, cudnn.benchmark = saved
        la = loss_a.float().cpu().numpy().tobytes()
        lb = loss_b.float().cpu().numpy().tobytes()
        if self.inject_shadow_mismatch:
            self.inject_shadow_mismatch = 0  # one-shot
            lb = bytes([lb[0] ^ 0x10]) + lb[1:]
        if la != lb:
            return {"tensor": "loss",
                    "detail": (f"shadow loss mismatch at round {round_}: "
                               f"{la.hex()} vs {lb.hex()}")}
        for (name, ga), (_n, gb) in zip(grads_a, grads_b):
            if ga is None and gb is None:
                continue
            if (ga is None or gb is None
                    or not torch.equal(self._bits(ga), self._bits(gb))):
                return {"tensor": name,
                        "detail": (f"shadow grad mismatch at round "
                                   f"{round_}: {name}")}
        return None

    def sync(self) -> None:
        """Wait for the device's queued work (on the CPU only the fault
        site).  The ``mesh.replica`` fault site, on the CPU too, as in
        the JAX package: ``hang`` models a peer wedged in a collective
        (the elastic deadline must end the wait in bounded time),
        ``ioerror`` the reset a SIGKILLed peer raises, ``latency`` a
        straggler."""
        from ..utils.faults import fault_point

        fault_point("mesh.replica")
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def check_weight_sync(self, tol: float = 0.0) -> float:
        """The reference's ``test_on_server = 1`` discipline across the
        ranks: each rank fingerprints every weight it holds (a float64
        sum and sum of squares per leaf; per slice of a leaf cut over the
        model ranks or under ``zero = 3``), the fingerprints are
        all-gathered, and every replica of a leaf (or of a slice) must
        agree within ``tol``.  A slice held by one rank only has nothing
        to compare.  Returns the largest deviation (0.0 on one rank);
        raises ``RuntimeError`` past ``tol``.  Collective."""
        assert self.params is not None, "init_model/load_model first"
        world = self.mesh_plan.n_devices
        if world == 1:
            return 0.0
        names = [(k, t) for k in sorted(self.params)
                 for t in sorted(self.params[k])]
        with torch.no_grad():
            fps = torch.stack([
                torch.stack([w.double().sum(), w.double().square().sum()])
                for w in (self.params[k][t] for k, t in names)])
        every = pdist.gather_host(fps.cpu().numpy())  # [world, leaves, 2]
        worst, where = 0.0, None
        for i, (k, t) in enumerate(names):
            shape = tuple(self.params[k][t].shape)
            replicas: Dict[Optional[tuple], List[int]] = {}
            for r in range(world):
                held = self.held_slice(f"{k}/{t}", shape, r)
                key = None if held is None else tuple(
                    (s_.start, s_.stop) for s_ in held[0])
                replicas.setdefault(key, []).append(r)
            for ranks in replicas.values():
                d = float(np.abs(every[ranks, i] - every[ranks[0], i]).max())
                if d > worst:
                    worst, where = d, f"{k}/{t}"
        if worst > tol:
            raise RuntimeError(
                f"weight-sync check failed: max fingerprint deviation "
                f"{worst:g} across {world} processes (tol {tol:g}), largest "
                f"at {where} — replicated weights have diverged")
        return worst

    def _pad_train_batch(self, batch: DataBatch):
        """``(data, label, extras, mask, n_real)``: a short batch (its
        ``extra_data`` too) zero-padded to ``batch_size`` with a 0/1 row
        mask that keeps the padded rows out of the loss; the trailing
        ``num_batch_padd`` rows of a full batch are masked the same way.
        A batch whose ``data`` and ``label`` are already tensors on the
        device passes through unpadded."""
        n = batch.data.shape[0]
        bs = self.batch_size or n
        world = self.mesh_plan.n_data if self.mesh_plan else 1
        if world > 1:
            # each rank feeds its own batch_size / N rows of the global
            # batch (N data indices: the model ranks of one data index
            # feed the same rows); its iterator pads its own tail
            bs //= world
            if n != bs:
                raise ValueError(
                    f"distributed run: each process must feed exactly "
                    f"batch_size/process_count = {bs} rows, got {n}; "
                    "use round_batch=1 in the data iterator")
        if n > bs:
            raise ValueError(f"train batch of {n} rows exceeds "
                             f"batch_size={bs}")
        n_real = n - int(batch.num_batch_padd or 0) if n == bs else n
        mask = np.zeros(bs, np.float32)
        mask[:n_real] = 1.0
        if isinstance(batch.data, torch.Tensor):
            if n != bs:
                raise ValueError(f"a device-resident batch must hold "
                                 f"batch_size={bs} rows, got {n}")
            return (batch.data, batch.label, list(batch.extra_data), mask,
                    n_real)

        def padded(a):
            a = np.asarray(a, np.float32)
            if n == bs:
                return a
            return np.concatenate(
                [a, np.zeros((bs - n,) + a.shape[1:], np.float32)])

        return (padded(batch.data), padded(batch.label),
                [padded(e) for e in batch.extra_data], mask, n_real)

    def _step_generator(self) -> torch.Generator:
        """The micro-batch's generator for the random layers (dropout,
        ``prelu``'s jitter, ``insanity``, ``insanity_max_pooling``), on
        the trainer's
        device (Philox on a card), seeded from ``(seed, epoch_counter,
        sample_counter)`` so a resumed run draws what an uninterrupted
        one drew."""
        gen = torch.Generator(device=self.device)
        micro = self.epoch_counter * self.update_period + self.sample_counter
        gen.manual_seed((self.seed * 1000003 + micro) & 0x7FFFFFFFFFFFFFFF)
        return gen

    def _node_pred_cache(self, data: np.ndarray, extras, n_real: int) -> dict:
        """Eval forwards for the train metric's ``metric[field,node]``
        entries, on the weights before the update."""
        cache = {}
        for node in self.train_metric.nodes:
            if node is not None and node not in cache:
                f = self._forward_fn(self.graph.node_index_of(node))
                cache[node] = f(self._compute_params(), self.aux, data,
                                extras).cpu().numpy()[:n_real]
        return cache

    def _check_trainable(self) -> None:
        if self.net is None:
            raise RuntimeError("update: init_model or load_model first")
        if self.quant_scheme:
            raise ValueError(
                f"this trainer serves a quantized model ({self.quant_scheme})"
                " and is inference-only: train on the f32 checkpoint and "
                "export again")

    def update(self, batch: DataBatch) -> None:
        """One micro-batch: the train forward from the f32 masters and
        the backward; then, on every ``update_period``-th micro-batch,
        the gradients summed over the ranks (:meth:`_reduce_grads`) and
        the updaters on every tensor in place (all the SGD tensors in one
        launch of the fused SGD kernel on a card) from the summed f32
        gradients, and ``epoch_counter += 1``.  With
        ``device_sample_every = N`` every Nth update then waits for the
        card and the wait lands in ``train_step_device_seconds``."""
        self._check_trainable()
        data_in, label_in, extras_in, mask_np, n_real = (
            self._pad_train_batch(batch))
        dev = self.device
        # the h2d stage: the host's time inside the batch's copy calls
        t0 = time.perf_counter()
        data = torch.as_tensor(data_in, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(label_in, dtype=torch.float32, device=dev)
        extras = [torch.as_tensor(e, dtype=torch.float32, device=dev)
                  for e in extras_in]
        mask = torch.from_numpy(mask_np).to(dev)
        pipeline_stats().add("h2d", time.perf_counter() - t0,
                             rows=int(data.shape[0]))
        # batch norm's sums and the random layers' draws see the group's
        # global batch; the rank-order fold (and the async exchange that
        # re-expresses it) keeps the JAX package's per-shard forward
        per_shard = self._det_active() or self._async_active()
        with pdist.sharded_batch(self.mesh_plan, not per_shard):
            params = self._compute_params()
            node_cache = {}
            if self.eval_train and self.train_metric.need_nodes():
                node_cache = self._node_pred_cache(data_in, extras_in,
                                                   n_real)
            flat = [(key, tag, w) for key, tags in params.items()
                    for tag, w in tags.items()]
            leaves = {}
            for key, tag, w in flat:
                leaves.setdefault(key, {})[tag] = (
                    w.detach().requires_grad_(True))
            with torch.enable_grad(), self.net.zero_saved_hooks():
                nodes, loss = self.net.forward_train(
                    leaves, data, labels, mask, self._step_generator(),
                    aux=self.aux, step=self.epoch_counter, extras=extras)
                out = nodes[self.net.out_node_index()].detach()
                del nodes  # only the graph keeps what the backward needs
                grads = torch.autograd.grad(
                    loss, [leaves[k][t] for k, t, _ in flat],
                    allow_unused=True)
        del leaves
        grads = [torch.zeros_like(w) if g is None else g.contiguous()
                 for (_k, _t, w), g in zip(flat, grads)]
        self.last_loss = loss.detach()
        if self._async_active():
            self._async_update([(k, t) for k, t, _w in flat], grads, out,
                               node_cache, label_in, n_real)
            return
        apply = True
        if self.update_period > 1:
            if self.divergence_policy:
                # the accumulation path: a tripped micro-batch's gradient
                # never joins the sum
                self._guard_loss(self._global_loss(self.last_loss),
                                 self.epoch_counter)
            with torch.no_grad():
                if self._grad_accum is None:
                    self._grad_accum = grads
                else:
                    for acc, g in zip(self._grad_accum, grads):
                        acc.add_(g)
            self.sample_counter += 1
            apply = self.sample_counter >= self.update_period
            grads = self._grad_accum
        if apply:
            names = [(k, t) for k, t, _w in flat]
            grads, self.last_loss = self._reduce_grads(grads, self.last_loss,
                                                       names)
            with torch.no_grad():
                self._apply_updates(names, grads)
            self._invalidate_prepared()
            self._grad_accum, self.sample_counter = None, 0
        if self.update_period == 1 and self.divergence_policy:
            # after the update, as the JAX package's fused step reads it
            self._guard_loss(self.last_loss, self.epoch_counter)
        if self.eval_train:
            self._add_train_eval(out, node_cache, label_in, n_real)
        if apply:
            self.epoch_counter += 1
            obs_device.maybe_sample_step(self.epoch_counter, self.sync)

    def _add_train_eval(self, out, node_cache, label_in, n_real) -> None:
        """The train metrics of one micro-batch (``eval_train``)."""
        base = out.float().cpu().numpy()[:n_real]
        cache = {None: base, **node_cache}
        preds = ([cache[n] for n in self.train_metric.nodes]
                 if node_cache else base)
        label_np = (label_in.cpu().numpy()
                    if isinstance(label_in, torch.Tensor) else label_in)
        self.train_metric.add_eval(preds, label_np[:n_real],
                                   self._label_ranges())

    def _async_update(self, names, grads, out, node_cache, label_in,
                      n_real) -> None:
        """The rest of an ``async_overlap = 1`` step: the per-group
        exchange (``parallel/async_ps``), then the divergence guard and
        the train metrics, whose fetches fence the card and are billed
        against the round's overlap fraction (JAX ``update``)."""
        stepper = self._async_stepper()
        self.last_loss = stepper.step(names, grads, self.last_loss,
                                      self.epoch_counter)
        self._invalidate_prepared()
        if self.divergence_policy or self.eval_train:
            t0 = time.perf_counter()
            if self.divergence_policy:
                self._guard_loss(self.last_loss, self.epoch_counter)
            if self.eval_train:
                self._add_train_eval(out, node_cache, label_in, n_real)
            stepper.add_blocked(time.perf_counter() - t0)
        self.epoch_counter += 1
        obs_device.maybe_sample_step(self.epoch_counter, self.sync)

    # ------------------------------------------------------------------
    # async data parallelism (parallel/async_ps)
    def _async_stepper(self):
        """The lazily built ``AsyncStepper``; dropped when the net is
        rebuilt."""
        if self._async is None:
            from ..parallel.async_ps import AsyncStepper

            self._async = AsyncStepper(self)
        return self._async

    def async_round_end(self, round_: int) -> bool:
        """The round-boundary fence of async mode, and every
        ``async_resync_period`` rounds the hard re-sync barrier (the
        staleness buffers drained first).  A no-op when async mode is
        off or no async step ran yet; True on a resync."""
        if self._async is None or not self._async_active():
            return False
        return self._async.round_end(round_)

    def async_abandon(self, generation: Optional[int] = None,
                      reason: str = "rebuild") -> int:
        """Discard every pending gradient aggregate and move the async
        updater to a new generation (a rollback; the elastic rebuild of
        ROADMAP.md (k4)).  Returns the number dropped."""
        if self._async is None:
            return 0
        return self._async.updater.reset_staleness(
            generation=generation, reason=reason)

    def async_snapshot(self) -> Optional[dict]:
        """The pipeline's telemetry block (pending depths, pushes,
        applies, drops, the overlap fraction); None outside async
        mode."""
        if self._async is None:
            return None
        return self._async.snapshot()

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The group's loss (the sum of the data indices' shares over
        the data sub-group; collective)."""
        if self.mesh_plan.n_data == 1:
            return loss
        return pdist.all_reduce_(loss.float().reshape(1).clone(),
                                 self.mesh_plan.data_group)[0]

    def _reduce_grads(self, grads: List[torch.Tensor], loss: torch.Tensor,
                      names: Sequence[Tuple[str, str]]):
        """``(grads, loss)`` summed over the data sub-group (every model
        rank of a data index holds the same whole gradients).  The
        whole tensors' gradients and the loss: packed into one flat f32
        buffer and all-reduced, or under ``det_reduce`` all-gathered and
        added in rank order (``((g0 + g1) + g2) + ...``,
        :func:`rank_order_fold`), which no backend can reorder.  Under
        ``zero >= 1`` the gradients of the tensors cut over the data
        ranks (``names`` in ``_dims``) come back as this rank's slices of
        the sum: reduce-scattered here in one flat buffer, or already
        reduce-scattered by the backward when ``zero = 3`` gathers at
        use.  A no-op on one data index."""
        if self.mesh_plan.n_data == 1:
            return grads, loss
        group, det = self.mesh_plan.data_group, self._det_active()
        cut = [i for i, n in enumerate(names) if n in self._dims]
        out = list(grads)
        if cut and not self._jit_gather():
            dims = [self._dims[names[i]] for i in cut]
            shapes = []
            for i, d in zip(cut, dims):
                shape = list(grads[i].shape)
                shape[d] //= self.mesh_plan.n_data
                shapes.append(shape)
            mine = pdist.reduce_scatter(
                pdist.pack_by_rank([grads[i] for i in cut], dims,
                                   self.mesh_plan.n_data), group, det=det)
            for i, g in zip(cut, pdist.unpack_slices(mine, shapes)):
                out[i] = g
        whole = sorted(set(range(len(grads))) - set(cut))
        buf = torch.cat([grads[i].reshape(-1) for i in whole]
                        + [loss.float().reshape(1)])
        if det:
            buf = rank_order_fold(pdist.all_gather(buf, group))
        else:
            pdist.all_reduce_(buf, group)
        off = 0
        for i in whole:
            out[i] = buf[off:off + grads[i].numel()].view_as(grads[i])
            off += grads[i].numel()
        return out, buf[off]

    def _apply_updates(self, names: Sequence[Tuple[str, str]],
                       grads: Sequence[torch.Tensor],
                       epoch: Optional[int] = None) -> None:
        """The updaters over the masters in place, one ``apply_all`` at
        the schedule position ``epoch`` (``epoch_counter`` unless the
        async step applies an older aggregate).  A tensor sharded under
        ``zero >= 1`` is updated on this rank's slice only: its
        gradient, which :meth:`_reduce_grads` left as this rank's slice
        (contiguous, the fused SGD kernel's table takes it as it is),
        its state slice, and the master's slice (``zero = 3``: the
        master IS the slice) or a contiguous slice of the whole master,
        whose ranks' slices are then all-gathered back into it (``zero
        = 1``)."""
        items, back = [], []
        plan = self.mesh_plan
        for (key, tag), g in zip(names, grads):
            up, state = self.updaters[(key, tag)], self.ustates[key][tag]
            master = self.params[key][tag]
            d = self._dims.get((key, tag))
            if d is None or self.zero >= 3:
                items.append((up, master, g, state))
                continue
            start, n = plan.slice_bounds(tuple(master.shape), d)
            w_mine = master.narrow(d, start, n).contiguous()
            items.append((up, w_mine, g, state))
            back.append((master, w_mine, d))
        apply_all(items, self.epoch_counter if epoch is None else epoch)
        whole = self._gather_slices([w for _m, w, _d in back],
                                    [d for _m, _w, d in back])
        for (master, _w, _d), full in zip(back, whole):
            master.copy_(full)

    def update_scan(self, data, labels, n_steps: Optional[int] = None,
                    sync: bool = True):
        """K training steps: ``data`` of shape ``[K, B, ...]`` (a
        micro-batch a step) or one ``[B, ...]`` batch reused
        ``n_steps = K`` times, each step a full ``batch_size`` batch.  The
        JAX package runs the K steps as one device program; here they are
        K :meth:`update` calls on batches staged on the device once, which
        is the same math.  Returns the K f32 losses: a numpy array, or
        with ``sync=False`` a tensor on the device, the card's queue not
        drained (``eval_train`` must be off: the train metrics read the
        outputs back).  Refuses what the JAX trainer refuses, with its
        messages."""
        self._check_trainable()
        if not sync and self.eval_train:
            raise ValueError(
                "update_scan(sync=False) cannot overlap with eval_train: "
                "per-step train metrics fetch the scan outputs (a full "
                "sync); pass sync=True or set eval_train = 0")
        if self.update_period != 1:
            raise ValueError("update_scan requires update_period == 1")
        if self._async_active():
            raise ValueError(
                "update_scan is the fused multi-step program — it "
                "cannot interleave the per-group async exchange; use "
                "update() (scan_steps=1) with async_overlap=1")
        if self.graph.extra_data_num:
            raise ValueError(
                "update_scan does not support extra_data nodes; use update()")
        if self.eval_train and self.train_metric.need_nodes():
            raise ValueError(
                "update_scan cannot score node-bound train metrics "
                "(metric[field,node] with eval_train); use update()")
        in_ndim = len(self.net.input_node_shape(self.batch_size))
        dev = self.device
        x = torch.as_tensor(np.asarray(data, np.float32), device=dev)
        y = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
        per_step = x.dim() == in_ndim + 1
        if per_step:
            k = int(x.shape[0])
            if n_steps is not None and n_steps != k:
                raise ValueError(
                    f"n_steps={n_steps} != leading data axis {k}")
        else:
            if n_steps is None:
                raise ValueError(
                    "single-batch mode needs n_steps (or pass [K,B,...])")
            k = int(n_steps)
        world = self.mesh_plan.n_data
        if world > 1:
            # each data index feeds its own [K, B/N, ...] rows; K must
            # match on every rank (a mismatched tail would leave a collective
            # that the others never join)
            local = self.batch_size // world
            got = int(x.shape[1] if per_step else x.shape[0])
            if got != local:
                raise ValueError(
                    f"distributed update_scan: each process must feed "
                    f"batch_size/process_count = {local} rows, got {got}")
            ks = pdist.gather_host(np.asarray([k], np.int64)).reshape(-1)
            if not (ks == k).all():
                raise ValueError(
                    f"distributed update_scan: step counts differ across "
                    f"processes ({sorted(set(int(v) for v in ks))}); every "
                    "process must scan the same K")
        if y.dim() == (2 if per_step else 1):
            y = y.unsqueeze(-1)  # one label column
        losses = []
        for i in range(k):
            self.update(DataBatch(data=x[i] if per_step else x,
                                  label=y[i] if per_step else y))
            losses.append(self.last_loss.float())
        out = torch.stack(losses)
        if not sync:
            return out
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # the divergence guard
    def _guard_loss(self, loss: torch.Tensor, epoch: int) -> None:
        """Read the step's loss back (the guard's one host sync) and raise
        :class:`DivergenceError` on a non-finite value, then run the
        spike gate.  ``inject_nan_step`` / ``inject_spike_step`` make the
        loss at that update read as NaN / a finite spike, once."""
        v = np.float64(float(loss))
        if self.inject_nan_step == epoch:
            self.inject_nan_step = -1  # one-shot: a transient fault
            v = np.float64(np.nan)
        if self.inject_spike_step == epoch:
            self.inject_spike_step = -1  # one-shot: a transient spike
            v = max(abs(v), 1.0) * 1e6  # finite, past any ratio gate
        arr = np.asarray([v])
        if not np.isfinite(v):
            raise DivergenceError(
                f"divergence guard: non-finite loss {v!r} at update {epoch} "
                f"(round {self.round}, policy "
                f"{self.divergence_policy or 'abort'})", loss=arr, epoch=epoch)
        self._guard_loss_ratio(arr, epoch)

    _SPIKE_WINDOW = 32  # rolling finite-loss history length
    _SPIKE_MIN_SAMPLES = 8  # the gate stays disarmed until this many

    def _guard_loss_ratio(self, arr: np.ndarray, first_epoch: int) -> None:
        """``divergence_loss_ratio``: a finite loss above ratio x the
        rolling median of recent finite losses trips too.  The step is
        the unit.  A spike never enters the history (a blow-up must not
        raise the median that judges it); the window rides the trainer,
        so a rollback's fresh trainer starts disarmed."""
        ratio = self.divergence_loss_ratio
        if not ratio:
            return
        hist = self._loss_window
        for i, v in enumerate(arr):
            v = float(v)
            if len(hist) >= self._SPIKE_MIN_SAMPLES:
                med = float(np.median(hist))
                if abs(v) > ratio * max(abs(med), 1e-12):
                    epoch = first_epoch + i
                    raise DivergenceError(
                        f"divergence guard: finite loss spike {v:g} > "
                        f"{ratio:g} x rolling median {med:g} at update "
                        f"{epoch} (round {self.round}, policy "
                        f"{self.divergence_policy or 'abort'})",
                        loss=arr, epoch=epoch)
            hist.append(v)
            if len(hist) > self._SPIKE_WINDOW:
                del hist[0]

    def weights_finite(self) -> bool:
        """True when no parameter holds a NaN or an Inf: a CRC-valid
        checkpoint can still carry a blow-up (the last update of its
        round went non-finite after that round's losses were read)."""
        ok = all(bool(torch.isfinite(w).all())
                 for tags in self.params.values() for w in tags.values())
        return not pdist.any_process_flag(not ok)

    def scale_learning_rate(self, factor: float) -> None:
        """Multiply every updater's base learning rate by ``factor`` (the
        rollback's back-off)."""
        for up in self.updaters.values():
            up.param.base_lr *= factor

    def update_all(self, data: np.ndarray, labels: np.ndarray) -> None:
        """numpy-in convenience (the wrapper API's batch update)."""
        self.update(DataBatch(data=np.asarray(data), label=np.asarray(labels)))

    # ------------------------------------------------------------------
    # weight access (the wrapper API: 2-D views, the visitor's tags)
    def get_weight(self, layer_name: str, tag: str) -> np.ndarray:
        """The weight ``tag`` of layer ``layer_name`` as the reference
        visitor's 2-D f32 view (:meth:`_to_2d`); a ``(0, 0)`` array when
        the layer has no such weight."""
        i = self.graph.layer_index_of(layer_name)
        key = self.net.param_key[i]
        if key not in self.params or tag not in self.params[key]:
            return np.zeros((0, 0), np.float32)
        w = self._data_whole_params()[key][tag]
        d = self._mdims.get((key, tag))
        if d is not None:  # the model slices gathered (collective)
            w = self._gather_slices([w], [d], axis="model")[0]
        # a copy: on the CPU ``numpy()`` would share the live master
        w = w.detach().float().cpu().numpy().copy()
        return self._to_2d(w, self.graph.layers[i].type_name, tag)

    def set_weight(self, weight: np.ndarray, layer_name: str, tag: str) -> None:
        """Write a 2-D view (:meth:`get_weight`'s layout, or anything of
        the same size) into the weight in place, on the trainer's device,
        and drop the operands prepared from the old weights, as
        :meth:`update` does.  ``tag`` is ``wmat`` or ``bias``."""
        if tag not in ("wmat", "bias"):
            raise ValueError("tag must be wmat or bias")
        i = self.graph.layer_index_of(layer_name)
        key = self.net.param_key[i]
        cur = self.params[key][tag]
        new = self._from_2d(np.asarray(weight, np.float32),
                            self._whole_shape(key, tag),
                            self.graph.layers[i].type_name, tag)
        new = self._model_slice(torch.from_numpy(np.ascontiguousarray(new)),
                                self._mdims.get((key, tag)))
        d = self._dims.get((key, tag))
        if self.zero >= 3 and d is not None:
            new = self._my_slice(new, d)
        with torch.no_grad():
            cur.copy_(new)
        self._invalidate_prepared()

    @staticmethod
    def _to_2d(w: np.ndarray, type_name: str, tag: str) -> np.ndarray:
        """The reference visitor's 2-D view: a conv ``wmat`` (HWIO)
        becomes ``(cout, cin_g*kh*kw)`` in ``(cin, kh, kw)`` minor order
        (the unpack_patch2col layout); anything else row-major."""
        if type_name == "conv" and tag == "wmat" and w.ndim == 4:
            kh, kw, ci, co = w.shape
            return w.transpose(3, 2, 0, 1).reshape(co, ci * kh * kw)
        if w.ndim == 1:
            return w[None, :]
        return w.reshape(w.shape[0], -1)

    @staticmethod
    def _from_2d(w2: np.ndarray, shape, type_name: str, tag: str) -> np.ndarray:
        if type_name == "conv" and tag == "wmat" and len(shape) == 4:
            kh, kw, ci, co = shape
            return w2.reshape(co, ci, kh, kw).transpose(2, 3, 1, 0)
        return w2.reshape(shape)

    def _label_ranges(self) -> Dict[str, Tuple[int, int]]:
        g = self.graph
        return {name: g.label_range[i] for name, i in g.label_name_map.items()}

    def evaluate(self, iter_eval, data_name: str) -> str:
        """Round-end evaluation: the train metrics gathered since the
        last call (``eval_train``), then every metric over ``iter_eval``
        (eval forward), as ``\\tname-metric:value`` fields."""
        ret = ""
        if self.eval_train:
            self.train_metric.reduce_across_processes(
                self.mesh_plan.data_group)
            ret += self.train_metric.print("train")
            self.train_metric.clear()
        if iter_eval is None or len(self.metric) == 0:
            return ret
        self.metric.clear()
        nodes = [None if n is None else self.graph.node_index_of(n)
                 for n in self.metric.nodes]
        fns = {n: self._forward_fn(self.net.out_node_index() if n is None
                                   else n) for n in set(nodes)}
        params = self._compute_params()
        iter_eval.before_first()
        # in a group each rank scores its own rows (a sharded iterator)
        # and batch norm's batch statistics are the global batch's
        with pdist.sharded_batch(self.mesh_plan):
            while iter_eval.next():
                batch = iter_eval.value()
                n = batch.batch_size - batch.num_batch_padd
                outs = {k: f(params, self.aux, batch.data,
                             batch.extra_data).cpu().numpy()[:n]
                        for k, f in fns.items()}
                self.metric.add_eval([outs[k] for k in nodes],
                                     batch.label[:n], self._label_ranges())
        if self._gathered is not None:
            self._invalidate_prepared()  # zero = 3: drop the whole weights
        self.metric.reduce_across_processes(self.mesh_plan.data_group)
        ret += self.metric.print(data_name)
        return ret
