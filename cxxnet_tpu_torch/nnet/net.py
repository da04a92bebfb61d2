"""FunctionalNet: a parsed NetGraph executed as PyTorch code.

Counterpart of ``cxxnet_tpu/nnet/net.py``, the predict and the train
forward:

* node 0 is the input; ``input_shape = C,H,W`` maps to a flat ``(N, W)``
  node when ``C == H == 1`` else an NHWC image node; ``extra_data_num =
  k`` adds the side-input nodes ``in_1..in_k`` (nodes 1..k), shaped from
  ``extra_data_shape[i]`` by the same rule and fed from the batch's
  ``extra_data`` (``forward(..., extras=)``), cast to the compute dtype;
* layers are configured with the global defaults first, then their own
  section;
* shared layers reuse the primary layer's parameters;
* self-loop loss layers transform their node in place in f32, and in
  training add ``grad_scale / (batch_size * update_period) *
  loss_masked(...)`` to the step's objective, ``batch_size`` being the
  conf's batch, not the rows fed;
* ``compute_dtype = bfloat16`` runs the layers on bf16 parameters and
  activations; the out node is f32.  In training the f32 masters are
  cast under autograd, so their gradients come back in f32;
* sibling 1x1 convs that read one node at one write-version run as ONE
  GEMM (``_sibling_1x1_groups``), through the hand-written conv-block
  kernel (``ops/kernels/conv_block.py``), in training too: the group's
  ``(C, O)`` kernel is a ``torch.cat`` of the masters at each step;
* a quantized entry (``wmat_q8`` codes, ``ops/quant.py``) keeps its
  codes int8 and its scales and bias f32 in the prepared operands and
  runs ``conv_apply_q`` / ``fc_apply_q`` (the int8 GEMM kernel for a
  2-D fullc and a 1x1 conv); a sibling group with quantized members
  builds its kernel per forward from the dequantized codes rounded to
  the compute dtype (``effective_wmat``), as the JAX package does in its
  program, so only int8 codes stay at rest;
* dropout draws, in layer order, from the one ``torch.Generator`` the
  trainer hands the step;
* the input node keeps the f32 ids when a consumer of it declares
  ``integer_input`` (the embedding), whatever the compute dtype;
* norm layers (``batch_norm``, ``layer_norm``) keep their parameters
  f32 under a bf16 compute dtype: their ``prepare`` does not cast;
* layer state (``init_aux``: the attention KV caches under
  ``decode = 1``, batch norm's running statistics under ``bn_eval =
  running``) is threaded through ``forward(..., aux=, step=)`` and
  ``forward_train(..., aux=)``: a layer with ``apply_stateful`` whose
  key is in ``aux`` reads its state there and the new state replaces it
  in the dict (a shared stateful layer's later occurrence reads what the
  earlier one wrote); ``step`` is the decode loop's absolute position
  at predict time and the update counter in training (``insanity``'s
  anneal reads it).
  Only branch-embed groups (below) move a layer past another, and they
  never defer a shared stateful layer, so the stateful-layer order is
  the declaration order;
* branch-embed fusion (``conv_branch_embed = 1``): inception-style
  sibling branch convs (odd k, stride 1, SAME padding) whose inputs
  trace back, through elementwise layers and 1x1/s1 convs, to one
  (node, write-version) run as ONE zero-padded block conv through
  ``F.conv2d`` (cuDNN), each member's kernel centre-embedded in its own
  (cin, cout) block (``_branch_embed_plan``, ``_apply_branch_embed``).
  The block kernel is built in ``prepare`` (per forward when a member is
  int8, from ``effective_wmat``) and is dropped with the other prepared
  operands; training runs through autograd.  The auto value (-1) is off:
  off for training and on the CPU as in the JAX package, and off on the
  card too, where the JAX package turns it on for inference (its ~3.6x
  larger products were measured to pay on the TPU's MXU only; ROADMAP.md
  section C).

* the model axis (``model_parallel = m``): the trainer holds a rank's
  slice of each tensor ``MeshPlan.model_dim`` cuts and binds the cuts
  here (``bind_model_slices``).  A plain conv (one group) or a
  ``fullc`` whose output dim is cut computes its own ``cout`` /
  ``nout`` slice with its own bias slice and all-gathers the output
  over the model sub-group (``distributed.model_input`` on its input,
  ``model_gather`` on its output: Megatron's pair); a sibling-1x1 group
  of such convs runs its GEMM (K6) over the concatenation of each
  member's slice and splits the gathered output back per member, in
  order.  A layer that computes on its own slices (``moe``, a
  pipelined stack: ``takes_model_slices``) gets them as they are.  Any
  other cut tensor (batch norm's and layer norm's vectors, the
  attention and embedding weights, a group with an uncut member, the
  members of a branch-embed group) is gathered at use, all of them in
  one all-gather per ``prepare`` (``distributed.gather_leaves``).
* ``zero = 3`` (``bind_data_slices``): the trainer holds a rank's data
  slice of each cut tensor, and ``prepare`` builds each layer's (each
  sibling-1x1 or branch-embed group's) operands at its lookup in
  ``_run`` from its weights gathered whole (``distributed.gather_slices``:
  one all-gather, whose backward reduce-scatters the gradient into the
  slice), keeping none of them past the layer; a layer whose cut tensors
  are all vectors (batch norm's gamma and beta) comes in the all-gather
  of the layer before it (``_zero_plan``).  The training forward runs
  under ``distributed.saved_whole_hooks``, so what autograd saves of a
  whole matrix is its recipe, gathered again in the backward.
* ``remat = 1`` recomputes activations in the backward instead of
  keeping them: in training each unit the JAX package wraps in
  ``jax.checkpoint`` (a plain layer, a stateful layer, a sibling-1x1
  group, a branch-embed group; not a loss layer or an int8 entry) runs
  under ``torch.utils.checkpoint`` (``_recomputed``).  The flash
  attention runs inside its layer's unit, so K9 runs again in the
  backward and its O and LSE are not kept.  A unit's recompute replays
  the step generator's draws (``torch.utils.checkpoint`` restores only
  the global generators) and leaves the generator where the step left
  it; a stateful layer's new state is taken from the first run only, so
  batch norm's running statistics move once a step.
"""

from __future__ import annotations

import contextlib
import functools
from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..layers import Layer, LossLayer, create_layer
from ..layers.conv import ConvolutionLayer
from ..layers.linear import FullConnectLayer
from ..layers.pairtest import PairTestLayer
from ..layers.structure import SplitLayer
from ..ops import kernels as _klib
from ..ops import quant as opsq
from ..ops.kernels import conv_block as _kcb
from ..parallel import distributed as pdist
from .graph import NetGraph


def _recomputed(fn, gen: Optional[torch.Generator], *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations
    are recomputed in the backward.  The recompute draws what the first
    run drew from ``gen`` (its state is set back to the first run's
    start) and leaves ``gen`` where it found it."""
    if gen is None:
        return checkpoint(fn, *args, use_reentrant=False)
    start = gen.get_state()
    runs = []

    def run(*a):
        if not runs:
            runs.append(1)
            return fn(*a)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return fn(*a)
        finally:
            gen.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


class _AtUse(Mapping):
    """A mapping whose values are built anew at each lookup (``zero =
    3``'s prepared operands: nothing whole is kept between two uses)."""

    def __init__(self, builders: dict) -> None:
        self._builders = builders

    def __getitem__(self, key):
        return self._builders[key]()

    def __iter__(self):
        return iter(self._builders)

    def __len__(self) -> int:
        return len(self._builders)


class FunctionalNet:
    """Executable (eval) form of a NetGraph."""

    def __init__(self, graph: NetGraph) -> None:
        self.graph = graph
        self.batch_size = 0
        self.update_period = 1
        self.remat = 0
        self.compute_dtype = torch.float32
        self.fuse_1x1 = 1
        self._fuse_cache = None
        self.conv_branch_embed = -1  # -1 auto (off), 0 off, 1 on
        self._embed_cache = None
        self.model_plan = None  # the trainer's MeshPlan, with cut tensors
        #: key -> tag -> the dim cut over the model axis (None: whole),
        #: for the keys with a cut tag (bind_model_slices)
        self.model_dims: Dict[str, Dict[str, Optional[int]]] = {}
        self._shard_cache = None
        #: ZeRO-3 (bind_data_slices): key -> tag -> the dim cut over the
        #: data ranks, the data sub-group, and the rank-order fold flag
        self.zero_dims: Dict[str, Dict[str, int]] = {}
        self.zero_group = None
        self.zero_det = False
        self.zero_vectors: set = set()
        self.layer_objs: List[Layer] = []
        self.param_key: List[Optional[str]] = []
        for i, spec in enumerate(graph.layers):
            if spec.type_name == "shared":
                self.layer_objs.append(self.layer_objs[spec.primary])
                self.param_key.append(self.param_key[spec.primary])
                continue
            lay = create_layer(spec.type_name)
            if isinstance(lay, SplitLayer):
                lay.n_split = len(spec.nindex_out)
            self.layer_objs.append(lay)
            tag = spec.name if spec.name else spec.type_name
            self.param_key.append(f"l{i}_{tag}")
        self._configure_layers()
        self.node_shapes: List[Optional[Tuple[int, ...]]] = []

    # ------------------------------------------------------------------
    def _configure_layers(self) -> None:
        g = self.graph
        for name, val in g.defcfg:
            if name == "batch_size":
                self.batch_size = int(val)
            elif name == "update_period":
                self.update_period = int(val)
            elif name == "remat":
                self.remat = int(val)
            elif name == "fuse_1x1":
                self.fuse_1x1 = int(val)
            elif name == "conv_branch_embed":
                self.conv_branch_embed = int(val)
            elif name == "kernel_lib":
                _klib.parse_mode(val)
            elif name == "compute_dtype":
                if val in ("bfloat16", "bf16"):
                    self.compute_dtype = torch.bfloat16
                elif val in ("float32", "fp32"):
                    self.compute_dtype = torch.float32
                else:
                    raise ValueError(
                        f"compute_dtype must be bfloat16 or float32, got {val!r}")
        for i, spec in enumerate(g.layers):
            if spec.type_name == "shared":
                continue
            lay = self.layer_objs[i]
            for name, val in g.defcfg:
                self._safe_set(lay, name, val)
            for name, val in g.layercfg[i]:
                self._safe_set(lay, name, val)

    @staticmethod
    def _safe_set(lay: Layer, name: str, val: str) -> None:
        """Layer ``set_param`` ignores keys it does not know; an error on
        a key it does claim is a bad value and must fail loudly."""
        try:
            lay.set_param(name, val)
        except NotImplementedError:
            raise
        except Exception as e:
            raise ValueError(
                f"layer {lay.__class__.__name__}: bad value for "
                f"{name!r} = {val!r}: {e}") from e

    # ------------------------------------------------------------------
    def input_node_shape(self, batch_size: int) -> Tuple[int, ...]:
        c, h, w = self.graph.input_shape
        if self.graph.input_layout == "seq":
            return (batch_size, h, w)
        if c == 1 and h == 1:
            return (batch_size, w)
        return (batch_size, h, w, c)

    def extra_node_shape(self, k: int, batch_size: int) -> Tuple[int, ...]:
        """The shape of side-input node ``in_{k+1}``."""
        c, h, w = self.graph.extra_shape[k]
        if c == 1 and h == 1:
            return (batch_size, w)
        return (batch_size, h, w, c)

    def infer_shapes(self, batch_size: int) -> List[Tuple[int, ...]]:
        """Run shape inference over the DAG; returns per-node shapes."""
        g = self.graph
        shapes: List[Optional[Tuple[int, ...]]] = [None] * g.num_nodes
        shapes[0] = self.input_node_shape(batch_size)
        for k in range(g.extra_data_num):
            shapes[k + 1] = self.extra_node_shape(k, batch_size)
        for i, spec in enumerate(g.layers):
            in_shapes = []
            for n in spec.nindex_in:
                if shapes[n] is None:
                    raise ValueError(
                        f"layer {i} ({spec.type_name}) input node "
                        f"{g.node_names[n]!r} has no shape yet")
                in_shapes.append(shapes[n])
            out_shapes = self.layer_objs[i].infer_shape(in_shapes)
            if len(out_shapes) != len(spec.nindex_out):
                raise ValueError(
                    f"layer {i} ({spec.type_name}): produced {len(out_shapes)} "
                    f"outputs for {len(spec.nindex_out)} output nodes")
            for n, s in zip(spec.nindex_out, out_shapes):
                shapes[n] = tuple(s)
        self.node_shapes = shapes
        return shapes  # type: ignore[return-value]

    def init_aux(self, batch_size: int, device=None) -> Dict[str, dict]:
        """Non-gradient layer state on ``device`` (the KV caches of
        ``decode = 1`` attention, batch norm's running statistics);
        empty when no layer carries any."""
        shapes = self.infer_shapes(batch_size)
        aux: Dict[str, dict] = {}
        for i, spec in enumerate(self.graph.layers):
            lay = self.layer_objs[i]
            if spec.type_name == "shared" or not hasattr(lay, "init_aux"):
                continue
            st = lay.init_aux([shapes[n] for n in spec.nindex_in], device)
            if st:
                aux[self.param_key[i]] = st
        return aux

    def _node0_wants_ints(self) -> bool:
        """True when any consumer of the data node declares
        ``integer_input`` (keyed to the graph, not to declaration
        order): the ids then stay f32 for every consumer."""
        return any(0 in spec.nindex_in
                   and getattr(self.layer_objs[i], "integer_input", False)
                   for i, spec in enumerate(self.graph.layers))

    def init_params(self, gen: torch.Generator,
                    batch_size: int) -> Dict[str, dict]:
        """Fresh f32 master params on the CPU, drawn from ``gen`` layer by
        layer in declaration order."""
        shapes = self.infer_shapes(batch_size)
        params: Dict[str, dict] = {}
        for i, spec in enumerate(self.graph.layers):
            if spec.type_name == "shared":
                continue
            p = self.layer_objs[i].init_params(
                gen, [shapes[n] for n in spec.nindex_in])
            if p:
                params[self.param_key[i]] = p
        return params

    # ------------------------------------------------------------------
    def _graph_versions(self):
        """Declaration-order dataflow scan shared by the two fusion
        planners: per-node write counts, per-layer read keys ``(node,
        version-at-read)``, and ``writers[n][v]`` = the layer whose write
        created version ``v+1`` of node ``n`` (version 0 = graph input)."""
        g = self.graph
        writes = [0] * g.num_nodes
        for spec in g.layers:
            for n in spec.nindex_out:
                writes[n] += 1
        version = [0] * g.num_nodes
        writers: Dict[int, List[int]] = {}
        in_keys: List[List[Tuple[int, int]]] = []
        for i, spec in enumerate(g.layers):
            in_keys.append([(n, version[n]) for n in spec.nindex_in])
            for n in spec.nindex_out:  # reads happen before writes
                writers.setdefault(n, []).append(i)
                version[n] += 1
        return writes, in_keys, writers

    def _sibling_1x1_groups(self):
        """Groups of distinct 1x1/p0/ungrouped conv layers with one
        stride that read one input node at one write-version, to run as
        ONE concatenated GEMM.  Returns ``(groups, member)``: leader
        index -> member indices, and member index -> leader.

        The key carries the write-version because a self-loop layer
        between two sibling declarations changes the node they read.
        Members run early (at the leader's position), so each must be the
        sole writer of its output node.  Shared layers keep the plain
        path."""
        if self._fuse_cache is not None:
            return self._fuse_cache
        writes, in_keys, _writers = self._graph_versions()
        by_input: Dict[Tuple[int, int, int], List[int]] = {}
        for i, spec in enumerate(self.graph.layers):
            if spec.type_name == "shared":
                continue
            lay = self.layer_objs[i]
            if type(lay) is not ConvolutionLayer:
                continue
            p = lay.param
            if ((p.kernel_height, p.kernel_width, p.pad_x, p.pad_y,
                 p.num_group) == (1, 1, 0, 0, 1)
                    and len(spec.nindex_in) == 1
                    and len(spec.nindex_out) == 1
                    and spec.nindex_out[0] != spec.nindex_in[0]
                    and writes[spec.nindex_out[0]] == 1):
                n, v = in_keys[i][0]
                by_input.setdefault((n, v, p.stride), []).append(i)
        groups: Dict[int, List[int]] = {}
        member: Dict[int, int] = {}
        for idxs in by_input.values():
            if len(idxs) < 2:
                continue
            groups[idxs[0]] = idxs
            for j in idxs:
                member[j] = idxs[0]
        self._fuse_cache = (groups, member)
        return self._fuse_cache

    # ------------------------------------------------------------------
    # branch-embed fusion: with SAME padding and stride 1, the k_max conv
    # of a centre-embedded smaller kernel equals the smaller conv, so the
    # group's convs are one conv over the concatenated inputs with a
    # block kernel (zeros off the diagonal blocks)

    #: elementwise single-in/single-out layers a provenance walk may step
    #: through: they keep (H, W), so two convs whose walks meet at one
    #: (node, version) see the same spatial dims
    _EMBED_WALK_TYPES = frozenset({
        "relu", "sigmoid", "tanh", "softplus", "xelu", "insanity",
        "prelu", "bias", "batch_norm", "dropout",
    })

    def use_branch_embed(self) -> bool:
        """Whether the forward fuses inception branches: only under
        ``conv_branch_embed = 1``.  The JAX package's auto value (-1) is
        off for training and on the CPU, and on for inference on an
        accelerator; the port keeps it off on the card too, where the
        fused GoogLeNet forward measured slower (ROADMAP.md section C),
        so in training and serving alike only an explicit 1 fuses."""
        return self.conv_branch_embed == 1

    def _branch_embed_plan(self):
        """``(items, groups)``: the execution plan, a list of ``("L",
        layer)`` / ``("E", leader)`` items (None when nothing groups),
        and ``leader -> member indices``.

        Members are odd-k (3/5/7) stride-1 SAME ungrouped convs whose
        inputs trace back, through ``_EMBED_WALK_TYPES`` layers and
        1x1/s1/p0 convs, to one (node, write-version).  Declaration order
        interleaves the branches (the 5x5 reduce sits between the 3x3 and
        the 5x5 conv), so a group runs at its LAST member's position and
        the layers in that window that consume member outputs move after
        it; a group is kept only when every node written in the window
        has one writer (any dependency-respecting order is then the
        same), no moved layer leads a sibling-1x1 group, and no moved
        layer is a shared stateful one.  The JAX package's planner, rule
        for rule."""
        if self._embed_cache is not None:
            return self._embed_cache
        g = self.graph
        writes, in_keys, writers = self._graph_versions()

        def walkable(p: int) -> bool:
            ps = g.layers[p]
            if len(ps.nindex_in) != 1 or len(ps.nindex_out) != 1:
                return False
            if ps.type_name in self._EMBED_WALK_TYPES:
                return True
            if ps.type_name == "conv":
                lp = self.layer_objs[p].param
                return ((lp.kernel_height, lp.kernel_width, lp.stride,
                         lp.pad_y, lp.pad_x, lp.num_group)
                        == (1, 1, 1, 0, 0, 1))
            return False

        def root_of(i: int) -> Tuple[int, int]:
            n, v = in_keys[i][0]
            while v > 0:
                p = writers[n][v - 1]
                if not walkable(p):
                    break
                n, v = in_keys[p][0]
            return n, v

        by_root: Dict[Tuple[int, int], List[int]] = {}
        for i, spec in enumerate(g.layers):
            if spec.type_name == "shared":
                continue
            lay = self.layer_objs[i]
            if type(lay) is not ConvolutionLayer:
                continue
            p = lay.param
            if not (p.stride == 1 and p.num_group == 1
                    and p.kernel_height == p.kernel_width
                    and p.kernel_height in (3, 5, 7)
                    and p.pad_y == (p.kernel_height - 1) // 2
                    and p.pad_x == (p.kernel_width - 1) // 2
                    and len(spec.nindex_in) == 1
                    and len(spec.nindex_out) == 1
                    and spec.nindex_out[0] != spec.nindex_in[0]
                    and writes[spec.nindex_out[0]] == 1):
                continue
            by_root.setdefault(root_of(i), []).append(i)

        fuse_groups = self._sibling_1x1_groups()[0] if self.fuse_1x1 else {}
        key_counts: Dict[Optional[str], int] = {}
        for k in self.param_key:
            key_counts[k] = key_counts.get(k, 0) + 1
        found: List[Tuple[List[int], List[int]]] = []  # (members, moved)
        for idxs in by_root.values():
            if len(idxs) < 2:
                continue
            idxs = sorted(idxs)
            first, last = idxs[0], idxs[-1]
            iset = set(idxs)
            dep_nodes: set = set()
            moved: List[int] = []
            for j in range(first, last + 1):
                sj = g.layers[j]
                if j in iset:
                    dep_nodes.update(sj.nindex_out)
                elif any(n in dep_nodes for n in sj.nindex_in):
                    moved.append(j)
                    dep_nodes.update(sj.nindex_out)
            # (<= 1: a member may read the never-written input node)
            ok = (all(writes[n] == 1 for j in range(first, last + 1)
                      for n in g.layers[j].nindex_out)
                  and all(writes[in_keys[j][0][0]] <= 1 for j in idxs)
                  and not any(j in fuse_groups for j in moved)
                  and not any(
                      hasattr(self.layer_objs[j], "apply_stateful")
                      and key_counts[self.param_key[j]] > 1
                      for j in moved))
            if ok:
                found.append((idxs, moved))
        found.sort(key=lambda t: t[0][0])
        if not found:
            self._embed_cache = (None, {})
            return self._embed_cache
        items: List[Tuple[str, int]] = []
        gmap: Dict[int, List[int]] = {}
        pos = 0
        for idxs, moved in found:
            first, last = idxs[0], idxs[-1]
            if first < pos:  # overlapping window: drop this group
                continue
            skip = set(idxs) | set(moved)
            items.extend(("L", j) for j in range(pos, first))
            items.extend(("L", j) for j in range(first, last + 1)
                         if j not in skip)
            items.append(("E", idxs[0]))
            items.extend(("L", j) for j in moved)
            gmap[idxs[0]] = idxs
            pos = last + 1
        items.extend(("L", j) for j in range(pos, len(g.layers)))
        self._embed_cache = (items, gmap)
        return self._embed_cache

    @staticmethod
    def _embed_kernel(ps: List[dict], cdt: torch.dtype) -> torch.Tensor:
        """A branch group's block kernel, OIHW ``(sum cout, sum cin,
        kmax, kmax)`` in ``cdt`` and ``channels_last`` as the conv layer
        keeps its own: each member's kernel (dequantized codes for an
        int8 member) centre-embedded in its diagonal block, zeros
        elsewhere.  Built by slice assignment, so autograd carries each
        member's gradient back to its master."""
        ws = [opsq.effective_wmat(p, cdt) for p in ps]
        kmax = max(w.shape[0] for w in ws)
        cin = sum(w.shape[2] for w in ws)
        cout = sum(w.shape[3] for w in ws)
        wk = torch.zeros((cout, cin, kmax, kmax), dtype=cdt,
                         device=ws[0].device)
        ci = co = 0
        for w in ws:
            k, _, c, o = w.shape
            d0 = (kmax - k) // 2
            wk[co:co + o, ci:ci + c, d0:d0 + k, d0:d0 + k] = \
                w.permute(3, 2, 0, 1)
            ci += c
            co += o
        return wk.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def _apply_branch_embed(grp: dict, xs: Sequence[torch.Tensor],
                            cdt: Optional[torch.dtype] = None
                            ) -> List[torch.Tensor]:
        """One block-kernel conv for a branch group (NHWC inputs, one per
        member); per-member NHWC outputs.  ``grp`` holds the prepared
        ``wk`` (or the int8 ``members`` to build it from), the ``(O,)``
        ``bias`` (zeros for members without one; None when none has one)
        and the per-member output ``splits``."""
        if not all(x.shape[:3] == xs[0].shape[:3] for x in xs):
            raise ValueError(
                "branch-embed members must share input spatial dims: "
                f"{[tuple(x.shape) for x in xs]}")
        wk = grp["wk"]
        if wk is None:
            wk = FunctionalNet._embed_kernel(grp["members"],
                                             cdt or xs[0].dtype)
        pad = (wk.shape[2] - 1) // 2
        x = torch.cat(list(xs), dim=3)
        y = F.conv2d(x.permute(0, 3, 1, 2), wk, grp["bias"],
                     padding=(pad, pad)).permute(0, 2, 3, 1)
        return list(torch.split(y, grp["splits"], dim=3))

    # ------------------------------------------------------------------
    # the model axis: tensor slices
    def bind_model_slices(self, plan, dims: Dict[str, Dict[str, Optional[int]]]
                          ) -> None:
        """The trainer's cuts: ``dims[key][tag]`` the dimension of the
        slice it holds (None: whole), for every key with a cut tag, and
        its ``MeshPlan`` (the model sub-group)."""
        self.model_plan = plan if dims else None
        self.model_dims = dict(dims)
        self._shard_cache = None

    def _shard_plan(self):
        """``(sliced, gathered)`` param keys: the layers that compute
        their own output channels on their slices and gather the output
        (a plain conv, a ``fullc``, a sibling-1x1 group of them), and
        the keys whose cut tags are gathered at use.  A layer that
        ``takes_model_slices`` is in neither."""
        if self._shard_cache is not None:
            return self._shard_cache
        sliced, gathered = set(), set()
        for i, key in enumerate(self.param_key):
            dims = self.model_dims.get(key)
            if not dims or key in sliced or key in gathered:
                continue
            lay = self.layer_objs[i]
            if getattr(lay, "takes_model_slices", lambda: False)():
                continue
            own = ((type(lay) is ConvolutionLayer and lay.param.num_group == 1)
                   or type(lay) is FullConnectLayer)
            if own and all(d is not None for d in dims.values()):
                sliced.add(key)
            else:
                gathered.add(key)
        fuse = self._sibling_1x1_groups()[0] if self.fuse_1x1 else {}
        embed = self._branch_embed_plan()[1] if self.use_branch_embed() \
            else {}
        for idxs in fuse.values():
            keys = {self.param_key[j] for j in idxs}
            if not keys <= sliced:
                gathered |= keys & sliced
                sliced -= keys
        for idxs in embed.values():
            keys = {self.param_key[j] for j in idxs}
            gathered |= keys & sliced
            sliced -= keys
        self._shard_cache = (sliced, gathered)
        return self._shard_cache

    def _gather_at_use(self, params: Dict[str, dict]) -> Dict[str, dict]:
        """``params`` with the cut tags of the gathered keys whole (one
        all-gather of the model sub-group; each slice's gradient comes
        back as its part of the whole's)."""
        gathered = self._shard_plan()[1]
        names = [(k, t) for k in sorted(gathered) if k in params
                 for t, d in sorted(self.model_dims[k].items())
                 if d is not None]
        if not names:
            return params
        whole = pdist.gather_leaves([params[k][t] for k, t in names],
                                    [self.model_dims[k][t] for k, t in names],
                                    self.model_plan.model_group)
        out = {k: dict(v) if k in gathered else v for k, v in params.items()}
        for (k, t), w in zip(names, whole):
            out[k][t] = w
        return out

    def _gather_parts(self, y: torch.Tensor, splits: Sequence[int]
                      ) -> List[torch.Tensor]:
        """A sliced sibling group's output ``y`` (each member's local
        channels side by side) gathered over the model sub-group and
        split back into each member's whole output, in order."""
        g = pdist.model_gather(y.unsqueeze(0), 0, self.model_plan.model_group)
        outs = []
        for part in torch.split(g, list(splits), dim=-1):
            part = part.movedim(0, -2)  # (..., ranks, local channels)
            outs.append(part.reshape(tuple(part.shape[:-2]) + (-1,)))
        return outs

    # ------------------------------------------------------------------
    # ZeRO-3: the data slices gathered at use
    def bind_data_slices(self, group, dims: Dict[str, Dict[str, int]],
                         det: bool = False, vectors=()) -> None:
        """The trainer's ``zero = 3`` cuts: ``dims[key][tag]`` the
        dimension of the data slice it holds, ``group`` the data
        sub-group, ``det`` the rank-order fold of the gradients
        (``det_reduce``), ``vectors`` the keys whose cut tensors are all
        vectors (gathered with the layer before them, :meth:`_zero_plan`).
        Empty ``dims``: the weights are whole."""
        self.zero_dims = {k: dict(v) for k, v in dims.items()}
        self.zero_group = group if dims else None
        self.zero_det = bool(det)
        self.zero_vectors = set(vectors) & set(dims)

    def _zero_plan(self) -> List[tuple]:
        """``zero = 3``'s gathers, in the order :meth:`_run` looks the
        operands up: ``(map, name, keys, riders)`` for each lookup that
        holds a cut tensor (``map`` ``layers`` / ``groups`` / ``embed``
        of :meth:`prepare`, ``name`` its key there).  ``riders``: the
        keys of the vector-only layers after it (batch norm's gamma and
        beta, a bias) up to the next lookup with a cut matrix, gathered
        in its one all-gather and kept for their own lookup, so a vector
        costs no collective of its own.  A vector key looked up more
        than once, or before any matrix, gathers alone."""
        fuse, member = (self._sibling_1x1_groups() if self.fuse_1x1
                        else ({}, {}))
        items, embed = (self._branch_embed_plan() if self.use_branch_embed()
                        else (None, {}))
        if items is None:
            items = [("L", i) for i in range(len(self.graph.layers))]
        looks = []
        for kind, i in items:
            if kind == "E":
                looks.append(("embed", i, [self.param_key[j]
                                           for j in embed[i]]))
            elif i not in member:
                looks.append(("layers", self.param_key[i],
                              [self.param_key[i]]))
            elif member[i] == i:
                looks.append(("groups", i, [self.param_key[j]
                                            for j in fuse[i]]))
        looks = [(m, n, [k for k in dict.fromkeys(keys)
                         if k in self.zero_dims]) for m, n, keys in looks]
        looks = [lk for lk in looks if lk[2]]
        seen: Dict[str, int] = {}
        for _m, _n, keys in looks:
            for k in keys:
                seen[k] = seen.get(k, 0) + 1
        plan, host = [], None
        for m, n, keys in looks:
            if (host is not None and len(keys) == 1 and m == "layers"
                    and keys[0] in self.zero_vectors and seen[keys[0]] == 1):
                host[3].append(keys[0])
                continue
            entry = (m, n, keys, [])
            plan.append(entry)
            if not all(k in self.zero_vectors for k in keys):
                host = entry
        return plan

    def zero_units(self) -> List[List[str]]:
        """The keys gathered together under ``zero = 3``: one list per
        all-gather of :meth:`_zero_plan` (a layer or a sibling-1x1 or
        branch-embed group, with the vectors that ride with it)."""
        return [keys + riders for _m, _n, keys, riders in self._zero_plan()]

    def zero_saved_hooks(self):
        """The training forward's saved-tensor hooks under ``zero = 3``
        (``distributed.saved_whole_hooks``), else a no-op context."""
        if not self.zero_dims:
            return contextlib.nullcontext()
        return pdist.saved_whole_hooks()

    def _zero_whole(self, params: Dict[str, dict], keys: Sequence[str]
                    ) -> Dict[str, dict]:
        """``params`` of ``keys`` with their cut tags whole: one
        ``distributed.gather_slices`` of all of them over the data
        sub-group (the backward: one reduce-scatter)."""
        out = {k: dict(params[k]) for k in keys if k in params}
        names = [(k, t) for k in out for t in sorted(self.zero_dims.get(k, {}))
                 if t in out[k]]
        whole = pdist.gather_slices([out[k][t] for k, t in names],
                                    [self.zero_dims[k][t] for k, t in names],
                                    self.zero_group, self.zero_det)
        for (k, t), w in zip(names, whole):
            out[k][t] = w
        return out

    def _at_use(self, keys: Sequence[str], params: Dict[str, dict], build,
                riders: Sequence[str] = (), stash: Optional[dict] = None):
        """``build(whole)`` over the keys' weights gathered whole, every
        tensor it returns (and every gathered one) registered with its
        recipe (``distributed.register_regen``: gather and build again)
        and counted while it lives (``distributed.track_gathered``).
        ``build`` returns a dict of tensors (or of None / lists).  The
        ``riders``' weights come in the same all-gather and wait in
        ``stash`` for their own lookup (:meth:`_ridden`)."""
        def make(extra=()):
            whole = self._zero_whole(params, [*keys, *extra])
            for k in extra:
                stash[k] = whole.pop(k)
            return whole, build(whole)

        whole, out = make(riders)
        fresh = {w.untyped_storage().data_ptr() for tags in whole.values()
                 for w in tags.values()}
        for k, tags in whole.items():
            for t, w in tags.items():
                pdist.register_regen(
                    w, lambda k=k, t=t: self._zero_whole(params, [k])[k][t])
        for name, v in out.items():
            if not isinstance(v, torch.Tensor):
                continue
            if v.untyped_storage().data_ptr() not in fresh:
                pdist.track_gathered(v)
            pdist.register_regen(v, lambda name=name: make()[1][name])
        return out

    def _ridden(self, key: str, params: Dict[str, dict], stash: dict,
                build):
        """``build(whole)`` of a rider (:meth:`_zero_plan`): its weights
        from ``stash``, where its host's gather left them (or gathered
        now, should the host not have run).  A vector is small, so what
        autograd saves of it is kept as it is (no recipe); it is counted
        while it lives."""
        whole = ({key: stash.pop(key)} if key in stash
                 else self._zero_whole(params, [key]))
        out = build(whole)
        fresh = {w.untyped_storage().data_ptr() for w in whole[key].values()}
        for v in out.values():
            if (isinstance(v, torch.Tensor) and v.numel()
                    and v.untyped_storage().data_ptr() not in fresh):
                pdist.track_gathered(v)
        return out

    # ------------------------------------------------------------------
    def prepare(self, params: Dict[str, dict]) -> Dict[str, object]:
        """Master params -> the forward's operands: each layer's params in
        the compute dtype and its kernel's layout (none for the members of
        a sibling-1x1 or branch-embed group, which run as the group; a
        quantized entry's codes, scales and bias as they are,
        ``opsq.prepare_q``), each sibling-1x1 group's concatenated ``(C,
        O)`` kernel (``_group_kernel``) and each branch-embed group's
        block kernel (``_embed_kernel``, under ``use_branch_embed()``),
        with the group's ``(O,)`` bias (zeros for members without one;
        None when no member has one).  A group with an int8 member keeps
        ``members`` instead of a kernel and builds it per forward.  Once
        per load for predict; per step, under autograd, for training.
        Over a model axis the gathered keys' cut tags are gathered first
        (:meth:`_gather_at_use`).  Under ``zero = 3`` the three maps
        build an entry of cut weights anew at each lookup, from the
        weights gathered then (:meth:`_at_use`)."""
        cdt = self.compute_dtype
        if self.model_dims:
            params = self._gather_at_use(params)
        fuse = self._sibling_1x1_groups()[0] if self.fuse_1x1 else {}
        embed = self._branch_embed_plan()[1] if self.use_branch_embed() \
            else {}
        member = {j for idxs in (*fuse.values(), *embed.values())
                  for j in idxs}
        zero = self.zero_dims
        riders = ({(m, n): r for m, n, _k, r in self._zero_plan()} if zero
                  else {})
        rides = {k for r in riders.values() for k in r}
        stash: dict = {}  # zero = 3: the riders' gathered weights
        layers: Dict[str, object] = {}
        for i, key in enumerate(self.param_key):
            if key in params and key not in layers and i not in member:
                if key in rides:
                    layers[key] = functools.partial(
                        self._ridden, key, params, stash,
                        functools.partial(self._prepare_one, i, key, cdt))
                    continue
                if key in zero:
                    layers[key] = functools.partial(
                        self._at_use, [key], params,
                        functools.partial(self._prepare_one, i, key, cdt),
                        riders.get(("layers", key), ()), stash)
                    continue
                layers[key] = (opsq.prepare_q(params[key])
                               if opsq.is_quantized(params[key]) else
                               self.layer_objs[i].prepare(params[key], cdt))

        def group(idxs, build, key, params=params):
            ps = [params[self.param_key[j]] for j in idxs]
            splits = [(p[opsq.QKEY] if opsq.is_quantized(p)
                       else p["wmat"]).shape[3] for p in ps]
            bias = None
            if any("bias" in p for p in ps):
                dev = next(p["bias"] for p in ps if "bias" in p).device
                bias = torch.cat([
                    p["bias"] if "bias" in p else torch.zeros(n, device=dev)
                    for p, n in zip(ps, splits)]).to(cdt)
            quant = any(opsq.is_quantized(p) for p in ps)
            return {key: None if quant else build(ps, cdt),
                    "members": ps if quant else None,
                    "bias": bias, "splits": splits}

        if not zero:
            return {"layers": layers,
                    "groups": {leader: group(idxs, self._group_kernel, "w2d")
                               for leader, idxs in fuse.items()},
                    "embed": {leader: group(idxs, self._embed_kernel, "wk")
                              for leader, idxs in embed.items()}}
        # zero = 3: each layer's (each group's) operands are built from
        # its gathered weights at each lookup and kept by nobody
        def lazy_group(idxs, build, key, at):
            keys = list(dict.fromkeys(self.param_key[j] for j in idxs))
            return functools.partial(
                self._at_use, keys, params,
                lambda whole: group(idxs, build, key, params=whole),
                riders.get(at, ()), stash)

        return {"layers": _AtUse({k: v if callable(v) else (lambda v=v: v)
                                  for k, v in layers.items()}),
                "groups": _AtUse({leader: lazy_group(
                    idxs, self._group_kernel, "w2d", ("groups", leader))
                    for leader, idxs in fuse.items()}),
                "embed": _AtUse({leader: lazy_group(
                    idxs, self._embed_kernel, "wk", ("embed", leader))
                    for leader, idxs in embed.items()})}

    def _prepare_one(self, i: int, key: str, cdt: torch.dtype,
                     whole: Dict[str, dict]) -> dict:
        """Layer ``i``'s operands from ``whole``, its weights gathered."""
        return self.layer_objs[i].prepare(whole[key], cdt)

    @staticmethod
    def _group_kernel(ps: List[dict], cdt: torch.dtype) -> torch.Tensor:
        """A sibling group's ``(C, O)`` kernel in ``cdt``: each member's
        1x1 HWIO kernel (dequantized codes for an int8 member), side by
        side on O."""
        ws = [opsq.effective_wmat(p, cdt) for p in ps]
        return torch.cat([w.reshape(w.shape[2], -1) for w in ws],
                         dim=1).contiguous()

    def forward(self, prepared: Dict[str, object], data: torch.Tensor,
                aux: Optional[Dict[str, dict]] = None,
                step: Optional[int] = None,
                extras: Sequence[torch.Tensor] = ()
                ) -> List[Optional[torch.Tensor]]:
        """The predict forward of ``data`` (the input node's tensor, on
        the params' device) and the side inputs ``extras``; returns every
        node's value.  ``aux`` (from ``init_aux``) is updated in place;
        ``step`` is the absolute position of the first token under
        ``decode = 1``."""
        return self._run(prepared, data, aux=aux, step=step,
                         extras=extras)[0]

    def forward_train(self, params: Dict[str, dict], data: torch.Tensor,
                      labels: torch.Tensor, mask: Optional[torch.Tensor],
                      gen: Optional[torch.Generator],
                      aux: Optional[Dict[str, dict]] = None,
                      step: Optional[int] = None,
                      extras: Sequence[torch.Tensor] = ()):
        """The train forward from the f32 master ``params``: returns
        ``(nodes, loss)`` with the summed, scaled f32 loss of every loss
        layer, differentiable back to the masters.  ``labels`` is the
        ``(N, label_width)`` label matrix, ``mask`` the ``(N,)`` 0/1 row
        weight, ``gen`` the step's generator for the random layers,
        ``step`` the update counter; ``aux`` (from ``init_aux``) takes
        each stateful layer's new state in place."""
        return self._run(self.prepare(params), data, labels=labels,
                         mask=mask, train=True, gen=gen, aux=aux, step=step,
                         extras=extras)

    def _label_field(self, labels: torch.Tensor, target: str) -> torch.Tensor:
        g = self.graph
        if target not in g.label_name_map:
            raise ValueError(f"LossLayer: unknown target={target!r}")
        a, b = g.label_range[g.label_name_map[target]]
        if labels.dim() == 1:
            labels = labels[:, None]
        return labels[:, a:b]

    def _run(self, prepared, data, labels=None, mask=None, train=False,
             gen=None, aux=None, step=None, extras=()):
        g = self.graph
        cdt = self.compute_dtype
        layers, groups = prepared["layers"], prepared["groups"]
        out_idx = self.out_node_index()
        nodes: List[Optional[torch.Tensor]] = [None] * g.num_nodes
        nodes[0] = data if self._node0_wants_ints() else data.to(cdt)
        if len(extras) != g.extra_data_num:
            raise ValueError(f"the net has {g.extra_data_num} extra_data "
                             f"node(s); {len(extras)} side input(s) given")
        for k, e in enumerate(extras):
            nodes[k + 1] = e.to(cdt)
        loss = torch.zeros((), dtype=torch.float32, device=data.device)
        batch = self.batch_size if self.batch_size > 0 else data.shape[0]
        fuse_groups, fuse_member = (
            self._sibling_1x1_groups() if self.fuse_1x1 else ({}, {}))
        embed_items, embed_groups = (
            self._branch_embed_plan() if self.use_branch_embed()
            else (None, {}))
        items = (embed_items if embed_items is not None
                 else [("L", i) for i in range(len(g.layers))])
        remat = bool(self.remat and train)
        sliced = self._shard_plan()[0] if self.model_dims else set()
        mgroup = self.model_plan.model_group if sliced else None

        def unit(fn, *args):
            return _recomputed(fn, gen, *args) if remat else fn(*args)

        for kind, i in items:
            spec = g.layers[i]
            if kind == "E":
                idxs = embed_groups[i]
                xs = [nodes[g.layers[j].nindex_in[0]] for j in idxs]
                if any(v is None for v in xs):
                    raise ValueError(
                        f"branch-embed group at layer {i}: unset input node")
                outs = unit(self._apply_branch_embed, prepared["embed"][i],
                            xs, cdt)
                for j, out in zip(idxs, outs):
                    nodes[g.layers[j].nindex_out[0]] = out
                continue
            if i in fuse_member:
                if fuse_member[i] != i:
                    continue  # output produced by its group leader
                x = nodes[spec.nindex_in[0]]
                if x is None:
                    raise ValueError(f"layer {i}: unset input node")
                grp = groups[i]
                w2d = grp["w2d"]
                if w2d is None:
                    w2d = self._group_kernel(grp["members"], cdt)
                cut = self.param_key[i] in sliced
                if cut:
                    x = pdist.model_input(x, mgroup)
                y = unit(functools.partial(
                    _kcb.conv1x1_block,
                    stride=self.layer_objs[i].param.stride), x, w2d,
                    grp["bias"])
                parts = (self._gather_parts(y, grp["splits"]) if cut
                         else torch.split(y, grp["splits"], dim=3))
                grp = w2d = None  # zero = 3: nothing whole outlives its use
                for j, part in zip(fuse_groups[i], parts):
                    nodes[g.layers[j].nindex_out[0]] = part
                continue
            lay = self.layer_objs[i]
            inputs = [nodes[n] for n in spec.nindex_in]
            if any(v is None for v in inputs):
                raise ValueError(f"layer {i}: unset input node")
            if isinstance(lay, PairTestLayer) and isinstance(lay.master,
                                                             LossLayer):
                lay = lay.master
            if isinstance(lay, LossLayer):
                logits = inputs[0].float()
                if labels is not None:
                    scale = lay.grad_scale / (batch * self.update_period)
                    loss = loss + scale * lay.loss_masked(
                        logits, self._label_field(labels, lay.target), mask)
                out = lay.transform(logits)
                if spec.nindex_out[0] != out_idx:
                    out = out.to(cdt)
                nodes[spec.nindex_out[0]] = out
                continue
            key = self.param_key[i]
            lparams = layers.get(key, {})
            if opsq.is_quantized(lparams):
                nodes[spec.nindex_out[0]] = self._apply_quant_layer(
                    lay, lparams, inputs[0])
                continue
            if aux is not None and key in aux and hasattr(lay,
                                                          "apply_stateful"):
                outs, aux[key] = unit(functools.partial(
                    lay.apply_stateful, train=train, gen=gen, step=step),
                    lparams, aux[key], inputs)
            elif key in sliced:  # this rank's output channels, gathered
                outs = unit(functools.partial(
                    lay.apply, train=train, gen=gen, step=step),
                    lparams, [pdist.model_input(inputs[0], mgroup)])
                outs = [pdist.model_gather(o, o.dim() - 1, mgroup)
                        for o in outs]
            else:
                outs = unit(functools.partial(
                    lay.apply, train=train, gen=gen, step=step),
                    lparams, inputs)
            lparams = None  # zero = 3: nothing whole outlives its use
            for n, v in zip(spec.nindex_out, outs):
                nodes[n] = v
        return nodes, loss

    @staticmethod
    def _apply_quant_layer(lay: Layer, lparams: dict,
                           x: torch.Tensor) -> torch.Tensor:
        """One int8-quantized layer: the exporter quantizes plain conv and
        fullc layers only, so anything else is a plan fault."""
        if type(lay) is ConvolutionLayer:
            p = lay.param
            return opsq.conv_apply_q(lparams, x, p.stride, p.pad_y, p.pad_x,
                                     groups=p.num_group)
        if type(lay) is FullConnectLayer:
            return opsq.fc_apply_q(lparams, x)
        raise ValueError(
            f"quantized params on unsupported layer {type(lay).__name__}: "
            "the export plan covers conv and fullc only")

    def out_node_index(self) -> int:
        """The final node (prediction output)."""
        return self.graph.layers[-1].nindex_out[-1] if self.graph.layers else 0
