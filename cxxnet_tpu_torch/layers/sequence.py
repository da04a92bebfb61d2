"""Sequence layers: multi-head attention, layer norm, sequence pooling,
mixture of experts and the block stacks.

Counterpart of ``cxxnet_tpu/layers/sequence.py``.  Sequence nodes are
``(N, T, D)``.  ``attention`` config keys:

* ``nhead`` — number of heads (D % nhead == 0)
* ``causal`` — 1 for autoregressive masking
* ``attn_impl = auto|pallas|xla`` — parsed and validated.  On a card
  a full-sequence attention whose head dim the flash kernels are built
  for (``flash.HEAD_DIMS``: 16, 32, 64) runs them (K9 forward, K10
  backward, ``ops/flash.py``), whatever the value and whatever T: the
  kernels mask their own ragged edges, so the JAX package's rule of
  sending short or odd T to the dense ``mha`` has no reason here.  Any
  other head dim takes the dense ``mha`` under ``auto`` and ``xla``
  and raises under ``pallas``, as the JAX package does when its flash
  probe fails.  On the CPU ``pallas`` takes the flash kernels' plain
  versions and ``auto`` / ``xla`` the dense ``mha``, as the JAX package
  does off a TPU.  The windowed generation path attends through the
  same rule.
* ``seq_parallel = ring|alltoall`` (``1``/``2``; ``a2a``) — sequence
  parallelism over the model axis (``model_parallel > 1``), the JAX
  package's dispatch: ``alltoall`` swaps the T split for a head split
  around the local attention (``attention_fn``); ``ring`` under
  ``attn_impl = pallas`` runs ``ring_attention_flash`` (K9 and K10 once
  a hop, with offsets), otherwise the streaming-softmax
  ``ring_attention`` (``ops/attention.py``).  T must divide by the
  model axis, and for ``alltoall`` ``nhead`` too (the JAX messages).
  On one model rank the key changes nothing.
* ``decode = 1`` with ``decode_window = W`` — KV-cache incremental
  decoding for generation: ``init_aux`` gives f32 key and value caches
  of W positions, and ``apply_stateful`` writes this call's keys and
  values at ``step`` and attends against the cache under the causal
  rule, in plain torch (the JAX package computes it outside any kernel
  too).  The caches are updated IN PLACE and returned (the JAX package
  returns new arrays).

Parameters use the framework's ``(nout, nin)`` layout: a fused ``wmat``
``(3D, D)`` and ``bias`` for q, k and v, then ``wproj`` ``(D, D)`` and
``bproj``.  ``layer_norm`` computes its statistics in f32 and keeps its
parameters in f32 under a bf16 compute dtype.

``moe`` (``nexpert``, ``topk``, ``nhidden``) and the block stacks
``pipe_transformer`` and ``pipe_mlp`` (``nblock``, ``pipeline_parallel``,
``n_microbatch``; the transformer also ``nhead``, ``causal``,
``ffn_hidden``, ``eps``) keep the JAX package's params and tags; the
stacks run through ``ops/pipeline.py``, as GPipe stages over a model
axis of more than one rank under ``pipeline_parallel``.  Over a model
axis the MoE layer computes its own experts (expert parallelism) and a
pipelined stack its own stage, each on the slices the trainer holds
(``MeshPlan.model_dim``); the other layers here get their weights
gathered at use (``nnet/net.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..ops import attention as sp_attention
from ..ops.attention import NEG_INF, mha
from ..ops.flash import HEAD_DIMS, flash_mha
from ..ops.pipeline import _stage_apply, pipeline_apply
from ..parallel import distributed as pdist
from .base import Layer, Params, Shape, register


def _layer_norm(x, w, b, eps: float):
    """Layer-norm math: statistics in f32 under mixed precision."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


@register
class AttentionLayer(Layer):
    type_name = "attention"

    _SP_MODES = {"0": 0, "1": 1, "2": 2, "off": 0, "ring": 1,
                 "alltoall": 2, "a2a": 2}

    def __init__(self) -> None:
        super().__init__()
        self.nhead = 1
        self.causal = 0
        self.seq_parallel = 0
        self.attn_impl = "auto"
        self.decode = 0
        self.decode_window = 0
        self.mesh_plan = None  # bound by the trainer (bind_mesh)

    def set_param(self, name, val):
        if name == "nhead":
            self.nhead = int(val)
        elif name == "causal":
            self.causal = int(val)
        elif name == "attn_impl":
            if val not in ("auto", "pallas", "xla"):
                raise ValueError(
                    f"attn_impl must be auto|pallas|xla, got {val!r}")
            self.attn_impl = val
        elif name == "seq_parallel":
            if val not in self._SP_MODES:
                raise ValueError(
                    f"seq_parallel must be one of {sorted(self._SP_MODES)},"
                    f" got {val!r}")
            self.seq_parallel = self._SP_MODES[val]
        elif name == "decode":
            self.decode = int(val)
        elif name == "decode_window":
            self.decode_window = int(val)
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 3:
            raise ValueError(
                "attention: input must be a sequence node (N, T, D); set "
                "input_layout = seq")
        n, t, d = shape
        if self.nhead <= 0 or d % self.nhead != 0:
            raise ValueError(
                f"attention: nhead={self.nhead} must divide model dim {d}")
        if self.seq_parallel and self.mesh_plan is not None:
            nm = self.mesh_plan.n_model
            if nm > 1 and t % nm != 0:
                raise ValueError(
                    f"attention: seq_parallel needs T={t} divisible by the "
                    f"model axis ({nm})")
            if nm > 1 and self.seq_parallel == 2 and self.nhead % nm != 0:
                raise ValueError(
                    f"attention: seq_parallel=alltoall needs "
                    f"nhead={self.nhead} divisible by the model axis ({nm})")
        return [tuple(shape)]

    def bind_mesh(self, plan) -> None:
        self.mesh_plan = plan

    def init_params(self, gen, in_shapes) -> Params:
        d = in_shapes[0][2]
        sigma = self.param.init_sigma
        return {
            "wmat": sigma * torch.randn((3 * d, d), generator=gen),
            "bias": torch.zeros(3 * d),
            "wproj": sigma * torch.randn((d, d), generator=gen),
            "bproj": torch.zeros(d),
        }

    def _qkv(self, params, x):
        n, t, d = x.shape
        h = self.nhead
        qkv = F.linear(x, params["wmat"], params["bias"])
        qkv = qkv.reshape(n, t, 3, h, d // h)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def attention_fn(self, head_dim: int, on_card: bool):
        """The full-sequence attention for this head dim and device:
        ``flash_mha`` on a card for a head dim in ``HEAD_DIMS``, and on
        the CPU under ``attn_impl = pallas``; else the dense ``mha``.
        Raises under ``pallas`` on a card for another head dim."""
        if on_card:
            if head_dim in HEAD_DIMS:
                return flash_mha
            if self.attn_impl == "pallas":
                raise NotImplementedError(
                    f"attention: attn_impl=pallas asks for the flash "
                    f"kernels, which are built for head dims {HEAD_DIMS}, "
                    f"not {head_dim}; use attn_impl=auto or xla")
            return mha
        return flash_mha if self.attn_impl == "pallas" else mha

    def attend(self, q, k, v):
        """Full-sequence attention ``(q, k, v) -> o`` on ``(B, T, H, Dh)``
        through ``attention_fn``."""
        fn = self.attention_fn(q.shape[-1], q.is_cuda)
        return fn(q, k, v, bool(self.causal))

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        n, t, d = x.shape
        q, k, v = self._qkv(params, x)
        plan = self.mesh_plan
        if self.seq_parallel and plan is not None and plan.n_model > 1:
            o = self._seq_parallel(q, k, v)
        else:
            o = self.attend(q, k, v)
        o = o.reshape(n, t, d)
        return [F.linear(o, params["wproj"], params["bproj"])]

    def _seq_parallel(self, q, k, v):
        """The JAX package's dispatch over the model sub-group: the
        all-to-all form around ``attention_fn``, the flash ring under
        ``attn_impl = pallas`` (on a card only for the flash kernels'
        head dims, as the local path), else the dense ring."""
        group, causal = self.mesh_plan.model_group, bool(self.causal)
        if self.seq_parallel == 2:
            return sp_attention.a2a_self_attention(
                q, k, v, group, causal,
                attn_fn=self.attention_fn(q.shape[-1], q.is_cuda))
        if self.attn_impl == "pallas":
            self.attention_fn(q.shape[-1], q.is_cuda)  # the head-dim check
            return sp_attention.ring_self_attention_flash(q, k, v, group,
                                                          causal)
        return sp_attention.ring_self_attention(q, k, v, group, causal)

    def init_aux(self, in_shapes, device=None):
        """KV cache state for ``decode = 1``."""
        if not self.decode:
            return {}
        if self.seq_parallel:
            raise ValueError(
                "attention: decode=1 (single-token KV caching) does not "
                "compose with seq_parallel")
        if not self.causal:
            raise ValueError(
                "attention: decode=1 requires causal=1 — incremental "
                "decoding cannot reproduce bidirectional attention")
        if self.decode_window <= 0:
            raise ValueError(
                "attention: decode=1 needs decode_window (max positions "
                "the cache holds — the training T)")
        n, _, d = in_shapes[0]
        h = self.nhead
        shape = (n, self.decode_window, h, d // h)
        return {"kcache": torch.zeros(shape, device=device),
                "vcache": torch.zeros(shape, device=device)}

    def apply_stateful(self, params, aux, inputs, train=False, gen=None,
                       step=None):
        """Write this call's k/v into the caches at ``step..step+t-1``
        and attend q against everything up to its own position."""
        x = inputs[0]
        n, t, d = x.shape
        dh = d // self.nhead
        q, k, v = self._qkv(params, x)
        kc, vc = aux["kcache"], aux["vcache"]
        w = kc.shape[1]
        start = min(max(int(step or 0), 0), w - t)
        kc[:, start:start + t] = k.float()
        vc[:, start:start + t] = v.float()
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc) * (1.0 / dh ** 0.5)
        q_pos = start + torch.arange(t, device=x.device)[:, None]
        k_pos = torch.arange(w, device=x.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vc).to(x.dtype)
        out = F.linear(o.reshape(n, t, d), params["wproj"], params["bproj"])
        return [out], aux


@register
class LayerNormLayer(Layer):
    type_name = "layer_norm"

    def __init__(self) -> None:
        super().__init__()
        self.eps = 1e-6

    def set_param(self, name, val):
        if name == "eps":
            self.eps = float(val)
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        return [tuple(in_shapes[0])]

    def init_params(self, gen, in_shapes) -> Params:
        d = in_shapes[0][-1]
        return {"wmat": torch.ones(d), "bias": torch.zeros(d)}

    def prepare(self, params, dtype):
        """Norm parameters stay f32 under any compute dtype."""
        return dict(params)

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [_layer_norm(inputs[0], params["wmat"], params["bias"],
                            self.eps)]


@register
class SeqPoolLayer(Layer):
    """Mean-pool the time axis: (N, T, D) -> (N, D) classification head."""

    type_name = "seq_pool"

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 3:
            raise ValueError("seq_pool: input must be a sequence node")
        return [(shape[0], shape[2])]

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [inputs[0].mean(dim=1)]


def topk_mask(gate: torch.Tensor, k: int) -> torch.Tensor:
    """A 0/1 mask of exactly ``k`` entries per row of ``gate``: its ``k``
    largest, the lower index first among ties (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none among ties, and its CUDA order
    differs from its CPU one)."""
    idx = torch.sort(gate, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.zeros_like(gate).scatter(-1, idx, 1.0)


@register
class MoELayer(Layer):
    """Mixture-of-experts projection: ``nexpert`` expert projections
    ``(nhidden, D)`` in one ``(E, nhidden, D)`` tensor, routed by a
    softmax gate, optionally masked to exactly ``topk`` experts and
    renormalised (``topk = 0`` keeps the dense soft mixture).  Every
    expert's product runs (dense dispatch), in the compute dtype; the
    gate is computed in f32 and cast to it.  Works on flat ``(N, D)``
    and sequence ``(N, T, D)`` nodes.

    Expert parallelism, as the JAX package's docstring describes it:
    over a model axis that divides ``nexpert`` the trainer holds a
    rank's ``E / m`` experts of ``wmat``, ``bias`` and ``wgate``; the
    gate's ``(E, D)`` rows are gathered before the logits, so every
    rank computes the whole gate, the one-rank product, and routing is
    whole on every rank, ties falling as in JAX; the rank computes its
    experts' gated share, and the shares are summed over the model
    sub-group.  The gather moves the gate's ``E * D`` values, not one
    logit per token and expert."""

    type_name = "moe"

    def __init__(self) -> None:
        super().__init__()
        self.nexpert = 4
        self.topk = 0
        self.mesh_plan = None  # bound by the trainer (bind_mesh)

    def bind_mesh(self, plan) -> None:
        self.mesh_plan = plan

    def takes_model_slices(self) -> bool:
        """The layer computes on its own experts' slices."""
        return True

    def set_param(self, name, val):
        if name == "nexpert":
            self.nexpert = int(val)
        elif name == "topk":
            self.topk = int(val)
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) not in (2, 3):
            raise ValueError("moe: input must be a matrix or sequence node")
        if self.param.num_hidden <= 0:
            raise ValueError("moe: must set nhidden correctly")
        if self.nexpert < 1 or not (0 <= self.topk <= self.nexpert):
            raise ValueError("moe: need nexpert >= 1 and 0 <= topk <= nexpert")
        return [tuple(shape[:-1]) + (self.param.num_hidden,)]

    def init_params(self, gen, in_shapes) -> Params:
        d = in_shapes[0][-1]
        nh = self.param.num_hidden
        e = self.nexpert
        sigma = self.param.init_sigma
        return {
            "wgate": sigma * torch.randn((e, d), generator=gen),
            "wmat": sigma * torch.randn((e, nh, d), generator=gen),
            "bias": torch.zeros((e, nh)),
        }

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        e_mine = params["wmat"].shape[0]
        group, wgate = None, params["wgate"]
        if e_mine != self.nexpert:  # this rank's experts of the model axis
            group = self.mesh_plan.model_group
            x = pdist.model_input(x, group)
            # each rank then uses its own experts' gates: the gate's
            # gradient is summed over the ranks before each keeps its rows
            wgate = pdist.model_input(pdist.model_gather(wgate, 0, group),
                                      group)
        logits = torch.einsum("...d,ed->...e", x, wgate).float()
        gate = torch.softmax(logits, dim=-1)
        if self.topk:
            gate = gate * topk_mask(gate, self.topk)
            gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True),
                                          1e-30)
        gate = gate.to(x.dtype)
        if group is not None:
            first = self.mesh_plan.model_index * e_mine
            gate = gate.narrow(-1, first, e_mine)
        h = torch.einsum("...d,eod->...eo", x, params["wmat"]) + params["bias"]
        y = torch.einsum("...e,...eo->...o", gate, h)
        return [y if group is None else pdist.model_sum(y, group)]


class _PipelineStackLayer(Layer):
    """Homogeneous block-stack layers: the ``nblock``,
    ``pipeline_parallel`` and ``n_microbatch`` keys, the JAX package's
    stage and microbatch checks, and its dispatch (``_apply_stack``):
    with ``pipeline_parallel`` on a model axis of more than one rank
    the stack runs as GPipe stages over it (``ops/pipeline.py``), each
    rank on its stage of the stacked params; otherwise it runs in
    order, the same math.  Subclasses define ``_block(p, x)`` and their
    params stack."""

    def __init__(self) -> None:
        super().__init__()
        self.nblock = 2
        self.pipeline_parallel = 0
        self.n_microbatch = 4
        self.mesh_plan = None  # bound by the trainer (bind_mesh)

    def set_param(self, name, val):
        if name == "nblock":
            self.nblock = int(val)
        elif name == "pipeline_parallel":
            self.pipeline_parallel = int(val)
        elif name == "n_microbatch":
            self.n_microbatch = int(val)
        else:
            super().set_param(name, val)

    def bind_mesh(self, plan) -> None:
        self.mesh_plan = plan

    def _pipelined(self) -> bool:
        plan = self.mesh_plan
        return bool(self.pipeline_parallel and plan is not None
                    and plan.n_model > 1)

    def takes_model_slices(self) -> bool:
        """Pipelined, the layer runs on its own stage of the stack; else
        the trainer's slices are gathered at use."""
        return self._pipelined()

    def _check_pipeline_shape(self, batch: int) -> None:
        if self.pipeline_parallel and self.mesh_plan is not None:
            nm = self.mesh_plan.n_model
            if nm > 1 and self.nblock % nm != 0:
                raise ValueError(
                    f"{self.type_name}: nblock={self.nblock} must divide "
                    f"over the model axis ({nm} stages)")
            if nm > 1 and batch % self.n_microbatch != 0:
                raise ValueError(
                    f"{self.type_name}: batch {batch} must divide into "
                    f"{self.n_microbatch} microbatches")

    def _apply_stack(self, stack, x):
        """The stack pipelined over the model axis (when configured on
        one of more than one rank) or run in order: the same math."""
        if self._pipelined():
            return pipeline_apply(self._block, stack, x, self.mesh_plan,
                                  n_microbatch=self.n_microbatch,
                                  n_block=self.nblock)
        return _stage_apply(self._block, stack, x)

    def apply(self, params, inputs, train=False, gen=None, step=None):
        return [self._apply_stack(params, inputs[0])]


@register
class PipeTransformerLayer(_PipelineStackLayer):
    """A stack of ``nblock`` identical pre-LN transformer blocks, their
    params in stacked ``(L, ...)`` tensors: layer_norm -> multi-head
    attention (the dense ``mha``, as in the JAX package) -> residual ->
    layer_norm -> gelu-MLP -> residual, ``transformer_conf``'s block.
    The four LN tags stay f32 under a bf16 compute dtype."""

    type_name = "pipe_transformer"
    f32_tags = frozenset({"ln1_w", "ln1_b", "ln2_w", "ln2_b"})

    def __init__(self) -> None:
        super().__init__()
        self.nhead = 1
        self.causal = 0
        self.ffn_hidden = 0  # default 4*D
        self.eps = 1e-6

    def set_param(self, name, val):
        if name == "nhead":
            self.nhead = int(val)
        elif name == "causal":
            self.causal = int(val)
        elif name == "ffn_hidden":
            self.ffn_hidden = int(val)
        elif name == "eps":
            self.eps = float(val)
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 3:
            raise ValueError(
                "pipe_transformer: input must be a sequence node (N, T, D)")
        d = shape[2]
        if self.nhead <= 0 or d % self.nhead != 0:
            raise ValueError(
                f"pipe_transformer: nhead={self.nhead} must divide dim {d}")
        self._check_pipeline_shape(shape[0])
        return [tuple(shape)]

    def init_params(self, gen, in_shapes) -> Params:
        d = in_shapes[0][2]
        h = self.ffn_hidden or 4 * d
        n = self.nblock
        sigma = self.param.init_sigma
        return {
            "ln1_w": torch.ones((n, d)),
            "ln1_b": torch.zeros((n, d)),
            "ln2_w": torch.ones((n, d)),
            "ln2_b": torch.zeros((n, d)),
            "wqkv": sigma * torch.randn((n, 3 * d, d), generator=gen),
            "bqkv": torch.zeros((n, 3 * d)),
            "wproj": sigma * torch.randn((n, d, d), generator=gen),
            "bproj": torch.zeros((n, d)),
            "wff1": sigma * torch.randn((n, h, d), generator=gen),
            "bff1": torch.zeros((n, h)),
            "wff2": sigma * torch.randn((n, d, h), generator=gen),
            "bff2": torch.zeros((n, d)),
        }

    def prepare(self, params, dtype):
        return {t: v if t in self.f32_tags else v.to(dtype)
                for t, v in params.items()}

    def _block(self, p, x):
        n, t, d = x.shape
        nh = self.nhead
        h = _layer_norm(x, p["ln1_w"], p["ln1_b"], self.eps)
        qkv = F.linear(h, p["wqkv"], p["bqkv"]).reshape(n, t, 3, nh, d // nh)
        o = mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                causal=bool(self.causal))
        x = x + F.linear(o.reshape(n, t, d), p["wproj"], p["bproj"])
        h2 = _layer_norm(x, p["ln2_w"], p["ln2_b"], self.eps)
        f = F.linear(F.gelu(F.linear(h2, p["wff1"], p["bff1"]),
                            approximate="tanh"), p["wff2"], p["bff2"])
        return x + f


@register
class PipeMLPLayer(_PipelineStackLayer):
    """A stack of ``nblock`` identical relu-MLP blocks ``y = relu(x W_i +
    b_i)`` (width = input dim), their params one ``(L, D, D)`` stack."""

    type_name = "pipe_mlp"

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        (shape,) = in_shapes
        if len(shape) != 2:
            raise ValueError("pipe_mlp: input must be a matrix node")
        self._check_pipeline_shape(shape[0])
        return [tuple(shape)]

    def init_params(self, gen, in_shapes) -> Params:
        d = in_shapes[0][1]
        return {
            "wmat": self.param.init_sigma * torch.randn(
                (self.nblock, d, d), generator=gen),
            "bias": torch.zeros((self.nblock, d)),
        }

    @staticmethod
    def _block(p, x):
        return torch.relu(x @ p["wmat"] + p["bias"])
