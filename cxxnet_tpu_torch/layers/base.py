"""Layer protocol, shared hyper-parameters, weight init, and the registry.

Counterpart of ``cxxnet_tpu/layers/base.py``.  A layer is three
functions: ``infer_shape`` (shape inference and validation),
``init_params`` (a ``torch.Generator`` draws the initial weights) and
``apply`` (the forward over a list of tensors; ``train`` and the step's
``torch.Generator`` matter only to stochastic layers).  Activations are
NHWC and conv weights HWIO, as in the JAX package, so parameters and
checkpoints interchange; ``prepare`` turns a layer's master parameters
into the form ``apply`` consumes (compute dtype, cuDNN layout): once per
load for predict, and per step under autograd for training, so the
gradients reach the f32 masters through it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Shape = Tuple[int, ...]
Params = Dict[str, torch.Tensor]


class LayerParam:
    """Shared layer hyper-parameters + weight initialization (names,
    defaults, and the gaussian / xavier-uniform / kaiming rules of the
    reference's ``layer/param.h``)."""

    def __init__(self) -> None:
        self.init_sigma = 0.01
        self.init_uniform = -1.0
        self.init_bias = 0.0
        self.random_type = 0  # 0 gaussian, 1 uniform/xavier, 2 kaiming
        self.num_hidden = 0
        self.num_channel = 0
        self.num_group = 1
        self.kernel_width = 0
        self.kernel_height = 0
        self.stride = 1
        self.pad_x = 0
        self.pad_y = 0
        self.no_bias = 0
        self.num_input_channel = 0
        self.num_input_node = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "init_sigma":
            self.init_sigma = float(val)
        elif name == "init_uniform":
            self.init_uniform = float(val)
        elif name == "init_bias":
            self.init_bias = float(val)
        elif name == "random_type":
            table = {"gaussian": 0, "uniform": 1, "xavier": 1, "kaiming": 2}
            if val not in table:
                raise ValueError(f"invalid random_type {val!r}")
            self.random_type = table[val]
        elif name == "nhidden":
            self.num_hidden = int(val)
        elif name == "nchannel":
            self.num_channel = int(val)
        elif name == "ngroup":
            self.num_group = int(val)
        elif name == "kernel_size":
            self.kernel_width = self.kernel_height = int(val)
        elif name == "kernel_height":
            self.kernel_height = int(val)
        elif name == "kernel_width":
            self.kernel_width = int(val)
        elif name == "stride":
            self.stride = int(val)
        elif name == "pad":
            self.pad_y = self.pad_x = int(val)
        elif name == "pad_y":
            self.pad_y = int(val)
        elif name == "pad_x":
            self.pad_x = int(val)
        elif name == "no_bias":
            self.no_bias = int(val)

    def rand_init_weight(self, gen: torch.Generator, shape: Shape,
                         in_num: int, out_num: int) -> torch.Tensor:
        """Draw an initial f32 weight tensor on the CPU from ``gen``."""
        if self.random_type == 0:
            return self.init_sigma * torch.randn(shape, generator=gen)
        if self.random_type == 1:
            a = math.sqrt(3.0 / (in_num + out_num))
            if self.init_uniform > 0:
                a = self.init_uniform
            return torch.empty(shape).uniform_(-a, a, generator=gen)
        if self.random_type == 2:
            if self.num_hidden > 0:
                sigma = math.sqrt(2.0 / self.num_hidden)
            else:
                sigma = math.sqrt(
                    2.0 / (self.num_channel * self.kernel_width
                           * self.kernel_height))
            return sigma * torch.randn(shape, generator=gen)
        raise ValueError(f"unsupported random_type {self.random_type}")


class Layer:
    """Base class of all layer types."""

    type_name: str = ""

    def __init__(self) -> None:
        self.param = LayerParam()

    def set_param(self, name: str, val: str) -> None:
        self.param.set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        raise NotImplementedError

    def init_params(self, gen: torch.Generator,
                    in_shapes: Sequence[Shape]) -> Params:
        return {}

    def prepare(self, params: Params, dtype: torch.dtype) -> Params:
        """Master params -> what ``apply`` consumes: cast to the compute
        dtype (differentiable)."""
        return {t: v.to(dtype) for t, v in params.items()}

    def apply(self, params: Params, inputs: Sequence[torch.Tensor],
              train: bool = False,
              gen: Optional[torch.Generator] = None,
              step: Optional[int] = None) -> List[torch.Tensor]:
        """``step``: the decode loop's absolute position, which only
        position-aware layers read."""
        raise NotImplementedError

    def _check_arity(self, in_shapes: Sequence[Shape], n_in: int) -> None:
        if len(in_shapes) != n_in:
            raise ValueError(
                f"{self.type_name}: expected {n_in} input(s), got {len(in_shapes)}"
            )


class LossLayer(Layer):
    """Base of the self-loop loss layers.

    A loss layer transforms its node in place (e.g. softmax
    probabilities) and, in training, adds ``grad_scale / (batch_size *
    update_period) * loss`` to the step's objective, where ``loss`` is
    a summed (not averaged) function whose gradient is the one the
    reference injects (``cxxnet_tpu/layers/base.py:177-243``).  Each
    subclass defines the per-row loss; ``target`` names the label field
    it reads."""

    def __init__(self) -> None:
        super().__init__()
        self.target = "label"
        self.grad_scale = 1.0

    def set_param(self, name: str, val: str) -> None:
        if name == "target":
            self.target = val
        elif name == "grad_scale":
            self.grad_scale = float(val)
        else:
            super().set_param(name, val)

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        return [tuple(in_shapes[0])]

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Forward transform (prediction output), e.g. softmax probs."""
        return x

    def row_loss(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The loss of each row of ``x`` (f32 logits) against its label
        columns, shape ``(N,)``."""
        raise NotImplementedError

    def loss(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Summed (not averaged) loss; the net scales it by
        ``grad_scale / (batch_size * update_period)``."""
        return self.row_loss(x, labels).sum()

    def loss_masked(self, x: torch.Tensor, labels: torch.Tensor,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``loss`` with an optional per-row weight ``(N,)``: the 0/1 mask
        of a short final batch padded to the batch size, whose padded
        rows then contribute exactly zero gradient."""
        if weight is None:
            return self.loss(x, labels)
        per_row = self.row_loss(x, labels)
        return (per_row * weight.to(per_row.dtype)).sum()


# ----------------------------------------------------------------------
# registry
_REGISTRY: Dict[str, Callable[[], Layer]] = {}


def register(cls):
    """Class decorator: register a Layer under its ``type_name``."""
    if not cls.type_name:
        raise ValueError(f"{cls} missing type_name")
    _REGISTRY[cls.type_name] = cls
    return cls


def create_layer(type_name: str) -> Layer:
    """Factory by config name; ``pairtest-<master>-<slave>`` composes two
    layer types (``layers/pairtest.py``), ``torch`` is the plugin layer
    (``plugin/torch_adapter.py``, loaded on demand); ``shared[...]`` is
    resolved by the net."""
    if type_name.startswith("pairtest-"):
        from .pairtest import PairTestLayer

        rest = type_name[len("pairtest-"):]
        if "-" not in rest:
            raise ValueError(
                f'unknown layer type: "{type_name}" (pairtest needs '
                "pairtest-<master>-<slave>)")
        master_name, slave_name = rest.split("-", 1)
        return PairTestLayer(create_layer(master_name),
                             create_layer(slave_name))
    if type_name == "torch" and type_name not in _REGISTRY:
        from ..plugin import torch_adapter  # noqa: F401 - registers "torch"
    if type_name not in _REGISTRY:
        raise ValueError(f'unknown layer type: "{type_name}"')
    return _REGISTRY[type_name]()
