"""A graph layer hosting a ``torch.nn.Module`` (``torch:`` layers).

Counterpart of ``cxxnet_tpu/plugin/torch_adapter.py``.  Config:

    layer[a->b] = torch:name
      torch_op = torch.nn.Conv2d(3, 8, 3, padding=1)

``torch_op`` is parsed as a whitelisted ``torch.nn.*`` constructor call
(AST-validated, literal arguments only, never ``eval``-uated): configs
are untrusted input.  The module's parameters are the layer's params,
tags ``blob0``, ``blob1``, ... in ``module.parameters()`` order, f32
masters that the updaters and checkpoints own like any other weights;
they are cast to the compute dtype as every layer's params are, and the
module runs in f32 on the net's device through
``torch.func.functional_call`` over those tensors, so autograd reaches
the masters directly.  NHWC nodes are NCHW inside the module.

The module's buffers (a BatchNorm's running statistics) stay in the
module on the net's device and are not checkpointed, as in the JAX
package.  The JAX package runs the module twice per training step (the
callback's forward, then its backward's re-run, each after
``torch.manual_seed(0)``), so a module's running statistics move twice
a step and its dropout draws one mask forever; here the module runs
once a step, on PyTorch's own random stream.
"""

from __future__ import annotations

import ast
import itertools
from typing import List, Sequence

import torch

from ..layers.base import Layer, Params, Shape, register


def _build_torch_expr(expr: str):
    """Construct the module described by ``torch_op`` WITHOUT ``eval``.

    Configs are untrusted input (they get downloaded and shared), so the
    expression grammar is a strict whitelist validated on the AST:

    * calls whose callee is a dotted path rooted at ``torch.nn`` (nested
      calls allowed, e.g. ``torch.nn.Sequential(torch.nn.ReLU())``),
    * literal arguments: numbers, strings, booleans, ``None``, tuples/
      lists of literals, unary minus.

    Anything else — attribute chains escaping ``torch.nn``, subscripts,
    lambdas, comprehensions, dunder tricks — raises ``ValueError``.
    """
    import torch

    def build(node: ast.expr):
        if isinstance(node, ast.Call):
            path = _dotted_path(node.func)
            if not path or path[:2] != ["torch", "nn"] or len(path) < 3:
                raise ValueError(
                    "torch_op: only torch.nn.* constructors are allowed, "
                    f"got {'.'.join(path) if path else ast.dump(node.func)}"
                )
            obj = torch.nn
            for name in path[2:]:
                if name.startswith("_"):
                    raise ValueError(f"torch_op: private attribute {name!r}")
                obj = getattr(obj, name)
            args = [literal(a) for a in node.args]
            kwargs = {}
            for kw in node.keywords:
                if kw.arg is None:
                    raise ValueError("torch_op: **kwargs not allowed")
                kwargs[kw.arg] = literal(kw.value)
            return obj(*args, **kwargs)
        raise ValueError(
            f"torch_op: expected a torch.nn.* call, got {ast.dump(node)}"
        )

    def literal(node: ast.expr):
        if isinstance(node, ast.Call):
            return build(node)  # nested module, e.g. inside Sequential
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = literal(node.operand)
            if isinstance(v, (int, float)):
                return -v
        if isinstance(node, (ast.Tuple, ast.List)):
            vals = [literal(e) for e in node.elts]
            return tuple(vals) if isinstance(node, ast.Tuple) else vals
        raise ValueError(
            f"torch_op: argument must be a literal, got {ast.dump(node)}"
        )

    def _dotted_path(node: ast.expr):
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return parts[::-1]
        return None

    tree = ast.parse(expr, mode="eval")
    return build(tree.body)


def _to_torch_layout(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x  # NHWC -> NCHW


def _from_torch_layout(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x  # NCHW -> NHWC


@register
class TorchAdapterLayer(Layer):
    type_name = "torch"

    def __init__(self) -> None:
        super().__init__()
        self.torch_op = ""
        self._module = None
        self._names: List[str] = []

    def set_param(self, name: str, val: str) -> None:
        if name == "torch_op":
            self.torch_op = val
        else:
            super().set_param(name, val)

    def _build(self) -> torch.nn.Module:
        if self._module is None:
            if not self.torch_op:
                raise ValueError("torch layer: must set torch_op")
            self._module = _build_torch_expr(self.torch_op).float()
            self._names = [n for n, _ in self._module.named_parameters()]
        return self._module

    def infer_shape(self, in_shapes: Sequence[Shape]) -> List[Shape]:
        self._check_arity(in_shapes, 1)
        mod = self._build()
        held = next(itertools.chain(mod.buffers(), mod.parameters()), None)
        dev = held.device if held is not None else torch.device("cpu")
        was = mod.training
        mod.eval()  # no running statistic moves
        with torch.no_grad():
            y = mod(_to_torch_layout(torch.zeros(in_shapes[0], device=dev)))
        mod.train(was)
        return [tuple(_from_torch_layout(y).shape)]

    def init_params(self, gen, in_shapes) -> Params:
        """A fresh module's parameters, its init drawn under a seed taken
        from ``gen`` (PyTorch's global stream is left as it was)."""
        self._build()
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = _build_torch_expr(self.torch_op).float()
        return {f"blob{i}": p.detach().clone()
                for i, p in enumerate(fresh.parameters())}

    def apply(self, params, inputs, train=False, gen=None, step=None):
        x = inputs[0]
        mod = self._build()
        held = next(mod.buffers(), None)
        if held is not None and held.device != x.device:
            mod.to(x.device)  # the buffers live on the net's device
        mod.train(train)
        blobs = {name: params[f"blob{i}"].float()
                 for i, name in enumerate(self._names)}
        y = torch.func.functional_call(mod, blobs,
                                       (_to_torch_layout(x.float()),))
        return [_from_torch_layout(y).to(x.dtype)]
