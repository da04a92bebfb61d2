"""Foreign-module layers: ``torch:`` hosts a ``torch.nn.Module`` in the net.

Counterpart of ``cxxnet_tpu/plugin/``.  The JAX package runs the module
on the host through ``jax.pure_callback``; here it is native PyTorch and
runs on the net's device (:mod:`torch_adapter`).
"""

from .torch_adapter import TorchAdapterLayer  # noqa: F401
