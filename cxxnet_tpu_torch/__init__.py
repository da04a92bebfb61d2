"""cxxnet-tpu on PyTorch and CUDA: the port of ``cxxnet_tpu`` to one
NVIDIA H100.

It reads the same ``.conf`` grammar and the same checkpoint container as
the JAX package, keeps its NHWC activations and HWIO conv weights, and
runs the JAX package's Pallas kernels as hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use and loaded with ``ctypes``)
beside plain PyTorch versions of the same functions for the CPU.

It serves CNNs (``task=serve``, :class:`serve.Engine`), trains them
(``task=train``, :meth:`nnet.trainer.NetTrainer.update`, ``updater =
sgd``), trains the byte-level transformer language model (``iter =
text``, ``updater = adam``, flash attention) and samples from it
(``task=generate``, :mod:`nnet.generate`); the other tasks are later
slices (ROADMAP.md).  Its library API is :mod:`wrapper` (``DataIter``,
``Net``, ``train``), its C ABI the ``CXN*`` functions of
``csrc/host/cxxnet_capi.h`` over :mod:`capi_shim`, and its
observability plane :mod:`obs` (``/metricsz``, ``/alertz``, the event
log, spans).  The package imports neither ``jax`` nor ``cxxnet_tpu``.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
