"""Operators with hand-written CUDA kernels beside plain PyTorch
versions: ``maxpool`` (forward and two backwards), ``lrn`` (forward and
backward), ``kernels.conv_block`` and ``kernels.update_step``.

``KERNELS`` lists every kernel of the port, for builds and launch
counts (``chip_smoke.py``): the serving path's K1, K4 and K6 first, then
the training path's K2, K3, K5 and K8.
"""

from . import lrn, maxpool
from .kernels import conv_block, update_step

KERNELS = (maxpool.KERNEL, lrn.KERNEL, conv_block.KERNEL,
           maxpool.BWD_KERNEL, maxpool.BWD_S1_KERNEL, lrn.BWD_KERNEL,
           update_step.KERNEL)
