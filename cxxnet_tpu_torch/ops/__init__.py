"""Operators with hand-written CUDA kernels beside plain PyTorch
versions: ``maxpool`` (forward and two backwards), ``lrn`` (forward and
backward), ``kernels.conv_block``, ``kernels.update_step``, ``flash``
(attention forward and backward) and ``kernels.int8_gemm``;
``attention.mha`` is the dense golden function, ``quant`` the int8
weight scheme, ``pipeline`` the block stacks' runner.

``KERNELS`` lists every kernel of the port, for builds and launch
counts (``chip_smoke.py``): GoogLeNet serving's K1, K4 and K6, then its
training's K2, K3, K5 and K8, then the language model's K9 and K10,
then quantized serving's K7.
"""

from . import flash, lrn, maxpool
from .kernels import conv_block, int8_gemm, update_step

KERNELS = (maxpool.KERNEL, lrn.KERNEL, conv_block.KERNEL,
           maxpool.BWD_KERNEL, maxpool.BWD_S1_KERNEL, lrn.BWD_KERNEL,
           update_step.KERNEL, flash.FWD_KERNEL, flash.BWD_KERNEL,
           int8_gemm.KERNEL)
