"""The port's kernel modules against the JAX package, on the CPU.

Each kernel of ``cxxnet_tpu_torch.ops`` (max pool forward and its two
backwards, LRN forward and backward, the fused 1x1 conv block, the SGD
step) has a plain PyTorch version that the wrapper runs for a CPU
tensor.  Inputs are made with numpy from a seed (integer values and
relu zeros where ties matter) and fed to the JAX function and to the
port's counterpart:

* max pool: bit-equal to ``layers/conv._maxpool_eq`` and to the Pallas
  kernel in interpret mode (a max selects one of its inputs);
* LRN: ``ops/lrn.lrn_xla`` and the Pallas kernel (interpret), f32, to
  rtol 1e-5 / atol 1e-6 (sums of squares taken in another order);
* conv block: the stock branch of ``FunctionalNet._apply_fused_1x1`` and
  the Pallas kernel (interpret), to rtol 1e-5 / atol 1e-4 (GEMM
  accumulation order differs between oneDNN and XLA); its autograd
  Function's gradients against ``jax.grad`` of the stock branch to
  rtol = atol = 1e-5;
* max-pool backward (K2): bit-equal to ``jax.vjp`` of ``_maxpool_eq``
  and of the Pallas kernel (interpret): both sum in (dy, dx) order;
* stride-1 backward (K3): bit-equal to ``maxpool_bwd_s1`` (interpret);
  to rtol = atol = 1e-6 against ``_maxpool_eq``'s vjp, which adds in
  the other order;
* LRN backward (K5): rtol 1e-5 / atol 1e-6 against the vjp of the Pallas
  kernel (interpret), 1e-4 / 1e-6 against the vjp of ``lrn_xla``;
* SGD step (K8): bit-equal to ``SGDUpdater.apply`` run op by op; against
  the Pallas kernel (interpret), whose XLA CPU lowering contracts
  ``mom * m - lr * (...)`` into one FMA, within one rounding of each
  product plus one of the result; the multi-tensor entry over tensors
  of 1, 7, 257 and 100003 values with their own lr, wd and clip (NaNs
  where the clip guards them) bit-equal to the one-tensor plain version
  and to ``SGDUpdater.apply``, its split at the launch's capacity;
* the conv block's choice of its bf16 kernel: the wgmma main path for K
  and O multiples of 8 and 16-byte aligned operands (every GoogLeNet
  group), the mma.sync edge path for the rest;
* the lr and momentum schedules to rtol 2e-7 over epochs 0..2000;
* dropout: kept fraction, scale, determinism and the eval identity;
* flash attention (K9, K10): the plain forward and the autograd
  Function's backward against the Pallas kernels in interpret mode at
  (2, 64, 2, 16): causal and not, uneven and single blocks, cross
  lengths, offsets with fully masked rows through ``flash_mha_lse``;
  f32 outputs and LSE within 1e-5, gradients against ``jax.vjp`` within
  2e-4 (with an LSE cotangent in the offset cases), bf16 within 0.05 of
  f32; the dense ``mha`` against the JAX package's within 1e-5; the
  plain backward's rounding of p and dS to the input dtype: bit-equal to
  the unrounded formulas in f32, in bf16 within 2e-2 of each row's
  largest against ``jax.vjp`` of the Pallas kernels (interpret) and
  within 1.5e-2 of the tensor's largest against the f32 backward.

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds each against its plain version there.
"""

import importlib
import math
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cxxnet_tpu.layers import conv as jconv
from cxxnet_tpu.ops import attention as jattn
from cxxnet_tpu.nnet.net import FunctionalNet as JaxNet
from cxxnet_tpu.ops.kernels import conv_block as jcb
from cxxnet_tpu.ops.kernels import update_step as jup
from cxxnet_tpu.updater import SGDUpdater as JaxSGD
from cxxnet_tpu.updater.param import UpdaterParam as JaxUpdaterParam

# cxxnet_tpu.ops re-exports functions under the modules' names
jlrn = importlib.import_module("cxxnet_tpu.ops.lrn")
jmp = importlib.import_module("cxxnet_tpu.ops.maxpool")
jflash = importlib.import_module("cxxnet_tpu.ops.flash")

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.layers.elemwise import DropoutLayer
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import KERNELS, attention, flash, lrn, maxpool
from cxxnet_tpu_torch.ops import _build
from cxxnet_tpu_torch.ops.kernels import conv_block, update_step
from cxxnet_tpu_torch.updater import create_updater
from cxxnet_tpu_torch.updater.param import UpdaterParam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (h, w, k, s, p): stride 1 and 2, pad 0 and 1, and sizes whose ceil
# geometry leaves a partial edge window (e.g. 8 at k3 s2 p0: windows
# start at 0, 2, 4, 6 and the last one reads only columns 6-7)
POOL_CASES = [
    (8, 8, 3, 2, 0),
    (9, 7, 3, 2, 0),
    (6, 6, 3, 1, 1),
    (7, 5, 3, 1, 1),
    (10, 10, 2, 2, 0),
    (11, 11, 3, 2, 1),
    (5, 5, 3, 1, 0),
    (14, 14, 7, 1, 0),
]


@pytest.mark.parametrize("h,w,k,s,p", POOL_CASES)
def test_maxpool_plain_bit_equal_to_jax(h, w, k, s, p):
    x = np.random.RandomState(h * 100 + w * 10 + k + s + p).randn(
        2, h, w, 5).astype(np.float32)
    ref_eq = np.asarray(jconv._maxpool_eq(jnp.asarray(x), k, k, s, p, p))
    ref_pl = np.asarray(jmp.maxpool_fused(jnp.asarray(x), k, k, s, p, p,
                                          interpret=True))
    got = maxpool.maxpool_fwd(torch.from_numpy(x), k, k, s, p, p).numpy()
    assert got.shape == ref_eq.shape == ref_pl.shape
    np.testing.assert_array_equal(got, ref_eq)
    np.testing.assert_array_equal(got, ref_pl)


@pytest.mark.parametrize("h,w,k,s,p", POOL_CASES)
def test_pool_geometry_matches_jax(h, w, k, s, p):
    assert maxpool.geometry(h, w, k, k, s, p, p) == jconv._pool_geometry(
        h, w, k, k, s, p, p)
    assert maxpool.geometry(h, w, k, k, s, p, p) == jmp._geometry(
        h, w, k, k, s, p, p)


@pytest.mark.parametrize("nsize", [3, 5, 4])
def test_lrn_plain_matches_jax(nsize):
    x = np.random.RandomState(nsize).randn(3, 4, 5, 24).astype(np.float32)
    kw = dict(nsize=nsize, alpha=0.01, beta=0.75, knorm=1.5)
    ref_xla = np.asarray(jlrn.lrn_xla(jnp.asarray(x), **kw))
    ref_pl = np.asarray(jlrn.lrn(jnp.asarray(x), interpret=True, **kw))
    got = lrn.lrn_fwd(torch.from_numpy(x), nsize, 0.01, 0.75, 1.5).numpy()
    np.testing.assert_allclose(got, ref_xla, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref_pl, rtol=1e-5, atol=1e-6)


def test_lrn_window_offsets_match_jax():
    for n in range(1, 8):
        assert lrn.window_offsets(n) == jlrn._window_offsets(n)


def _group(rng, cin, outs, biased):
    """Per-member HWIO 1x1 params and the group's concatenated operands."""
    gparams = []
    for o, b in zip(outs, biased):
        d = {"wmat": (rng.randn(1, 1, cin, o) * 0.2).astype(np.float32)}
        if b:
            d["bias"] = rng.randn(o).astype(np.float32)
        gparams.append(d)
    w2d = np.concatenate([d["wmat"][0, 0] for d in gparams], axis=1)
    bias = None
    if any(biased):
        bias = np.concatenate([d.get("bias", np.zeros(o, np.float32))
                               for d, o in zip(gparams, outs)])
    return gparams, w2d, bias


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("biased", [(True, True, True), (True, False, True),
                                    (False, False, False)])
def test_conv_block_plain_matches_jax(stride, biased):
    rng = np.random.RandomState(7 + stride)
    outs = (8, 12, 5)
    x = rng.randn(2, 7, 6, 16).astype(np.float32)
    gparams, w2d, bias = _group(rng, 16, outs, biased)
    stock = JaxNet._apply_fused_1x1(
        stride, [{t: jnp.asarray(v) for t, v in d.items()} for d in gparams],
        jnp.asarray(x))
    stock = np.concatenate([np.asarray(p) for p in stock], axis=3)
    pallas = np.asarray(jcb.conv1x1_block(
        jnp.asarray(x), jnp.asarray(w2d),
        None if bias is None else jnp.asarray(bias), stride=stride,
        interpret=True))
    got = conv_block.conv1x1_block(
        torch.from_numpy(x), torch.from_numpy(w2d),
        None if bias is None else torch.from_numpy(bias),
        stride=stride).numpy()
    assert got.shape == stock.shape == pallas.shape
    np.testing.assert_allclose(got, stock, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)


def test_conv_block_relu_epilogue_matches_pallas():
    rng = np.random.RandomState(3)
    x = rng.randn(40, 24).astype(np.float32)
    w = rng.randn(24, 19).astype(np.float32)
    b = rng.randn(19).astype(np.float32)
    ref = np.asarray(jcb.fused_block_gemm(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), relu=True,
                                          interpret=True))
    got = conv_block.conv_block_gemm(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), relu=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    assert (got >= 0).all()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = [k.launches for k in KERNELS]
    x = torch.randn(1, 5, 5, 4)
    maxpool.maxpool_fwd(x, 3, 3, 2)
    lrn.lrn_fwd(x, 5, 1e-4, 0.75, 1.0)
    conv_block.conv1x1_block(x, torch.randn(4, 6))
    xg = x.clone().requires_grad_(True)
    y = maxpool.maxpool(lrn.lrn(xg, 5, 1e-4, 0.75, 1.0), 3, 3, 1, 1, 1)
    conv_block.conv1x1_block(maxpool.maxpool(y, 3, 3, 2),
                             torch.randn(4, 6)).sum().backward()
    w = torch.randn(9)
    update_step.sgd_update(w, torch.randn(9), torch.zeros(9), 0.1, 0.9)
    assert xg.grad is not None
    assert [k.launches for k in KERNELS] == before


def _tied(rng, shape):
    """Integer values with relu zeros: ties in most windows."""
    return np.maximum(rng.randint(-3, 4, shape), 0).astype(np.float32)


@pytest.mark.parametrize("h,w,k,s,p", POOL_CASES)
def test_maxpool_bwd_plain_bit_equal_to_jax(h, w, k, s, p):
    rng = np.random.RandomState(h * 7 + w + k + s + p)
    x = _tied(rng, (2, h, w, 5))
    y, vjp = jax.vjp(lambda v: jconv._maxpool_eq(v, k, k, s, p, p),
                     jnp.asarray(x))
    _, vjp_pl = jax.vjp(lambda v: jmp.maxpool_fused(v, k, k, s, p, p,
                                                    interpret=True),
                        jnp.asarray(x))
    g = rng.randn(*y.shape).astype(np.float32)
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    ref_pl = np.asarray(vjp_pl(jnp.asarray(g))[0])
    got = maxpool.maxpool_bwd(torch.from_numpy(x),
                              torch.from_numpy(np.array(y)),
                              torch.from_numpy(g), k, k, s, p, p).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref_pl)


# the JAX package's default backward rounds to bf16 after each add (XLA's
# vjp of _maxpool_eq, and the Pallas _bwd_kernel, bit-equal to it); the
# port's K2 and K3 sum in f32 and round once (as K3's Pallas kernel
# _bwd_s1_kernel does), the more accurate choice.  Each bf16 rounding
# moves a sum by at most 2**-8 of its magnitude, which is at most the sum
# of the contributions' magnitudes, so the two differ per element by at
# most (contributions) * 2**-8 * sum |g| over the windows that give the
# element its gradient, and not at all where one window does.
BF16_POOL_BWD_CASES = [
    ((4, 28, 28, 64), 3, 2, 0),
    ((4, 15, 15, 16), 3, 2, 0),
    ((2, 11, 11, 8), 3, 2, 1),
    ((4, 14, 14, 32), 3, 1, 1),  # K3
    ((2, 9, 8, 16), 5, 1, 2),    # K3
]


@pytest.mark.parametrize("shape,k,s,p", BF16_POOL_BWD_CASES)
def test_maxpool_bwd_plain_bf16_within_one_rounding_of_jax(shape, k, s, p):
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    y, vjp = jax.vjp(lambda v: jconv._maxpool_eq(v, k, k, s, p, p), xb)
    g = jnp.asarray(rng.randn(*y.shape).astype(np.float32), jnp.bfloat16)
    ref = np.asarray(vjp(g)[0], np.float32)
    tx, ty, tg = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (x, y, g))
    if maxpool.same_size_s1(k, k, s, p, p):
        def bwd(*a):
            return maxpool.maxpool_bwd_s1(*a, k, p)
    else:
        def bwd(*a):
            return maxpool.maxpool_bwd(*a, k, k, s, p, p)
        _, vjp_pl = jax.vjp(lambda v: jmp.maxpool_fused(
            v, k, k, s, p, p, interpret=True), xb)
        np.testing.assert_array_equal(
            np.asarray(vjp_pl(g)[0], np.float32), ref)
    got = bwd(tx, ty, tg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    xf, yf = tx.float(), ty.float()
    count = bwd(xf, yf, torch.ones_like(yf)).numpy()
    mag = bwd(xf, yf, tg.float().abs()).numpy()
    diff = np.abs(got - ref)
    assert (diff <= count * 2.0 ** -8 * mag).all()
    assert (diff[count <= 1] == 0).all()
    if shape == (4, 28, 28, 64):  # the difference is real, not vacuous
        assert (diff > 0).sum() > 100


@pytest.mark.parametrize("c,dtype,offset,vector", [
    (64, torch.bfloat16, 0, True),
    (24, torch.bfloat16, 0, True),
    (8, torch.bfloat16, 0, True),
    (12, torch.bfloat16, 0, False),   # not 8 bf16 channels a vector
    (5, torch.bfloat16, 0, False),
    (12, torch.float32, 0, True),
    (6, torch.float32, 0, False),     # not 4 f32 channels a vector
    (64, torch.bfloat16, 1, False),   # x 2 bytes off 16
    (64, torch.bfloat16, 8, True),    # x 16 bytes on
    (64, torch.float32, 2, False),    # x 8 bytes off 16
])
def test_maxpool_bwd_kernel_rule(c, dtype, offset, vector):
    buf = torch.zeros(2 * 9 * 9 * c + offset, dtype=dtype)
    x = buf[offset:].view(2, 9, 9, c)
    y = torch.zeros(2, 4, 4, c, dtype=dtype)
    assert x.is_contiguous()
    assert maxpool.takes_vector(x, y, torch.zeros_like(y), 3, 2) is vector


def test_maxpool_bwd_kernel_rule_sizes_and_gradient_alignment():
    x = torch.zeros(2, 9, 9, 16, dtype=torch.bfloat16)
    y = torch.zeros(2, 4, 4, 16, dtype=torch.bfloat16)
    g = torch.zeros(2 * 4 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(
        y.shape)
    assert not maxpool.takes_vector(x, y, g, 3, 2)  # g 2 bytes off 16
    assert maxpool.takes_vector(x, y, y, 3, 2)
    # 2**31 elements in x or in y need 64-bit indices: the edge kernel's
    # (a 1-row window, so that the band of window rows stays small)
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    big, small = meta(2, 32768, 4096, 8), meta(2, 16384, 2048, 8)
    assert big.numel() == 2 ** 31 and big.data_ptr() % 16 == 0
    assert maxpool.takes_vector(small, small, small, 1, 1)
    assert not maxpool.takes_vector(big, small, small, 1, 1)
    assert not maxpool.takes_vector(small, big, big, 1, 1)


@pytest.mark.parametrize("oh,ow,c,dtype,k,s,vector", [
    (250, 454, 64, torch.bfloat16, 3, 2, True),   # 2 rows: 232448 bytes
    (250, 455, 64, torch.bfloat16, 3, 2, False),  # 232960
    (250, 500, 64, torch.bfloat16, 3, 2, False),
    (250, 227, 64, torch.float32, 3, 2, True),    # 232448
    (250, 228, 64, torch.float32, 3, 2, False),
    (250, 302, 64, torch.bfloat16, 3, 1, True),   # 3 rows: 231936
    (250, 303, 64, torch.bfloat16, 3, 1, False),  # 232704
    (1, 900, 64, torch.bfloat16, 3, 2, True),     # 1 row: 230400
])
def test_maxpool_bwd_kernel_rule_band_within_shared_memory(oh, ow, c, dtype,
                                                           k, s, vector):
    """K2's main path stages the y and g rows of the windows covering one
    input row in a block's shared memory (232448 bytes on the H100); a
    wider band takes the edge kernel."""
    x = torch.empty(2, 2 * oh, 2 * ow, c, dtype=dtype, device="meta")
    y = torch.empty(2, oh, ow, c, dtype=dtype, device="meta")
    assert maxpool.takes_vector(x, y, y, k, s) is vector


def _googlenet_pools():
    """``(x shape, y shape, (kh, kw, s, py, px))`` of every max pool of
    GoogLeNet's b128 forward, in order, from the port's shape inference."""
    tr = NetTrainer()
    tr.set_params(tcfg.parse_file(os.path.join(
        REPO, "example", "ImageNet", "googlenet.conf")) + [
            ("dev", "cpu"), ("batch_size", "128")])
    tr.init_model()
    net = tr.net
    shapes = net.infer_shapes(128)
    pools = []
    for i, spec in enumerate(tr.graph.layers):
        lay = net.layer_objs[i]
        if type(lay).__name__ == "MaxPoolingLayer":
            p = lay.param
            pools.append((shapes[spec.nindex_in[0]],
                          shapes[spec.nindex_out[0]],
                          (p.kernel_height, p.kernel_width, p.stride,
                           p.pad_y, p.pad_x)))
    return pools


def test_every_googlenet_stride2_pool_takes_the_vector_kernel():
    pools = []
    for xs, ys, (kh, _, s, py, px) in _googlenet_pools():
        if maxpool.same_size_s1(kh, kh, s, py, px):
            continue
        pools.append(xs)
        x = torch.empty(xs, dtype=torch.bfloat16, device="meta")
        y = torch.empty(ys, dtype=torch.bfloat16, device="meta")
        assert maxpool.takes_vector(x, y, y, kh, s), xs
        x32, y32 = x.float(), y.float()
        assert maxpool.takes_vector(x32, y32, y32, kh, s), xs
    assert pools == [(128, 112, 112, 64), (128, 56, 56, 192),
                     (128, 28, 28, 480), (128, 14, 14, 832)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_googlenet_pool_takes_the_forward_vector_kernel(dtype):
    """K1's main path at all 13 pools of a b128 forward (4 stride-2, 9
    stride-1), on meta tensors of the port's inferred shapes."""
    pools = _googlenet_pools()
    assert len(pools) == 13
    for xs, _, geom in pools:
        x = torch.empty(xs, dtype=dtype, device="meta")
        assert maxpool.takes_vector_fwd(x, *geom), xs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_googlenet_inception_pool_takes_the_s1_vector_kernel(dtype):
    """K3's main path at the 9 same-size stride-1 pools of a b128 step."""
    pools = []
    for xs, ys, geom in _googlenet_pools():
        if not maxpool.same_size_s1(*geom):
            continue
        pools.append(xs)
        x = torch.empty(xs, dtype=dtype, device="meta")
        y = torch.empty(ys, dtype=dtype, device="meta")
        assert maxpool.takes_vector_s1(x, y, y, geom[0]), xs
    assert pools == [(128, 28, 28, 192), (128, 28, 28, 256),
                     (128, 14, 14, 480), (128, 14, 14, 512),
                     (128, 14, 14, 512), (128, 14, 14, 512),
                     (128, 14, 14, 528), (128, 7, 7, 832), (128, 7, 7, 832)]


@pytest.mark.parametrize("c,dtype,offset,vector", [
    (64, torch.bfloat16, 0, True),
    (40, torch.bfloat16, 0, True),
    (8, torch.bfloat16, 0, True),
    (12, torch.bfloat16, 0, False),   # not 8 bf16 channels a vector
    (5, torch.bfloat16, 0, False),
    (12, torch.float32, 0, True),
    (6, torch.float32, 0, False),     # not 4 f32 channels a vector
    (64, torch.bfloat16, 1, False),   # x 2 bytes off 16
    (64, torch.bfloat16, 8, True),    # x 16 bytes on
    (64, torch.float32, 2, False),    # x 8 bytes off 16
])
def test_maxpool_fwd_kernel_rule(c, dtype, offset, vector):
    buf = torch.zeros(2 * 9 * 9 * c + offset, dtype=dtype)
    x = buf[offset:].view(2, 9, 9, c)
    assert x.is_contiguous()
    assert maxpool.takes_vector_fwd(x, 3, 3, 2) is vector


@pytest.mark.parametrize("c,dtype,offset,operand,vector", [
    (64, torch.bfloat16, 0, "x", True),
    (24, torch.bfloat16, 0, "x", True),
    (12, torch.bfloat16, 0, "x", False),  # not 8 bf16 channels a vector
    (12, torch.float32, 0, "x", True),
    (6, torch.float32, 0, "x", False),    # not 4 f32 channels a vector
    (64, torch.bfloat16, 1, "x", False),  # x 2 bytes off 16
    (64, torch.bfloat16, 1, "y", False),  # y 2 bytes off 16
    (64, torch.bfloat16, 1, "g", False),  # g 2 bytes off 16
    (64, torch.bfloat16, 8, "g", True),   # g 16 bytes on
    (64, torch.float32, 2, "y", False),   # y 8 bytes off 16
])
def test_maxpool_bwd_s1_kernel_rule(c, dtype, offset, operand, vector):
    def make(name):
        at = offset if name == operand else 0
        return torch.zeros(2 * 9 * 9 * c + at, dtype=dtype)[at:].view(
            2, 9, 9, c)

    assert maxpool.takes_vector_s1(make("x"), make("y"), make("g"),
                                   3) is vector


def test_maxpool_fwd_and_s1_kernel_rules_need_32bit_indices():
    """2**31 elements in x or in y need 64-bit indices: the edge kernels'
    (a 1-row window, so that the band of window rows stays small)."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    big, small = meta(2, 32768, 4096, 8), meta(2, 16384, 2048, 8)
    assert big.numel() == 2 ** 31 and big.data_ptr() % 16 == 0
    assert maxpool.takes_vector_fwd(small, 1, 1, 1)
    assert not maxpool.takes_vector_fwd(big, 1, 1, 1)
    # an output of 2**31 elements from an input under it (pad 1, 1x1)
    assert not maxpool.takes_vector_fwd(meta(2, 32767, 4095, 8), 1, 1, 1,
                                        1, 1)
    assert maxpool.takes_vector_s1(small, small, small, 1)
    assert not maxpool.takes_vector_s1(big, big, big, 1)
    assert not maxpool.takes_vector_s1(small, small, big, 1)


@pytest.mark.parametrize("h,w,c,dtype,k,vector", [
    (250, 605, 64, torch.bfloat16, 3, True),   # 3 rows: 232320 bytes
    (250, 606, 64, torch.bfloat16, 3, False),  # 232704
    (250, 605, 32, torch.float32, 3, True),    # 232320
    (250, 606, 32, torch.float32, 3, False),   # 232704
    (250, 605, 1024, torch.bfloat16, 3, True),  # one 128-byte slice wide
    (250, 606, 1024, torch.float32, 3, False),
    (250, 302, 8, torch.bfloat16, 3, True),    # 16 bytes a position
    (250, 1816, 64, torch.bfloat16, 1, True),  # 1 row: 232448
    (250, 1817, 64, torch.bfloat16, 1, False),
    (2, 908, 64, torch.float32, 3, True),      # 2 rows (h < k): 232448
    (2, 909, 64, torch.float32, 3, False),
])
def test_maxpool_fwd_kernel_rule_band_within_shared_memory(h, w, c, dtype, k,
                                                           vector):
    """K1's main path stages the input rows one output row's windows
    cover, one channel slice of 128 bytes a position wide, in a block's
    shared memory (232448 bytes on the H100); a wider band takes the
    edge kernel."""
    x = torch.empty(2, h, w, c, dtype=dtype, device="meta")
    assert maxpool.takes_vector_fwd(x, k, k, 2) is vector


@pytest.mark.parametrize("h,w,c,dtype,k,vector", [
    (250, 302, 64, torch.bfloat16, 3, True),    # 2 x 3 rows: 231936 bytes
    (250, 303, 64, torch.bfloat16, 3, False),   # 232704
    (250, 302, 32, torch.float32, 3, True),     # 231936
    (250, 303, 32, torch.float32, 3, False),
    (250, 302, 832, torch.bfloat16, 3, True),   # one 128-byte slice wide
    (250, 303, 832, torch.float32, 3, False),
    (250, 1452, 8, torch.bfloat16, 5, True),    # 2 x 5 rows: 232320
    (250, 1453, 8, torch.bfloat16, 5, False),   # 232480
    (1, 908, 64, torch.bfloat16, 3, True),      # 2 x 1 row (h < k): 232448
    (1, 909, 64, torch.bfloat16, 3, False),
])
def test_maxpool_bwd_s1_kernel_rule_band_within_shared_memory(h, w, c, dtype,
                                                              k, vector):
    """K3's main path stages the y and g rows of the windows covering one
    input row, one channel slice of 128 bytes a position wide, in a
    block's shared memory; a wider band takes the edge kernel."""
    x = torch.empty(2, h, w, c, dtype=dtype, device="meta")
    assert maxpool.takes_vector_s1(x, x, x, k) is vector


@pytest.mark.parametrize("h,w,k", [(6, 6, 3), (7, 5, 3), (9, 8, 5),
                                   (14, 14, 3)])
def test_maxpool_bwd_s1_plain_matches_jax(h, w, k):
    p = (k - 1) // 2
    rng = np.random.RandomState(h + w * 3 + k)
    x = _tied(rng, (2, h, w, 6))
    x[0, 0, 0, 0] = np.nan  # a NaN input gets no gradient
    y, vjp = jax.vjp(lambda v: jconv._maxpool_eq(v, k, k, 1, p, p),
                     jnp.asarray(x))
    g = rng.randn(*y.shape).astype(np.float32)
    ref_pl = np.asarray(jmp.maxpool_bwd_s1(jnp.asarray(x), y, jnp.asarray(g),
                                           k, p, interpret=True))
    ref_eq = np.asarray(vjp(jnp.asarray(g))[0])
    got = maxpool.maxpool_bwd_s1(torch.from_numpy(x),
                                 torch.from_numpy(np.array(y)),
                                 torch.from_numpy(g), k, p).numpy()
    np.testing.assert_array_equal(got, ref_pl)
    np.testing.assert_allclose(got, ref_eq, rtol=1e-6, atol=1e-6)
    assert got[0, 0, 0, 0] == 0.0


def test_maxpool_function_takes_the_eligible_backward():
    x = torch.from_numpy(_tied(np.random.RandomState(0), (1, 6, 6, 3)))
    for geom, kernel in (((3, 3, 1, 1, 1), "s1"), ((3, 3, 2, 0, 0), "any"),
                         ((3, 3, 1, 0, 0), "any")):
        xg = x.clone().requires_grad_(True)
        y = maxpool.maxpool(xg, *geom)
        g = torch.randn(y.shape)
        y.backward(g)
        kh, kw, s, py, px = geom
        ref = (maxpool.maxpool_bwd_s1_plain(x, y.detach(), g, kh, py)
               if kernel == "s1" else
               maxpool.maxpool_bwd_plain(x, y.detach(), g, *geom))
        assert maxpool.same_size_s1(*geom) == (kernel == "s1")
        assert torch.equal(xg.grad, ref)


@pytest.mark.parametrize("nsize", [3, 4, 5])
def test_lrn_bwd_plain_matches_jax(nsize):
    rng = np.random.RandomState(10 + nsize)
    x = rng.randn(3, 4, 5, 24).astype(np.float32)
    x[x < -0.5] = 0.0  # relu zeros
    g = rng.randn(*x.shape).astype(np.float32)
    kw = dict(nsize=nsize, alpha=0.01, beta=0.75, knorm=1.5)
    _, vjp_pl = jax.vjp(lambda v: jlrn.lrn(v, interpret=True, **kw),
                        jnp.asarray(x))
    _, vjp_xla = jax.vjp(lambda v: jlrn.lrn_xla(v, **kw), jnp.asarray(x))
    got = lrn.lrn_bwd(torch.from_numpy(x), torch.from_numpy(g), nsize, 0.01,
                      0.75, 1.5).numpy()
    np.testing.assert_allclose(got, np.asarray(vjp_pl(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(vjp_xla(jnp.asarray(g))[0]),
                               rtol=1e-4, atol=1e-6)
    xg = torch.from_numpy(x).requires_grad_(True)
    lrn.lrn(xg, nsize, 0.01, 0.75, 1.5).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xg.grad.numpy(), got)


def _sgd_inputs(shape, clip, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    g = (rng.randn(*shape) * 2).astype(np.float32)
    m = rng.randn(*shape).astype(np.float32)
    if clip:
        g.reshape(-1)[::7] = np.nan  # the clip's NaN guard zeroes these
    return w, g, m


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(7,), (3, 3, 5, 17), (1000, 1024)])
def test_sgd_update_plain_matches_jax(shape, clip):
    w, g, m = _sgd_inputs(shape, clip, len(shape))
    up = JaxSGD("wmat")
    for k, v in (("lr", "0.01"), ("wd", "0.0002"),
                 ("clip_gradient", str(clip))):
        up.set_param(k, v)
    epoch = 5
    w_ref, s_ref = up.apply(jnp.asarray(w), jnp.asarray(g),
                            {"m": jnp.asarray(m)}, jnp.asarray(epoch))
    lr = float(np.asarray(up.param.learning_rate(epoch)))
    mom = float(np.asarray(up.param.momentum_at(epoch)))
    w_pl, m_pl = jup.sgd_update(jnp.asarray(w), jnp.asarray(g),
                                jnp.asarray(m), jnp.float32(lr),
                                jnp.float32(mom), wd=0.0002, clip=clip,
                                interpret=True)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    update_step.sgd_update(tw, torch.from_numpy(g), tm, lr, mom, 0.0002,
                           clip)
    got_w, got_m = tw.numpy(), tm.numpy()
    # op by op, as the JAX package's SGDUpdater spells it: bit-equal
    np.testing.assert_array_equal(got_w, np.asarray(w_ref))
    np.testing.assert_array_equal(got_m, np.asarray(s_ref["m"]))
    # the Pallas kernel's XLA CPU lowering fuses mom*m - lr*(...) into an
    # FMA (measured: it differs from the op-by-op rule in the last bits):
    # it may skip the rounding of either product, so the two agree
    # within one rounding of each product plus one of the result
    gc = update_step.nan_clip(torch.from_numpy(g), clip).numpy() if clip \
        else g
    step = np.float32(lr) * (gc + np.float32(0.0002) * w)
    bound_m = (np.spacing(np.abs(np.float32(mom) * m))
               + np.spacing(np.abs(step)) + np.spacing(np.abs(got_m)))
    assert (np.abs(got_m - np.asarray(m_pl)) <= bound_m).all()
    bound_w = bound_m + np.spacing(np.abs(got_w))
    assert (np.abs(got_w - np.asarray(w_pl)) <= bound_w).all()
    assert np.isfinite(got_w).all()


# a scalar, sizes off the kernel's 4-wide vectors, one past a 256-value
# block pass, one over many 2048-value chunks
MULTI_SIZES = (1, 7, 257, 100003)


@pytest.mark.parametrize("epoch", [0, 7])
def test_sgd_update_multi_plain_matches_per_tensor_and_jax(epoch):
    clips = (0.0, 0.5, 0.0, 2.0)
    cases, jax_out = [], []
    for i, (n, clip) in enumerate(zip(MULTI_SIZES, clips)):
        w, g, m = _sgd_inputs((n,), clip, 40 + i)
        up = JaxSGD("wmat" if i % 2 else "bias")
        for k, v in (("lr", f"{0.01 * (i + 1)}"), ("wd", f"{1e-4 * i}"),
                     ("clip_gradient", str(clip)), ("lr:schedule",
                                                    "expdecay")):
            up.set_param(k, v)
        w_ref, s_ref = up.apply(jnp.asarray(w), jnp.asarray(g),
                                {"m": jnp.asarray(m)}, jnp.asarray(epoch))
        jax_out.append((np.asarray(w_ref), np.asarray(s_ref["m"])))
        cases.append((w, g, m, float(np.asarray(
            up.param.learning_rate(epoch))), float(np.asarray(
                up.param.momentum_at(epoch))), up.param.wd, clip))
    multi = [[torch.from_numpy(a.copy()) for a in c[:3]] for c in cases]
    update_step.sgd_update_multi(*zip(*multi), *(
        [c[j] for c in cases] for j in range(3, 7)))
    for (w, g, m, *hyper), (tw, _, tm), (jw, jm) in zip(cases, multi,
                                                        jax_out):
        pw, pm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
        update_step.sgd_update_plain(pw, torch.from_numpy(g), pm, *hyper)
        assert torch.equal(tw, pw) and torch.equal(tm, pm)
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(tm.numpy(), jm)
        assert np.isfinite(tw.numpy()).all()


def test_sgd_update_multi_splits_at_the_launch_capacity():
    with open(update_step.KERNEL.source) as f:
        cap = re.search(r"constexpr int MAX_TENSORS = (\d+);", f.read())
    assert int(cap.group(1)) == update_step.MAX_TENSORS
    z = torch.zeros(3)
    with pytest.raises(ValueError, match="length"):
        update_step.sgd_update_multi([z], [z], [z], [0.1], [0.9], [], [0.0])
    with pytest.raises(ValueError, match="shapes"):
        update_step.sgd_update_multi([z], [torch.zeros(4)], [z], [0.1],
                                     [0.9], [0.0], [0.0])
    update_step.sgd_update_multi([], [], [], [], [], [], [])  # a no-op


@pytest.mark.parametrize("k,o,offset,dtype,wgmma", [
    (192, 176, 0, torch.bfloat16, True),
    (832, 624, 0, torch.bfloat16, True),
    (8, 8, 0, torch.bfloat16, True),
    (17, 176, 0, torch.bfloat16, False),   # K % 8
    (192, 77, 0, torch.bfloat16, False),   # O % 8
    (192, 176, 1, torch.bfloat16, False),  # X 2 bytes off 16
    (192, 176, 8, torch.bfloat16, True),   # X 16 bytes on
    (192, 176, 0, torch.float32, False),   # f32 has one kernel
])
def test_conv_block_kernel_rule(k, o, offset, dtype, wgmma):
    buf = torch.zeros(4 * k + 8, dtype=dtype)
    x = buf[offset:offset + 4 * k].view(4, k)
    w = torch.zeros(k, o, dtype=dtype)
    assert x.is_contiguous()
    assert conv_block.takes_wgmma(x, w) is wgmma


def test_every_googlenet_group_takes_the_wgmma_kernel():
    tr = NetTrainer()
    tr.set_params(tcfg.parse_file(os.path.join(
        REPO, "example", "ImageNet", "googlenet.conf")) + [
            ("dev", "cpu"), ("batch_size", "128")])
    tr.init_model()
    net = tr.net
    shapes = net.infer_shapes(128)
    groups, _ = net._sibling_1x1_groups()
    mko = []
    for i, members in groups.items():
        spec = tr.graph.layers[i]
        n, oh, ow, _ = shapes[spec.nindex_out[0]]
        k = shapes[spec.nindex_in[0]][3]
        o = sum(net.layer_objs[j].param.num_channel for j in members)
        mko.append((n * oh * ow, k, o))
        assert conv_block.takes_wgmma(
            torch.zeros(8, k, dtype=torch.bfloat16),
            torch.zeros(k, o, dtype=torch.bfloat16)), (k, o)
    assert sorted(mko) == sorted([
        (100352, 192, 176), (100352, 256, 288), (25088, 480, 304),
        (25088, 512, 296), (25088, 512, 280), (25088, 512, 288),
        (25088, 528, 448), (6272, 832, 448), (6272, 832, 624)])


SCHEDULES = [
    {},
    {"lr:schedule": "expdecay", "lr:gamma": "0.9", "lr:step": "7"},
    {"lr:schedule": "polydecay", "lr:gamma": "0.5", "lr:alpha": "0.5"},
    {"lr:schedule": "polydecay", "lr:gamma": "0.01", "lr:alpha": "0.75",
     "lr:step": "3", "lr:minimum_lr": "0.002"},
    {"lr:schedule": "factor", "lr:factor": "0.5", "lr:step": "100",
     "lr:start_epoch": "250"},
    {"momentum_schedule": "1", "base_momentum": "0.5",
     "final_momentum": "0.95", "saturation_epoch": "700"},
]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedules_match_jax(sched):
    ours, ref = UpdaterParam("wmat"), JaxUpdaterParam("wmat")
    for p in (ours, ref):
        for k, v in {"eta": "0.05", "wmat:lr": "0.02", "bias:lr": "9",
                     **sched}.items():
            p.set_param(k, v)
    assert ours.base_lr == 0.02
    epochs = np.arange(0, 2001)
    want_lr = np.asarray(jax.vmap(ref.learning_rate)(jnp.asarray(epochs)))
    want_m = np.asarray(jax.vmap(ref.momentum_at)(jnp.asarray(epochs)))
    got_lr = np.array([ours.learning_rate(int(e)) for e in epochs])
    got_m = np.array([ours.momentum_at(int(e)) for e in epochs])
    assert got_lr.dtype == got_m.dtype == np.float32
    np.testing.assert_allclose(got_lr, want_lr, rtol=2e-7, atol=0)
    np.testing.assert_allclose(got_m, want_m, rtol=2e-7, atol=0)


def test_updater_factory_ports_sgd_only():
    up = create_updater("sgd", "bias")
    w = torch.ones(3)
    st = up.init_state(w)
    up.apply(w, torch.ones(3), st, 0)
    assert torch.allclose(st["m"], torch.full((3,), -0.01))
    for name in ("adam", "nag", "rmsprop", "adagrad", "lars", "lamb"):
        assert create_updater(name, "wmat").type_name == name
    with pytest.raises(ValueError):
        create_updater("sgdd", "wmat")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("biased", [(True, False, True), (True, True, True)])
def test_conv_block_function_grads_match_jax(stride, biased):
    rng = np.random.RandomState(20 + stride)
    outs = (8, 12, 5)
    x = rng.randn(2, 7, 6, 16).astype(np.float32)
    gparams, _, _ = _group(rng, 16, outs, biased)
    gy = rng.randn(2, -(-7 // stride), -(-6 // stride),
                   sum(outs)).astype(np.float32)

    def stock(gp, xv):
        parts = JaxNet._apply_fused_1x1(stride, gp, xv)
        return jnp.sum(jnp.concatenate(parts, axis=3) * gy)

    jgp = [{t: jnp.asarray(v) for t, v in d.items()} for d in gparams]
    ref_p, ref_x = jax.grad(stock, argnums=(0, 1))(jgp, jnp.asarray(x))

    tp = [{t: torch.from_numpy(v).requires_grad_(True) for t, v in d.items()}
          for d in gparams]
    tx = torch.from_numpy(x).requires_grad_(True)
    w2d = torch.cat([d["wmat"].reshape(16, -1) for d in tp], dim=1)
    bias = torch.cat([d["bias"] if "bias" in d else torch.zeros(o)
                      for d, o in zip(tp, outs)])
    y = conv_block.conv1x1_block(tx, w2d, bias, stride=stride)
    (y * torch.from_numpy(gy)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_x), **tol)
    for d, r in zip(tp, ref_p):
        assert sorted(d) == sorted(r)  # bias-less members get no bias grad
        for t in d:
            np.testing.assert_allclose(d[t].grad.numpy(), np.asarray(r[t]),
                                       **tol)


def test_conv_block_function_relu_grads_match_autograd_of_plain():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(30, 12).astype(np.float32))
    w = torch.from_numpy(rng.randn(12, 7).astype(np.float32))
    b = torch.from_numpy(rng.randn(7).astype(np.float32))
    gy = torch.from_numpy(rng.randn(30, 7).astype(np.float32))
    grads = []
    for f in (lambda *a: conv_block._ConvBlockGemm.apply(*a, True),
              lambda *a: conv_block.conv_block_plain(*a, relu=True)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        (f(*leaves) * gy).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_dropout_keeps_the_expected_fraction():
    lay = DropoutLayer()
    lay.set_param("threshold", "0.4")
    x = torch.full((1000, 1000), 2.0)
    gen = torch.Generator().manual_seed(11)
    (y,) = lay.apply({}, [x], train=True, gen=gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.6) < 0.01 * 0.6
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / 0.6))
    (y2,) = lay.apply({}, [x], train=True,
                      gen=torch.Generator().manual_seed(11))
    assert torch.equal(y, y2)
    (y3,) = lay.apply({}, [x], train=True,
                      gen=torch.Generator().manual_seed(12))
    assert not torch.equal(y, y3)
    assert lay.apply({}, [x], train=False, gen=gen)[0] is x
    lay.set_param("threshold", "0")
    assert lay.apply({}, [x], train=True, gen=gen)[0] is x


def test_kernel_sources_and_build_keys():
    for k in KERNELS:
        with open(k.source) as f:
            src = f.read()
        # every kernel names the Pallas kernel it replaces and exports
        # one C entry per dtype the wrapper can ask for
        assert k.replaces.split(":")[0] in src
        for sfx in k.dtypes:
            assert f'extern "C" int {k.name}_{sfx}(' in src
        path = k.library_path()
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
        assert path == k.library_path()  # stable key


def test_wrapper_checks_refuse_bad_tensors():
    with pytest.raises(TypeError):
        _build.dtype_suffix(torch.zeros(2, dtype=torch.float16))
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda("t", torch.zeros(2), 1)
    with pytest.raises(ValueError, match="K mismatch"):
        conv_block.conv_block_gemm(torch.zeros(3, 4), torch.zeros(5, 2))


# ----------------------------------------------------------------------
# flash attention (K9 forward, K10 backward)
def _qkv(b=2, t=64, tk=None, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    tk = t if tk is None else tk
    return tuple(rng.randn(b, n, h, d).astype(np.float32)
                 for n in (t, tk, tk))


def _torch_leaves(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blocks", [(512, 512), (16, 32), (32, 16)])
def test_flash_forward_and_grads_match_the_pallas_kernel(causal, blocks):
    q, k, v = _qkv(seed=1 + causal)
    g = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jflash.flash_mha(a, b, c, causal, *blocks, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv = _torch_leaves(q, k, v)
    out = flash.flash_mha(tq, tk, tv, causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    for name, t, want in zip("qkv", (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,tk", [(64, 32), (32, 64)])
def test_flash_cross_lengths_match_the_pallas_kernel(causal, t, tk):
    q, k, v = _qkv(t=t, tk=tk, seed=3)
    out_j = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, 16, 16, True)
    out = flash.flash_mha(*_torch_leaves(q, k, v), causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)


# (q_off, k_off): rows 0..39 see no key; a shifted diagonal; no row
# sees any key; keys all in the past
@pytest.mark.parametrize("offs", [(0, 40), (16, 0), (0, 70), (64, 0)])
def test_flash_lse_offsets_and_dead_rows_match_the_pallas_kernel(offs):
    q, k, v = _qkv(seed=4)
    rng = np.random.RandomState(5)
    g = rng.randn(*q.shape).astype(np.float32)
    g_lse = rng.randn(2, 64, 2).astype(np.float32)
    (out_j, lse_j), vjp = jax.vjp(
        lambda a, b, c: jflash.flash_mha_lse(
            a, b, c, jnp.int32(offs[0]), jnp.int32(offs[1]), True, 16, 32,
            True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    tq, tk, tv = _torch_leaves(q, k, v)
    out, lse = flash.flash_mha_lse(tq, tk, tv, *offs, causal=True)
    assert lse.shape == (2, 64, 2)
    torch.autograd.backward([out, lse],
                            [torch.from_numpy(g), torch.from_numpy(g_lse)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               rtol=1e-5, atol=1e-5)
    dead = offs[0] + np.arange(64) < offs[1]
    assert (out.detach().numpy()[:, dead] == 0).all()
    assert (lse.detach().numpy()[:, dead] == -1e30).all()
    for name, t, want in zip("qkv", (tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_close_to_f32(causal):
    q, k, v = _qkv(seed=6)
    ref = attention.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    out = flash.flash_mha(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (q, k, v)), causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_and_plain_flash_match_the_jax_mha(causal):
    q, k, v = _qkv(seed=7)
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(attention.mha(tq, tk, tv, causal).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    o, lse = flash.flash_fwd_plain(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), want, rtol=1e-5, atol=1e-5)
    assert lse.shape == (2, 2, 64) and lse.dtype == torch.float32


def test_flash_bwd_plain_is_the_autograd_of_mha():
    """The explicit backward formulas define the gradient of attention:
    against autograd of the dense ``mha`` (f32, sums in another
    order)."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(t=32, seed=8))
    g = torch.from_numpy(
        np.random.RandomState(2).randn(2, 32, 2, 16).astype(np.float32))
    o = attention.mha(q, k, v, causal=True)
    o.backward(g)
    o2, lse = flash.flash_fwd_plain(q.detach(), k.detach(), v.detach(), True)
    dl = (g * o2).sum(-1).permute(0, 2, 1)
    got = flash.flash_bwd_plain(q.detach(), k.detach(), v.detach(), g, lse,
                                dl, True)
    for t, d in zip((q, k, v), got):
        torch.testing.assert_close(d, t.grad, rtol=1e-5, atol=1e-5)


def _bwd_inputs(causal, dtype, seed):
    """q, k, v, dO in ``dtype`` and the forward's lse and dl (f32), the
    plain forward's, from seeded numpy draws."""
    q, k, v = _qkv(seed=seed)
    g = np.random.RandomState(seed + 100).randn(*q.shape).astype(np.float32)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    o, lse = flash.flash_fwd_plain(tq, tk, tv, causal)
    dl = (tg.float() * o.float()).sum(-1).permute(0, 2, 1)
    return tq, tk, tv, tg, lse, dl


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_f32_rounds_nothing(causal):
    """In f32 the rounding of p and dS to the input dtype is a no-op: the
    plain backward is bit-equal to the unrounded formulas."""
    q, k, v, do, lse, dl = _bwd_inputs(causal, torch.float32, 21)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        vis = attention.causal_mask(q.shape[1], k.shape[1], 0, 0, q.device)
        p = torch.where(vis, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - dl[..., None])
    want = (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, do))
    got = flash.flash_bwd_plain(q, k, v, do, lse, dl, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name


def _row_rel(got, ref):
    """The worst row's largest error over that row's largest magnitude
    (a row: one vector of Dh)."""
    got, ref = (np.asarray(x, np.float32) for x in (got, ref))
    err = np.abs(got - ref).max(-1)
    return float((err / np.maximum(np.abs(ref).max(-1), 1e-30)).max())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_bf16_matches_the_pallas_kernel(causal):
    """bf16 through the autograd entry (plain forward, plain backward with
    p and dS rounded to bf16) against ``jax.vjp`` of the Pallas kernels in
    interpret mode (p and dS kept f32), on the same bf16 inputs.  Each
    gradient row within 2e-2 of its largest magnitude: both sides round
    their output to bf16 (one ulp apart reads 2**-7 = 7.8e-3), and the
    port's p and dS roundings add a little (worst reading 9.05e-3)."""
    q, k, v = _qkv(seed=22 + causal)
    g = np.random.RandomState(23).randn(*q.shape).astype(np.float32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    out_j, vjp = jax.vjp(
        lambda a, b, c: jflash.flash_mha(a, b, c, causal, 16, 32, True),
        bf(q), bf(k), bf(v))
    grads_j = vjp(bf(g))
    tq, tk, tv = _torch_leaves(q, k, v, dtype=torch.bfloat16)
    out = flash.flash_mha(tq, tk, tv, causal)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert _row_rel(out.detach().float(), out_j.astype(jnp.float32)) <= 2e-2
    for name, t, want in zip("qkv", (tq, tk, tv), grads_j):
        assert t.grad.dtype == torch.bfloat16
        rel = _row_rel(t.grad.float(), want.astype(jnp.float32))
        assert rel <= 2e-2, f"d{name}: worst row-relative error {rel:.3g}"


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_bf16_close_to_f32(causal):
    """The bf16 plain backward against the f32 one on the same
    bf16-valued inputs: each gradient within 1.5e-2 of the tensor's
    largest magnitude (p, dS and the outputs rounded to bf16; worst
    reading 5.7e-3).  Held to the tensor's largest, not per row: an early
    causal row's dQ cancels to near zero, where bf16 leaves only noise."""
    bf16 = _bwd_inputs(causal, torch.bfloat16, 24)
    q, k, v, do = (x.float() for x in bf16[:4])  # the same values in f32
    o, lse = flash.flash_fwd_plain(q, k, v, causal)
    dl = (do * o).sum(-1).permute(0, 2, 1)
    want = flash.flash_bwd_plain(q, k, v, do, lse, dl, causal)
    got = flash.flash_bwd_plain(*bf16, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        rel = float((a.float() - b).abs().max() / b.abs().max())
        assert rel <= 1.5e-2, f"{name}: {rel:.3g} of the largest"


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash._check("q", x, x)
    with pytest.raises(NotImplementedError, match="head dim"):
        flash._geometry(torch.zeros(1, 4, 1, 24), torch.zeros(1, 4, 1, 24),
                        torch.zeros(1, 4, 1, 24))
    with pytest.raises(ValueError, match="fit together"):
        flash._geometry(x, torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16))


def test_build_key_covers_the_local_headers(tmp_path, monkeypatch):
    """A kernel library is rebuilt when a csrc header it includes
    changes, not only when its own source does."""
    (tmp_path / "t.cuh").write_text("// one\n")
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    k = _build.Kernel("k", "none")
    before = k.library_path()
    (tmp_path / "t.cuh").write_text("// two\n")
    assert k.library_path() != before
    assert "flash_tiles.cuh" in open(flash.FWD_KERNEL.source).read()
