"""Each CUDA kernel of the port against its plain PyTorch version: the
forwards of max pool, LRN and the conv block; the two max-pool
backwards and the SGD step bit for bit (ties, partial windows, NaNs);
the LRN forward and backward to 1e-5 in float32 and 1e-2 in bfloat16 on
both paths, with the C entry each call took (the vector kernels at C 8
to 1024, the edge kernels at C 70, a misaligned view and nsize 11;
nsize 1 to 11, beta 0.5 to 1.5), NaN and inf at knorm 0 where the plain
version has them; the flash
attention forward (K9) within 1e-5 (float32) and 1e-2 (bfloat16) and
the backward (K10) within 1e-6 and 2e-2 of each row's largest plain
magnitude (in bfloat16 at least 1e-3 of the tensor's largest), over
ragged and cross lengths (T 1 and 7, under one 16-row tensor-core tile;
63 and 65, either side of a 64-row tile), offsets on and off the tile
boundaries with fully masked rows, head dims 16, 32 and 64, and strided
q/k/v slices of a fused qkv tensor, and K10 bit-equal from one launch to
the next (no atomics); the int8 GEMM (K7) within 1e-5 (float32) and 8e-3
(bfloat16, one rounding) of each row's largest plain magnitude, with and
without bias and relu, at ragged M, K and O and at K not a multiple of 8
(the kernel's scalar loads), and a quantized net's forward on the card;
the conv block's bf16 wgmma kernel at M 1, 127, 129 and 6272 (either
side of a 128-row tile, and inception 5's rows) with K and O of
GoogLeNet's groups and O 256 (each tile width), bias and relu on and
off, within 2e-2, and its
rule: K 17 and an X view 2 bytes off 16-byte alignment take the
mma.sync edge kernel, which the per-entry counts show; the SGD step's
multi-tensor launch over tensors of 1 to 100003 values with their own
lr, wd and clip, NaNs under a clip and a misaligned view (scalar path),
bit-equal to the plain version, one launch a set and one more past its
capacity; the attention layer at head dims 8 and 128 (outside the
flash kernels' dims) through the dense path on the card, forward and
gradients against the CPU within 1e-4, no flash launch; ResNet-50's
sibling-1x1 groups (K 64 to 1024, O 320 to 2560, stride 1 and 2,
bias-free) on the wgmma kernel through ``conv1x1_block``, the strided
input's gradient only on ``x[:, ::s, ::s]``, both within 2e-2 of the
plain conv; ``batch_norm`` on the card against the CPU (f32 within
1e-5, bf16 within 2e-2 of the largest, gradients too); a small
bottleneck net's f32 step (TF32 off) against the CPU under ``bn_eval =
batch`` and ``running`` (updates within 1e-3 of each tensor's largest,
running statistics within 1e-5); one step of ``nag``, ``rmsprop``,
``adagrad``, ``lars`` and ``lamb`` against the CPU within 1e-5; K1 and
K2 at the MNIST nets' pools (a partial last window, 2x2 outputs) on
their vector entries, bit-equal; and ``update_period = 2`` on the card
(K8 on every second micro-batch, the weights within 1e-5 of the CPU's);
the conv rewrites (``conv_s2d``, Winograd F(4x4) and F(2x2)) on the
card against the CPU, forward and gradients in f32 with TF32 off
(within 1e-5 of the largest), and in bf16 the forward's error against
the f32 direct conv within the JAX tests' bf16 profile; ``prelu``'s
jitter,
``insanity`` and ``insanity_max_pooling`` in training on the card
bit-equal to their formulas on the same on-card draws; a side-input
net (csv + attachtxt, ``fixconn``, ``bias``, ``softplus``, a ``torch:``
conv) stepped on the card against the CPU (f32, TF32 off, updates
within 1e-4 of each tensor's largest); the library API's raw-array
predict (``wrapper.Net``, through the bucket cache) and the C ABI's
``CXNNetPredictBatch`` (the port's library loaded by ``ctypes`` into
this process) bit-equal to ``trainer.predict`` on the card, and the
``xla_device_memory_bytes`` series of ``/metricsz`` equal to
``torch.cuda.memory_stats()`` read at the same moment; the integrity
digest computed on the card (f32 and bf16, whole and as a block whose
word index passes 2^31) equal to the host oracle's, a bf16 net's
shadow step bitwise clean on the card (cuDNN's settings restored), a
``torch.profiler`` window around one K1 launch showing its symbol; one
closed-loop cycle on the card (``loop.ContinuousLoop``) whose published,
hot-reloaded round answers at bucket 32 bit-equal to ``trainer.predict``
of the published checkpoint, and a step from a block the data service
deals bit-equal to the step from the local chain's batch; ``moe``'s
top-k routing under tied gates on the card equal to the CPU's, and a
small flash LM under ``remat = 1`` on the card equal to ``remat = 0``,
K9 launched twice per attention layer a step; data parallelism: two gloo
rank processes on ``cuda:0`` sum, gather and broadcast CUDA tensors
through ``parallel.distributed`` with the tensors left on the card (a
collective gloo cannot run on them raises), ``dev = gpu:k`` is the card ``k`` and a card past
the host's raises the JAX package's message, and the SGD kernel over the
ZeRO slices of each tensor (cut along ``MeshPlan.owner_dim`` for 2 and 3
ranks) equals it over the whole tensors bit for bit.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one.  The file imports nothing of JAX, so on a machine with a
card and no JAX it runs alone, without the suite's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.ops import flash, lrn, maxpool
from cxxnet_tpu_torch.ops import quant as opsq
from cxxnet_tpu_torch.ops.kernels import conv_block, int8_gemm, update_step

# (h, w, k, s, p) as in test_torch_ops.py: strides 1 and 2, pads 0 and 1,
# partial edge windows
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,k,s,p", POOL_CASES)
def test_cuda_maxpool_bit_equal_to_plain(cuda_device, dtype, h, w, k, s, p):
    x = torch.randn(3, h, w, 40, device=cuda_device).to(dtype)
    n0 = maxpool.KERNEL.launches
    got = maxpool.maxpool_fwd(x, k, k, s, p, p)
    torch.cuda.synchronize()
    assert maxpool.KERNEL.launches == n0 + 1
    assert torch.equal(got, maxpool.maxpool_plain(x, k, k, s, p, p))


# LRN's paths, (c, offset): C 8, 64, 72, 192 and 1024 (the vector kernel
# in both dtypes: 1 to 256 vectors a position), 70 (the edge kernel in
# both) and a view one element off 16-byte alignment (the edge kernel);
# nsize 11 is past the vector kernel's largest window (the edge kernel)
LRN_CASES = [(8, 0), (64, 0), (72, 0), (192, 0), (1024, 0), (70, 0),
             (64, 1)]
LRN_NSIZES = [1, 3, 4, 5, 9, 11]
LRN_TOL = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]
# beta 1.5 is past the vector kernels' log2/exp2 route: powf there
LRN_BETAS = [0.5, 0.75, 1.0, 1.5]


def _lrn_input(c, offset, device, dtype, seed):
    """A (5, 7, 9, c) input, ``offset`` elements into its buffer."""
    gen = torch.Generator().manual_seed(seed)
    buf = torch.randn(5 * 7 * 9 * c + offset, generator=gen)
    return buf.to(device, dtype)[offset:].view(5, 7, 9, c)


def _lrn_main(x, nsize, offset):
    """Whether the rule sends ``x`` to the vector kernel, held to the
    cases' own reading of it."""
    main = lrn.takes_vector(x, nsize=nsize)
    assert main is (offset == 0 and x.shape[-1] % (16 // x.element_size())
                    == 0 and nsize <= lrn.VECTOR_NSIZE)
    return main


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", LRN_TOL)
@pytest.mark.parametrize("nsize", LRN_NSIZES)
@pytest.mark.parametrize("c,offset", LRN_CASES)
@pytest.mark.parametrize("beta", LRN_BETAS)
def test_cuda_lrn_matches_plain(cuda_device, dtype, tol, nsize, c, offset,
                                beta):
    """The wrapper's path (the vector kernel where ``takes_vector``
    holds, else the edge kernel), which the per-entry count shows, and
    the edge kernel by its C entry, each against the plain version."""
    x = _lrn_input(c, offset, cuda_device, dtype, c + nsize)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    main = _lrn_main(x, nsize, offset)
    ref = lrn.lrn_plain(x, nsize, 1e-2, beta, 1.0)
    before = dict(lrn.KERNEL.by_symbol)
    got = lrn.lrn_fwd(x, nsize, 1e-2, beta, 1.0)
    torch.cuda.synchronize()
    want = f"lrn_fwd_{sfx}" + ("" if main else "_edge")
    assert _symbols_since(lrn.KERNEL, before) == {want: 1}
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    got = lrn.launch_fwd(f"lrn_fwd_{sfx}_edge", x, nsize, 1e-2, beta, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,o", [(100, 192, 176), (70, 40, 72),
                                   (5, 17, 9), (257, 832, 624)])
def test_cuda_conv_block_matches_plain(cuda_device, dtype, tol, m, k, o):
    x = torch.randn(m, k, device=cuda_device).to(dtype)
    w = (torch.randn(k, o, device=cuda_device) / k ** 0.5).to(dtype)
    b = torch.randn(o, device=cuda_device).to(dtype)
    for bias in (b, None):
        for relu in (False, True):
            got = conv_block.conv_block_gemm(x, w, bias, relu)
            ref = conv_block.conv_block_plain(x, w, bias, relu)
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                       atol=tol)


def _tied(shape, device, dtype, seed):
    """Integer-valued inputs with relu zeros: many ties in every window."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-3, 4, shape, generator=gen).float().clamp_min(0)
    return x.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,k,s,p", POOL_CASES)
def test_cuda_maxpool_bwd_bit_equal_to_plain(cuda_device, dtype, h, w, k, s,
                                             p):
    x = _tied((3, h, w, 40), cuda_device, dtype, h * 10 + w)
    y = maxpool.maxpool_fwd(x, k, k, s, p, p)
    g = torch.randn(y.shape, device=cuda_device).to(dtype)
    n0 = maxpool.BWD_KERNEL.launches
    got = maxpool.maxpool_bwd(x, y, g, k, k, s, p, p)
    torch.cuda.synchronize()
    assert maxpool.BWD_KERNEL.launches == n0 + 1
    assert torch.equal(got, maxpool.maxpool_bwd_plain(x, y, g, k, k, s, p, p))


# K2's paths, (h, w, c, k, s, p): k3 s2, k2 s2, k3 s1 p0 (not the
# same-size stride-1 pool K3 takes), padded k3 s2 p1, odd H and W, C 8,
# 24 and 64 (the vector gather in both dtypes) and 5 (the edge kernel);
# a row of 1000 x 64 whose band of window rows outgrows shared memory
# (the edge kernel too)
POOL_BWD_CASES = [
    (9, 9, 64, 3, 2, 0),
    (8, 10, 24, 2, 2, 0),
    (7, 7, 8, 3, 1, 0),
    (11, 13, 64, 3, 2, 1),
    (15, 13, 24, 3, 2, 0),
    (9, 9, 5, 3, 2, 0),
    (5, 1000, 64, 3, 2, 0),
]


def _symbols_since(kernel, before):
    return {n: c - before.get(n, 0) for n, c in kernel.by_symbol.items()
            if c != before.get(n, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,k,s,p", POOL_BWD_CASES)
def test_cuda_maxpool_bwd_paths_bit_equal_to_plain(cuda_device, dtype, h, w,
                                                   c, k, s, p):
    """The wrapper's path (the vector gather where ``takes_vector`` holds,
    else the edge kernel) and the edge kernel by its C entry, each
    bit-equal to the plain version, with a NaN input that gets no
    gradient."""
    x = _tied((3, h, w, c), cuda_device, dtype, h * 31 + c)
    x[0, 0, 0, :] = float("nan")
    y = maxpool.maxpool_fwd(x, k, k, s, p, p)
    g = torch.randn(y.shape, device=cuda_device).to(dtype)
    ref = maxpool.maxpool_bwd_plain(x, y, g, k, k, s, p, p)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    main = maxpool.takes_vector(x, y, g, k, s)
    assert main is (c % (16 // x.element_size()) == 0 and w < 1000)
    before = dict(maxpool.BWD_KERNEL.by_symbol)
    got = maxpool.maxpool_bwd(x, y, g, k, k, s, p, p)
    torch.cuda.synchronize()
    want = f"maxpool_bwd_{sfx}" + ("" if main else "_edge")
    assert _symbols_since(maxpool.BWD_KERNEL, before) == {want: 1}
    assert torch.equal(got, ref)
    assert not bool(got[0, 0, 0].any())
    got = maxpool.launch_bwd(f"maxpool_bwd_{sfx}_edge", x, y, g, k, k, s, p,
                             p)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_maxpool_bwd_misaligned_view_takes_the_edge(cuda_device,
                                                         dtype):
    n, h, w, c = 2, 9, 9, 16
    buf = _tied((n * h * w * c + 1,), cuda_device, dtype, 5)
    x = buf[1:].view(n, h, w, c)
    y = maxpool.maxpool_fwd(x, 3, 3, 2)
    g = torch.randn(y.shape, device=cuda_device).to(dtype)
    assert not maxpool.takes_vector(x, y, g, 3, 2)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    before = dict(maxpool.BWD_KERNEL.by_symbol)
    got = maxpool.maxpool_bwd(x, y, g, 3, 3, 2)
    torch.cuda.synchronize()
    assert _symbols_since(maxpool.BWD_KERNEL, before) == {
        f"maxpool_bwd_{sfx}_edge": 1}
    assert torch.equal(got, maxpool.maxpool_bwd_plain(x, y, g, 3, 3, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,k", [(6, 6, 3), (7, 5, 3), (9, 8, 5),
                                   (14, 14, 3)])
def test_cuda_maxpool_bwd_s1_bit_equal_to_plain(cuda_device, dtype, h, w, k):
    p = (k - 1) // 2
    x = _tied((2, h, w, 72), cuda_device, dtype, h + w + k)
    x[0, 0, 0, :4] = float("nan")  # a NaN input gets no gradient
    y = maxpool.maxpool_fwd(x, k, k, 1, p, p)
    g = torch.randn(y.shape, device=cuda_device).to(dtype)
    n0 = maxpool.BWD_S1_KERNEL.launches
    got = maxpool.maxpool_bwd_s1(x, y, g, k, p)
    torch.cuda.synchronize()
    assert maxpool.BWD_S1_KERNEL.launches == n0 + 1
    ref = maxpool.maxpool_bwd_s1_plain(x, y, g, k, p)
    assert torch.equal(got, ref)
    assert torch.equal(got[0, 0, 0, :4], torch.zeros_like(got[0, 0, 0, :4]))


# K1's paths, (h, w, c, k, s, p): every POOL_CASES geometry at C 40 (the
# vector gather in both dtypes), 12 (bf16: the edge kernel; f32: the
# gather) and 6 (the edge kernel in both); C 104, whose channel slices
# of 8 vectors leave a shorter last one; images whose rows the blocks
# share unevenly (23 output rows in blocks of 12 and 11, 11 in 6 and 5,
# 51 in 5s and a 1); and a row of 1000 x 64 whose band outgrows shared
# memory (the edge kernel)
POOL_FWD_CASES = [(h, w, c, k, s, p) for h, w, k, s, p in POOL_CASES
                  for c in (40, 12, 6)] + [
    (9, 120, 104, 3, 2, 0),
    (9, 120, 104, 3, 1, 1),
    (23, 20, 64, 3, 1, 1),
    (23, 20, 64, 3, 2, 0),
    (51, 50, 64, 3, 1, 1),
    (5, 1000, 64, 3, 2, 0),
]


def _equal_with_nans(got, ref) -> bool:
    """Bit-equal where the reference is a number, NaN where it is NaN
    (``torch.equal`` is false on any NaN)."""
    nan = torch.isnan(ref.float())
    return (torch.equal(torch.isnan(got.float()), nan)
            and torch.equal(got[~nan], ref[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,k,s,p", POOL_FWD_CASES)
def test_cuda_maxpool_fwd_paths_bit_equal_to_plain(cuda_device, dtype, h, w,
                                                   c, k, s, p):
    """The wrapper's path (the vector gather where ``takes_vector_fwd``
    holds, else the edge kernel) and the edge kernel by its C entry,
    each bit-equal to the plain version, NaN where it has a NaN."""
    x = _tied((3, h, w, c), cuda_device, dtype, h * 31 + w + c)
    x[0, 0, 0, :] = float("nan")
    x[2, h - 1, w - 1, : c // 2] = float("nan")
    ref = maxpool.maxpool_plain(x, k, k, s, p, p)
    assert bool(torch.isnan(ref.float()).any())
    sfx = "f32" if dtype == torch.float32 else "bf16"
    main = maxpool.takes_vector_fwd(x, k, k, s, p, p)
    assert main is (c % (16 // x.element_size()) == 0 and w < 1000)
    before = dict(maxpool.KERNEL.by_symbol)
    got = maxpool.maxpool_fwd(x, k, k, s, p, p)
    torch.cuda.synchronize()
    want = f"maxpool_fwd_{sfx}" + ("" if main else "_edge")
    assert _symbols_since(maxpool.KERNEL, before) == {want: 1}
    assert got.shape == ref.shape and _equal_with_nans(got, ref)
    got = maxpool.launch_fwd(f"maxpool_fwd_{sfx}_edge", x, k, k, s, p, p)
    torch.cuda.synchronize()
    assert _equal_with_nans(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_maxpool_fwd_misaligned_view_takes_the_edge(cuda_device,
                                                         dtype):
    n, h, w, c = 2, 9, 9, 16
    buf = _tied((n * h * w * c + 1,), cuda_device, dtype, 6)
    x = buf[1:].view(n, h, w, c)
    ref = maxpool.maxpool_plain(x, 3, 3, 2)
    assert not maxpool.takes_vector_fwd(x, 3, 3, 2)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    before = dict(maxpool.KERNEL.by_symbol)
    got = maxpool.maxpool_fwd(x, 3, 3, 2)
    torch.cuda.synchronize()
    assert _symbols_since(maxpool.KERNEL, before) == {
        f"maxpool_fwd_{sfx}_edge": 1}
    assert torch.equal(got, ref)


# K3's paths, (h, w, c, k): k3 and k5 with odd h != w, C 72 (the vector
# gather in both dtypes), 12 (bf16: the edge kernel) and 6 (the edge
# kernel in both); C 104, whose channel slices of 8 vectors leave a
# shorter last one; an image whose rows the blocks share unevenly (23
# rows in blocks of 6, 6, 6 and 5 in bf16); a row of 400 x 64 whose band
# outgrows shared memory (the edge kernel)
POOL_S1_CASES = [(h, w, c, k) for h, w, k in ((7, 5, 3), (5, 9, 3),
                                              (9, 7, 5), (14, 14, 3))
                 for c in (72, 12, 6)] + [
    (7, 60, 104, 3),
    (23, 20, 64, 3),
    (3, 400, 64, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,k", POOL_S1_CASES)
def test_cuda_maxpool_bwd_s1_paths_bit_equal_to_plain(cuda_device, dtype, h,
                                                      w, c, k):
    """The wrapper's path (the vector gather where ``takes_vector_s1``
    holds, else the edge kernel) and the edge kernel by its C entry,
    each bit-equal to the plain version; a NaN input gets no gradient."""
    p = (k - 1) // 2
    x = _tied((3, h, w, c), cuda_device, dtype, h * 17 + w + c)
    x[0, 0, 0, :] = float("nan")
    x[1, h // 2, w // 2, : c // 2] = float("nan")
    y = maxpool.maxpool_fwd(x, k, k, 1, p, p)
    g = torch.randn(y.shape, device=cuda_device).to(dtype)
    ref = maxpool.maxpool_bwd_s1_plain(x, y, g, k, p)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    main = maxpool.takes_vector_s1(x, y, g, k)
    assert main is (c % (16 // x.element_size()) == 0 and w < 400)
    before = dict(maxpool.BWD_S1_KERNEL.by_symbol)
    got = maxpool.maxpool_bwd_s1(x, y, g, k, p)
    torch.cuda.synchronize()
    want = f"maxpool_bwd_s1_{sfx}" + ("" if main else "_edge")
    assert _symbols_since(maxpool.BWD_S1_KERNEL, before) == {want: 1}
    assert torch.equal(got, ref)
    assert not bool(got[0, 0, 0].any())
    assert not bool(got[1, h // 2, w // 2, : c // 2].any())
    got = maxpool.launch_bwd_s1(f"maxpool_bwd_s1_{sfx}_edge", x, y, g, k, p)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_maxpool_bwd_s1_misaligned_view_takes_the_edge(cuda_device,
                                                            dtype):
    n, h, w, c = 2, 9, 9, 16
    x = _tied((n, h, w, c), cuda_device, dtype, 7)
    y = maxpool.maxpool_fwd(x, 3, 3, 1, 1, 1)
    buf = torch.randn(n * h * w * c + 1, device=cuda_device).to(dtype)
    g = buf[1:].view(n, h, w, c)
    assert not maxpool.takes_vector_s1(x, y, g, 3)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    before = dict(maxpool.BWD_S1_KERNEL.by_symbol)
    got = maxpool.maxpool_bwd_s1(x, y, g, 3, 1)
    torch.cuda.synchronize()
    assert _symbols_since(maxpool.BWD_S1_KERNEL, before) == {
        f"maxpool_bwd_s1_{sfx}_edge": 1}
    assert torch.equal(got, maxpool.maxpool_bwd_s1_plain(x, y, g, 3, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", LRN_TOL)
@pytest.mark.parametrize("nsize", LRN_NSIZES)
@pytest.mark.parametrize("c,offset", LRN_CASES)
@pytest.mark.parametrize("beta", LRN_BETAS)
def test_cuda_lrn_bwd_matches_plain(cuda_device, dtype, tol, nsize, c,
                                    offset, beta):
    """As the forward: the wrapper's path by its per-entry count, then
    the edge kernel by its C entry, each against the plain version."""
    x = _lrn_input(c, offset, cuda_device, dtype, c + nsize)
    x[0, 0, 0, :8] = 0.0  # relu zeros
    g = torch.randn(x.shape, device=cuda_device).to(dtype)
    sfx = "f32" if dtype == torch.float32 else "bf16"
    main = _lrn_main(x, nsize, offset)
    before = dict(lrn.BWD_KERNEL.by_symbol)
    n0 = lrn.BWD_KERNEL.launches
    got = lrn.lrn_bwd(x, g, nsize, 1e-2, beta, 1.0)
    torch.cuda.synchronize()
    assert lrn.BWD_KERNEL.launches == n0 + 1
    want = f"lrn_bwd_{sfx}" + ("" if main else "_edge")
    assert _symbols_since(lrn.BWD_KERNEL, before) == {want: 1}
    ref = lrn.lrn_bwd_plain(x, g, nsize, 1e-2, beta, 1.0)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    got = lrn.launch_bwd(f"lrn_bwd_{sfx}_edge", x, g, nsize, 1e-2, beta, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", LRN_TOL)
@pytest.mark.parametrize("c,offset", [(64, 0), (70, 0), (64, 1)])
def test_cuda_lrn_zero_norm_places_nan_and_inf_as_plain(cuda_device, dtype,
                                                        tol, c, offset):
    """knorm = 0: an all-zero position has norm 0 (y = 0 * inf, NaN), and
    one whose only nonzero values (+-1e-30) square to 0 has y = +-inf
    there; both directions on both paths put NaN and inf where the plain
    version does, and hold the rest to the tolerance.  alpha = nsize
    keeps the other norms near 5: at alpha 1e-2 a window of small inputs
    has a norm near 1e-4 and p near 1e3, where dx cancels two terms of
    that size and the plain version itself lies past the 1e-5 atol from
    float64 (``check_lrn_power`` in ``chip_smoke.py`` reads it), so only
    a pow bit-equal to the plain version's would pass."""
    x = _lrn_input(c, offset, cuda_device, dtype, 5)
    x[0, 0, 0, :] = 0.0
    x[1, 2, 3, :] = 0.0
    x[1, 2, 3, 5], x[1, 2, 3, 6] = 1e-30, -1e-30
    g = torch.randn(x.shape, device=cuda_device).to(dtype)
    args = (5, 5.0, 0.75, 0.0)
    ref = lrn.lrn_plain(x, *args)
    assert bool(torch.isnan(ref[0, 0, 0]).all())
    assert ref[1, 2, 3, 5] == float("inf") and ref[1, 2, 3, 6] == -float(
        "inf")
    ref_bwd = lrn.lrn_bwd_plain(x, g, *args)
    assert bool(torch.isnan(ref_bwd[0, 0, 0]).all())
    sfx = "f32" if dtype == torch.float32 else "bf16"
    edge = "" if _lrn_main(x, 5, offset) else "_edge"
    before = (dict(lrn.KERNEL.by_symbol), dict(lrn.BWD_KERNEL.by_symbol))
    for got, want in ((lrn.lrn_fwd(x, *args), ref),
                      (lrn.launch_fwd(f"lrn_fwd_{sfx}_edge", x, *args), ref),
                      (lrn.lrn_bwd(x, g, *args), ref_bwd),
                      (lrn.launch_bwd(f"lrn_bwd_{sfx}_edge", x, g, *args),
                       ref_bwd)):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, equal_nan=True)
    assert _symbols_since(lrn.KERNEL, before[0]) == (
        {f"lrn_fwd_{sfx}_edge": 2} if edge else
        {f"lrn_fwd_{sfx}": 1, f"lrn_fwd_{sfx}_edge": 1})
    assert _symbols_since(lrn.BWD_KERNEL, before[1]) == (
        {f"lrn_bwd_{sfx}_edge": 2} if edge else
        {f"lrn_bwd_{sfx}": 1, f"lrn_bwd_{sfx}_edge": 1})


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("n", [1, 7, 255, 257, 100003])
def test_cuda_sgd_update_bit_equal_to_plain(cuda_device, clip, n):
    gen = torch.Generator().manual_seed(n)
    w, g, m = (torch.randn(n, generator=gen).to(cuda_device)
               for _ in range(3))
    g[::5] = float("nan")
    if clip == 0.0:
        g = torch.nan_to_num(g)  # no NaN guard without a clip
    w2, m2 = w.clone(), m.clone()
    n0 = update_step.KERNEL.launches
    update_step.sgd_update(w, g, m, 0.01, 0.9, 2e-4, clip)
    torch.cuda.synchronize()
    assert update_step.KERNEL.launches == n0 + 1
    update_step.sgd_update_plain(w2, g, m2, 0.01, 0.9, 2e-4, clip)
    assert torch.equal(w, w2) and torch.equal(m, m2)
    assert bool(torch.isfinite(w).all())


@pytest.mark.cuda
def test_cuda_autograd_runs_the_backward_kernels(cuda_device):
    x = _tied((2, 9, 9, 16), cuda_device, torch.bfloat16, 1)
    x.requires_grad_(True)
    before = [k.launches for k in (maxpool.BWD_KERNEL,
                                   maxpool.BWD_S1_KERNEL, lrn.BWD_KERNEL)]
    y = maxpool.maxpool(lrn.lrn(x, 5, 1e-4, 0.75, 1.0), 3, 3, 1, 1, 1)
    y = maxpool.maxpool(y, 3, 3, 2)
    y.float().sum().backward()
    torch.cuda.synchronize()
    after = [k.launches for k in (maxpool.BWD_KERNEL,
                                  maxpool.BWD_S1_KERNEL, lrn.BWD_KERNEL)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert x.grad is not None and bool(torch.isfinite(x.grad.float()).all())


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(2, 6, 6, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        maxpool.maxpool_fwd(x.transpose(1, 2), 3, 3, 2)
    with pytest.raises(TypeError):
        lrn.lrn_fwd(x.half(), 5, 1e-4, 0.75, 1.0)
    with pytest.raises(TypeError):
        conv_block.conv_block_gemm(
            x.reshape(-1, 8),
            torch.randn(8, 4, device=cuda_device, dtype=torch.bfloat16))
    wb = torch.zeros(6, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        update_step.sgd_update(wb, wb, wb, 0.1, 0.9)
    with pytest.raises(ValueError, match="same-size"):
        maxpool.maxpool_bwd_s1(x, x, x, 3, 0)


# (B, T, Tk, H, D, causal, q_off, k_off): ragged T, cross lengths, rows
# that see no key (k_off > q_off), every head dim the kernels take
FLASH_CASES = [
    (2, 64, 64, 2, 16, True, 0, 0),
    (2, 100, 100, 3, 64, True, 0, 0),
    (2, 100, 100, 3, 64, False, 0, 0),
    (1, 130, 70, 2, 32, False, 0, 0),
    (1, 70, 130, 2, 32, True, 0, 0),
    (2, 96, 96, 2, 64, True, 0, 50),
    (2, 96, 96, 2, 64, True, 30, 0),
    # every head dim at T 7 (under one 16-row mma tile, as the windowed
    # generation path calls K9), 63 and 65 (either side of a 64-row tile)
    (2, 7, 7, 2, 32, True, 0, 0),
    (1, 7, 70, 2, 64, True, 63, 0),
    (2, 63, 63, 3, 16, False, 0, 0),
    (1, 63, 65, 2, 32, True, 0, 0),
    (2, 65, 65, 2, 64, True, 0, 0),
    (1, 65, 63, 2, 16, True, 0, 0),
    # offsets off the tile boundaries: a diagonal inside the tiles, and
    # dead rows ending mid-tile
    (2, 130, 130, 2, 64, True, 37, 5),
    (1, 130, 100, 2, 32, True, 3, 41),
]
# bf16 only: T 1, a decode step over 33 keys.  In f32 each of its dK rows
# is one product whose dS = p (dP - dl) cancels, so the plain version's
# other summation order shows above the f32 limit of 1e-6 per row
FLASH_CASES_BF16 = [(1, 1, 33, 2, 16, True, 32, 0)]
# each row's largest error over that row's largest plain magnitude, per
# kernel and dtype, as chip_smoke.py holds them (reasons there)
FLASH_TOL = {("fwd", torch.float32): 1e-5, ("fwd", torch.bfloat16): 1e-2,
             ("bwd", torch.float32): 1e-6, ("bwd", torch.bfloat16): 2e-2}
# the bf16 backward's row scale is at least this share of the tensor's
# largest: a query that sees one key has dQ = 0 exactly, noise on both
# sides (chip_smoke.py's FLASH_ROW_FLOOR)
BWD_ROW_FLOOR = {torch.float32: 0.0, torch.bfloat16: 1e-3}
LSE_ATOL = 1e-5


def _close(got, ref, tol, what, floor=0.0):
    """Row by row (a row is one vector of D): a late causal row is far
    smaller than row 0, so the tensor's largest magnitude is no scale
    for it; each row's scale is at least ``floor`` of the largest."""
    err = (got.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    scale = scale.clamp_min(max(floor * float(scale.max()), 1e-30))
    rel = float((err / scale).max())
    assert rel <= tol, f"{what}: worst row-relative error {rel:.3g}"


def _flash_inputs(device, dtype, b, t, tk, h, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, h, d, generator=gen).to(device, dtype)
            for n in (t, tk, tk, t)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,case", [(d, c) for c in FLASH_CASES
                   for d in (torch.float32, torch.bfloat16)]
    + [(torch.bfloat16, c) for c in FLASH_CASES_BF16])
def test_cuda_flash_matches_plain(cuda_device, dtype, case):
    b, t, tk, h, d, causal, q_off, k_off = case
    q, k, v, do = _flash_inputs(cuda_device, dtype, b, t, tk, h, d, t + tk)
    n0, n1 = flash.FWD_KERNEL.launches, flash.BWD_KERNEL.launches
    o, lse = flash.flash_fwd(q, k, v, causal, q_off, k_off)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, causal, q_off, k_off)
    _close(o, o_ref, FLASH_TOL[("fwd", dtype)], "o")
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=LSE_ATOL)
    dl = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = flash.flash_bwd(q, k, v, do, lse_ref, dl, causal, q_off, k_off)
    ref = flash.flash_bwd_plain(q, k, v, do, lse_ref, dl, causal, q_off,
                                k_off)
    torch.cuda.synchronize()
    assert (flash.FWD_KERNEL.launches, flash.BWD_KERNEL.launches) == (
        n0 + 1, n1 + 1)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype
        _close(a, r, FLASH_TOL[("bwd", dtype)], name, BWD_ROW_FLOOR[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_bwd_is_deterministic(cuda_device, dtype, causal):
    """K10 sums every output element in one fixed order (no atomics):
    two launches on the same inputs are bit-equal."""
    q, k, v, do = _flash_inputs(cuda_device, dtype, 2, 200, 200, 2, 64, 11)
    o, lse = flash.flash_fwd(q, k, v, causal)
    dl = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    first = flash.flash_bwd(q, k, v, do, lse, dl, causal)
    second = flash.flash_bwd(q, k, v, do, lse, dl, causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_autograd_reads_fused_qkv_slices(cuda_device, dtype):
    """The attention layer's layout: q, k, v are strided slices of one
    (B, T, 3, H, D) tensor; the LSE takes a cotangent of its own."""
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 80, 3, 2, 64, generator=gen).to(cuda_device, dtype)
    g = torch.randn(2, 80, 2, 64, generator=gen).to(cuda_device, dtype)
    g_lse = torch.randn(2, 80, 2, generator=gen).to(cuda_device)
    x = qkv.clone().requires_grad_(True)
    n0, n1 = flash.FWD_KERNEL.launches, flash.BWD_KERNEL.launches
    o, lse = flash.flash_mha_lse(x[:, :, 0], x[:, :, 1], x[:, :, 2], 0, 0,
                                 True)
    torch.autograd.backward([o, lse], [g, g_lse])
    torch.cuda.synchronize()
    assert (flash.FWD_KERNEL.launches, flash.BWD_KERNEL.launches) == (
        n0 + 1, n1 + 1)
    # the plain versions on the same slices; the backward from the values
    # the Function hands K10: the kernel's o and lse, dl = delta - dlse
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, True)
    _close(o, o_ref, FLASH_TOL[("fwd", dtype)], "o")
    torch.testing.assert_close(lse.detach(), lse_ref.permute(0, 2, 1),
                               rtol=0, atol=LSE_ATOL)
    lse_k = lse.detach().permute(0, 2, 1).contiguous()
    dl = ((g.float() * o.detach().float()).sum(-1).permute(0, 2, 1)
          - g_lse.float().permute(0, 2, 1)).contiguous()
    ref = torch.stack(flash.flash_bwd_plain(q, k, v, g, lse_k, dl, True), 2)
    _close(x.grad, ref, FLASH_TOL[("bwd", dtype)], "dqkv",
           BWD_ROW_FLOOR[dtype])


@pytest.mark.cuda
def test_cuda_flash_refuses_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(1, 8, 1, 24, device=cuda_device)
    with pytest.raises(NotImplementedError, match="head dim"):
        flash.flash_fwd(x, x, x)
    y = torch.randn(1, 8, 1, 16, device=cuda_device)
    with pytest.raises(TypeError):
        flash.flash_fwd(y, y.bfloat16(), y)
    # a layout the kernels cannot read in place is refused, not copied
    with pytest.raises(ValueError, match="strides"):
        flash.flash_fwd(y.transpose(1, 3).contiguous().transpose(1, 3), y, y)
    with pytest.raises(ValueError, match="strides"):
        z = torch.randn(1, 8, 1, 17, device=cuda_device)[..., 1:]
        flash.flash_fwd(z, y, y)


# (M, K, O): ragged everywhere; K % 8 != 0 takes the scalar loads; one
# GoogLeNet shape (i4e_pool_proj) and the classifier's
INT8_CASES = [(5, 17, 9), (100, 64, 64), (257, 528, 128), (130, 1024, 1000),
              (70, 40, 33), (333, 200, 72)]
INT8_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _int8_operands(device, dtype, m, k, o, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=gen).to(device, dtype)
    q = torch.randint(-127, 128, (o, k), generator=gen,
                      dtype=torch.int8).to(device)
    scale = (torch.rand(o, generator=gen) * 0.01 / k ** 0.5).to(device)
    bias = (torch.randn(o, generator=gen) * 0.1).to(device)
    return x, q, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,o", INT8_CASES)
def test_cuda_int8_gemm_matches_plain(cuda_device, dtype, m, k, o):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, q, scale, bias = _int8_operands(cuda_device, dtype, m, k, o, m + k)
    for b in (bias, None):
        for relu in (False, True):
            n0 = int8_gemm.KERNEL.launches
            got = int8_gemm.int8_gemm_rescale(x, q, scale, b, relu)
            torch.cuda.synchronize()
            assert int8_gemm.KERNEL.launches == n0 + 1
            assert got.dtype == dtype and got.shape == (m, o)
            ref = int8_gemm.int8_gemm_plain(x, q, scale, b, relu)
            _close(got, ref, INT8_TOL[dtype], f"int8 {m}x{k}x{o} bias "
                   f"{b is not None} relu {relu}")


@pytest.mark.cuda
@pytest.mark.parametrize("o", [8, 32, 40, 64, 1000])
@pytest.mark.parametrize("k", [16, 64, 832, 1024])
@pytest.mark.parametrize("m", [1, 7, 129, 4096])
def test_cuda_int8_gemm_wgmma_matches_plain(cuda_device, m, k, o):
    """K7's bf16 main path either side of a 128-row tile, at one 64-deep
    slice and at GoogLeNet's deepest K, at tile widths 32 and 64 and the
    classifier's ragged O, with and without bias and relu."""
    x, q, scale, bias = _int8_operands(cuda_device, torch.bfloat16, m, k, o,
                                       m * 7 + k + o)
    assert int8_gemm.takes_wgmma(x, q)
    for b in (bias, None):
        for relu in (False, True):
            before = dict(int8_gemm.KERNEL.by_symbol)
            got = int8_gemm.int8_gemm_rescale(x, q, scale, b, relu)
            torch.cuda.synchronize()
            assert _symbols_since(int8_gemm.KERNEL, before) == {
                int8_gemm.WGMMA: 1}
            assert got.dtype == torch.bfloat16 and got.shape == (m, o)
            ref = int8_gemm.int8_gemm_plain(x, q, scale, b, relu)
            _close(got, ref, INT8_TOL[torch.bfloat16],
                   f"int8 wgmma {m}x{k}x{o} bias {b is not None} relu {relu}")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,o", [(300, 4096, 72), (20000, 2304, 200),
                                   (500, 4096, 24)])
def test_cuda_int8_gemm_wgmma_long_k_in_chunks(cuda_device, m, k, o):
    """A K whose B panel does not fit beside the ring (past 1152 at tile
    width 64, 2432 at 32): the panel is converted in chunks of slices
    per tile."""
    x, q, scale, bias = _int8_operands(cuda_device, torch.bfloat16, m, k, o,
                                       k)
    before = dict(int8_gemm.KERNEL.by_symbol)
    got = int8_gemm.int8_gemm_rescale(x, q, scale, bias, True)
    torch.cuda.synchronize()
    assert _symbols_since(int8_gemm.KERNEL, before) == {int8_gemm.WGMMA: 1}
    _close(got, int8_gemm.int8_gemm_plain(x, q, scale, bias, True),
           INT8_TOL[torch.bfloat16], f"int8 wgmma {m}x{k}x{o}")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,o,splits", [
    (128, 1024, 1000, 1), (128, 1024, 1000, 2), (128, 1024, 1000, 3),
    (128, 1024, 1000, 4), (128, 1024, 1000, 8), (7, 1024, 40, 5),
    (300, 192, 32, 3), (6272, 832, 128, 2),
])
def test_cuda_int8_gemm_split_k_matches_plain(cuda_device, m, k, o, splits):
    """K7's main path with K cut into ``splits`` parts (one to eight),
    with and without bias and relu: within the bf16
    tolerance of the plain version, and the same bits on a second call
    (the parts are added in a fixed order)."""
    x, q, scale, bias = _int8_operands(cuda_device, torch.bfloat16, m, k, o,
                                       m + k + splits)
    for b in (bias, None):
        for relu in (False, True):
            before = dict(int8_gemm.KERNEL.by_symbol)
            got = int8_gemm.launch(int8_gemm.WGMMA, x, q, scale, b, relu,
                                   splits)
            again = int8_gemm.launch(int8_gemm.WGMMA, x, q, scale, b, relu,
                                     splits)
            torch.cuda.synchronize()
            assert _symbols_since(int8_gemm.KERNEL, before) == {
                int8_gemm.WGMMA: 2}
            assert torch.equal(got, again)
            _close(got, int8_gemm.int8_gemm_plain(x, q, scale, b, relu),
                   INT8_TOL[torch.bfloat16],
                   f"int8 {m}x{k}x{o} in {splits} splits")


@pytest.mark.cuda
def test_cuda_int8_gemm_split_k_past_the_slices_raises(cuda_device):
    """More parts than 64-deep K slices, or than ``SPLIT_MAX``, is
    refused by the C entry."""
    from cxxnet_tpu_torch.ops._build import KernelError

    x, q, scale, bias = _int8_operands(cuda_device, torch.bfloat16, 128, 128,
                                       64, 1)
    with pytest.raises(KernelError):
        int8_gemm.launch(int8_gemm.WGMMA, x, q, scale, bias, False, 3)
    x, q, scale, bias = _int8_operands(cuda_device, torch.bfloat16, 128, 1024,
                                       64, 2)
    with pytest.raises(KernelError):
        int8_gemm.launch(int8_gemm.WGMMA, x, q, scale, bias, False,
                         int8_gemm.SPLIT_MAX + 1)


@pytest.mark.cuda
def test_cuda_int8_gemm_edge_rule(cuda_device):
    """K 24, O 36, and X or q views off 16-byte alignment take the
    mma.sync edge kernel; the aligned operands of the same shape take
    the wgmma kernel; all agree with the plain version."""
    def take(x, q, scale, bias, want):
        before = dict(int8_gemm.KERNEL.by_symbol)
        got = int8_gemm.int8_gemm_rescale(x, q, scale, bias, True)
        torch.cuda.synchronize()
        assert _symbols_since(int8_gemm.KERNEL, before) == {want: 1}
        _close(got, int8_gemm.int8_gemm_plain(x, q, scale, bias, True),
               INT8_TOL[torch.bfloat16], f"int8 {tuple(x.shape)} {want}")

    take(*_int8_operands(cuda_device, torch.bfloat16, 300, 24, 64, 1),
         int8_gemm.EDGE)
    take(*_int8_operands(cuda_device, torch.bfloat16, 300, 64, 36, 2),
         int8_gemm.EDGE)
    m, k, o = 300, 192, 64
    x, q, scale, bias = _int8_operands(cuda_device, torch.bfloat16, m + 1,
                                       k, o, 3)
    flat = x.reshape(-1)
    off = flat[1:1 + m * k].view(m, k)
    assert off.data_ptr() % 16 == 2
    take(off, q, scale, bias, int8_gemm.EDGE)
    take(flat[8:8 + m * k].view(m, k), q, scale, bias, int8_gemm.WGMMA)
    qbuf = torch.zeros(o * k + 16, dtype=torch.int8, device=cuda_device)
    qoff = qbuf[8:8 + o * k].view(o, k)
    qoff.copy_(q)
    take(x[:m], qoff, scale, bias, int8_gemm.EDGE)
    take(x[:m], q, scale, bias, int8_gemm.WGMMA)


@pytest.mark.cuda
def test_cuda_int8_gemm_refuses_what_the_kernel_does_not_take(cuda_device):
    x, q, scale, bias = _int8_operands(cuda_device, torch.float32, 8, 16,
                                       4, 0)
    with pytest.raises(TypeError):
        int8_gemm.int8_gemm_rescale(x.half(), q, scale)
    with pytest.raises(TypeError):
        int8_gemm.int8_gemm_rescale(x, q.float(), scale)
    with pytest.raises(TypeError):
        int8_gemm.int8_gemm_rescale(x, q, scale.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        int8_gemm.int8_gemm_rescale(x.t().contiguous().t(), q, scale)
    with pytest.raises(ValueError, match="CUDA"):
        int8_gemm.int8_gemm_rescale(x, q.cpu(), scale)
    with pytest.raises(ValueError, match="entries"):
        int8_gemm.int8_gemm_rescale(x, q, scale, bias[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantized_layers_launch_k7(cuda_device, dtype):
    """A 1x1 conv (strided too) and a 2-D fullc run K7 on the card and
    agree with the same layers on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(1, 1, 24, 16, generator=gen)
    q, s = opsq.quantize_weight(w.numpy(), 3)
    lp = opsq.prepare_q({opsq.QKEY: torch.from_numpy(q),
                         opsq.SKEY: torch.from_numpy(s),
                         "bias": torch.randn(16, generator=gen)})
    x = torch.randn(2, 9, 9, 24, generator=gen)
    for stride in (1, 2):
        ref = opsq.conv_apply_q(lp, x.to(dtype), stride, 0, 0)
        card = {t: v.to(cuda_device) for t, v in lp.items()}
        n0 = int8_gemm.KERNEL.launches
        got = opsq.conv_apply_q(card, x.to(cuda_device, dtype), stride, 0, 0)
        torch.cuda.synchronize()
        assert int8_gemm.KERNEL.launches == n0 + 1
        _close(got.cpu(), ref, INT8_TOL[dtype], f"1x1 conv stride {stride}")
    fq = {opsq.QKEY: torch.from_numpy(q.reshape(24, 16).T.copy()),
          opsq.SKEY: torch.from_numpy(s)}
    ref = opsq.fc_apply_q(fq, x.reshape(-1, 24).to(dtype))
    got = opsq.fc_apply_q({t: v.to(cuda_device) for t, v in fq.items()},
                          x.reshape(-1, 24).to(cuda_device, dtype))
    _close(got.cpu(), ref, INT8_TOL[dtype], "fullc")


@pytest.mark.cuda
# GoogLeNet's K and O (the tile picker takes widths 192, 160, 224 and 128
# there), and O 256 (width 256)
@pytest.mark.parametrize("k,o", [(192, 176), (528, 296), (528, 448),
                                 (832, 624), (832, 256)])
@pytest.mark.parametrize("m", [1, 127, 129, 6272])
def test_cuda_conv_block_wgmma_matches_plain(cuda_device, m, k, o):
    gen = torch.Generator().manual_seed(m + k + o)
    x = torch.randn(m, k, generator=gen).to(cuda_device, torch.bfloat16)
    w = (torch.randn(k, o, generator=gen) / k ** 0.5).to(
        cuda_device, torch.bfloat16)
    b = torch.randn(o, generator=gen).to(cuda_device, torch.bfloat16)
    for bias in (b, None):
        for relu in (False, True):
            n0 = dict(conv_block.KERNEL.by_symbol)
            got = conv_block.conv_block_gemm(x, w, bias, relu)
            torch.cuda.synchronize()
            by = conv_block.KERNEL.by_symbol
            assert by.get(conv_block.WGMMA, 0) == n0.get(conv_block.WGMMA,
                                                         0) + 1
            assert by.get(conv_block.EDGE, 0) == n0.get(conv_block.EDGE, 0)
            ref = conv_block.conv_block_plain(x, w, bias, relu)
            torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                                       atol=2e-2)
            if relu:
                assert bool((got >= 0).all())


@pytest.mark.cuda
def test_cuda_conv_block_edge_rule(cuda_device):
    """K 17, and an X view 2 bytes off 16-byte alignment, take the
    mma.sync edge kernel; the aligned view of the same rows takes the
    wgmma kernel.  Both agree with the plain version."""
    gen = torch.Generator().manual_seed(3)

    def take(x, w, b, want):
        n0 = dict(conv_block.KERNEL.by_symbol)
        got = conv_block.conv_block_gemm(x, w, b, True)
        torch.cuda.synchronize()
        took = {n: c - n0.get(n, 0) for n, c in
                conv_block.KERNEL.by_symbol.items() if c != n0.get(n, 0)}
        assert took == {want: 1}
        torch.testing.assert_close(
            got.float(), conv_block.conv_block_plain(x, w, b, True).float(),
            rtol=2e-2, atol=2e-2)

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            cuda_device, torch.bfloat16)

    take(bf16(300, 17), bf16(17, 64, scale=0.25), bf16(64), conv_block.EDGE)
    m, k, o = 300, 192, 176
    buf = bf16(m * k + 8)
    w, b = bf16(k, o, scale=k ** -0.5), bf16(o)
    off = buf[1:1 + m * k].view(m, k)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    take(off, w, b, conv_block.EDGE)
    take(buf[8:8 + m * k].view(m, k), w, b, conv_block.WGMMA)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [6, update_step.MAX_TENSORS + 3])
def test_cuda_sgd_update_multi_bit_equal_to_plain(cuda_device, count):
    gen = torch.Generator().manual_seed(count)
    sizes = [(1, 7, 257, 100003, 4096, 12)[i % 6] for i in range(count)]
    ws, gs, ms, hyper = [], [], [], []
    for i, n in enumerate(sizes):
        w, g, m = (torch.randn(n + 1, generator=gen).to(cuda_device)
                   for _ in range(3))
        clip = (0.0, 0.5, 1.5)[i % 3]
        g[::5] = float("nan")
        if clip == 0.0:
            g = torch.nan_to_num(g)  # no NaN guard without a clip
        # every fourth tensor an offset view: 4 bytes off 16, scalar path
        sl = slice(1, n + 1) if i % 4 == 3 else slice(0, n)
        ws.append(w[sl])
        gs.append(g[sl].contiguous() if i % 8 == 7 else g[sl])
        ms.append(m[sl])
        hyper.append((0.01 * (1 + i % 5), 0.9, 2e-4 * (i % 2), clip))
    ws2, ms2 = [w.clone() for w in ws], [m.clone() for m in ms]
    n0 = update_step.KERNEL.launches
    update_step.sgd_update_multi(ws, gs, ms, *zip(*hyper))
    torch.cuda.synchronize()
    assert update_step.KERNEL.launches == n0 + -(-count //
                                                update_step.MAX_TENSORS)
    for w, g, m, h, w2, m2 in zip(ws, gs, ms, hyper, ws2, ms2):
        update_step.sgd_update_plain(w2, g, m2, *h)
        assert torch.equal(w, w2) and torch.equal(m, m2)
        assert bool(torch.isfinite(w).all())


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [8, 128])
def test_cuda_attention_outside_the_kernel_head_dims(cuda_device, head_dim):
    torch.backends.cuda.matmul.allow_tf32 = False
    nhead, t = 2, 40
    d = nhead * head_dim
    gen = torch.Generator().manual_seed(head_dim)
    params = {"wmat": torch.randn(3 * d, d, generator=gen) * d ** -0.5,
              "bias": torch.randn(3 * d, generator=gen) * 0.1,
              "wproj": torch.randn(d, d, generator=gen) * d ** -0.5,
              "bproj": torch.randn(d, generator=gen) * 0.1}
    x = torch.randn(2, t, d, generator=gen)
    g = torch.randn(2, t, d, generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        lay = create_layer("attention")
        for k, v in (("nhead", nhead), ("causal", 1), ("attn_impl", "auto")):
            lay.set_param(k, str(v))
        p = {k: v.to(dev, copy=True).requires_grad_(True)
             for k, v in params.items()}
        xt = x.to(dev, copy=True).requires_grad_(True)
        n0 = flash.FWD_KERNEL.launches + flash.BWD_KERNEL.launches
        y = lay.apply(p, [xt])[0]
        y.backward(g.to(dev))
        torch.cuda.synchronize()
        assert flash.FWD_KERNEL.launches + flash.BWD_KERNEL.launches == n0
        out[str(dev)] = [y.detach().cpu(), xt.grad.cpu()] + [
            p[k].grad.cpu() for k in sorted(p)]
        if dev != "cpu":
            lay.set_param("attn_impl", "pallas")
            with pytest.raises(NotImplementedError, match=str(head_dim)):
                lay.apply(p, [xt])
    for got, ref in zip(out[str(cuda_device)], out["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# ResNet-50's sibling groups at batch 2: (H, C, O, stride)
RESNET_GROUPS = [(56, 64, 320, 1), (56, 256, 640, 2), (28, 512, 1280, 2),
                 (14, 1024, 2560, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,c,o,stride", RESNET_GROUPS)
def test_cuda_resnet_group_wgmma_and_strided_grad(cuda_device, h, c, o,
                                                  stride):
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(h + c)
    x = torch.randn(2, h, h, c, generator=gen).to(cuda_device,
                                                  torch.bfloat16)
    w = (torch.randn(c, o, generator=gen) / c ** 0.5).to(cuda_device,
                                                        torch.bfloat16)
    g = torch.randn(2, -(-h // stride), -(-h // stride), o,
                    generator=gen).to(cuda_device, torch.bfloat16)
    xk = x.clone().requires_grad_(True)
    n0 = dict(conv_block.KERNEL.by_symbol)
    y = conv_block.conv1x1_block(xk, w, None, stride=stride)
    torch.cuda.synchronize()
    took = {n: v - n0.get(n, 0) for n, v in
            conv_block.KERNEL.by_symbol.items() if v != n0.get(n, 0)}
    assert took == {conv_block.WGMMA: 1}
    y.backward(g)
    xr = x.float().requires_grad_(True)
    yr = F.conv2d(xr.permute(0, 3, 1, 2), w.float().t()[:, :, None, None],
                  stride=stride).permute(0, 2, 3, 1)
    yr.backward(g.float())
    scale = yr.abs().max()
    assert (y.float() - yr).abs().max() <= 2e-2 * scale
    dx = xk.grad.float()
    on = dx[:, ::stride, ::stride]
    assert (on - xr.grad[:, ::stride, ::stride]).abs().max() <= (
        2e-2 * xr.grad.abs().max())
    off = dx.clone()
    off[:, ::stride, ::stride] = 0
    assert not bool(off.any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stats", ["twopass", "onepass"])
def test_cuda_batch_norm_matches_cpu(cuda_device, stats, dtype):
    lay = create_layer("batch_norm")
    lay.set_param("bn_stats", stats)
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn(8, 14, 14, 64, generator=gen) * 3 + 1).to(dtype)
    p = {"wmat": torch.rand(64, generator=gen) + 0.5,
         "bias": torch.randn(64, generator=gen)}
    g = torch.randn(x.shape, generator=gen).to(dtype)
    out = {}
    for dev in ("cpu", cuda_device):
        xs = x.to(dev).detach().requires_grad_(True)
        ps = {k: v.to(dev).detach().requires_grad_(True)
              for k, v in p.items()}
        (y,) = lay.apply(lay.prepare(ps, dtype), [xs], train=True)
        y.backward(g.to(dev))
        out[str(dev)[:3]] = [t.float().cpu() for t in
                             (y, xs.grad, ps["wmat"].grad, ps["bias"].grad)]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, ref in zip(out["cud"], out["cpu"]):
        assert (got - ref).abs().max() <= tol * ref.abs().max()


def _bottleneck_conf(bn_eval):
    from cxxnet_tpu_torch.models.builders import _res_bottleneck

    return (
        "netconfig = start\n"
        "layer[0->c1] = conv:conv1\n  kernel_size = 3\n  pad = 1\n"
        "  nchannel = 16\n  no_bias = 1\n  random_type = kaiming\n"
        "layer[c1->b1] = batch_norm:bn1\nlayer[b1->b1] = relu\n"
        "layer[b1->p1] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        + _res_bottleneck("p1", "s0b0", 16, 8, 32, 1)
        + _res_bottleneck("s0b0", "s1b0", 32, 16, 64, 2)
        + "layer[s1b0->pool] = avg_pooling\n  kernel_size = 4\n"
        "  stride = 1\nlayer[pool->flat] = flatten\n"
        "layer[flat->fc] = fullc:fc\n  nhidden = 10\n"
        "layer[fc->fc] = softmax\nnetconfig = end\n"
        "input_shape = 3,16,16\nbatch_size = 16\nupdater = sgd\n"
        "eta = 0.1\nmomentum = 0.9\nwd = 0.0005\nbn_stats = onepass\n"
        f"bn_eval = {bn_eval}\ncompute_dtype = float32\nseed = 5\n")


@pytest.mark.cuda
@pytest.mark.parametrize("bn_eval", ["batch", "running"])
def test_cuda_bottleneck_step_matches_cpu(cuda_device, bn_eval, tmp_path):
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = cfgmod.parse_pairs(_bottleneck_conf(bn_eval))
    src = NetTrainer()
    src.set_params(conf + [("dev", "cpu")])
    src.init_model()
    path = str(tmp_path / "0000.model")
    src.save_model(path)
    rng = np.random.RandomState(3)
    x = rng.randn(16, 16, 16, 3).astype(np.float32)
    y = rng.randint(0, 10, (16, 1)).astype(np.float32)
    trs = {}
    for dev in ("cpu", "gpu"):
        tr = NetTrainer()
        tr.set_params(conf + [("dev", dev)])
        tr.load_model(path)
        tr.update_all(x, y)
        trs[dev] = tr
    cpu, card = trs["cpu"], trs["gpu"]
    for key, tags in src.params.items():
        for tag, w0 in tags.items():
            d_cpu = cpu.params[key][tag] - w0
            d_card = card.params[key][tag].cpu() - w0
            assert ((d_card - d_cpu).abs().max()
                    <= 1e-3 * d_cpu.abs().max()), (key, tag)
    assert len(card.aux) == (9 if bn_eval == "running" else 0)
    for key, tags in cpu.aux.items():
        for tag, a in tags.items():
            assert ((card.aux[key][tag].cpu() - a).abs().max()
                    <= 1e-5 * a.abs().max()), (key, tag)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nag", "rmsprop", "adagrad", "lars",
                                  "lamb"])
def test_cuda_new_updaters_match_cpu(cuda_device, name):
    from cxxnet_tpu_torch.updater import create_updater

    gen = torch.Generator().manual_seed(11)
    w = torch.randn(64, 3, 3, 32, generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        up = create_updater(name, "wmat")
        for k, v in (("lr", "0.05"), ("wd", "0.001"),
                     ("clip_gradient", "1.0")):
            up.set_param(k, v)
        wd = w.clone().to(dev)
        st = up.init_state(wd)
        g_gen = torch.Generator().manual_seed(12)
        for epoch in range(3):
            g = torch.randn(w.shape, generator=g_gen).to(dev)
            up.apply(wd, g, st, epoch)
        out[str(dev)[:3]] = [wd.cpu()] + [v.cpu() for v in st.values()]
    for got, ref in zip(out["cud"], out["cpu"]):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# ----------------------------------------------------------------------
# the MNIST nets: K1 and K2 at their pools, K8 under update_period

# (x, k, s): MNIST_CONV.conf's pool (7x7 out, its last window partial)
# and digits_conv.conf's two (4x4 and 2x2 out)
MNIST_POOLS = [((100, 14, 14, 32), 3, 2), ((50, 8, 8, 32), 2, 2),
               ((50, 4, 4, 64), 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,s", MNIST_POOLS)
def test_cuda_maxpool_at_the_mnist_pools(cuda_device, shape, k, s, dtype):
    """K1 and K2 take their channel-vector entries at the MNIST nets'
    pools and are bit-equal to their plain versions (relu zeros: ties)."""
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=gen).clamp_min(0).to(cuda_device,
                                                            dtype)
    fwd0 = dict(maxpool.KERNEL.by_symbol)
    y = maxpool.maxpool_fwd(x, k, k, s)
    assert {n: c - fwd0.get(n, 0) for n, c in maxpool.KERNEL.by_symbol.items()
            if c != fwd0.get(n, 0)} == {f"maxpool_fwd_{sfx}": 1}
    assert torch.equal(y, maxpool.maxpool_plain(x, k, k, s))
    g = torch.randn(y.shape, generator=gen).to(cuda_device, dtype)
    bwd0 = dict(maxpool.BWD_KERNEL.by_symbol)
    dx = maxpool.maxpool_bwd(x, y, g, k, k, s)
    assert {n: c - bwd0.get(n, 0)
            for n, c in maxpool.BWD_KERNEL.by_symbol.items()
            if c != bwd0.get(n, 0)} == {f"maxpool_bwd_{sfx}": 1}
    assert torch.equal(dx, maxpool.maxpool_bwd_plain(x, y, g, k, k, s))


PERIOD_CONF = """
netconfig = start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 32
  init_sigma = 0.1
layer[1->1] = relu
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc1
  nhidden = 10
  init_sigma = 0.1
layer[4->4] = softmax
netconfig = end
input_shape = 1,14,14
batch_size = 20
update_period = 2
eta = 0.1
momentum = 0.9
wd = 0.0001
"""


@pytest.mark.cuda
def test_cuda_update_period_two_matches_cpu(cuda_device, tmp_path):
    """``update_period = 2`` on the card: K8 once per two micro-batches
    over the summed f32 gradients, the weights within 1e-5 of each
    tensor's largest CPU weight (f32, TF32 off) after four."""
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = cfgmod.parse_pairs(PERIOD_CONF)
    src = NetTrainer()
    src.set_params(conf + [("dev", "cpu")])
    src.init_model()
    path = str(tmp_path / "0000.model")
    src.save_model(path)
    trs = {}
    for dev in ("cpu", "gpu"):
        tr = NetTrainer()
        tr.set_params(conf + [("dev", dev)])
        tr.load_model(path)
        trs[dev] = tr
    rng = np.random.RandomState(5)
    launches = []
    for _ in range(4):
        x = rng.rand(20, 14, 14, 1).astype(np.float32)
        y = rng.randint(0, 10, (20, 1)).astype(np.float32)
        n0 = update_step.KERNEL.launches
        for tr in trs.values():
            tr.update_all(x, y)
        launches.append(update_step.KERNEL.launches - n0)
    assert launches == [0, 1, 0, 1]
    assert trs["gpu"].epoch_counter == trs["cpu"].epoch_counter == 2
    for key, tags in trs["cpu"].params.items():
        for tag, w in tags.items():
            got = trs["gpu"].params[key][tag].cpu()
            assert (got - w).abs().max() <= 1e-5 * w.abs().max(), (key, tag)


def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return saved


def _restore_tf32(saved):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


# bf16: a rewrite's error against the f32 direct conv within this many
# times the bf16 direct conv's, plus 1e-3 of max(1, the largest output)
# (tests/test_layers.py:578 for Winograd; s2d sums the same products in
# another order)
BF16_REWRITE_FACTOR = {"conv_s2d": 2.0, "1": 25.0, "2": 3.0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg,uses", [
    ((("kernel_size", "7"), ("stride", "2"), ("pad", "3"),
      ("conv_s2d", "1")), "conv_s2d"),
    ((("kernel_size", "3"), ("pad", "1"), ("conv_wino", "1")), "conv_wino"),
    ((("kernel_size", "3"), ("pad", "1"), ("conv_wino", "2")), "conv_wino"),
])
def test_cuda_conv_rewrites_match_cpu(cuda_device, cfg, uses, dtype):
    """f32 (TF32 off): the card against the CPU, forward and gradients,
    within 1e-5 of each tensor's largest.  bf16 on the card: the
    rewrite's forward error against the f32 direct conv within the
    bf16 profile above."""
    from cxxnet_tpu_torch.layers import conv as tconv

    lay = create_layer("conv")
    for k, v in cfg + (("nchannel", "24"),):
        lay.set_param(k, v)
    gen = torch.Generator().manual_seed(3)
    shape = (4, 30, 29, 16)
    lay.infer_shape([shape])
    p = {t: torch.randn(v.shape, generator=gen) * 0.2
         for t, v in lay.init_params(gen, [shape]).items()}
    x = torch.randn(shape, generator=gen)
    g = torch.randn((4,) + tuple(lay.infer_shape([shape])[0][1:]),
                    generator=gen)

    def run(dev, dt, how=uses):
        xs = x.to(dev, dt).detach().requires_grad_(True)
        ps = {k: v.to(dev).detach().requires_grad_(True)
              for k, v in p.items()}
        lay.conv_s2d = int(dict(cfg).get("conv_s2d", 0)) if how else 0
        lay.conv_wino = int(dict(cfg).get("conv_wino", 0)) if how else 0
        tconv.REWRITE_USES.clear()
        (y,) = lay.apply(lay.prepare(ps, dt), [xs])
        assert tconv.REWRITE_USES == ({how: 1} if how else {})
        y.backward(g.to(dev, dt))
        return [t.detach().float().cpu() for t in
                (y, xs.grad, ps["wmat"].grad, ps["bias"].grad)]

    saved = _no_tf32()
    try:
        if dtype == torch.float32:
            for got, ref in zip(run(cuda_device, dtype), run("cpu", dtype)):
                assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
            return
        ref = run(cuda_device, torch.float32, how="")[0]
        e_direct = (run(cuda_device, dtype, how="")[0] - ref).abs().max()
        e_rewrite = (run(cuda_device, dtype)[0] - ref).abs().max()
    finally:
        _restore_tf32(saved)
    factor = BF16_REWRITE_FACTOR[dict(cfg).get("conv_wino", "conv_s2d")]
    scale = max(1.0, float(ref.abs().max()))
    assert e_rewrite <= factor * e_direct + 1e-3 * scale, (
        float(e_rewrite), float(e_direct))


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,shape", [
    ("prelu", (("random", "0.3"),), (8, 12, 11, 16)),
    ("insanity", (("lb", "3"), ("ub", "8")), (8, 12, 11, 16)),
    ("insanity_max_pooling", (("kernel_size", "3"), ("stride", "2"),
                              ("keep", "0.7")), (8, 12, 11, 16)),
])
def test_cuda_random_layers_match_their_formula(cuda_device, name, cfg,
                                                shape):
    lay = create_layer(name)
    for k, v in cfg:
        lay.set_param(k, v)
    lay.infer_shape([shape])
    params = {t: (v + 0.1).to(cuda_device) for t, v in
              lay.init_params(torch.Generator(), [shape]).items()}
    x = torch.randn(shape, device=cuda_device)
    got = lay.apply(params, [x], train=True, gen=torch.Generator(
        device=cuda_device).manual_seed(11))[0]
    u = torch.rand(shape, device=cuda_device,
                   generator=torch.Generator(device=cuda_device)
                   .manual_seed(11))
    if name == "prelu":
        mask = torch.clamp(params["bias"] * (1 + (2 * u - 1) * 0.3), 0, 1)
        ref = torch.where(x > 0, x, x * mask)
    elif name == "insanity":
        ref = torch.where(x > 0, x, x / (u * 5.0 + 3.0))
    else:
        h, w = shape[1], shape[2]
        i = torch.arange(h, device=cuda_device)
        j = torch.arange(w, device=cuda_device)
        nb = [x[:, (i - 1).clamp(min=0)], x[:, (i + 1).clamp(max=h - 1)],
              x[:, :, (j - 1).clamp(min=0)], x[:, :, (j + 1).clamp(max=w - 1)]]
        d = (1.0 - 0.7) / 4.0
        xj = nb[3]
        for k in range(2, -1, -1):
            xj = torch.where(u < 0.7 + (k + 1) * d, nb[k], xj)
        xj = torch.where(u < 0.7, x, xj)
        ref = maxpool.maxpool_plain(xj, 3, 3, 2)
    assert torch.equal(got, ref)
    assert not torch.equal(got, lay.apply(params, [x])[0])


SIDE_CUDA = """
extra_data_num = 1
extra_data_shape[0] = 1,1,2
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 8
layer[1->1] = xelu
layer[1->2] = torch:t1
  torch_op = "torch.nn.Conv2d(8, 8, 3, padding=1)"
layer[2->3] = max_pooling
  kernel_size = 2
  stride = 2
layer[3->4] = flatten
layer[in_1->5] = fixconn:fx
  nhidden = 3
  fixconn_weight = {fix}
layer[5->5] = bias
layer[5->5] = softplus
layer[4,5->6] = concat
layer[6->7] = fullc:fc
  nhidden = 4
layer[7->7] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 4
eta = 0.1
momentum = 0.9
compute_dtype = float32
seed = 3
"""


@pytest.mark.cuda
def test_cuda_side_input_net_step_matches_cpu(cuda_device, tmp_path):
    import numpy as np

    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    (tmp_path / "fix.txt").write_text("3 2 3\n0 0 1.5\n1 1 -0.5\n2 0 2\n")
    conf = SIDE_CUDA.format(fix=tmp_path / "fix.txt")
    rs = np.random.RandomState(0)
    batch = DataBatch(data=rs.randn(4, 8, 8, 3).astype(np.float32),
                      label=rs.randint(0, 4, (4, 1)).astype(np.float32),
                      extra_data=[rs.randn(4, 2).astype(np.float32)])
    init = NetTrainer()
    init.set_params(tcfg.parse_pairs(conf) + [("dev", "cpu")])
    init.init_model()
    init.save_model(str(tmp_path / "0.model"))
    saved = _no_tf32()
    trainers = {}
    try:
        for dev in ("cpu", "gpu"):
            tr = NetTrainer()
            tr.set_params(tcfg.parse_pairs(conf) + [("dev", dev)])
            tr.load_model(str(tmp_path / "0.model"))
            tr.update(batch)
            trainers[dev] = tr
    finally:
        _restore_tf32(saved)
    for key, tags in init.params.items():
        for tag, w0 in tags.items():
            ref = trainers["cpu"].params[key][tag] - w0
            got = trainers["gpu"].params[key][tag].cpu() - w0
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max(), key


WRAP_NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 16
  pad = 1
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = relu
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 10
layer[5->5] = softmax
netconfig = end
input_shape = 3,16,16
batch_size = 32
eta = 0.01
"""


@pytest.mark.cuda
def test_cuda_wrapper_and_c_abi_predict_equal_trainer_predict(cuda_device,
                                                              tmp_path):
    import ctypes

    import numpy as np

    from cxxnet_tpu_torch import wrapper
    from cxxnet_tpu_torch.ops import _build

    net = wrapper.Net(dev="gpu", cfg=WRAP_NET)
    net.init_model()
    rs = np.random.RandomState(0)
    x = rs.randn(20, 16, 16, 3).astype(np.float32)
    net.update(rs.randn(32, 16, 16, 3).astype(np.float32),
               rs.randint(0, 10, 32).astype(np.float32))
    ref = net.trainer.predict(np.concatenate(
        [x, np.zeros((12, 16, 16, 3), np.float32)]))[:20]
    n0 = maxpool.KERNEL.launches
    got = net.predict(x)  # bucket 32: the same batch shape as ref's
    assert maxpool.KERNEL.launches == n0 + 1
    np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / "w.model")
    net.save_model(path)
    (tmp_path / "net.conf").write_text(WRAP_NET)
    lib = ctypes.CDLL(_build.build_host("libcxxnet_capi"))
    lib.CXNNetCreate.restype = ctypes.c_void_p
    lib.CXNNetCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.CXNNetLoadModel.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.CXNNetPredictBatch.restype = ctypes.POINTER(ctypes.c_float)
    lib.CXNNetPredictBatch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint * 4, ctypes.POINTER(ctypes.c_uint)]
    lib.CXNNetFree.argtypes = [ctypes.c_void_p]
    lib.CXNGetLastError.restype = ctypes.c_char_p
    h = lib.CXNNetCreate(b"gpu", WRAP_NET.encode())
    assert h, lib.CXNGetLastError()
    assert lib.CXNNetLoadModel(h, path.encode()) == 0, lib.CXNGetLastError()
    shape = (ctypes.c_uint * 4)(*x.shape)
    n = ctypes.c_uint()
    out = lib.CXNNetPredictBatch(
        h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), shape,
        ctypes.byref(n))
    assert out, lib.CXNGetLastError()
    np.testing.assert_array_equal(np.ctypeslib.as_array(out, (n.value,)),
                                  ref)
    lib.CXNNetFree(h)


@pytest.mark.cuda
def test_cuda_memory_series_equal_memory_stats(cuda_device):
    from cxxnet_tpu_torch import obs
    from cxxnet_tpu_torch.obs import device as obs_device

    keep = torch.randn(1 << 20, device=cuda_device)
    obs_device.register_memory_collector()
    text = obs.registry().render_prometheus()
    stats = torch.cuda.memory_stats(0)
    got = {}
    for line in text.splitlines():
        if line.startswith("xla_device_memory_bytes{"):
            key, val = line.rsplit(" ", 1)
            got[key] = float(val)
    want = {
        'xla_device_memory_bytes{device="cuda:0",stat="bytes_in_use"}':
            stats["allocated_bytes.all.current"],
        'xla_device_memory_bytes{device="cuda:0",stat="peak_bytes_in_use"}':
            stats["allocated_bytes.all.peak"],
        'xla_device_memory_bytes{device="cuda:0",stat="bytes_limit"}':
            torch.cuda.get_device_properties(0).total_memory,
    }
    assert {k: got[k] for k in want} == {k: float(v) for k, v in want.items()}
    del keep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_digest_equals_the_host_oracle(cuda_device, dtype):
    import numpy as np

    from cxxnet_tpu_torch.integrity import digest_array, digest_tensor

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    t = (torch.randn(1 << 20, 7, generator=gen, device=cuda_device)
         * 1e3).to(dtype)
    host = t.cpu()
    words = (host.view(torch.int16).numpy() if dtype == torch.bfloat16
             else host.numpy())
    assert digest_tensor(t) == digest_array(words)
    block = t[:3, :]
    index = (slice(1 << 30, (1 << 30) + 3), slice(0, 7))
    assert digest_tensor(block, index=index, shape=(1 << 31, 7)) == \
        digest_array(words[:3], index=index, shape=(1 << 31, 7))
    t.view(-1)[5:6].view(torch.int16 if dtype == torch.bfloat16
                         else torch.int32).bitwise_xor_(
        torch.tensor([4], dtype=torch.int16 if dtype == torch.bfloat16
                     else torch.int32, device=cuda_device))
    assert digest_tensor(t) != digest_array(words)
    assert np.array_equal(words, host.view(torch.int16).numpy()
                          if dtype == torch.bfloat16 else host.numpy())


SHADOW_NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 16
  init_sigma = 0.1
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = lrn
  local_size = 5
layer[3->4] = flatten
layer[4->4] = dropout
  threshold = 0.3
layer[4->5] = fullc:fc
  nhidden = 10
  init_sigma = 0.1
layer[5->5] = softmax
netconfig = end
input_shape = 3,16,16
batch_size = 32
updater = sgd
eta = 0.1
momentum = 0.9
compute_dtype = bfloat16
dev = gpu
seed = 2
"""


@pytest.mark.cuda
def test_cuda_shadow_step_is_bitwise_clean(cuda_device):
    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(SHADOW_NET))
    tr.init_model()
    k1 = maxpool.KERNEL.launches
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    for r in range(3):
        assert tr.shadow_step(r) is None
    assert maxpool.KERNEL.launches == k1 + 6  # one a leg
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == saved
    tr.set_param("inject_shadow_mismatch", "1")
    assert tr.shadow_step(3)["tensor"] == "loss"


@pytest.mark.cuda
def test_cuda_profiler_window_shows_the_kernel_symbol(cuda_device,
                                                      tmp_path):
    import json

    from cxxnet_tpu_torch.utils.profiler import TraceController

    x = torch.randn(8, 28, 28, 64, device=cuda_device).to(torch.bfloat16)
    maxpool.maxpool_fwd(x, 3, 3, 2, 0, 0)  # built and bound outside
    torch.cuda.synchronize()
    tc = TraceController()
    tc.configure([("profile", "1"), ("profile_dir", str(tmp_path)),
                  ("profile_start", "0"), ("profile_steps", "1")])
    tc.step(0)
    maxpool.maxpool_fwd(x, 3, 3, 2, 0, 0)
    tc.step(1)
    trace = json.load(open(tc.trace_path))
    kernels = [e["name"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    assert any("maxpool_fwd_vec_kernel" in n for n in kernels), kernels


class _Rows:
    """A fixed (data, label) set in whole batches of ``bs`` (the closed
    loop's replay and eval iterators)."""

    def __init__(self, x, y, bs):
        self.x, self.y, self.bs, self.pos, self.cur = x, y, bs, 0, None

    def before_first(self):
        self.pos = 0

    def next(self):
        from cxxnet_tpu_torch.io.data import DataBatch

        if self.pos + self.bs > len(self.x):
            return False
        sl = slice(self.pos, self.pos + self.bs)
        self.cur = DataBatch(data=self.x[sl], label=self.y[sl])
        self.pos += self.bs
        return True

    def value(self):
        return self.cur


@pytest.mark.cuda
def test_cuda_published_round_answers_equal_trainer_predict(cuda_device,
                                                            tmp_path):
    """One closed-loop cycle on the card: a bf16 net fine-tuned on
    feedback, published and hot-reloaded; the engine's answers at bucket
    32 bit-equal to ``trainer.predict`` of the published checkpoint."""
    import numpy as np

    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.loop import ContinuousLoop, FeedbackWriter
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import Engine
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    cfg = tcfg.parse_pairs(SHADOW_NET + "metric = error\n")
    mdir = str(tmp_path / "m")
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    tr.save_model(ckpt.publish_path(mdir, 0), round_=0)
    rs = np.random.RandomState(1)
    x = rs.randn(96, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, (96, 1)).astype(np.float32)
    eng = Engine(cfg=cfg, model_dir=mdir, max_batch_size=32,
                 batch_timeout_ms=0)
    w = FeedbackWriter(str(tmp_path / "fb"))
    try:
        loop = ContinuousLoop(eng, cfg, feedback_dir=w.dir,
                              base_iter=_Rows(x, y, 32),
                              eval_iter=_Rows(x[:64], y[:64], 32),
                              rounds_per_cycle=1, min_records=32,
                              publish_min_delta=-1.0, feedback_writer=w)
        w.append_batch(x[32:], y[32:])
        k1 = maxpool.KERNEL.launches
        assert loop.run_cycle() == "published" and eng.round == 1
        assert maxpool.KERNEL.launches > k1
        got = eng.scores(x[:32])
        ref = NetTrainer()
        ref.set_params(cfg)
        ref.load_model(ckpt.publish_path(mdir, 1))
        want = ref.predict_fn()(ref.params, ref.aux, x[:32], ()).cpu()
        np.testing.assert_array_equal(got, want.numpy())
    finally:
        w.close()
        eng.close()


@pytest.mark.cuda
def test_cuda_service_fed_step_equals_a_local_one(cuda_device, tmp_path):
    """A step on the card from a block the data service deals equals
    the step from the local chain's batch, bit for bit."""
    import numpy as np

    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.io.augment import ANCHOR_KEY
    from cxxnet_tpu_torch.io.data import create_iterator
    from cxxnet_tpu_torch.io.dataservice import DataServiceServer
    from cxxnet_tpu_torch.io.imgbin import BinPageWriter, encode_raw
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    rs = np.random.RandomState(3)
    path = str(tmp_path / "d")
    w = BinPageWriter(path + ".bin")
    with open(path + ".lst", "w") as f:
        for i in range(64):
            w.push(encode_raw(rs.randint(0, 255, (18, 18, 3)).astype(
                np.float32)))
            f.write(f"{i}\t{i % 10}\tr{i}\n")
    w.close()
    sec = [("iter", "imgbin"), ("image_bin", path + ".bin"),
           ("image_list", path + ".lst"), ("raw_pixels", "1"),
           ("rand_crop", "1"), ("rand_mirror", "1"), ("silent", "1")]
    glob = [("input_shape", "3,16,16"), ("batch_size", "32"),
            ("silent", "1")]
    srv = DataServiceServer(sec, glob, silent=True)
    srv.start()
    chains = [create_iterator(sec), create_iterator(
        [("iter", "service"), ("data_service_addr", f"127.0.0.1:{srv.port}")])]
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    weights = []
    try:
        for it in chains:
            for n, v in glob:
                it.set_param(n, v)
            it.init()
            it.set_param(ANCHOR_KEY, "1")
            it.before_first()
            assert it.next()
            tr = NetTrainer()
            tr.set_params(tcfg.parse_pairs(SHADOW_NET))
            tr.init_model()
            k8 = update_step.KERNEL.launches
            tr.update(it.value())
            assert update_step.KERNEL.launches == k8 + 1
            weights.append([tr.get_weight(n, t) for n in ("c1", "fc")
                            for t in ("wmat", "bias")])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
        for it in chains:
            it.close()
        srv.close()
    for a, b in zip(*weights):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_topk_under_tied_gates_matches_cpu(cuda_device, dtype):
    """``moe``'s exactly-k routing on the card: rows of tied gates (x = 0,
    and gates from a 3-value set) keep the same k experts as on the CPU,
    the lower index first; the layer's output matches the CPU's (f32
    within 1e-5, bf16 within 2e-2 of the largest)."""
    import numpy as np

    from cxxnet_tpu_torch.layers.sequence import topk_mask

    rng = np.random.RandomState(0)
    gate = torch.from_numpy(rng.choice([0.0, 0.25, 0.5], size=(4096, 8))
                            .astype(np.float32))
    for k in (1, 2, 3):
        cpu = topk_mask(gate, k)
        assert torch.equal(topk_mask(gate.to(cuda_device), k).cpu(), cpu)
        assert (cpu.sum(-1) == k).all()
    lay = create_layer("moe")
    for name, val in (("nexpert", "8"), ("nhidden", "16"), ("topk", "2")):
        lay.set_param(name, val)
    gen = torch.Generator().manual_seed(1)
    p = lay.init_params(gen, [(64, 32)])
    p["bias"] = torch.randn(p["bias"].shape, generator=gen)
    x = torch.zeros(3, 64, 32)
    x[1] = torch.randn(64, 32, generator=gen)
    outs = {}
    for dev in ("cpu", cuda_device):
        pd = lay.prepare({t: v.to(dev) for t, v in p.items()}, dtype)
        (outs[str(dev)],) = lay.apply(pd, [x.to(dev).to(dtype)])
    ref, got = outs["cpu"].float(), outs[str(cuda_device)].float().cpu()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got - ref).abs().max() <= tol * ref.abs().max()
    want = p["bias"][:2].mean(0).to(dtype).float()  # x = 0: experts 0, 1
    assert torch.allclose(got[0], want.expand(64, -1), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_remat_lm_matches_no_remat(cuda_device, tmp_path):
    """A small LM (T 64, d 64, 2 heads, 2 blocks, bf16, flash) trained 3
    steps on the card under ``remat = 1`` and ``= 0`` from one
    checkpoint: the weights equal within 1e-2 of each tensor's largest
    update (they read bit-equal where cuBLAS picks the same kernels),
    K9 launched twice per attention layer a step under remat and once
    without, K10 once either way."""
    import numpy as np

    from cxxnet_tpu_torch import config as cfgmod
    from cxxnet_tpu_torch.models import transformer_lm_conf
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    conf = cfgmod.parse_pairs(transformer_lm_conf(
        seq_len=64, dim=64, nhead=2, nlayer=2, batch_size=4, dev="gpu",
        compute_dtype="bfloat16", attn_impl="pallas"))
    src = NetTrainer()
    src.set_params(conf)
    src.init_model()
    path = str(tmp_path / "0000.model")
    src.save_model(path)
    w0 = {(k, t): v.detach().cpu().clone() for k, tags in src.params.items()
          for t, v in tags.items()}
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (4, 64)).astype(np.float32)
    y = rng.randint(0, 256, (4, 64)).astype(np.float32)
    out = {}
    for remat in ("0", "1"):
        tr = NetTrainer()
        tr.set_params(conf + [("remat", remat)])
        tr.load_model(path)
        n0, n1 = flash.FWD_KERNEL.launches, flash.BWD_KERNEL.launches
        for _ in range(3):
            tr.update_all(x, y)
        torch.cuda.synchronize()
        per = 2 if remat == "1" else 1
        assert (flash.FWD_KERNEL.launches - n0,
                flash.BWD_KERNEL.launches - n1) == (3 * 2 * per, 3 * 2)
        out[remat] = {(k, t): v.detach().cpu() for k, tags in
                      tr.params.items() for t, v in tags.items()}
    for kt, w in out["0"].items():
        d = (w - w0[kt]).abs().max()
        assert (out["1"][kt] - w).abs().max() <= 1e-2 * d, kt


_GLOO_RANK = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[3])
from cxxnet_tpu_torch.parallel import distributed as pdist
rank = int(sys.argv[2])
pdist.init_distributed(sys.argv[1], 2, rank, dev="gpu:0", timeout_s=60)
dev = torch.device("cuda:0")
t = torch.arange(6, dtype=torch.float32, device=dev) * (rank + 1)
s = pdist.all_reduce_(t.clone())
g = pdist.all_gather(t)
b = pdist.broadcast_(t.clone(), src=1)
assert s.device == dev and all(p.device == dev for p in g)
print(json.dumps({"sum": s.tolist(), "gather": [p.tolist() for p in g],
                  "bcast": b.tolist(), "backend": pdist.backend(),
                  "calls": pdist.STATS["calls"]}))
pdist.shutdown_distributed()
"""


@pytest.mark.cuda
def test_cuda_gloo_collectives_between_two_ranks_on_one_card(cuda_device,
                                                              tmp_path):
    import json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK, f"127.0.0.1:{port}", str(r),
         repo], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _err in outs]
    base = list(range(6))
    for g in got:
        assert g["backend"] == "gloo"
        assert g["sum"] == [3.0 * v for v in base]
        assert g["gather"] == [[1.0 * v for v in base],
                               [2.0 * v for v in base]]
        assert g["bcast"] == [2.0 * v for v in base]
        assert g["calls"] == 3


@pytest.mark.cuda
def test_cuda_gpu_k_is_card_k(cuda_device):
    from cxxnet_tpu_torch.nnet.trainer import resolve_device
    from cxxnet_tpu_torch.parallel.mesh import rank_device

    n = torch.cuda.device_count()
    for k in range(n):
        assert rank_device(f"gpu:{k}") == torch.device(f"cuda:{k}")
    assert resolve_device("tpu") == torch.device("cuda:0")
    with pytest.raises(ValueError,
                       match=rf"ordinals \[{n}\] but only {n} devices"):
        resolve_device(f"gpu:{n}")


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 3])
def test_cuda_k8_on_zero_slices_bit_equal_to_whole(cuda_device, ranks):
    from cxxnet_tpu_torch.parallel.mesh import MeshPlan

    shapes = [(7, 7, 192, 64), (1024, 832), (96,), (6, 10, 9), (5, 7)]
    gen = torch.Generator(device=cuda_device).manual_seed(ranks)
    whole = [[torch.randn(s, generator=gen, device=cuda_device)
              for _ in range(3)] for s in shapes]
    hyper = ([0.01] * len(shapes), [0.9] * len(shapes),
             [5e-4] * len(shapes), [1.0] * len(shapes))
    ref = [[t.clone() for t in wgm] for wgm in whole]
    update_step.sgd_update_multi(*zip(*ref), *hyper)
    sliced = 0
    for r in range(ranks):
        plan = MeshPlan(device=cuda_device, n_data=ranks, rank=r)
        mine, where = [], []
        for (w, g, m), s in zip(whole, shapes):
            d = plan.owner_dim(s)
            if d is None:
                continue
            start, n = plan.slice_bounds(s, d)
            mine.append([t.narrow(d, start, n).contiguous() for t in (w, g, m)])
            where.append((s, d, start, n))
        n0 = update_step.KERNEL.launches
        update_step.sgd_update_multi(*zip(*mine),
                                     *(h[:len(mine)] for h in hyper))
        torch.cuda.synchronize()
        assert update_step.KERNEL.launches == n0 + 1
        for (wm, _g, mm), (s, d, start, n) in zip(mine, where):
            i = shapes.index(s)
            assert torch.equal(wm, ref[i][0].narrow(d, start, n))
            assert torch.equal(mm, ref[i][2].narrow(d, start, n))
            sliced += 1
    assert sliced >= 3 * ranks  # three or more shapes cut at 2 and 3 ranks


# ----------------------------------------------------------------------
# the ring's calls of K9/K10 and the async step's K8 tables (k2a, k3)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_off,k_off", [(0, 0), (0, 96), (96, 0)])
def test_cuda_flash_ring_hop_offsets_match_plain(cuda_device, dtype, q_off,
                                                 k_off):
    """A ring hop's blocks at two model ranks (T 96 each): the diagonal,
    rank 0's hop 1 (every key ahead of every query: o = 0 and lse =
    -1e30 exactly, zero gradients) and rank 1's hop 1 (every key
    visible), with an LSE cotangent, against the plain versions."""
    b, t, h, d = 2, 96, 2, 64
    q, k, v, do = _flash_inputs(cuda_device, dtype, b, t, t, h, d,
                                7 + q_off + k_off)
    dlse = torch.randn(b, h, t, generator=torch.Generator().manual_seed(5)
                       ).to(cuda_device)
    o, lse = flash.flash_fwd(q, k, v, True, q_off, k_off)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, True, q_off, k_off)
    _close(o, o_ref, FLASH_TOL[("fwd", dtype)], "o")
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=LSE_ATOL)
    dl = ((do.float() * o_ref.float()).sum(-1).permute(0, 2, 1)
          - dlse).contiguous()
    got = flash.flash_bwd(q, k, v, do, lse_ref, dl, True, q_off, k_off)
    ref = flash.flash_bwd_plain(q, k, v, do, lse_ref, dl, True, q_off, k_off)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        _close(a, r, FLASH_TOL[("bwd", dtype)], name, BWD_ROW_FLOOR[dtype])
    if k_off > q_off:
        assert bool((o == 0).all()) and bool((lse == -1e30).all())
        assert all(bool((a == 0).all()) for a in got)


@pytest.mark.cuda
def test_cuda_async_group_apply_is_one_k8_launch(cuda_device):
    """The async step applies a group's aggregate through ``apply_all``
    over that group's tensors: one K8 launch over the group's sub-table,
    bit-equal to the plain version on the same values."""
    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.parallel.async_ps import AsyncStepper

    conf = """netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 64
layer[1->1] = relu
layer[1->2] = fullc:fc2
  nhidden = 32
layer[2->2] = relu
layer[2->3] = fullc:fc3
  nhidden = 10
layer[3->3] = softmax
netconfig = end
input_shape = 1,1,48
batch_size = 8
eta = 0.1
momentum = 0.9
wd = 0.0001
async_groups = 3
"""
    trs = {}
    for dev in ("gpu", "cpu"):
        tr = NetTrainer()
        tr.set_params(tcfg.parse_pairs(conf + f"dev = {dev}\n"))
        tr.init_model()
        tr._async = AsyncStepper(tr)
        trs[dev] = tr
    groups = trs["gpu"]._async.groups
    assert len(groups) == 3
    gen = torch.Generator().manual_seed(21)
    for gid in reversed(range(len(groups))):
        grads = [torch.randn(trs["cpu"].params[k][t].shape, generator=gen)
                 for k, t in groups[gid]]
        n0 = update_step.KERNEL.launches
        for dev, tr in trs.items():
            up = tr._async.updater
            up.push(gid, [g.to(tr.device) for g in grads], 0)
            assert up.pull_req(gid) == 1
        torch.cuda.synchronize()
        assert update_step.KERNEL.launches == n0 + 1
        for k, t in groups[gid]:
            assert torch.equal(trs["gpu"].params[k][t].cpu(),
                               trs["cpu"].params[k][t]), (k, t)
