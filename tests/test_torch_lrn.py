"""The LRN kernels' routing rule, halo scheme and power route, on the CPU.

``lrn.takes_vector`` decides before a launch whether K4
(``csrc/lrn_fwd.cu``) and K5 (``csrc/lrn_bwd.cu``) take their one-pass
kernels over 16-byte channel vectors or the scalar edge kernels.  It
reads only shapes, dtypes, alignment and nsize, so it is held here on
CPU and meta tensors: every GoogLeNet LRN takes the vector kernels.

The vector kernels' arithmetic is emulated in torch on the CPU and held
against the plain versions:

* the halo scheme: the channels cut into vectors of 4 (f32) or 8 (bf16)
  lanes, each vector's squares (and K5's ``t``) with ``nsize // 2``
  values of each neighbouring vector of the same position, zeros past
  the position's edges, each lane's window added in offset order:
  bit-equal to the plain version with the same power, every nsize the
  kernels are instantiated for;
* the power route (``exp2_pow`` in ``csrc/lrn_vec.cuh``):
  ``norm = m * 2**k`` with ``m`` in [1, 2), ``norm^e`` as
  ``2**i * exp2(e * k - i + e * log2(m))`` with ``i`` the integer
  nearest ``e * k``; ``norm^(e-1)`` as that times ``1 / norm``; ``pow``
  itself where ``norm`` is outside [2**-124, 2**124] (0, inf and NaN
  among them) or ``e`` is 0 or past 1 in magnitude.  Within 1e-5 relative of the plain version's
  ``pow`` over norms from 1e-18 to 1e18 and beta 0.5, 0.75 and 1.0 (the
  tolerance the card's checks hold the kernels to), also with the
  device's MUFU errors pushed to their documented worst (``lg2.approx``
  2**-22 absolutely on [1, 2), ``ex2.approx`` 2 ulp), which stay within
  6 ulp; inf and NaN where ``pow`` puts them.

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds each path against its plain version there.
"""

import os

import pytest
import torch

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import lrn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BETAS = [0.5, 0.75, 1.0]


def _at(c, dtype, offset=0):
    """A (2, 3, 5, c) CPU tensor ``offset`` elements into its buffer."""
    buf = torch.zeros(2 * 3 * 5 * c + offset, dtype=dtype)
    return buf[offset:].view(2, 3, 5, c)


@pytest.mark.parametrize("c,dtype,offset,vector", [
    (8, torch.bfloat16, 0, True),      # one vector a position
    (64, torch.bfloat16, 0, True),
    (192, torch.bfloat16, 0, True),
    (2048, torch.bfloat16, 0, True),   # 256 vectors: a whole block
    (2056, torch.bfloat16, 0, False),  # 257 vectors
    (70, torch.bfloat16, 0, False),    # not 8 bf16 channels a vector
    (12, torch.bfloat16, 0, False),
    (64, torch.bfloat16, 1, False),    # x 2 bytes off 16
    (64, torch.bfloat16, 8, True),     # x 16 bytes on
    (4, torch.float32, 0, True),
    (1024, torch.float32, 0, True),    # 256 vectors
    (1028, torch.float32, 0, False),   # 257 vectors
    (70, torch.float32, 0, False),     # not 4 f32 channels a vector
    (64, torch.float32, 2, False),     # x 8 bytes off 16
])
def test_lrn_kernel_rule(c, dtype, offset, vector):
    x = _at(c, dtype, offset)
    assert x.is_contiguous()
    assert lrn.takes_vector(x, nsize=5) is vector
    assert lrn.takes_vector(x, torch.zeros_like(x), nsize=5) is vector


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nsize", [0, 1, 2, 5, 8, 9, 10, 11, 17])
def test_lrn_kernel_rule_takes_windows_up_to_nine(dtype, nsize):
    """The vector kernels are instantiated for nsize 1 to 9 (a halo of
    at most 4 channels a side, within one neighbouring vector)."""
    assert lrn.VECTOR_NSIZE == 9
    assert lrn.takes_vector(_at(64, dtype), nsize=nsize) is (1 <= nsize <= 9)


def test_lrn_kernel_rule_gradient_alignment_and_32bit_indices():
    x = _at(64, torch.bfloat16)
    assert lrn.takes_vector(x, _at(64, torch.bfloat16, 8), nsize=5)
    assert not lrn.takes_vector(x, _at(64, torch.bfloat16, 1), nsize=5)

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    big, small = meta(2, 32768, 4096, 8), meta(2, 16384, 2048, 8)
    assert big.numel() == 2 ** 31 and big.data_ptr() % 16 == 0
    assert lrn.takes_vector(small, small, nsize=5)
    assert not lrn.takes_vector(big, big, nsize=5)
    assert not lrn.takes_vector(small, big, nsize=5)


def _googlenet_lrns():
    """``(x shape, (nsize, alpha, beta, knorm))`` of every LRN of
    GoogLeNet's b128 forward, from the port's shape inference."""
    tr = NetTrainer()
    tr.set_params(tcfg.parse_file(os.path.join(
        REPO, "example", "ImageNet", "googlenet.conf")) + [
            ("dev", "cpu"), ("batch_size", "128")])
    tr.init_model()
    shapes = tr.net.infer_shapes(128)
    out = []
    for i, spec in enumerate(tr.graph.layers):
        lay = tr.net.layer_objs[i]
        if type(lay).__name__ == "LRNLayer":
            out.append((shapes[spec.nindex_in[0]],
                        (lay.nsize, lay.alpha, lay.beta, lay.knorm)))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_googlenet_lrn_takes_the_vector_kernels(dtype):
    lrns = _googlenet_lrns()
    assert [s for s, _ in lrns] == [(128, 56, 56, 64), (128, 56, 56, 192)]
    for shape, (nsize, *_rest) in lrns:
        x = torch.empty(shape, dtype=dtype, device="meta")
        assert lrn.takes_vector(x, x, nsize=nsize), shape


# ----------------------------------------------------------------------
# the kernels' arithmetic, emulated


def route_pows(norm: torch.Tensor, e: float, lg_err=0.0, ex_ulps=0.0):
    """``(norm^e, norm^(e-1))`` the vector kernels' way (``route_takes``,
    ``in_route``, ``exp2_pow`` and ``recip`` in ``csrc/lrn_vec.cuh``),
    the log2 of the mantissa off by ``lg_err`` and the exp2 by
    ``ex_ulps`` (the MUFU errors), in f32 but for the two fused
    multiply-adds, taken in float64 and rounded once."""
    fast = ((norm >= 2.0 ** -124) & (norm <= 2.0 ** 124) & (e != 0.0)
            & (abs(e) <= 1.0))
    safe = torch.where(fast, norm, torch.ones_like(norm))
    mant, exp = torch.frexp(safe)            # safe = mant 2^exp, [0.5, 1)
    m, k = mant * 2, (exp - 1).float()       # safe = m 2^k, m in [1, 2)
    lg = torch.log2(m) + lg_err
    ek = e * k
    ek_lo = (e * k.double() - ek.double()).float()       # exact
    inner = (e * lg.double() + ek_lo.double()).float()   # fmaf
    yi = torch.round(ek)
    rest = (ek - yi) + inner
    ex = torch.exp2(rest)
    ex = ex + ex_ulps * (torch.nextafter(ex, torch.tensor(float("inf")))
                         - ex)
    p = torch.where(fast, torch.ldexp(ex, yi), norm.pow(e))
    return p, torch.where(fast, p * (1.0 / safe), norm.pow(e - 1.0))


def exact_pows(norm: torch.Tensor, e: float):
    """The plain version's two pows."""
    return norm.pow(e), norm.pow(e - 1.0)


def _vector_window_sums(v, lanes, half, lo, hi):
    """``sum_{d=lo..hi} v[..., c+d]`` as the vector kernels take it: the
    channels cut into vectors of ``lanes``, each extended by the last
    ``half`` values of the vector below and the first ``half`` of the
    one above (zeros past the position's first and last vector), each
    lane's window added in offset order."""
    c = v.shape[-1]
    vecs = v.reshape(*v.shape[:-1], c // lanes, lanes)
    zeros = torch.zeros_like(vecs[..., :1, :half])
    below = torch.cat([zeros, vecs[..., :-1, lanes - half:]], dim=-2)
    above = torch.cat([vecs[..., 1:, :half], zeros], dim=-2)
    e = torch.cat([below, vecs, above], dim=-1)
    acc = None
    for d in range(lo, hi + 1):
        sl = e[..., half + d:half + d + lanes]
        acc = sl if acc is None else acc + sl
    return acc.reshape(v.shape)


def vector_fwd(x, nsize, alpha, beta, knorm, power):
    lanes = 16 // x.element_size()
    lo, hi = lrn.window_offsets(nsize)
    xf = x.float()
    norm = knorm + (alpha / nsize) * _vector_window_sums(
        xf * xf, lanes, nsize // 2, lo, hi)
    return (xf * power(norm, -beta)[0]).to(x.dtype)


def vector_bwd(x, g, nsize, alpha, beta, knorm, power):
    """K5's main path: the norm once, ``norm^-beta`` and
    ``norm^(-beta-1)`` by ``power``, ``t``'s halo, the reversed
    window."""
    lanes = 16 // x.element_size()
    lo, hi = lrn.window_offsets(nsize)
    xf, gf = x.float(), g.float()
    norm = knorm + (alpha / nsize) * _vector_window_sums(
        xf * xf, lanes, nsize // 2, lo, hi)
    p, q = power(norm, -beta)
    t = gf * xf * q
    back = _vector_window_sums(t, lanes, nsize // 2, -hi, -lo)
    coef = 2.0 * (alpha / nsize) * beta
    return (gf * p - (coef * xf) * back).to(x.dtype)


def _inputs(c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 4, 5, c, generator=gen).to(dtype)
    x[0, 0, 0, :3] = 0.0  # relu zeros
    g = torch.randn(x.shape, generator=gen).to(dtype)
    return x, g


@pytest.mark.parametrize("dtype,c", [(torch.float32, 4),
                                     (torch.float32, 72),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 192)])
@pytest.mark.parametrize("nsize", range(1, lrn.VECTOR_NSIZE + 1))
def test_vector_halo_scheme_bit_equal_to_plain(dtype, c, nsize):
    """With the plain version's pow, the halo scheme gives the plain
    version's sums bit for bit, forward and backward (one vector a
    position at C 4 f32 and 8 bf16: both halos zero)."""
    x, g = _inputs(c, dtype, nsize)
    args = (nsize, 0.05, 0.75, 1.0)
    assert torch.equal(vector_fwd(x, *args, exact_pows),
                       lrn.lrn_plain(x, *args))
    assert torch.equal(vector_bwd(x, g, *args, exact_pows),
                       lrn.lrn_bwd_plain(x, g, *args))


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("nsize", [1, 4, 5, 9])
def test_vector_kernels_with_the_power_route_match_plain(beta, nsize):
    """The whole emulated main path, power route included, in f32
    within the card's tolerance (rtol = atol = 1e-5), at norms from 1 to
    ~1e4 (alpha / nsize * the window's squares, inputs up to ~60)."""
    x, g = _inputs(72, torch.float32, 10 + nsize)
    x = x * torch.logspace(-1, 1.8, 72)  # the norms span 1 .. ~1e4
    args = (nsize, 5.0, beta, 1.0)
    ref = lrn.lrn_plain(x, *args)
    norm = lrn._norm(x, nsize, 5.0, 1.0)
    assert float(norm.max()) > 1e3
    torch.testing.assert_close(vector_fwd(x, *args, route_pows), ref,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(vector_bwd(x, g, *args, route_pows),
                               lrn.lrn_bwd_plain(x, g, *args),
                               rtol=1e-5, atol=1e-5)


_NORMS = torch.logspace(-18, 18, 72001, dtype=torch.float32)


@pytest.mark.parametrize("beta", BETAS)
def test_power_route_within_tolerance_of_pow(beta):
    """``p`` and ``p`` times ``1 / norm`` against the plain version's two
    pows over norms from 1e-18 to 1e18 (norm^-2 normal)."""
    for got, ref in zip(route_pows(_NORMS, -beta),
                        exact_pows(_NORMS, -beta)):
        assert float(((got - ref) / ref).abs().max()) < 1e-5


def _ulps(got, ref64):
    ref = ref64.float()
    ulp = (torch.nextafter(ref, torch.tensor(float("inf"))) - ref).double()
    return float(((got.double() - ref64).abs() / ulp).max())


@pytest.mark.parametrize("beta", BETAS)
def test_power_route_worst_case_of_the_intrinsics(beta):
    """The route with the MUFU's documented worst errors pushed either
    way, against float64 pow: within 6 ulp (1.5 with exact MUFUs).
    ``exp2(e * __log2f(norm))`` without the split, at ``__log2f``'s
    documented 2 ulp of its result, is 20+ ulp off at norms far from 1:
    the error of log2's integer part, scaled by e."""
    ref = _NORMS.double().pow(-beta)
    worst = max(_ulps(route_pows(_NORMS, -beta, s * 2.0 ** -22, t)[0], ref)
                for s in (-1.0, 1.0) for t in (-2.0, 2.0))
    assert worst <= 6.0
    log2 = torch.log2(_NORMS)
    ulp = torch.nextafter(log2.abs(), torch.tensor(float("inf"))) - log2.abs()
    unsplit = max(_ulps(torch.exp2(-beta * (log2 + s * 2 * ulp)), ref)
                  for s in (-1.0, 1.0))
    assert unsplit > 20.0


@pytest.mark.parametrize("beta", BETAS + [0.0])
def test_power_route_places_inf_and_nan_as_pow(beta):
    """Norm 0 (knorm 0 over an all-zero window), -0, inf, NaN, a
    negative norm, a subnormal and one past 2**124 take pow, so both
    powers hold inf and NaN where the plain version's do
    (``exp2(e * log2(norm))`` alone gives NaN for 0 * inf at beta 0, and
    ``p / norm`` -inf at -0 where pow(-0, -1.5) is +inf); 1.5 takes the
    route."""
    norm = torch.tensor([0.0, -0.0, float("inf"), float("nan"), -2.0, 1.5,
                         1e-40, 3e38])
    for got, ref in zip(route_pows(norm, -beta), exact_pows(norm, -beta)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0,
                                   equal_nan=True)
