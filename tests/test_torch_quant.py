"""Quantized serving in the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

* ``quantize_weight``: codes and scales bit-equal, HWIO and
  ``(nout, nin)`` kernels, an all-zero channel and clipped codes;
* K7's plain version against the JAX ``int8_gemm_rescale`` in Pallas
  interpret mode: float32 within rtol 1e-5 (summation order), bfloat16
  within one bf16 rounding of the row's largest value (2**-8);
* ``fc_apply_q`` / ``conv_apply_q`` on every route (2-D and 3-D fullc,
  1x1, strided 1x1, 3x3), same tolerances, the 3x3 in bfloat16 within
  two roundings (``F.conv2d`` on bf16 operands returns bf16, which the
  rescale then rounds again; the JAX package rounds once);
* a small inception-shaped net (a sibling-1x1 group, a lone pool-proj
  1x1, a strided 1x1, 3x3 convs, a 2-D fullc) loaded from one shared f32
  checkpoint with ``quant = int8`` in both packages: scores within 1e-5
  in float32, logits within 2e-2 of their largest in bfloat16 (bf16
  activations through the net, rounded at other places);
* ``.quant.model`` artifacts both ways, leaves bit-equal;
* ``export_quantized``: the same plan, fallback order and verdict keys;
  a reject writes nothing; ``task=export_quant`` exits 0 and 3;
* the engine's sibling preference, its fall back to the f32 base, the
  on-load quantization, the quant scheme in the cache key, the weight
  bytes, and a quantized trainer's ``update`` refusal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cxxnet_tpu import config as jcfg
from cxxnet_tpu.nnet import quant as jnquant
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.ops import quant as jopsq
from cxxnet_tpu.ops.kernels import int8_gemm as jk7

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.nnet import quant as nquant
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import quant as opsq
from cxxnet_tpu_torch.ops.kernels import int8_gemm as k7
from cxxnet_tpu_torch.serve import Engine
from cxxnet_tpu_torch.utils import checkpoint as ckpt

BF16_ULP = 2.0 ** -8  # one bf16 rounding, relative to the value

NET = """
random_type = kaiming
init_bias = 0.1
netconfig = start
layer[0->c1] = conv:conv1
  kernel_size = 3
  stride = 2
  pad = 1
  nchannel = 8
layer[+1:c1r] = relu
layer[c1r->red] = conv:red
  kernel_size = 1
  nchannel = 8
layer[+1:redr] = relu
layer[redr->a] = conv:a_1x1
  kernel_size = 1
  nchannel = 6
layer[+1:ar] = relu
layer[redr->b] = conv:b_3x3r
  kernel_size = 1
  nchannel = 4
  no_bias = 1
layer[+1:br] = relu
layer[br->b3] = conv:b_3x3
  kernel_size = 3
  pad = 1
  nchannel = 6
layer[+1:b3r] = relu
layer[redr->pp] = max_pooling
  kernel_size = 3
  stride = 1
  pad = 1
layer[pp->ppj] = conv:pool_proj
  kernel_size = 1
  nchannel = 4
layer[+1:ppr] = relu
layer[ar,b3r,ppr->cat] = ch_concat
layer[cat->s] = conv:strided
  kernel_size = 1
  stride = 2
  nchannel = 8
layer[+1:sr] = relu
layer[sr->f] = flatten
layer[f->fc] = fullc:fc
  nhidden = 10
layer[fc->fc] = softmax
netconfig = end
input_shape = 3,16,16
batch_size = 8
dev = cpu
"""
EVAL = """
eval = val
iter = synthetic
  nsample = 32
  input_shape = 3,16,16
  nclass = 10
iter = end
"""
LAYERS = ("l0_conv1", "l2_red", "l4_a_1x1", "l6_b_3x3r", "l8_b_3x3",
          "l11_pool_proj", "l14_strided", "l17_fc")


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_lm.py``: drop the empty device-plane histogram
    the JAX trainer's compile listener registers, which an exposition
    check later in the same process (``tests/test_obs.py``) rejects."""
    from cxxnet_tpu.obs import device as obs_device
    from cxxnet_tpu.obs import registry

    name = "train_step_device_seconds"
    had = any(m.name == name for m in registry().metrics())
    yield
    reg = registry()
    fam = next((m for m in reg.metrics() if m.name == name), None)
    if not had and fam is not None and not fam.samples():
        with reg._lock:
            reg._metrics.pop(name, None)
        obs_device.reset()  # the next user registers the families anew


def _conf(dtype="float32", extra=""):
    return NET + f"compute_dtype = {dtype}\n" + extra


def _x(n=8, seed=0):
    return np.random.RandomState(seed).randn(n, 16, 16, 3).astype(np.float32)


def _jax(conf, path=None, seed=3):
    tr = JaxTrainer()
    tr.set_params(jcfg.parse_pairs(conf))
    if path is None:
        tr.set_param("seed", str(seed))
        tr.init_model()
    else:
        tr.load_model(path)
    return tr


def _port(conf, path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.load_model(path)
    return tr


@pytest.fixture(scope="module")
def f32_ckpt(tmp_path_factory):
    """One f32 checkpoint written by the JAX package (round 2)."""
    path = str(tmp_path_factory.mktemp("q") / "0002.model")
    _jax(_conf()).save_model(path, round_=2)
    return path


def _leaves(params):
    """``{key/tag: (dtype name, bytes)}`` of either package's params."""
    out = {}
    for key, tags in params.items():
        for tag, w in tags.items():
            if isinstance(w, torch.Tensor):
                w = w.detach().cpu()
                arr = (w.view(torch.int16).numpy() if w.dtype == torch.bfloat16
                       else w.numpy())
                name = str(w.dtype).split(".")[1]
            else:
                arr = np.asarray(w)
                name = arr.dtype.name
                arr = arr.view(np.int16) if name == "bfloat16" else arr
            out[f"{key}/{tag}"] = (name, arr.tobytes())
    return out


def _row_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=-1, keepdims=True) + 1e-30
    return float((np.abs(got - ref) / scale).max())


# ----------------------------------------------------------------------
# the scheme
@pytest.mark.parametrize("shape,out_axis", [((3, 3, 5, 7), 3),
                                            ((1, 1, 12, 6), 3),
                                            ((10, 24), 0)])
def test_quantize_weight_bit_equal_to_jax(shape, out_axis):
    rng = np.random.RandomState(sum(shape))
    w = rng.randn(*shape).astype(np.float32)
    idx = [slice(None)] * len(shape)
    idx[out_axis] = 1
    w[tuple(idx)] = 0.0  # an all-zero channel: scale 1, codes 0
    idx[out_axis] = 2
    w[tuple(idx)] = np.where(rng.rand(*w[tuple(idx)].shape) < 0.5, -1e3, 1.0)
    q, s = opsq.quantize_weight(w, out_axis)
    jq, js = jopsq.quantize_weight(w, out_axis)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.uint32), js.view(np.uint32))
    assert np.abs(q).max() == 127 and (q >= -127).all()
    assert s[1] == 1.0
    assert opsq.quant_error(w, out_axis) == jopsq.quant_error(w, out_axis)


def test_weight_bytes_and_effective_wmat_match_jax():
    rng = np.random.RandomState(1)
    w = rng.randn(1, 1, 12, 6).astype(np.float32)
    q, s = opsq.quantize_weight(w, 3)
    params = {"a": {opsq.QKEY: torch.from_numpy(q),
                    opsq.SKEY: torch.from_numpy(s),
                    "bias": torch.zeros(6)},
              "b": {"wmat": torch.zeros(4, 5, dtype=torch.bfloat16)}}
    jparams = {"a": {jopsq.QKEY: q, jopsq.SKEY: s,
                     "bias": np.zeros(6, np.float32)},
               "b": {"wmat": jnp.zeros((4, 5), jnp.bfloat16)}}
    assert opsq.weight_bytes(params) == jopsq.weight_bytes(jparams)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = opsq.effective_wmat(params["a"], dt).float().numpy()
        ref = np.asarray(jopsq.effective_wmat(jparams["a"], jdt), np.float32)
        np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------------
# K7 and the layer routes
def _k7_operands(m, k, o, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    q = rng.randint(-127, 128, (o, k)).astype(np.int8)
    s = (rng.rand(o) * 0.01).astype(np.float32)
    b = (rng.randn(o) * 0.1).astype(np.float32)
    return x, q, s, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,o,bias,relu", [(16, 32, 8, True, False),
                                             (13, 17, 9, False, False),
                                             (16, 40, 24, True, True),
                                             (7, 64, 5, False, True)])
def test_k7_plain_matches_jax_interpret(dtype, m, k, o, bias, relu):
    x, q, s, b = _k7_operands(m, k, o, m * k + o)
    tdt = getattr(torch, dtype)
    got = k7.int8_gemm_rescale(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(b) if bias else None, relu)
    assert got.dtype == tdt and got.shape == (m, o)
    ref = jk7.int8_gemm_rescale(jnp.asarray(x, dtype), jnp.asarray(q),
                                jnp.asarray(s),
                                jnp.asarray(b) if bias else None, relu=relu,
                                interpret=True)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:
        assert _row_rel(got.float().numpy(), ref) <= BF16_ULP


@pytest.mark.parametrize("m,k,o,x_off,q_off,dtype,wgmma", [
    (128, 1024, 1000, 0, 0, torch.bfloat16, True),   # the classifier
    (401408, 64, 64, 0, 0, torch.bfloat16, True),    # conv2_reduce
    (7, 16, 8, 0, 0, torch.bfloat16, True),
    (7, 24, 64, 0, 0, torch.bfloat16, False),        # K % 16
    (7, 200, 64, 0, 0, torch.bfloat16, False),
    (7, 64, 36, 0, 0, torch.bfloat16, False),        # O % 8
    (7, 64, 64, 1, 0, torch.bfloat16, False),        # X 2 bytes off 16
    (7, 64, 64, 8, 0, torch.bfloat16, True),         # X 16 bytes on
    (7, 64, 64, 0, 8, torch.bfloat16, False),        # q 8 bytes off 16
    (7, 64, 64, 0, 16, torch.bfloat16, True),
    (0, 64, 64, 0, 0, torch.bfloat16, False),        # no rows
    (7, 64, 64, 0, 0, torch.float32, False),         # f32: one kernel
])
def test_k7_kernel_rule(m, k, o, x_off, q_off, dtype, wgmma):
    """K7's choice of its bf16 kernel, a pure function of the operands'
    shapes, dtype and alignment: the wgmma main path or the mma.sync
    edge path (``tests/test_torch_cuda.py`` holds both on the card)."""
    x = torch.empty(m * k + x_off, dtype=dtype, device="meta" if m * k >
                    1 << 20 else "cpu")[x_off:].view(m, k)
    q = torch.zeros(o * k + q_off, dtype=torch.int8)[q_off:].view(o, k)
    assert x.is_contiguous() and q.is_contiguous()
    assert k7.takes_wgmma(x, q) is wgmma


def test_every_quantized_googlenet_layer_takes_the_wgmma_kernel():
    """The 11 layers a quantized GoogLeNet forward sends to K7 (each
    1x1 / pad-0 / ungrouped conv outside a sibling group, and the 2-D
    fullc), at b128: all on the main path."""
    from cxxnet_tpu_torch.layers.conv import ConvolutionLayer
    from cxxnet_tpu_torch.layers.linear import FullConnectLayer

    tr = NetTrainer()
    tr.set_params(tcfg.parse_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "example", "ImageNet", "googlenet.conf")) + [("dev", "cpu")])
    tr.init_model()
    net = tr.net
    shapes = net.infer_shapes(128)
    member = net._sibling_1x1_groups()[1]
    mko = []
    for i, spec in enumerate(tr.graph.layers):
        lay = net.layer_objs[i]
        xin, out = shapes[spec.nindex_in[0]], shapes[spec.nindex_out[0]]
        if type(lay) is ConvolutionLayer and i not in member:
            p = lay.param
            if (p.kernel_height, p.kernel_width, p.pad_y, p.pad_x,
                    p.num_group) == (1, 1, 0, 0, 1):
                mko.append((out[0] * out[1] * out[2], xin[3], out[3]))
        elif type(lay) is FullConnectLayer and len(xin) == 2:
            mko.append((xin[0], xin[1], out[1]))
    for m, k, o in mko:
        x = torch.empty((m, k), dtype=torch.bfloat16, device="meta")
        assert k7.takes_wgmma(x, torch.zeros(o, k, dtype=torch.int8)), (
            m, k, o)
    assert sorted(mko) == sorted([
        (401408, 64, 64), (100352, 192, 32), (100352, 256, 64),
        (25088, 480, 64), (25088, 512, 64), (25088, 512, 64),
        (25088, 512, 64), (25088, 528, 128), (6272, 832, 128),
        (6272, 832, 128), (128, 1024, 1000)])
    # on an H100's 132 SMs only the classifier's one row tile splits K
    assert {mko: k7.k_splits(*mko, 132) for mko in mko} == {
        **{mko: 1 for mko in mko}, (128, 1024, 1000): 4}


@pytest.mark.parametrize("m,k,o,sms,splits", [
    (128, 1024, 1000, 132, 4),   # 16 tiles, 16 slices: 4 parts of 4
    (1, 1024, 1000, 132, 4),     # a served row
    (256, 1024, 1000, 132, 4),   # 32 tiles
    (128, 512, 1000, 132, 2),    # 8 slices
    (784, 192, 32, 132, 1),      # 7 tiles, 3 slices: fewer than 4 a part
    (784, 2048, 32, 132, 8),     # 7 tiles, 32 slices
    (128, 64, 64, 132, 1),       # one slice
    (6272, 832, 128, 132, 1),    # 98 tiles, more than half the SMs
    (4288, 832, 128, 132, 1),    # 68 tiles
    (4224, 832, 128, 132, 2),    # 66 tiles, 13 slices
    (128, 1024, 1000, 16, 1),    # 16 tiles on 16 SMs
    (128, 1024, 1000, 40, 2),
])
def test_k7_split_rule(m, k, o, sms, splits):
    """How many parts K7's main path cuts K into: a pure function of the
    shape and the SM count."""
    assert k7.k_splits(m, k, o, sms) == splits


def _route_params(kind, seed):
    rng = np.random.RandomState(seed)
    shape = {"fc": (10, 24), "1x1": (1, 1, 24, 10),
             "3x3": (3, 3, 24, 10)}[kind]
    q, s = opsq.quantize_weight(rng.randn(*shape).astype(np.float32),
                                0 if kind == "fc" else 3)
    b = (rng.randn(10) * 0.1).astype(np.float32)
    return ({opsq.QKEY: torch.from_numpy(q), opsq.SKEY: torch.from_numpy(s),
             "bias": torch.from_numpy(b)},
            {jopsq.QKEY: jnp.asarray(q), jopsq.SKEY: jnp.asarray(s),
             "bias": jnp.asarray(b)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["fc2d", "fc3d", "1x1", "1x1s2", "3x3",
                                   "3x3s2"])
def test_apply_q_routes_match_jax(dtype, route):
    kind = route[:3] if route.startswith("3x3") else (
        "fc" if route.startswith("fc") else "1x1")
    lp, jlp = _route_params(kind, len(route))
    rng = np.random.RandomState(7)
    stride = 2 if route.endswith("s2") else 1
    tdt = getattr(torch, dtype)
    if kind == "fc":
        x = rng.randn(*((6, 24) if route == "fc2d" else (3, 5, 24)))
        x = x.astype(np.float32)
        got = opsq.fc_apply_q(opsq.prepare_q(lp), torch.from_numpy(x).to(tdt))
        ref = jopsq.fc_apply_q(jlp, jnp.asarray(x, dtype))
    else:
        x = rng.randn(2, 9, 9, 24).astype(np.float32)
        pad = 1 if kind == "3x3" else 0
        got = opsq.conv_apply_q(opsq.prepare_q(lp),
                                torch.from_numpy(x).to(tdt), stride, pad, pad)
        ref = jopsq.conv_apply_q(jlp, jnp.asarray(x, dtype), stride, pad, pad)
    ref = np.asarray(ref, np.float32)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        twice = kind == "3x3"  # bf16 conv output, then the rescale
        assert _row_rel(got.float().numpy(), ref) <= BF16_ULP * (
            3 if twice else 1)


# ----------------------------------------------------------------------
# the quantized net through a shared checkpoint
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_net_scores_match_jax(f32_ckpt, dtype):
    conf = _conf(dtype, "quant = int8\n")
    jt = _jax(conf, f32_ckpt)
    tr = _port(conf, f32_ckpt)
    assert tr.quant_scheme == jt.quant_scheme == "int8"
    assert _leaves(tr.params) == _leaves(jt.params)
    assert tr.params["l2_red"][opsq.QKEY].dtype == torch.int8
    x = _x()
    node = tr.resolve_feature_node("fc")
    got = tr.predict_fn(node)(tr.params, tr.aux, x, ()).numpy()
    ref = np.asarray(jt.predict_fn(jt.graph.node_index_of("fc"))(
        jt.params, jt.aux, x, ()))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_artifacts_interchange_both_ways(f32_ckpt, tmp_path):
    plan = {k: "int8" for k in LAYERS}
    plan["l8_b_3x3"] = plan["l2_red"] = "bf16"  # bf16 leaves too
    conf = _conf()
    x = _x(seed=1)
    # JAX exports, the port serves
    jt = _jax(conf, f32_ckpt)
    jnquant.apply_plan(jt, dict(plan))
    jpath = str(tmp_path / "0002.quant.model")
    jt.save_model(jpath, round_=2)
    tr = _port(conf, jpath)
    assert tr.quant_scheme == "int8" and tr.quant_plan == plan
    assert tr.params["l8_b_3x3"]["wmat"].dtype == torch.bfloat16
    assert _leaves(tr.params) == _leaves(jt.params)
    np.testing.assert_allclose(
        tr.predict_fn()(tr.params, tr.aux, x, ()).numpy(),
        np.asarray(jt.predict_fn()(jt.params, jt.aux, x, ())),
        rtol=1e-5, atol=1e-6)
    # the port exports, JAX loads
    tr = _port(conf, f32_ckpt)
    nquant.apply_plan(tr, dict(plan))
    ppath = str(tmp_path / "0003.quant.model")
    tr.save_model(ppath, round_=3)
    man = ckpt.read_manifest(ppath)
    assert man["quant"] == {"scheme": "int8", "scales_dtype": "float32",
                            "int8_layers": 6, "bf16_layers": 2}
    jt2 = _jax(conf, ppath)
    assert jt2.quant_scheme == "int8" and jt2.quant_plan == plan
    assert _leaves(jt2.params) == _leaves(tr.params)
    # and the port reads its own artifact back bit for bit
    assert _leaves(_port(conf, ppath).params) == _leaves(tr.params)


def _eval_iter(pkg):
    mod = __import__(f"{pkg}.io.data", fromlist=["create_iterator"])
    cfgmod = jcfg if pkg == "cxxnet_tpu" else tcfg
    split = cfgmod.split_sections(cfgmod.parse_pairs(_conf() + EVAL))
    it = mod.create_iterator(split.find("eval")[0].entries)
    for n, v in split.global_entries:
        it.set_param(n, v)
    it.init()
    return it


def test_export_matches_jax_and_reject_writes_nothing(f32_ckpt, tmp_path):
    cfg_t, cfg_j = tcfg.parse_pairs(_conf()), jcfg.parse_pairs(_conf())
    # an unreachable gate demotes every layer, worst error first, then
    # rejects: the fallback order is the error ranking, in both packages
    out = str(tmp_path / "x.quant.model")
    v = nquant.export_quantized(cfg_t, f32_ckpt, _eval_iter(
        "cxxnet_tpu_torch"), min_agreement=1.01, calib_batches=1,
        out_path=out)
    jv = jnquant.export_quantized(cfg_j, f32_ckpt, _eval_iter("cxxnet_tpu"),
                                  min_agreement=1.01, calib_batches=1,
                                  out_path=out)
    assert set(v) == set(jv)
    assert not v["ok"] and not jv["ok"] and v["path"] is None
    assert v["fallbacks"] == jv["fallbacks"] and len(v["fallbacks"]) == 8
    assert v["layers"] == jv["layers"] == {k: "bf16" for k in LAYERS}
    assert v["eval_rows"] == jv["eval_rows"] == 8
    assert not os.path.exists(out) and not os.path.exists(
        ckpt.manifest_path(out))
    # a reachable gate publishes the same plan
    v = nquant.export_quantized(cfg_t, f32_ckpt, _eval_iter(
        "cxxnet_tpu_torch"), min_agreement=0.5, calib_batches=2)
    jv = jnquant.export_quantized(cfg_j, f32_ckpt, _eval_iter("cxxnet_tpu"),
                                  min_agreement=0.5, calib_batches=2,
                                  out_path=out)
    assert v["ok"] and v["layers"] == jv["layers"]
    assert v["path"] == nquant.quant_artifact_path(f32_ckpt)
    assert abs(v["agreement"] - jv["agreement"]) <= 1 / 16
    assert v["weight_bytes"] == jv["weight_bytes"]
    man = ckpt.read_manifest(v["path"])
    assert man["round"] == 2 and man["quant"]["agreement"] == v["agreement"]
    with pytest.raises(ValueError, match="agreement gate"):
        nquant.export_quantized(cfg_t, f32_ckpt, None)
    with pytest.raises(ValueError, match="already a quantized"):
        nquant.export_quantized(cfg_t, v["path"], None, min_agreement=0)


def test_cli_export_quant_exits_0_and_3(f32_ckpt, tmp_path, capsys):
    conf = tmp_path / "q.conf"
    conf.write_text(_conf() + EVAL)
    base = [str(conf), "task=export_quant", f"model_in={f32_ckpt}",
            "quant_calib_batches=1", "silent=1"]
    out = str(tmp_path / "rej.quant.model")
    assert LearnTask().run(base + ["quant_min_agreement=1.01",
                                   f"quant_out={out}"]) == 3
    assert not os.path.exists(out)
    report = str(tmp_path / "verdict.json")
    out = str(tmp_path / "ok.quant.model")
    assert LearnTask().run(base + ["quant_min_agreement=0",
                                   f"quant_out={out}",
                                   f"quant_report={report}"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    verdict = json.loads(lines[-1])
    assert verdict["ok"] and verdict["path"] == out and not verdict["gated"]
    assert json.loads(open(report).read()) == verdict
    assert verdict["bytes_ratio"] > 3.0


# ----------------------------------------------------------------------
# the trainer and the engine
def test_quantized_trainer_is_inference_only(f32_ckpt):
    tr = _port(_conf("float32", "quant = int8\n"), f32_ckpt)
    assert tr.updaters == {}
    with pytest.raises(ValueError, match="inference-only"):
        tr.update_all(_x(), np.zeros((8, 1), np.float32))


def test_cache_key_carries_the_quant_scheme(f32_ckpt):
    x = _x(4)
    keys = {}
    for scheme in ("", "int8"):
        extra = f"quant = {scheme}\n" if scheme else ""
        with Engine(cfg=_conf("float32", extra), model_in=f32_ckpt,
                    max_batch_size=8) as eng:
            eng.scores(x)
            (keys[scheme],) = eng._cache._keys
            assert eng.healthz()["quant"] == (scheme or "f32")
    assert keys[""][0] == keys["int8"][0]  # one net fingerprint ...
    assert keys[""][-1] == "" and keys["int8"][-1] == "int8"


def test_engine_prefers_the_sibling_and_reports_bytes(f32_ckpt, tmp_path):
    import shutil

    mdir = tmp_path / "m"
    mdir.mkdir()
    base = str(mdir / "0002.model")
    shutil.copy(f32_ckpt, base)
    shutil.copy(ckpt.manifest_path(f32_ckpt), ckpt.manifest_path(base))
    tr = _port(_conf(), base)
    nquant.apply_plan(tr, nquant.build_plan(tr))
    tr.save_model(nquant.quant_artifact_path(base), round_=2)
    for src in ({"model_dir": str(mdir)}, {"model_in": base}):
        with Engine(cfg=_conf("float32", "quant = int8\n"), max_batch_size=8,
                    **src) as eng:
            h = eng.healthz()
            assert h["quant"] == "int8" and h["round"] == 2
            assert h["model"].endswith("0002.quant.model")
            st = eng.snapshot_stats()
            m = st["model"]
            assert m["weight_bytes_f32"] / m["weight_bytes"] > 3.0
            assert (st["weight_bytes"], st["weight_bytes_f32"],
                    st["quant_scheme"]) == (m["weight_bytes"],
                                            m["weight_bytes_f32"], "int8")
            assert eng.predict(_x(3)).shape == (3,)
    # without the key the engine serves the f32 base
    with Engine(cfg=_conf(), model_dir=str(mdir), max_batch_size=8) as eng:
        assert eng.healthz()["quant"] == "f32"
        assert eng.healthz()["model"].endswith("0002.model")
        m = eng.snapshot_stats()["model"]
        assert m["weight_bytes"] == m["weight_bytes_f32"]


def test_engine_falls_back_to_the_f32_base_and_quantizes_on_load(
        f32_ckpt, tmp_path):
    import shutil

    mdir = tmp_path / "m"
    mdir.mkdir()
    base = str(mdir / "0002.model")
    shutil.copy(f32_ckpt, base)
    shutil.copy(ckpt.manifest_path(f32_ckpt), ckpt.manifest_path(base))
    # a self-consistent manifest over a payload that is not a model
    ckpt.write_checkpoint(nquant.quant_artifact_path(base), b"not a model",
                          round_=2, quant={"scheme": "int8"})
    with Engine(cfg=_conf("float32", "quant = int8\n"),
                model_dir=str(mdir), max_batch_size=8) as eng:
        assert eng.round == 2 and eng.model_path == base
        h = eng.healthz()
        assert h["quant"] == "int8"  # the base, quantized on load
        assert opsq.is_quantized(eng.trainer.params["l2_red"])
        ref = _port(_conf("float32", "quant = int8\n"), f32_ckpt)
        np.testing.assert_array_equal(
            eng.scores(_x(2)),
            ref.predict_fn()(ref.params, ref.aux, _x(2), ()).numpy())
