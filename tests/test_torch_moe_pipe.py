"""``moe``, ``pipe_transformer``, ``pipe_mlp`` and ``ops/pipeline.py`` in
the port, against the JAX package, on the CPU.

Inputs and params are made with numpy from a seed and fed to both
packages.

* Each layer's forward and the gradients of ``sum(y * gy)`` with respect
  to the input and every param, f32 and bf16 (the params cast as each
  net casts them: every tag, but ``pipe_transformer``'s four LN tags
  stay f32): f32 within 1e-5 (forward) and 1e-4 (gradients) of the
  tensor's largest, bf16 within 2e-2 (one or two bf16 roundings of
  the tensor's scale, 2^-8 each, summed over the layer's products).
* ``moe``'s routing: ``topk = 2`` against the dense mixture, exactly
  ``k`` experts under tied gates (x = 0: the lower indices, as
  ``jax.lax.top_k`` picks them) and ``topk_mask`` against
  ``jax.lax.top_k`` on rows full of ties.
* One ``pipe_transformer`` block against hand math (1e-4), the LN tags
  f32 under bf16, the layers' validation messages against the JAX ones.
* A MoE net and a ``pipe_mlp`` net trained 5 and 4 steps from one JAX
  checkpoint, and ``transformer_conf(pipeline_parallel=1)`` one step,
  against the JAX ``NetTrainer`` at the JAX tests' rtol 3e-4, atol 3e-5.
* ``pipeline_apply``'s checks message for message against the JAX
  package's (over more than one stage: ``tests/test_torch_model_axis.py``);
  ``model_parallel > 1`` refused where the JAX package, on one device,
  raises too.
* The stacked 3-D tensors through the checkpoint both ways, f32 and as
  ``~bf16`` words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu import models as jmodels
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import create_layer as jcreate
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.ops import attention as jattention
from cxxnet_tpu.ops import pipeline as jpipeline
from cxxnet_tpu.parallel import make_mesh

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import models as tmodels
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.layers.sequence import topk_mask
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import pipeline as tpipeline
from cxxnet_tpu_torch.parallel import mesh as tmesh

# (forward, gradients) of each tensor's largest, by compute dtype
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
NET_RTOL, NET_ATOL = 3e-4, 3e-5  # the JAX tests' bound for these nets


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """The JAX trainer registers ``train_step_device_seconds`` in the
    process-wide obs registry, empty unless steps are sampled; an
    exposition check later in the same process (``tests/test_obs.py``)
    rejects an empty histogram.  Leave the registry as found."""
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
        obs_device.reset()


def _pair(name, cfg):
    out = []
    for make in (create_layer, jcreate):
        lay = make(name)
        for k, v in cfg.items():
            lay.set_param(k, str(v))
        out.append(lay)
    return out


def _np_params(lay, shape, seed):
    """f32 numpy params of the JAX layer's shapes, drawn from ``seed``
    (biases and LN tags too, so every tag is exercised)."""
    p = lay.init_params(jax.random.PRNGKey(0), [shape])
    rng = np.random.RandomState(seed)
    out = {}
    for t, v in p.items():
        a = rng.randn(*v.shape).astype(np.float32) * 0.3
        if t.startswith("ln") and t.endswith("_w"):
            a += 1.0
        out[t] = a
    return out


def _run_both(tlay, jlay, params, x, gy, dtype):
    """Both layers' outputs and the gradients of ``sum(y * gy)`` with
    respect to the input and the f32 params, as f32 numpy."""
    keep = getattr(jlay, "f32_tags", frozenset())
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jf(p, xx):
        pc = {t: v if t in keep else v.astype(jdt) for t, v in p.items()}
        (y,) = jlay.apply(pc, [xx.astype(jdt)])
        return jnp.sum(y.astype(jnp.float32) * gy), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        {t: jnp.asarray(v) for t, v in params.items()}, jnp.asarray(x))
    tdt = getattr(torch, dtype)
    tp = {t: torch.from_numpy(v.copy()).requires_grad_(True)
          for t, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    (ty,) = tlay.apply(tlay.prepare(tp, tdt), [tx.to(tdt)])
    (ty.float() * torch.from_numpy(gy)).sum().backward()
    jout = {"y": np.asarray(jy.astype(jnp.float32)), "x": np.asarray(jgx),
            **{t: np.asarray(g) for t, g in jgp.items()}}
    tout = {"y": ty.detach().float().numpy(), "x": tx.grad.numpy(),
            **{t: v.grad.numpy() for t, v in tp.items()}}
    return tout, jout


def _hold(tout, jout, dtype):
    fwd, grad = TOL[dtype]
    assert sorted(tout) == sorted(jout)
    for name, ref in jout.items():
        tol = fwd if name == "y" else grad
        err = np.abs(tout[name] - ref).max()
        assert err <= tol * np.abs(ref).max() + 1e-7, (name, err)


# ----------------------------------------------------------------------
# the layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topk", [0, 2])
@pytest.mark.parametrize("shape", [(6, 10), (2, 5, 10)])
def test_moe_matches_jax(dtype, topk, shape):
    tlay, jlay = _pair("moe", {"nexpert": 4, "nhidden": 12, "topk": topk})
    assert tlay.infer_shape([shape]) == jlay.infer_shape([shape])
    rng = np.random.RandomState(1)
    params = _np_params(jlay, shape, 2)
    x = rng.randn(*shape).astype(np.float32)
    gy = rng.randn(*shape[:-1], 12).astype(np.float32)
    _hold(*_run_both(tlay, jlay, params, x, gy, dtype), dtype)


def test_moe_topk_is_not_the_dense_mixture():
    tlay, _ = _pair("moe", {"nexpert": 8, "nhidden": 4, "topk": 2})
    gen = torch.Generator().manual_seed(0)
    p = tlay.init_params(gen, [(4, 6)])
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 6)
                         .astype(np.float32))
    (y,) = tlay.apply(p, [x])
    tlay.topk = 0
    (y0,) = tlay.apply(p, [x])
    assert y.shape == (4, 4) and not torch.allclose(y, y0)


def test_moe_keeps_exactly_k_experts_under_tied_gates():
    """x = 0 makes every gate 1/E: exactly the first two experts, as the
    JAX layer picks them."""
    tlay, jlay = _pair("moe", {"nexpert": 8, "nhidden": 4, "topk": 2})
    params = _np_params(jlay, (4, 6), 3)
    x = np.zeros((4, 6), np.float32)
    (ty,) = tlay.apply({t: torch.from_numpy(v) for t, v in params.items()},
                       [torch.from_numpy(x)])
    (jy,) = jlay.apply({t: jnp.asarray(v) for t, v in params.items()},
                       [jnp.asarray(x)])
    want = np.broadcast_to(params["bias"][:2].mean(axis=0), (4, 4))
    np.testing.assert_allclose(ty.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_mask_orders_ties_as_jax_top_k(k):
    rng = np.random.RandomState(k)
    gate = rng.choice([0.0, 0.25, 0.5], size=(64, 8)).astype(np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(gate), k)
    want = np.asarray(jax.nn.one_hot(idx, 8).sum(axis=-2))
    got = topk_mask(torch.from_numpy(gate), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=-1) == k).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [0, 1])
def test_pipe_transformer_matches_jax(dtype, causal):
    cfg = {"nblock": 2, "nhead": 2, "causal": causal, "ffn_hidden": 24}
    tlay, jlay = _pair("pipe_transformer", cfg)
    shape = (2, 6, 8)
    assert tlay.infer_shape([shape]) == jlay.infer_shape([shape])
    rng = np.random.RandomState(4)
    params = _np_params(jlay, shape, 5)
    x = rng.randn(*shape).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)
    _hold(*_run_both(tlay, jlay, params, x, gy, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipe_mlp_matches_jax(dtype):
    tlay, jlay = _pair("pipe_mlp", {"nblock": 3})
    shape = (6, 8)
    rng = np.random.RandomState(6)
    params = _np_params(jlay, shape, 7)
    x = rng.randn(*shape).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)
    _hold(*_run_both(tlay, jlay, params, x, gy, dtype), dtype)


def test_pipe_transformer_block_matches_hand_math():
    """One block == the pre-LN block written out (the JAX test's)."""
    tlay, _ = _pair("pipe_transformer", {"nblock": 1, "nhead": 2})
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 16).astype(np.float32)
    params = tlay.init_params(torch.Generator().manual_seed(0), [x.shape])
    (y,) = tlay.apply(params, [torch.from_numpy(x)])

    def ln(v, w, b):
        mu = v.mean(-1, keepdims=True)
        var = ((v - mu) ** 2).mean(-1, keepdims=True)
        return (v - mu) / np.sqrt(var + 1e-6) * w + b

    def gelu(v):
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (v + 0.044715 * v ** 3)))

    p = {k: v.numpy()[0] for k, v in params.items()}
    h = ln(x, p["ln1_w"], p["ln1_b"])
    qkv = (h @ p["wqkv"].T + p["bqkv"]).reshape(2, 8, 3, 2, 8)
    o = np.asarray(jattention.mha(*(jnp.asarray(qkv[:, :, i])
                                    for i in range(3))))
    x1 = x + o.reshape(2, 8, 16) @ p["wproj"].T + p["bproj"]
    h2 = ln(x1, p["ln2_w"], p["ln2_b"])
    f = gelu(h2 @ p["wff1"].T + p["bff1"]) @ p["wff2"].T + p["bff2"]
    np.testing.assert_allclose(y.numpy(), x1 + f, rtol=1e-4, atol=1e-5)


def test_pipe_transformer_ln_tags_stay_f32_under_bf16():
    """The prepared stack keeps the four LN tags f32 and casts the rest,
    as the JAX net's ``_cast_params`` does."""
    kw = dict(batch_size=8, seq_len=8, dim=16, nhead=2, nlayer=2,
              num_class=4, dev="cpu", compute_dtype="bfloat16",
              pipeline_parallel=1)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(jmodels.transformer_conf(**kw)))
    jt.init_model()
    jcast = jt.net._cast_params(jt.params)["l0_blocks"]
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(tmodels.transformer_conf(**kw)))
    tr.init_model()
    tcast = tr.net.prepare(tr.params)["layers"]["l0_blocks"]
    assert sorted(tcast) == sorted(jcast)
    for tag, v in tcast.items():
        want = torch.float32 if jcast[tag].dtype == jnp.float32 \
            else torch.bfloat16
        assert v.dtype == want, tag
    assert {t for t, v in tcast.items() if v.dtype == torch.float32} == {
        "ln1_w", "ln1_b", "ln2_w", "ln2_b"}


@pytest.mark.parametrize("name,cfg,shape", [
    ("moe", {"nexpert": 4}, (4, 6)),
    ("moe", {"nhidden": 4, "nexpert": 2, "topk": 3}, (4, 6)),
    ("moe", {"nhidden": 4, "nexpert": 0}, (4, 6)),
    ("moe", {"nhidden": 4}, (2, 3, 4, 6)),
    ("pipe_transformer", {"nhead": 3}, (2, 4, 8)),
    ("pipe_transformer", {"nhead": 2}, (2, 8)),
    ("pipe_mlp", {}, (2, 4, 8)),
])
def test_validation_matches_jax(name, cfg, shape):
    tlay, jlay = _pair(name, cfg)
    with pytest.raises(ValueError) as je:
        jlay.infer_shape([shape])
    with pytest.raises(ValueError) as te:
        tlay.infer_shape([shape])
    assert str(te.value) == str(je.value)


# ----------------------------------------------------------------------
# nets trained in both packages from one checkpoint

MOE_CFG = [
    ("dev", "cpu"),
    ("batch_size", "16"),
    ("input_shape", "1,1,10"),
    ("seed", "7"),
    ("eta", "0.1"),
    ("momentum", "0.9"),
    ("netconfig", "start"),
    ("layer[0->1]", "moe:mx"),
    ("nexpert", "4"),
    ("nhidden", "32"),
    ("topk", "2"),
    ("layer[1->2]", "relu:r"),
    ("layer[2->3]", "fullc:fc"),
    ("nhidden", "4"),
    ("layer[3->3]", "softmax"),
    ("netconfig", "end"),
]
PIPE_MLP_CFG = [
    ("dev", "cpu"),
    ("batch_size", "16"),
    ("input_shape", "1,1,16"),
    ("seed", "5"),
    ("eta", "0.05"),
    ("netconfig", "start"),
    ("layer[0->1]", "pipe_mlp:pp"),
    ("nblock", "4"),
    ("n_microbatch", "4"),
    ("pipeline_parallel", "1"),
    ("init_sigma", "0.2"),
    ("layer[1->2]", "fullc:fc"),
    ("nhidden", "4"),
    ("layer[2->2]", "softmax"),
    ("netconfig", "end"),
]


def _trainers(tmp_path, jpairs, tpairs):
    """A JAX trainer with fresh weights and the port's loaded from its
    checkpoint."""
    jt = JaxTrainer()
    jt.set_params(jpairs)
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    tr = NetTrainer()
    tr.set_params(tpairs)
    tr.load_model(path)
    return jt, tr


def _train_both(jt, tr, batches):
    for x, y in batches:
        jt.update(JaxBatch(data=x, label=y))
        tr.update(DataBatch(data=x, label=y))
    assert sorted(jt.params) == sorted(tr.params)
    for key, tags in jt.params.items():
        for tag, w in tags.items():
            np.testing.assert_allclose(
                tr.params[key][tag].numpy(), np.asarray(w),
                rtol=NET_RTOL, atol=NET_ATOL, err_msg=f"{key}/{tag}")


def _batches(seed, n, xshape, nclass):
    r = np.random.RandomState(seed)
    return [(r.randn(*xshape).astype(np.float32),
             r.randint(0, nclass, (xshape[0], 1)).astype(np.float32))
            for _ in range(n)]


def test_moe_net_trains_like_jax(tmp_path):
    jt, tr = _trainers(tmp_path, MOE_CFG, MOE_CFG)
    assert tr.params["l0_mx"]["wmat"].shape == (4, 32, 10)
    _train_both(jt, tr, _batches(3, 5, (16, 10), 4))


def test_pipe_mlp_net_trains_like_jax(tmp_path):
    jt, tr = _trainers(tmp_path, PIPE_MLP_CFG, PIPE_MLP_CFG)
    assert tr.params["l0_pp"]["wmat"].shape == (4, 16, 16)
    _train_both(jt, tr, _batches(2, 4, (16, 16), 4))


def test_transformer_conf_pipeline_step_matches_jax(tmp_path):
    kw = dict(batch_size=16, seq_len=8, dim=16, nhead=2, nlayer=4,
              num_class=4, dev="cpu", compute_dtype="float32",
              pipeline_parallel=1, n_microbatch=4)
    jt, tr = _trainers(
        tmp_path, jcfg.parse_pairs(jmodels.transformer_conf(**kw)),
        tcfg.parse_pairs(tmodels.transformer_conf(**kw)))
    assert tr.params["l0_blocks"]["wqkv"].shape == (4, 48, 16)
    _train_both(jt, tr, _batches(3, 1, (16, 8, 16), 4))


# ----------------------------------------------------------------------
# the pipeline entry, model_parallel, checkpoints


def _mlp_block(p, x):
    return torch.relu(x @ p["w"] + p["b"])


def _mlp_stack(rng, l, d=16):
    return {"w": rng.randn(l, d, d).astype(np.float32) * 0.3,
            "b": rng.randn(l, d).astype(np.float32) * 0.1}


def test_pipeline_apply_one_stage_is_the_stack():
    rng = np.random.RandomState(9)
    stack = {t: torch.from_numpy(v) for t, v in _mlp_stack(rng, 4).items()}
    x = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    want = x
    for i in range(4):
        want = _mlp_block({"w": stack["w"][i], "b": stack["b"][i]}, want)
    got = tpipeline.pipeline_apply(_mlp_block, stack, x, None,
                                   n_microbatch=2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("l,micro", [(6, 2), (8, 3)])
def test_pipeline_apply_checks_match_jax(l, micro):
    rng = np.random.RandomState(10)
    stack = _mlp_stack(rng, l)
    x = rng.randn(8, 16).astype(np.float32)
    plan = make_mesh("cpu:0-3", model_parallel=4)
    with pytest.raises(ValueError) as je:
        jpipeline.pipeline_apply(
            lambda p, h: jax.nn.relu(h @ p["w"] + p["b"]),
            {t: jnp.asarray(v) for t, v in stack.items()}, jnp.asarray(x),
            plan.mesh, n_microbatch=micro)
    with pytest.raises(ValueError) as te:
        tpipeline.pipeline_apply(
            _mlp_block, {t: torch.from_numpy(v) for t, v in stack.items()},
            torch.from_numpy(x), tmesh.MeshPlan(torch.device("cpu"),
                                                n_model=4),
            n_microbatch=micro, n_block=l)
    assert str(te.value) == str(je.value)


def test_pipeline_apply_refuses_a_stack_not_cut_per_stage():
    """A stage handed the whole stack would run every block once per
    stage: the stage's blocks times the stages must be ``n_block``."""
    rng = np.random.RandomState(11)
    stack = _mlp_stack(rng, 8)
    with pytest.raises(ValueError, match="a stage holds 8 of 8 blocks "
                       "over 4 stages"):
        tpipeline.pipeline_apply(
            _mlp_block, {t: torch.from_numpy(v) for t, v in stack.items()},
            torch.from_numpy(rng.randn(8, 16).astype(np.float32)),
            tmesh.MeshPlan(torch.device("cpu"), n_model=4), n_microbatch=2,
            n_block=8)


def test_model_parallel_refused_where_jax_raises_on_one_device():
    pairs = PIPE_MLP_CFG + [("model_parallel", "2")]
    jt = JaxTrainer()
    jt.set_params(pairs)
    with pytest.raises(ValueError, match="model_parallel=2 must divide") as je:
        jt.init_model()
    port = NetTrainer()
    port.set_params(pairs)
    with pytest.raises(ValueError) as te:
        port.init_model()
    assert str(te.value) == str(je.value)
    tr = NetTrainer()
    tr.set_params(PIPE_MLP_CFG + [("model_parallel", "1")])
    tr.init_model()
    assert tr.params["l0_pp"]["wmat"].shape == (4, 16, 16)


def test_stacked_tensors_cross_the_checkpoint_both_ways(tmp_path):
    """The 3-D ``moe`` and ``pipe_*`` tensors, f32 and as ``~bf16`` words,
    from the JAX writer to the port's reader and back."""
    kw = dict(batch_size=4, seq_len=8, dim=16, nhead=2, nlayer=2,
              num_class=4, dev="cpu", compute_dtype="float32",
              pipeline_parallel=1)
    jpairs = jcfg.parse_pairs(jmodels.transformer_conf(**kw))
    tpairs = tcfg.parse_pairs(tmodels.transformer_conf(**kw))
    jt = JaxTrainer()
    jt.set_params(jpairs)
    jt.init_model()
    # a bf16 leaf: the JAX writer stores it as uint16 words
    jt.params["l0_blocks"]["wff1"] = jt.params["l0_blocks"]["wff1"].astype(
        jnp.bfloat16)
    path = str(tmp_path / "jax.model")
    jt.save_model(path)
    tr = NetTrainer()
    tr.set_params(tpairs)
    tr.load_model(path)
    for tag, w in jt.params["l0_blocks"].items():
        got = tr.params["l0_blocks"][tag]
        assert got.dtype == torch.float32 and got.dim() == w.ndim
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(w.astype(jnp.float32)))
    tr.params["l0_blocks"]["wqkv"] = tr.params["l0_blocks"]["wqkv"].to(
        torch.bfloat16)
    back = str(tmp_path / "port.model")
    tr.save_model(back)
    header, params, _, _ = JaxTrainer._read_model_file(back)
    assert params["l0_blocks"]["wqkv"].dtype == jnp.bfloat16
    for tag, w in tr.params["l0_blocks"].items():
        np.testing.assert_array_equal(
            np.asarray(params["l0_blocks"][tag]).astype(np.float32),
            w.float().numpy())
