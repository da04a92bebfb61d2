"""The model axis and sequence parallelism, on the CPU: gloo ranks of
the port against the JAX package's ``shard_map`` on CPU devices.

One job of two rank processes (``tests/torch_sp_rank.py``, each with a
deadline) with ``model_parallel = 2``:

* ``ring_self_attention``, ``ring_self_attention_flash`` (the flash
  kernels' plain versions per hop, with offsets) and
  ``a2a_self_attention`` on whole ``(2, 32, 4, 16)`` tensors, causal
  and not: the output and the gradients of ``sum(o * w)`` against the
  JAX functions on a ``(1, 2)`` mesh (Pallas in interpret mode for the
  flash ring), within ``OPS_ATOL`` / ``GRAD_RTOL``, ``GRAD_ATOL``.  A
  scatter or gather backward that multiplied or dropped the gradient
  by the model size fails these.  ``ppermute`` and ``all_to_all``
  alone, forward and backward, give their definitions' bits.
* The small LM (``transformer_lm_conf``: T 64, dim 32, 2 heads, 2
  blocks, f32, batch 2, SGD) from one checkpoint, 2 steps under
  ``seq_parallel = ring`` and ``alltoall``, each with ``attn_impl =
  pallas`` and ``xla``: the train metrics of the steps (the logloss is
  the LM's loss, ``LOSS_RTOL``) and every weight (``ATOL``) against the
  JAX trainer on ``dev = cpu:0-1``; the two model ranks' weights and
  losses equal bit for bit.

One job of four rank processes, a 2 x 2 mesh (``dist_num_proc = 4``,
``model_parallel = 2``): the LM under ``ring`` / ``xla`` (the dense
ring: the flash ring's hops are held above) on a global batch of 4, and a conv net with batch norm (``bn_eval = batch`` and
``running``) and dropout (draws a function of the shape, as in
``tests/test_torch_parallel_dp.py``), against the JAX trainer on four
CPU devices: the gradient reduction and batch norm's sums go over the
data sub-group, the two data indices read their own rows, and the
model axis neither doubles nor drops a gradient.  The model ranks hold
their slices of the cut tensors (``MeshPlan.model_dim``), so the
bytewise checks compare the whole tensors gathered over the model
axis across every rank, and each slice across the ranks that hold it.
The conv net again with a second trainer of
``model_parallel = 1`` built in the same processes before the steps:
each trainer's collectives go over its own plan's sub-groups.

In one process: the shape errors (``T % n_model``, ``nhead % n_model``)
with the JAX messages, and ``decode`` refused with ``seq_parallel``.
"""

import os
import types

import numpy as np
import pytest

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.models import transformer_lm_conf
from cxxnet_tpu_torch.nnet.trainer import NetTrainer

from test_torch_parallel_dp import NET as BN_NET  # noqa: E402
from test_torch_parallel_dp import run_ranks as _run_ranks  # noqa: E402
from torch_dp_rank import shape_draws  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
OPS_ATOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
LOSS_RTOL = 1e-5
ATOL = 1e-6  # weights after 2 SGD steps at eta 0.1
LM_STEPS = 2
LM_CASES = [(sp, impl) for sp in ("ring", "alltoall")
            for impl in ("pallas", "xla")]
B, T, H, D = 2, 32, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer's compile listener registers."""
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


def run_ranks(spec, tmp, world):
    _run_ranks(spec, tmp, world, script="torch_sp_rank.py")


def lm_conf(sp: str, impl: str, batch: int, dev: str = "cpu") -> str:
    conf = transformer_lm_conf(
        seq_len=64, dim=32, nhead=2, nlayer=2, batch_size=batch, dev=dev,
        compute_dtype="float32", attn_impl=impl, eta=0.1,
        seq_parallel={"ring": 1, "alltoall": 2}[sp])
    return conf.replace("updater = adam\n", "")


def _lm_batches(path, batch, seed):
    rng = np.random.RandomState(seed)
    np.savez(path,
             data=rng.randint(0, 256, (LM_STEPS, batch, 64)).astype(
                 np.float32),
             label=rng.randint(0, 256, (LM_STEPS, batch, 64)).astype(
                 np.float32))


def _init(conf_text, path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf_text))
    tr.init_model()
    tr.save_model(path)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp"))
    rng = np.random.RandomState(0)
    ops = os.path.join(tmp, "ops.npz")
    np.savez(ops, **{n: rng.randn(B, T, H, D).astype(np.float32)
                     for n in ("q", "k", "v", "w")})
    batches = os.path.join(tmp, "lm.npz")
    _lm_batches(batches, 2, 1)
    init = os.path.join(tmp, "lm_init.model")
    _init(lm_conf("ring", "xla", 2), init)
    runs = [dict(cfg=tcfg.parse_pairs(lm_conf(sp, impl, 2))
                 + [("model_parallel", "2")],
                 init=init, batches=batches, steps=LM_STEPS,
                 out=os.path.join(tmp, f"{sp}_{impl}"), train_metric=True)
            for sp, impl in LM_CASES]
    run_ranks({"ops": ops, "ops_out": os.path.join(tmp, "ops"),
               "model_parallel": 2, "runs": runs}, tmp, 2)
    return {"tmp": tmp, "ops": ops, "init": init, "batches": batches}


def _load(tmp, name, world):
    return [dict(np.load(os.path.join(tmp, f"{name}.r{r}.npz")))
            for r in range(world)]


def _leaves(d):
    return {k: v for k, v in d.items() if k.startswith(("p:", "aux:"))}


# ----------------------------------------------------------------------
# the ops
def _jax_ops(z, name, causal):
    import jax
    import jax.numpy as jnp

    from cxxnet_tpu.ops import attention as ja
    from cxxnet_tpu.parallel import make_mesh

    plan = make_mesh("cpu:0-1", model_parallel=2)
    fn = {"ring": lambda q, k, v: ja.ring_self_attention(
              q, k, v, plan.mesh, "model", causal=causal),
          "ring_flash": lambda q, k, v: ja.ring_self_attention_flash(
              q, k, v, plan.mesh, "model", causal=causal, interpret=True),
          "a2a": lambda q, k, v: ja.a2a_self_attention(
              q, k, v, plan.mesh, "model", causal=causal)}[name]
    qkv = [jnp.asarray(z[n]) for n in ("q", "k", "v")]
    w = jnp.asarray(z["w"])

    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * w), o

    # one program for the output and the gradients
    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*qkv)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "ring_flash", "a2a"])
def test_ops_match_jax_shard_map_on_two_devices(job, name, causal):
    z = np.load(job["ops"])
    want_o, want_g = _jax_ops(z, name, causal)
    tag = f"{name}:{int(causal)}"
    for got in _load(job["tmp"], "ops", 2):
        np.testing.assert_allclose(got[f"{tag}:o"], want_o, rtol=0,
                                   atol=OPS_ATOL)
        for n, g in zip("qkv", want_g):
            np.testing.assert_allclose(got[f"{tag}:d{n}"], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{tag} d{n}")


def _prims_want(z, name):
    """Each rank's output and input gradient of the primitive ``name``
    as ``lax.ppermute`` / ``lax.all_to_all`` define them, rank ``r``
    holding ``x_r = q[r]`` and the cotangent ``w[r]`` (reshaped)."""
    x, w = z["q"], z["w"]
    if name == "ppermute":  # PERM = [(0, 1)]
        zero = np.zeros_like(x[0])
        return [(zero, w[1]), (x[0], zero)]
    t, h = x.shape[1], x.shape[2] // 2
    out = []
    for r in range(2):
        o = np.concatenate([x[s][:, r * h:(r + 1) * h] for s in range(2)], 0)
        dx = np.concatenate([w[j].reshape(2 * t, h, -1)[r * t:(r + 1) * t]
                             for j in range(2)], 1)
        out.append((o, dx))
    return out


@pytest.mark.parametrize("name", ["ppermute", "all_to_all"])
def test_ppermute_and_all_to_all_match_their_definition(job, name):
    """The differentiable primitives over the model sub-group: ``ppermute``
    with a pair that leaves rank 0 without a sender (zeros, and a zero
    gradient on rank 1, which sends to no one in the inverse), and the
    tiled all-to-all from heads to time; their backwards are the inverse
    permutation and the inverse exchange, bit for bit."""
    z = np.load(job["ops"])
    for got, (o, dx) in zip(_load(job["tmp"], "ops", 2),
                            _prims_want(z, name)):
        assert got[f"prim:{name}:o"].tobytes() == o.tobytes()
        assert got[f"prim:{name}:dx"].tobytes() == dx.tobytes()


# ----------------------------------------------------------------------
# the LM over the model axis
def _jax_run(conf_text, dev, mp, init, batches):
    """The JAX trainer on ``dev`` with ``model_parallel = mp``, from
    ``init``, stepped over ``batches``."""
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf_text.replace("dev = cpu\n",
                                                     f"dev = {dev}\n"))
                  + [("model_parallel", str(mp))])
    jt.load_model(init)
    assert jt.mesh_plan.n_model == mp
    b = np.load(batches)
    for k in range(b["data"].shape[0]):
        jt.update(JaxBatch(data=b["data"][k], label=b["label"][k]))
    return jt


def _metric_values(text):
    return [float(f.split(":")[1]) for f in str(text).split("\t") if f]


def _assert_match_jax(got, jt):
    """Every weight and layer state within ``ATOL``, and the steps' train
    metrics where the run kept them (the LM's logloss is its loss)
    within ``LOSS_RTOL``."""
    from cxxnet_tpu.parallel.distributed import fetch_array

    if "train_metric" in got:
        want = _metric_values(jt.train_metric.print("train"))
        assert want and len(want) == len(_metric_values(
            got["train_metric"]))
        np.testing.assert_allclose(_metric_values(got["train_metric"]),
                                   want, rtol=LOSS_RTOL)
    n = 0
    for tree, pre in ((jt.params, "p:"), (jt.aux, "aux:")):
        for key, tags in tree.items():
            for tag, w in tags.items():
                np.testing.assert_allclose(got[f"{pre}{key}/{tag}"],
                                           fetch_array(w), rtol=0,
                                           atol=ATOL, err_msg=f"{key}/{tag}")
                n += 1
    assert n == len(_leaves(got))


@pytest.mark.parametrize("sp,impl", LM_CASES)
def test_lm_over_the_model_axis_matches_jax(job, sp, impl):
    jt = _jax_run(lm_conf(sp, impl, 2), "cpu:0-1", 2, job["init"],
                  job["batches"])
    got = _load(job["tmp"], f"{sp}_{impl}", 2)
    _assert_match_jax(got[0], jt)
    for name, w in _leaves(got[0]).items():
        assert w.tobytes() == got[1][name].tobytes(), name
    np.testing.assert_array_equal(got[0]["losses"], got[1]["losses"])


# ----------------------------------------------------------------------
# a 2 x 2 mesh
BN_CONF = BN_NET + "dev = cpu\n"


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp4"))
    lm_batches = os.path.join(tmp, "lm.npz")
    _lm_batches(lm_batches, 4, 2)
    lm_init = os.path.join(tmp, "lm_init.model")
    _init(lm_conf("ring", "xla", 4), lm_init)
    rng = np.random.RandomState(3)
    bn_batches = os.path.join(tmp, "bn.npz")
    np.savez(bn_batches,
             data=rng.randn(LM_STEPS, 8, 8, 8, 3).astype(np.float32),
             label=rng.randint(0, 4, (LM_STEPS, 8, 1)).astype(np.float32))
    bn_init = os.path.join(tmp, "bn_init.model")
    _init(BN_CONF, bn_init)
    runs = [dict(cfg=tcfg.parse_pairs(lm_conf("ring", "xla", 4))
                 + [("model_parallel", "2")], init=lm_init,
                 batches=lm_batches, steps=LM_STEPS,
                 out=os.path.join(tmp, "lm"), train_metric=True),
            dict(cfg=tcfg.parse_pairs(BN_CONF) + [("model_parallel", "2")],
                 init=bn_init, batches=bn_batches, steps=LM_STEPS,
                 out=os.path.join(tmp, "bn")),
            # a one-axis trainer built in the same processes after this
            # one must not move its reductions onto the whole job
            dict(cfg=tcfg.parse_pairs(BN_CONF) + [("model_parallel", "2")],
                 init=bn_init, batches=bn_batches, steps=LM_STEPS,
                 out=os.path.join(tmp, "bn_decoy"), decoy_model_parallel=1)]
    run_ranks({"runs": runs, "patch_draw": True}, tmp, 4)
    return {"tmp": tmp, "lm": (lm_init, lm_batches),
            "bn": (bn_init, bn_batches), "bn_decoy": (bn_init, bn_batches)}


@pytest.mark.parametrize("net", ["lm", "bn", "bn_decoy"])
def test_two_by_two_mesh_matches_jax_on_four_devices(job4, net,
                                                     monkeypatch):
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape:
                        jnp.asarray(shape_draws(shape) < p))
    conf = lm_conf("ring", "xla", 4) if net == "lm" else BN_CONF
    jt = _jax_run(conf, "cpu:0-3", 2, *job4[net])
    assert (jt.mesh_plan.n_data, jt.mesh_plan.n_model) == (2, 2)
    got = _load(job4["tmp"], net, 4)
    _assert_match_jax(got[0], jt)
    for r in range(1, 4):
        # the whole tensors, gathered over the model axis
        for name, w in _leaves(got[0]).items():
            assert w.tobytes() == got[r][name].tobytes(), (r, name)
        # each slice held by rank r, against its replica on data index 0
        held = got[r % 2]
        for name, w in got[r].items():
            if name.startswith(("s:", "u:")):
                assert w.tobytes() == held[name].tobytes(), (r, name)


# ----------------------------------------------------------------------
# in one process: the refusals
def _attention_pair(**cfg):
    pair = []
    for make in (create_layer, jax_layer):
        lay = make("attention")
        for k, v in cfg.items():
            lay.set_param(k, str(v))
        lay.bind_mesh(types.SimpleNamespace(n_model=2))
        pair.append(lay)
    return pair


@pytest.mark.parametrize("sp,nhead,shape", [
    ("ring", 2, (2, 7, 8)), ("alltoall", 2, (2, 7, 8)),
    ("alltoall", 1, (2, 8, 8)), ("ring", 1, (2, 8, 8))])
def test_shape_checks_are_jax_s(sp, nhead, shape):
    msgs = []
    for lay in _attention_pair(nhead=nhead, seq_parallel=sp):
        try:
            lay.infer_shape([shape])
            msgs.append("ok")
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    if shape[1] == 7:
        assert "divisible by the model axis" in msgs[0]
    assert (msgs[0] == "ok") == (sp == "ring" and shape[1] == 8)


def test_decode_refused_with_seq_parallel_as_jax():
    msgs = []
    for lay in _attention_pair(nhead=2, seq_parallel="ring", causal=1,
                               decode=1, decode_window=8):
        with pytest.raises(ValueError) as e:
            lay.init_aux([(2, 1, 8)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "seq_parallel" in msgs[0]

