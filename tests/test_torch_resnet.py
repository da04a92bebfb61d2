"""The ResNet slice on the CPU, against the JAX package.

* ``batch_norm`` alone, same seeded input, slope and bias in both
  packages: forward in both ``bn_stats`` modes, train and eval, f32
  (rtol = atol = 1e-5: f32 reductions in other orders) and bf16 (within
  2e-2 of the largest magnitude: one bf16 rounding of the output), and
  the input, slope and bias gradients for one cotangent (f32 within
  1e-4 of the largest, bf16 cosine >= 0.999).  ``bn_eval = running``:
  three training calls' EMA (rtol 1e-6) and the eval forward from it.
* One SGD step of a small bottleneck net (stem conv, BN, max pool, two
  ``_res_bottleneck`` blocks, the second a stride-2 projection, avg
  pool, fullc), from one JAX checkpoint on one synthetic batch: every
  tensor's update and momentum within 1e-3 of the JAX package's
  largest, the loss to rtol 1e-5, and the running statistics (within
  1e-5 of each tensor's largest) under ``bn_eval = running``; the bf16 step against the JAX
  bf16 step by cosine: the median tensor >= 0.98 and the whole step
  >= 0.95 (read: 0.9905 and 0.988; the JAX package's own bf16 step
  against its f32 step reads 0.991 and 0.969-0.991 over three seeds),
  the running statistics within 2e-2 of their largest.
* The full-depth ``resnet50_conf`` (batch 2, 32x32, 10 classes)
  forward in both packages from one checkpoint (atol 1e-5, rtol 1e-4).
* Each zoo builder's text equal to the JAX builder's.
* ``aux:`` and ``ust:`` checkpoint entries both ways, bit for bit, and
  the next step from them within the update tolerance; ``continue = 1``
  resuming a ``save_ustate = 1`` run exactly.
* Each new updater's three steps against the JAX updater, NaN
  gradients included (rtol 1e-5, atol 1e-7).
* A served bucket of a BN net against the JAX engine at the same bucket.
* ResNet-50's four sibling-1x1 groups, bias-free, three of them stride
  2, with operands that meet K6's wgmma rule (``takes_wgmma``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu import models as jmodels
from cxxnet_tpu.layers import create_layer as jcreate
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.updater import create_updater as jcreate_updater

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import models as tmodels
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.models.builders import _res_bottleneck
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops.kernels import conv_block
from cxxnet_tpu_torch.updater import create_updater

UPDATE_TOL = 1e-3  # of each tensor's largest update


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer's compile listener registers, which an
    exposition check later in the same process rejects."""
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


# ----------------------------------------------------------------------
# batch_norm alone

def _bn_pair(**keys):
    ours, ref = create_layer("batch_norm"), jcreate("batch_norm")
    for k, v in keys.items():
        ours.set_param(k, v)
        ref.set_param(k, v)
    return ours, ref


def _bn_inputs(seed, shape=(4, 5, 5, 6)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    slope = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    return x, slope, bias


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _close(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("stats", ["twopass", "onepass"])
def test_batch_norm_matches_jax(stats, train, dtype):
    ours, ref = _bn_pair(bn_stats=stats, eps="1e-5")
    x, slope, bias = _bn_inputs(1)
    g = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)

    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    pt = {"wmat": torch.from_numpy(slope).requires_grad_(True),
          "bias": torch.from_numpy(bias).requires_grad_(True)}
    (yt,) = ours.apply(ours.prepare(pt, tdt), [xt], train=train)
    assert yt.dtype == tdt
    yt.backward(torch.from_numpy(g).to(tdt))

    def f(xj, pj):
        return ref.apply(pj, [xj], train=train)[0]

    pj = {"wmat": jnp.asarray(slope), "bias": jnp.asarray(bias)}
    yj, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt), pj)
    gx, gp = vjp(jnp.asarray(g).astype(jdt))
    _close(yt.float().detach().numpy(), yj.astype(jnp.float32), dtype)
    grads = ((xt.grad, gx), (pt["wmat"].grad, gp["wmat"]),
             (pt["bias"].grad, gp["bias"]))
    for got, want in grads:
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        else:
            assert _cos(got, want) >= 0.999


@pytest.mark.parametrize("stats", ["twopass", "onepass"])
def test_batch_norm_running_ema_over_three_steps(stats):
    ours, ref = _bn_pair(bn_stats=stats, bn_eval="running",
                         bn_momentum="0.8")
    x, slope, bias = _bn_inputs(3)
    pt = {"wmat": torch.from_numpy(slope), "bias": torch.from_numpy(bias)}
    pj = {"wmat": jnp.asarray(slope), "bias": jnp.asarray(bias)}
    at = ours.init_aux([x.shape])
    aj = ref.init_aux([x.shape])
    assert sorted(at) == sorted(aj) == ["rmean", "rvar"]
    for step in range(3):
        xs = x * (step + 1) + step
        (yt,), at = ours.apply_stateful(pt, at, [torch.from_numpy(xs)],
                                        train=True)
        (yj,), aj = ref.apply_stateful(pj, aj, [jnp.asarray(xs)],
                                       train=True)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)
        assert not at["rmean"].requires_grad
        for k in at:
            np.testing.assert_allclose(at[k].numpy(), aj[k], rtol=1e-6)
    # eval normalises with the running statistics, not the batch's
    (yt,), _ = ours.apply_stateful(pt, at, [torch.from_numpy(x)])
    (yj,), _ = ref.apply_stateful(pj, aj, [jnp.asarray(x)])
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)
    (yb,) = ours.apply(pt, [torch.from_numpy(x)])
    assert not np.allclose(yb.numpy(), yt.numpy())


def test_batch_norm_params_stay_f32_and_no_aux_without_running():
    ours, _ = _bn_pair()
    assert ours.init_aux([(2, 3, 3, 4)]) == {}
    assert ours.eps == 1e-10 and ours.bn_momentum == 0.9
    p = ours.init_params(None, [(2, 3, 3, 4)])
    prepared = ours.prepare(p, torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in prepared.values())
    with pytest.raises(ValueError):
        ours.set_param("bn_eval", "ema")


# ----------------------------------------------------------------------
# a small bottleneck net: one training step against the JAX trainer

def _bottleneck_conf(dtype="float32", extra=""):
    net = (
        "netconfig = start\n"
        "layer[0->c1] = conv:conv1\n"
        "  kernel_size = 3\n  stride = 1\n  pad = 1\n  nchannel = 8\n"
        "  no_bias = 1\n  random_type = kaiming\n"
        "layer[c1->b1] = batch_norm:bn1\n"
        "layer[b1->b1] = relu\n"
        "layer[b1->p1] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        + _res_bottleneck("p1", "s0b0", 8, 4, 16, 1)
        + _res_bottleneck("s0b0", "s1b0", 16, 8, 32, 2)
        + "layer[s1b0->pool] = avg_pooling\n  kernel_size = 3\n"
        "  stride = 1\n"
        "layer[pool->flat] = flatten\n"
        "layer[flat->fc] = fullc:fc\n  nhidden = 5\n"
        "  random_type = xavier\n"
        "layer[fc->fc] = softmax\n"
        "netconfig = end\n")
    return net + (
        "input_shape = 3,12,12\nbatch_size = 8\ndev = cpu\n"
        "updater = sgd\neta = 0.1\nmomentum = 0.9\nwd = 0.0005\n"
        "wmat:lr = 0.1\nwmat:wd = 0.0001\nbn_stats = onepass\n"
        f"compute_dtype = {dtype}\nmetric = error\n" + extra)


def _batch(rows, seed, side=12, nclass=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, side, side, 3).astype(np.float32)
    y = rng.randint(0, nclass, (rows, 1)).astype(np.float32)
    return x, y


def _snapshot(params):
    return {k: {t: np.array(v, dtype=np.float32, copy=True)
                for t, v in tags.items()} for k, tags in params.items()}


def _jax_trainer(conf, path, seed, steps=0, x=None, y=None):
    """A JAX trainer loaded from fresh weights (drawn by the port and
    written to ``path``: the JAX package's own draw compiles a program
    per shape), after ``steps`` updates on ``(x, y)``, saved again."""
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.set_param("seed", str(seed))
    tr.init_model()
    tr.save_model(path)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf))
    jt.load_model(path)
    for _ in range(steps):
        jt.update_all(x, y)
    if steps:
        jt.save_model(path)
    return jt


def _port(conf, path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.load_model(path)
    return tr


def _assert_updates_match(jt, tr, w0, slot="m"):
    assert sorted(jt.params) == sorted(tr.params)
    for key, tags in w0.items():
        for tag, w in tags.items():
            dj = np.asarray(jt.params[key][tag]) - w
            dt = tr.params[key][tag].numpy() - w
            scale = np.abs(dj).max()
            assert scale > 0, f"{key}/{tag}: no update"
            assert np.abs(dt - dj).max() <= UPDATE_TOL * scale, f"{key}/{tag}"
            mj = np.asarray(jt.ustates[key][tag][slot])
            mt = tr.ustates[key][tag][slot].numpy()
            assert (np.abs(mt - mj).max()
                    <= UPDATE_TOL * np.abs(mj).max()), f"{key}/{tag} {slot}"


def _assert_aux_match(jt, tr, tol=1e-5):
    """Each running statistic within ``tol`` of its tensor's largest (a
    channel's mean near 0 has no relative precision)."""
    assert sorted(jt.aux) == sorted(tr.aux)
    for key, tags in jt.aux.items():
        for tag, a in tags.items():
            a = np.asarray(a)
            assert (np.abs(tr.aux[key][tag].numpy() - a).max()
                    <= tol * np.abs(a).max()), f"{key}/{tag}"


@pytest.mark.parametrize("bn_eval", ["batch", "running"])
def test_bottleneck_step_matches_jax(tmp_path, bn_eval):
    conf = _bottleneck_conf(extra=f"bn_eval = {bn_eval}\n")
    path = str(tmp_path / "0000.model")
    jt = _jax_trainer(conf, path, seed=4)
    tr = _port(conf, path)
    groups, _ = tr.net._sibling_1x1_groups()
    assert len(groups) == 2  # s0b0 stride 1, s1b0 stride 2, bias-free
    assert sorted(tr.net.layer_objs[i].param.stride for i in groups) == [1, 2]
    assert len(tr.aux) == (9 if bn_eval == "running" else 0)
    x, y = _batch(8, seed=5)
    w0 = _snapshot(jt.params)
    _, jloss = jt.net.forward(jt.params, jnp.asarray(x),
                              labels=jnp.asarray(y), train=True,
                              aux=jt.aux or None)
    jt.update_all(x, y)
    tr.update_all(x, y)
    np.testing.assert_allclose(float(tr.last_loss), float(jloss), rtol=1e-5)
    _assert_updates_match(jt, tr, w0)
    _assert_aux_match(jt, tr)
    xe, _ = _batch(4, seed=6)
    np.testing.assert_allclose(
        tr.predict_fn()(tr.params, tr.aux, xe, ()).numpy(),
        np.asarray(jt.predict_fn()(jt.params, jt.aux, xe, ())),
        atol=1e-5, rtol=1e-4)


def test_bottleneck_bf16_step_matches_jax_by_cosine(tmp_path):
    conf = _bottleneck_conf("bfloat16", "bn_eval = running\n")
    path = str(tmp_path / "0000.model")
    jt = _jax_trainer(conf, path, seed=8)
    tr = _port(conf, path)
    assert all(w.dtype == torch.float32 for tags in tr.params.values()
               for w in tags.values())
    x, y = _batch(8, seed=9)
    w0 = _snapshot(jt.params)
    jt.update_all(x, y)
    tr.update_all(x, y)
    cos, dts, djs = [], [], []
    for key, tags in w0.items():
        for tag, w in tags.items():
            dj = np.asarray(jt.params[key][tag]) - w
            dt = tr.params[key][tag].numpy() - w
            cos.append(_cos(dt, dj))
            dts.append(dt.ravel() / np.abs(dj).max())
            djs.append(dj.ravel() / np.abs(dj).max())
    # bf16 at batch 8 is noisy per tensor in both packages alike: a BN
    # bias whose gradient nearly cancels reads cosine 0.29-0.98 between
    # the JAX package's own bf16 and f32 steps; the median tensor and
    # the whole step (each tensor scaled by its largest update) hold
    assert np.median(cos) >= 0.98
    assert _cos(np.concatenate(dts), np.concatenate(djs)) >= 0.95
    _assert_aux_match(jt, tr, tol=2e-2)


@pytest.mark.parametrize("bn_eval", ["running", "batch"])
def test_resnet50_full_depth_forward_matches_jax(tmp_path, bn_eval):
    """Full depth at batch 2, 32x32: the port writes the checkpoint and
    the JAX package loads it.  Under ``bn_eval = running`` the 53 BNs
    normalise with the (initial) running statistics and the scores hold
    to atol 1e-5 / rtol 1e-4.  Under ``batch`` the last stage is 1x1,
    so each of its BNs normalises two values per channel with eps 1e-10:
    any difference between the two values' rounding is amplified without
    bound (1.95e-4 of its input's largest became 0.155 at ``s3b0_a``),
    in both packages alike, so the features are held at ``s2b5``, the
    end of stage 3 (2x2, eight values per channel; read 2.6e-4 of their
    largest), within 1e-3."""
    from cxxnet_tpu.io.data import DataBatch as JaxBatch
    from cxxnet_tpu_torch.io.data import DataBatch

    conf = tmodels.resnet50_conf(batch_size=2, input_size=32, num_class=10,
                                 dev="cpu", compute_dtype="float32")
    conf += f"bn_eval = {bn_eval}\n"
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.set_param("seed", "11")
    tr.init_model()
    assert sum(type(l).__name__ == "BatchNormLayer"
               for l in tr.net.layer_objs) == 53
    assert sum(len(t) for t in tr.params.values()) == 161
    assert len(tr.aux) == (53 if bn_eval == "running" else 0)
    path = str(tmp_path / "0000.model")
    tr.save_model(path)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf))
    jt.load_model(path)
    x, y = _batch(2, seed=12, side=32, nclass=10)
    if bn_eval == "running":
        got = tr.predict_fn()(tr.params, tr.aux, x, ()).numpy()
        ref = np.asarray(jt.predict_fn()(jt.params, jt.aux, x, ()))
        assert got.shape == (2, 10) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        got = tr.extract_feature(DataBatch(data=x, label=y), "s2b5")
        ref = np.asarray(jt.extract_feature(JaxBatch(data=x, label=y),
                                            "s2b5"))
        assert got.shape == (2, 2, 2, 1024)
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


# ----------------------------------------------------------------------
# the zoo builders

BUILDER_CASES = [
    ("mnist_mlp", {}), ("mnist_conv", {}), ("alexnet", {}),
    ("alexnet", {"input_size": 67, "batch_size": 4, "dev": "cpu"}),
    ("googlenet", {}), ("vgg16", {}), ("vgg19", {}), ("resnet50", {}),
    ("resnet50", {"batch_size": 2, "input_size": 32, "num_class": 10,
                  "compute_dtype": "float32"}),
    ("resnet101", {}), ("resnet152", {}), ("kaggle_bowl", {}),
    ("transformer", {}), ("transformer_lm", {"text_file": "a.txt"}),
]


@pytest.mark.parametrize("name,kw", BUILDER_CASES)
def test_builder_text_equals_jax(name, kw):
    assert sorted(tmodels.MODEL_BUILDERS) == sorted(jmodels.MODEL_BUILDERS)
    assert (tmodels.MODEL_BUILDERS[name](**kw)
            == jmodels.MODEL_BUILDERS[name](**kw))


def test_example_resnet_confs_are_the_builders_text():
    from cxxnet_tpu_torch import config as cfgmod

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for depth in (50, 101, 152):
        path = os.path.join(repo, "example", "ImageNet",
                            f"resnet{depth}.conf")
        built = cfgmod.parse_pairs(
            tmodels.MODEL_BUILDERS[f"resnet{depth}"]())
        assert cfgmod.parse_file(path) == built


def test_builders_raise_at_build_for_layers_not_ported():
    """Two pipeline stages ask for ``model_parallel = 2``: on one device
    the build raises the JAX package's message (over two ranks the GPipe
    stages train: test_torch_model_axis.py); one stage builds the block
    stack."""
    conf = tmodels.transformer_conf(pipeline_parallel=2, dev="cpu")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    with pytest.raises(ValueError, match="model_parallel=2 must divide "
                                         "the device count 1"):
        tr.init_model()
    conf = tmodels.transformer_conf(pipeline_parallel=1, dev="cpu")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.init_model()
    assert tr.params["l0_blocks"]["wqkv"].shape == (2, 3 * 128, 128)


# ----------------------------------------------------------------------
# checkpoints: aux: and ust: entries both ways, exact resume

def _assert_state_equal(jt, tr):
    for key, tags in jt.params.items():
        for tag, w in tags.items():
            np.testing.assert_array_equal(tr.params[key][tag].numpy(),
                                          np.asarray(w))
    for key, tags in jt.aux.items():
        for tag, w in tags.items():
            np.testing.assert_array_equal(tr.aux[key][tag].numpy(),
                                          np.asarray(w))
    for key, tags in jt.ustates.items():
        for tag, slots in tags.items():
            assert sorted(slots) == sorted(tr.ustates[key][tag])
            for slot, w in slots.items():
                np.testing.assert_array_equal(
                    tr.ustates[key][tag][slot].numpy(), np.asarray(w))


@pytest.mark.parametrize("writer,updater", [("jax", "sgd"),
                                            ("port", "lamb")])
def test_aux_and_ust_checkpoints_load_both_ways(tmp_path, writer, updater):
    conf = _bottleneck_conf(extra="bn_eval = running\nsave_ustate = 1\n"
                            f"updater = {updater}\n")
    x, y = _batch(8, seed=13)
    path = str(tmp_path / "0002.model")
    if writer == "jax":
        src = _jax_trainer(conf, path, seed=14, steps=2, x=x, y=y)
        dst = _port(conf, path)
        _assert_state_equal(src, dst)
        jt, tr = src, dst
    else:
        init = str(tmp_path / "0000.model")
        _jax_trainer(conf, init, seed=14)
        tr = _port(conf, init)
        for _ in range(2):
            tr.update_all(x, y)
        tr.save_model(path, round_=2)
        jt = JaxTrainer()
        jt.set_params(jcfg.parse_pairs(conf))
        jt.load_model(path)
        _assert_state_equal(jt, tr)
    assert any(np.abs(np.asarray(s)).max() > 0
               for tags in jt.ustates.values() for sl in tags.values()
               for s in sl.values())
    assert jt.epoch_counter == tr.epoch_counter == 2
    # the next step, from the restored state, agrees
    w0 = _snapshot(jt.params)
    x2, y2 = _batch(8, seed=15)
    jt.update_all(x2, y2)
    tr.update_all(x2, y2)
    if updater == "sgd":
        _assert_updates_match(jt, tr, w0)
    else:
        # lamb's m1 / sqrt(m2) is ill-conditioned where a gradient is
        # near 0 (one bn1 bias entry read 0.00079 against 0.00070): each
        # tensor's update by cosine
        for key, tags in w0.items():
            for tag, w in tags.items():
                assert _cos(tr.params[key][tag].numpy() - w,
                            np.asarray(jt.params[key][tag]) - w) >= 0.999
    _assert_aux_match(jt, tr)


RESUME_CONF = """
data = train
iter = synthetic
  nsample = 16
  input_shape = 3,12,12
  nclass = 5
iter = end
""" + _bottleneck_conf(extra="bn_eval = running\nsilent = 1\n")


@pytest.mark.parametrize("save_ustate", [1, 0])
def test_continue_resumes_a_save_ustate_run_exactly(tmp_path, save_ustate):
    conf = tmp_path / "r.conf"
    conf.write_text(RESUME_CONF)
    common = [str(conf), "task=train", "seed=3",
              f"save_ustate={save_ustate}"]
    LearnTask().run(common + [f"model_dir={tmp_path / 'a'}", "num_round=2"])
    LearnTask().run(common + [f"model_dir={tmp_path / 'b'}", "num_round=1"])
    LearnTask().run(common + [f"model_dir={tmp_path / 'b'}", "num_round=2",
                              "continue=1"])
    whole, resumed = (NetTrainer._read_model_file(
        str(tmp_path / d / "0002.model")) for d in ("a", "b"))
    assert whole[0]["epoch_counter"] == resumed[0]["epoch_counter"] == 4
    assert bool(whole[3]) == bool(save_ustate)
    same = all(np.array_equal(w, resumed[1][k][t])
               for k, tags in whole[1].items() for t, w in tags.items())
    # with the momentum saved the resumed run is the same run; without
    # it the momentum restarts at zero and the weights differ
    assert same == bool(save_ustate)
    for k, tags in whole[2].items():
        for t, w in tags.items():
            assert np.array_equal(w, resumed[2][k][t]) == bool(save_ustate)


# ----------------------------------------------------------------------
# the new updaters against the JAX package's

UPDATER_KEYS = {
    "nag": {"momentum": "0.8"},
    "rmsprop": {"rho": "0.9", "eps": "1e-6"},
    "adagrad": {"eps": "1e-7"},
    "lars": {"momentum": "0.9", "trust_coeff": "0.01"},
    "lamb": {"beta1": "0.8", "beta2": "0.99", "eps": "1e-5"},
}


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("name", sorted(UPDATER_KEYS))
def test_new_updater_steps_match_jax(name, clip):
    keys = {"lr": "0.05", "wd": "0.01", "lr:schedule": "expdecay",
            "lr:gamma": "0.5", "lr:step": "2", **UPDATER_KEYS[name]}
    if clip:
        keys["clip_gradient"] = str(clip)
    ours, ref = create_updater(name, "wmat"), jcreate_updater(name, "wmat")
    for k, v in keys.items():
        ours.set_param(k, v)
        ref.set_param(k, v)
    rng = np.random.RandomState(17)
    w = rng.randn(6, 7).astype(np.float32)
    wt, wj = torch.from_numpy(w.copy()), jnp.asarray(w)
    st, sj = ours.init_state(wt), ref.init_state(wj)
    for epoch in range(3):
        g = rng.randn(6, 7).astype(np.float32)
        if clip:
            g[1, 2] = g[4, 0] = np.nan
        ours.apply(wt, torch.from_numpy(g), st, epoch)
        wj, sj = ref.apply(wj, jnp.asarray(g), sj, jnp.asarray(epoch))
        np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-5, atol=1e-7)
        for slot in sj:
            np.testing.assert_allclose(st[slot].numpy(), sj[slot],
                                       rtol=1e-5, atol=1e-7)
    # nag takes no clip (as in the JAX package): its NaNs stay
    assert np.isfinite(wt.numpy()).all() == (name != "nag" or not clip)


def test_nag_without_clip_keeps_nans_as_jax_does():
    ours, ref = create_updater("nag", "bias"), jcreate_updater("nag", "bias")
    w = np.ones(4, np.float32)
    g = np.array([1.0, np.nan, -2.0, 0.5], np.float32)
    wt = torch.from_numpy(w.copy())
    st = ours.init_state(wt)
    ours.apply(wt, torch.from_numpy(g), st, 0)
    wj, _ = ref.apply(jnp.asarray(w), jnp.asarray(g),
                      ref.init_state(jnp.asarray(w)), jnp.asarray(0))
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-6)
    assert np.isnan(wt.numpy()[1])


# ----------------------------------------------------------------------
# serving a BN net: answers at equal buckets

def test_served_bucket_matches_the_jax_engine(tmp_path):
    from cxxnet_tpu.serve import Engine as JaxEngine
    from cxxnet_tpu_torch.serve import Engine

    conf = _bottleneck_conf()
    path = str(tmp_path / "0001.model")
    _jax_trainer(conf, path, seed=19)
    x, _ = _batch(5, seed=20)
    with Engine(cfg=conf, model_in=path, max_batch_size=8,
                batch_timeout_ms=0.0) as ours, \
            JaxEngine(cfg=conf, model_in=path, max_batch_size=8,
                      batch_timeout_ms=0.0) as ref:
        for n in (3, 5):  # buckets 4 and 8
            np.testing.assert_allclose(
                ours.scores(x[:n]), ref.submit(x[:n], kind="scores"),
                atol=1e-5, rtol=1e-4)
        # under bn_eval = batch the zero rows padding a bucket enter the
        # statistics in both packages: an answer depends on its bucket
        assert not np.allclose(ours.scores(x[:3]), ours.scores(x[:5])[:3])


# ----------------------------------------------------------------------
# ResNet-50's sibling-1x1 groups take K6's wgmma rule

def test_resnet50_groups_take_the_wgmma_rule():
    conf = tmodels.resnet50_conf(batch_size=1, dev="cpu")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.init_model()
    net = tr.net
    shapes = net.infer_shapes(1)
    groups, _ = net._sibling_1x1_groups()
    prepared = net.prepare(tr.params)
    seen = []
    for leader, idxs in groups.items():
        spec = net.graph.layers[leader]
        stride = net.layer_objs[leader].param.stride
        grp = prepared["groups"][leader]
        assert grp["bias"] is None
        w2d = grp["w2d"].to(torch.bfloat16)
        x = torch.zeros(shapes[spec.nindex_in[0]], dtype=torch.bfloat16)
        xs = x[:, ::stride, ::stride, :].contiguous()
        x2d = xs.reshape(-1, xs.shape[3])
        assert conv_block.takes_wgmma(x2d, w2d)
        seen.append((stride, x2d.shape[1], w2d.shape[1]))
    assert sorted(seen) == [(1, 64, 320), (2, 256, 640), (2, 512, 1280),
                            (2, 1024, 2560)]


def test_resnet50_bn_tensors_take_the_conf_tags_and_global_eps():
    """K8 takes the BN tensors under the conf's tags, no weight-decay
    exemption: BN's ``wmat`` gets ``wmat:wd`` 1e-4, its ``bias`` the
    global 5e-4; a global ``eps`` reaches every layer, BN's too, in both
    packages (as it reaches ``lamb``'s)."""
    conf = tmodels.resnet50_conf(batch_size=1, input_size=32, dev="cpu")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.init_model()
    bn_keys = {k for k, l in zip(tr.net.param_key, tr.net.layer_objs)
               if type(l).__name__ == "BatchNormLayer"}
    ups = {(k, t): up for (k, t), up in tr.updaters.items() if k in bn_keys}
    assert len(ups) == 2 * 53
    for (key, tag), up in ups.items():
        assert type(up).__name__ == "SGDUpdater"
        want_wd = 1e-4 if tag == "wmat" else 5e-4
        assert (up.param.wd, up.param.base_lr) == (want_wd, 0.1), (key, tag)
    conf += "updater = lamb\neps = 0.001\n"
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.init_model()
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf))
    jt._build_net()
    for net in (tr.net, jt.net):
        bns = [l for l in net.layer_objs
               if type(l).__name__ == "BatchNormLayer"]
        assert len(bns) == 53 and all(l.eps == 1e-3 for l in bns)
    assert all(up.eps == 1e-3 for up in tr.updaters.values())


def test_cli_trains_and_serves_resnet50_at_small_width(tmp_path, capfd):
    """``task=train`` on a ``resnet50_conf`` file as it stands (its
    synthetic sections, ``scan_steps``, ``metric = rec@1/rec@5``,
    ``eval_train``, ``bn_stats = onepass``), cut to 32x32 and 10
    classes, with ``bn_eval = running`` and ``bn_momentum = 0`` (the
    running statistics are the last step's), then its checkpoint served
    by ``Engine``: the bucket's answer equals ``predict_fn``'s, bit for
    bit.  (At the default momentum two steps leave the statistics near
    their (0, 1) start, and the forward overflowed to NaN from them;
    under ``batch`` the answers depend on the bucket.)"""
    from cxxnet_tpu_torch.serve import Engine

    text = tmodels.resnet50_conf(batch_size=4, input_size=32, num_class=10,
                                 nsample=8, dev="cpu",
                                 compute_dtype="float32")
    text += "bn_eval = running\nbn_momentum = 0\n"
    conf = tmp_path / "rn50.conf"
    conf.write_text(text + "silent = 1\n")
    mdir = tmp_path / "m"
    assert LearnTask().run([str(conf), "task=train", f"model_dir={mdir}",
                            "num_round=1", "max_round=1"]) == 0
    err = capfd.readouterr().err
    assert "[1]\ttrain-error:" in err and "\ttest-rec@5:" in err
    x, _ = _batch(3, seed=21, side=32, nclass=10)
    with Engine(cfg=text, model_in=str(mdir / "0001.model"),
                batch_timeout_ms=0.0) as eng:
        tr = eng.trainer
        assert tr.epoch_counter == 2 and len(tr.aux) == 53
        got = eng.scores(x)
        padded = np.concatenate([x, np.zeros((1,) + x.shape[1:], x.dtype)])
        want = tr.predict_fn()(tr.params, tr.aux, padded, ()).numpy()[:3]
    assert got.shape == (3, 10) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
