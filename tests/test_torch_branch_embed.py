"""Branch-embed fusion (``conv_branch_embed``) in the port, against the
JAX package, on the CPU.

* The plan (items and groups) equals the JAX planner's on the JAX
  tests' ``INCEPTION_CFG`` net and on ``example/ImageNet/googlenet.conf``'s
  graph (all nine inception modules group their 3x3 and 5x5 convs).
* ``_apply_branch_embed`` equals the member convs bit for bit on
  integer-valued f32 inputs, and the JAX package's op to rtol 1e-5 on
  random ones.
* From one JAX checkpoint: the forward under ``= 1`` against the JAX
  forward under ``= 1`` (f32, rtol 1e-5, atol 1e-6) and against the
  port's own ``= 0``; one training step under ``= 1`` against the JAX
  package's (each tensor's update within 1e-3 of its largest, the loss
  to rtol 1e-5), and against the port's ``= 0`` step.
* int8 members (codes and scales in the checkpoint): the fused forward
  equals the JAX package's fused forward on the same codes (rtol 1e-5).
* A checkpoint trained under ``= 1`` loads into the JAX package and into
  the port under ``= 0`` with the same predictions.
* The auto value (-1) is off in training, on the CPU and (a deliberate
  deviation, ROADMAP.md section C) on the card; ``remat = 1`` is read
  beside it (``tests/test_torch_remat.py`` trains the two together).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.nnet.graph import NetGraph as JaxGraph
from cxxnet_tpu.nnet.net import FunctionalNet as JaxNet
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.nnet.graph import NetGraph
from cxxnet_tpu_torch.nnet.net import FunctionalNet
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import quant as opsq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOOGLENET = os.path.join(REPO, "example", "ImageNet", "googlenet.conf")
UPDATE_TOL = 1e-3  # of each tensor's largest update
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6

# the JAX tests' net (tests/test_branch_embed.py), on the CPU: branch B's
# 1x1 reduce is declared after c3, so c5's input does not exist at c3's
# position and the plan must move c3's relu past the group
INCEPTION_CFG = [
    ("dev", "cpu"),
    ("batch_size", "16"),
    ("input_shape", "8,12,12"),
    ("eta", "0.1"),
    ("momentum", "0.9"),
    ("netconfig", "start"),
    ("layer[0->1]", "conv:r3"),
    ("kernel_size", "1"), ("pad", "0"), ("nchannel", "6"),
    ("random_type", "xavier"),
    ("layer[1->2]", "relu"),
    ("layer[2->3]", "conv:c3"),
    ("kernel_size", "3"), ("pad", "1"), ("nchannel", "8"),
    ("random_type", "xavier"),
    ("layer[3->4]", "relu"),
    ("layer[0->5]", "conv:r5"),
    ("kernel_size", "1"), ("pad", "0"), ("nchannel", "4"),
    ("random_type", "xavier"),
    ("layer[5->6]", "relu"),
    ("layer[6->7]", "conv:c5"),
    ("kernel_size", "5"), ("pad", "2"), ("nchannel", "4"),
    ("random_type", "xavier"),
    ("layer[7->8]", "relu"),
    ("layer[4,8->9]", "ch_concat"),
    ("layer[9->10]", "flatten"),
    ("layer[10->11]", "fullc:fc"),
    ("nhidden", "4"), ("random_type", "xavier"),
    ("layer[11->11]", "softmax"),
    ("netconfig", "end"),
]


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer's compile listener registers, which an
    exposition check later in the same process (``tests/test_obs.py``)
    rejects."""
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


def _cfg(bembed, extra=()):
    return INCEPTION_CFG + [("conv_branch_embed", str(bembed))] + list(extra)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """One checkpoint of the inception net, written by the JAX package."""
    jt = JaxTrainer()
    jt.set_params(_cfg(1) + [("seed", "11")])
    jt.init_model()
    path = str(tmp_path_factory.mktemp("bembed") / "0000.model")
    jt.save_model(path)
    return path


def _pair(path, bembed):
    """The JAX trainer and the port's trainer, both loaded from the JAX
    checkpoint ``path``, under ``conv_branch_embed = bembed``."""
    jt = JaxTrainer()
    jt.set_params(_cfg(bembed))
    jt.load_model(path)
    tr = NetTrainer()
    tr.set_params(_cfg(bembed))
    tr.load_model(path)
    return jt, tr


def _batch(seed, rows=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 12, 12, 8).astype(np.float32)
    y = rng.randint(0, 4, (rows, 1)).astype(np.float32)
    return x, y


def _plans(cfg):
    """``(port plan, JAX plan)`` over one conf's graph (no weights)."""
    pg = NetGraph()
    pg.configure(cfg)
    jg = JaxGraph()
    jg.configure(cfg)
    return FunctionalNet(pg)._branch_embed_plan(), \
        JaxNet(jg)._branch_embed_plan()


def _googlenet_cfg():
    return tcfg.parse_file(GOOGLENET)


@pytest.mark.parametrize("which", ["inception", "googlenet"])
def test_plan_matches_jax(which):
    cfg = _cfg(1) if which == "inception" else _googlenet_cfg()
    (items, groups), (jitems, jgroups) = _plans(cfg)
    assert items == jitems and groups == jgroups
    n_layers = len(NetGraph().configure(cfg).layers)
    ran = [i for kind, i in items if kind == "L"]
    members = [j for g in groups.values() for j in g]
    assert sorted(ran + members) == list(range(n_layers))
    if which == "inception":
        assert len(groups) == 1 and len(next(iter(groups.values()))) == 2
    else:
        assert len(groups) == 9
        assert all(len(g) == 2 for g in groups.values())


def test_plan_off_domain_and_config():
    """ResNet-shaped strided convs never group; the conf key is read, and
    ``remat`` is read beside it."""
    from cxxnet_tpu_torch.models import resnet50_conf

    cfg = tcfg.parse_pairs(resnet50_conf(batch_size=2, input_size=32,
                                         dev="cpu"))
    (items, groups), (jitems, jgroups) = _plans(
        cfg + [("conv_branch_embed", "1")])
    assert items is None and groups == {} and jitems is None
    g = NetGraph()
    g.configure(_cfg(1))
    assert FunctionalNet(g).conv_branch_embed == 1
    g = NetGraph()
    g.configure(_cfg(1, [("remat", "1")]))
    net = FunctionalNet(g)
    assert net.remat == 1 and net.use_branch_embed()


def test_auto_rule():
    """-1 is off for training and on the CPU, as in the JAX package; on
    the card the port keeps it off where the JAX package turns it on for
    inference (the deviation ROADMAP.md section C records)."""
    g = NetGraph()
    g.configure(_cfg(-1))
    net = FunctionalNet(g)
    jg = JaxGraph()
    jg.configure(_cfg(-1))
    jnet = JaxNet(jg)
    assert net.use_branch_embed() is False
    for train in (True, False):
        assert jnet.use_branch_embed(train, backend="cpu") is False
    assert jnet.use_branch_embed(True, backend="tpu") is False
    assert jnet.use_branch_embed(False, backend="tpu") is True  # deviation
    for v, want in ((0, False), (1, True)):
        net.conv_branch_embed = jnet.conv_branch_embed = v
        assert net.use_branch_embed() is want
        for train in (True, False):
            assert jnet.use_branch_embed(train, backend="cpu") is want


def _member_convs(x3, x5, w3, w5, b3, b5):
    """The two member convs as the port's conv layer runs them."""
    def conv(x, w, b, pad):
        y = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=pad)
        return y.permute(0, 2, 3, 1)
    return conv(x3, w3, b3, 1), conv(x5, w5, b5, 2)


def _group(ws, bs):
    ps = [{"wmat": w, "bias": b} for w, b in zip(ws, bs)]
    return {"wk": FunctionalNet._embed_kernel(ps, torch.float32),
            "members": None, "bias": torch.cat(bs),
            "splits": [w.shape[3] for w in ws]}


def test_apply_branch_embed_exact_and_against_jax():
    rng = np.random.RandomState(0)

    def ints(*shape):
        return torch.from_numpy(rng.randint(-3, 4, shape).astype(np.float32))

    x3, x5 = ints(2, 9, 9, 6), ints(2, 9, 9, 4)
    w3, w5 = ints(3, 3, 6, 8), ints(5, 5, 4, 3)
    b3, b5 = ints(8), ints(3)
    o3, o5 = FunctionalNet._apply_branch_embed(
        _group([w3, w5], [b3, b5]), [x3, x5])
    y3, y5 = _member_convs(x3, x5, w3, w5, b3, b5)
    assert torch.equal(o3, y3) and torch.equal(o5, y5)

    # random f32 against the JAX op
    x3, x5 = (torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in ((2, 9, 9, 6), (2, 9, 9, 4)))
    w3, w5, b3, b5 = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                      for s in ((3, 3, 6, 8), (5, 5, 4, 3), (8,), (3,)))
    ours = FunctionalNet._apply_branch_embed(_group([w3, w5], [b3, b5]),
                                             [x3, x5])
    ref = JaxNet._apply_branch_embed(
        [{"wmat": jnp.asarray(w3.numpy()), "bias": jnp.asarray(b3.numpy())},
         {"wmat": jnp.asarray(w5.numpy()), "bias": jnp.asarray(b5.numpy())}],
        [jnp.asarray(x3.numpy()), jnp.asarray(x5.numpy())])
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="share input spatial dims"):
        FunctionalNet._apply_branch_embed(_group([w3, w5], [b3, b5]),
                                          [x3, x5[:, :8]])


def _port_out(tr, x):
    return tr.predict_fn()(tr.params, tr.aux, x, ()).numpy()


def _jax_out(jt, x):
    nodes, _ = jt.net.forward(jt.params, jnp.asarray(x), train=False)
    return np.asarray(nodes[jt.net.out_node_index()])


def test_forward_matches_jax(jax_ckpt):
    path = jax_ckpt
    jt, tr = _pair(path, 1)
    assert jt.net.use_branch_embed(False) and tr.net.use_branch_embed()
    x, _ = _batch(3)
    ours = _port_out(tr, x)
    np.testing.assert_allclose(ours, _jax_out(jt, x), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    plain = NetTrainer()
    plain.set_params(_cfg(0))
    plain.load_model(path)
    np.testing.assert_allclose(ours, _port_out(plain, x), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    # the group's members have no operands of their own: the block
    # kernel holds them
    prep = tr._prepared_for(tr.params)
    (leader, grp), = prep["embed"].items()
    assert tuple(grp["wk"].shape) == (12, 10, 5, 5)
    assert not any(k.endswith(("_c3", "_c5")) for k in prep["layers"])


def _snapshot(params):
    return {k: {t: np.array(v, dtype=np.float32, copy=True)
                for t, v in tags.items()} for k, tags in params.items()}


def _assert_updates_match(ref_params, tr, w0, ref_loss):
    np.testing.assert_allclose(float(tr.last_loss), ref_loss, rtol=1e-5)
    for key, tags in w0.items():
        for tag, w in tags.items():
            dj = np.asarray(ref_params[key][tag]) - w
            dt = tr.params[key][tag].numpy() - w
            scale = np.abs(dj).max()
            assert scale > 0, f"{key}/{tag}: no update"
            assert np.abs(dt - dj).max() <= UPDATE_TOL * scale, f"{key}/{tag}"


def test_training_step_matches_jax(jax_ckpt):
    """Two steps under ``= 1`` (autograd through the block kernel) from
    one JAX checkpoint: against the JAX package's steps under ``= 1``, and
    against the port's own steps under ``= 0``."""
    jt, tr = _pair(jax_ckpt, 1)
    plain = NetTrainer()
    plain.set_params(_cfg(0))
    plain.load_model(jax_ckpt)
    w0 = _snapshot(jt.params)
    for seed in (5, 6):
        x, y = _batch(seed)
        _, jloss = jt.net.forward(jt.params, jnp.asarray(x),
                                  labels=jnp.asarray(y), train=True)
        jt.update_all(x, y)
        tr.update_all(x, y)
        plain.update_all(x, y)
    _assert_updates_match(jt.params, tr, w0, float(jloss))
    _assert_updates_match({k: {t: v.numpy() for t, v in tags.items()}
                           for k, tags in plain.params.items()},
                          tr, w0, float(plain.last_loss))


def _quantize_members(params, keys):
    """The members' kernels as int8 codes and f32 scales (the exporter's
    scheme), in both packages' dicts."""
    out = {}
    for k in keys:
        q, s = opsq.quantize_weight(np.asarray(params[k]["wmat"]), 3)
        out[k] = (q, s)
    return out


def test_int8_members_match_jax(jax_ckpt):
    jt, tr = _pair(jax_ckpt, 1)
    keys = [k for k in tr.params if k.endswith(("_c3", "_c5"))]
    assert len(keys) == 2
    for k, (q, s) in _quantize_members(tr.params, keys).items():
        bias = tr.params[k]["bias"]
        tr.params[k] = {opsq.QKEY: torch.from_numpy(q),
                        opsq.SKEY: torch.from_numpy(s), "bias": bias}
        jt.params[k] = {opsq.QKEY: jnp.asarray(q), opsq.SKEY: jnp.asarray(s),
                        "bias": jnp.asarray(bias.numpy())}
    tr._invalidate_prepared()
    x, _ = _batch(4)
    ours = _port_out(tr, x)
    prep = tr._prepared_for(tr.params)
    (grp,) = prep["embed"].values()
    assert grp["wk"] is None and len(grp["members"]) == 2
    np.testing.assert_allclose(ours, _jax_out(jt, x), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_checkpoint_interchange(tmp_path):
    """A checkpoint the port trained under ``= 1`` loads into the JAX
    package and into the port under ``= 0``: same predictions (the fusion
    is execution-only state)."""
    tr = NetTrainer()
    tr.set_params(_cfg(1) + [("seed", "3")])
    tr.init_model()
    x, y = _batch(9)
    tr.update_all(x, y)
    path = str(tmp_path / "be.model")
    tr.save_model(path)
    ours = _port_out(tr, x)
    plain = NetTrainer()
    plain.set_params(_cfg(0))
    plain.load_model(path)
    np.testing.assert_allclose(_port_out(plain, x), ours, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs("\n".join(
        f"{k} = {v}" for k, v in _cfg(0))))
    jt.load_model(path)
    np.testing.assert_allclose(_jax_out(jt, x), ours, rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_googlenet_fused_forward_equals_plain():
    """GoogLeNet at 64x64 (`models.googlenet_conf`, f32, two rows): the
    fused forward (nine groups) against the plain one in the port."""
    from cxxnet_tpu_torch.models import googlenet_conf

    cfg = tcfg.parse_pairs(googlenet_conf(input_size=64, batch_size=2,
                                          compute_dtype="float32",
                                          dev="cpu"))
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    outs = []
    for bembed in (0, 1):
        tr = NetTrainer()
        tr.set_params(cfg + [("conv_branch_embed", str(bembed)),
                             ("seed", "7")])
        tr.init_model()
        outs.append(_port_out(tr, x))
    assert len(tr.net._branch_embed_plan()[1]) == 9
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-6)
