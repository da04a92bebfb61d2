"""The rest of the layer zoo against the JAX package, on the CPU.

* ``softplus``, ``xelu``, ``prelu``, ``insanity`` and ``bias``: forward
  and every gradient at atol/rtol 1e-6 (f32), on the same numpy inputs
  and params.
* The random layers in training (``prelu``'s jitter, ``insanity``,
  ``insanity_max_pooling``): the JAX side's ``jax.random.uniform`` is
  patched to return numpy draws, and the port's ``uniform`` the same
  draws, so both packages compute on one set of draws; forward and
  gradients at 1e-6.  ``insanity``'s anneal before, inside and after
  the calm window, at eval and in training.
* ``conv_s2d`` and ``conv_wino`` against the JAX ``_conv_s2d`` and
  ``_conv_winograd3``: f32 outputs at the JAX tests' bounds (Winograd
  against the direct conv: 2e-4, its gradients 2e-3; s2d 1e-5), each
  port rewrite against the JAX rewrite at 1e-5, bf16 Winograd against
  the JAX bf16 output within one bf16 rounding of the output's scale
  (2^-8 of its largest magnitude), and which convs the rule admits.
* ``fixconn``: the product and the file's errors, message for message.
* ``torch:``: a stateless module's forward and all its gradients at
  1e-6 against the JAX adapter (``pure_callback``), the whitelist's
  rejections in both packages, and a net with a ``torch:`` layer saved
  and loaded with its ``blob`` tags.
* ``pairtest-<master>-<slave>``: the master's output and params, and
  ``compare`` against the JAX layer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import layers as JL
from cxxnet_tpu.layers import conv as jconv
from cxxnet_tpu.plugin import torch_adapter as jadapter

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import layers as TL
from cxxnet_tpu_torch.layers import conv as tconv
from cxxnet_tpu_torch.layers import elemwise as telem
from cxxnet_tpu_torch.nnet.trainer import NetTrainer, params_from_numpy
from cxxnet_tpu_torch.plugin import torch_adapter as tadapter

TOL = 1e-6


def _mk(make, name, cfg=()):
    lay = make(name)
    for k, v in cfg:
        lay.set_param(k, v)
    return lay


def _pair(name, cfg=()):
    return _mk(JL.create_layer, name, cfg), _mk(TL.create_layer, name, cfg)


def _jax_run(lay, params, x, train=False, rng=None, step=None):
    """The JAX layer's output and the gradients of ``sum(y * gy)`` with
    respect to ``x`` and every param, for a fixed seeded ``gy``."""
    def fwd(p, v):
        return lay.apply(p, [v], train=train, rng=rng, step=step)[0]

    y = jax.jit(fwd)(params, jnp.asarray(x))
    gy = jnp.asarray(np.random.RandomState(9).randn(*y.shape)
                     .astype(np.float32))
    gp, gx = jax.jit(jax.grad(lambda p, v: (fwd(p, v) * gy).sum(),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    return (np.asarray(y), np.asarray(gx),
            {t: np.asarray(v) for t, v in gp.items()})


def _port_run(lay, params, x, train=False, gen=None, step=None):
    p = {t: torch.from_numpy(np.array(v)).requires_grad_(True)
         for t, v in params.items()}
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    y = lay.apply(lay.prepare(p, torch.float32), [xt], train=train, gen=gen,
                  step=step)[0]
    gy = torch.from_numpy(np.random.RandomState(9).randn(*y.shape)
                          .astype(np.float32))
    leaves = [xt] + list(p.values())
    grads = torch.autograd.grad((y * gy).sum(), leaves, allow_unused=True)
    gp = {t: (np.zeros_like(np.asarray(params[t])) if g is None
              else g.numpy()) for t, g in zip(p, grads[1:])}
    return y.detach().numpy(), grads[0].numpy(), gp


def _close(got, ref, tol=TOL, scaled=False):
    """Output, input gradient and param gradients within ``tol``; with
    ``scaled``, within ``tol`` of each tensor's largest magnitude (a
    conv's sums run in another order in each package)."""
    y, gx, gp = got
    ry, rgx, rgp = ref
    assert set(gp) == set(rgp)
    for name, a, b in [("y", y, ry), ("dx", gx, rgx)] + [
            (t, gp[t], rgp[t]) for t in gp]:
        atol = tol * max(np.abs(b).max(), 1.0) if scaled else tol
        np.testing.assert_allclose(a, b, rtol=tol, atol=atol, err_msg=name)


def _params(jl, shape, seed=0):
    """The JAX layer's init params, moved off their draws: random values
    so a gradient through them is not degenerate."""
    p = jl.init_params(jax.random.PRNGKey(seed), [shape])
    rs = np.random.RandomState(seed + 100)
    return {t: (rs.uniform(0.05, 0.6, np.shape(v)).astype(np.float32))
            for t, v in p.items()}


ELEMWISE = {
    "softplus": ((), (5, 7)),
    "xelu": ((("b", "3.5"),), (2, 4, 5, 6)),
    "prelu": ((("init_slope", "0.3"),), (2, 4, 5, 6)),
    "insanity": ((("lb", "3"), ("ub", "8")), (3, 11)),
    "bias": ((("init_bias", "0.2"),), (4, 9)),
}


@pytest.mark.parametrize("name", sorted(ELEMWISE))
def test_elementwise_layer_matches_jax(name):
    cfg, shape = ELEMWISE[name]
    jl, tl = _pair(name, cfg)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    assert tuple(tl.infer_shape([shape])[0]) == tuple(
        jl.infer_shape([shape])[0])
    params = _params(jl, shape)
    assert set(params) == set(tl.init_params(torch.Generator(), [shape]))
    _close(_port_run(tl, params, x), _jax_run(jl, params, x))


def _patched_draws(monkeypatch, draws):
    """Both packages' uniform draws replaced by ``draws`` (one array a
    call, in call order)."""
    jq, tq = list(draws), list(draws)

    def jax_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                    maxval=1.0):
        u = jq.pop(0)
        assert tuple(shape) == u.shape
        return jnp.asarray(u, dtype)

    def port_uniform(x, gen):
        u = tq.pop(0)
        assert tuple(x.shape) == u.shape
        return torch.from_numpy(u)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(telem, "uniform", port_uniform)
    monkeypatch.setattr(tconv, "uniform", port_uniform)


RANDOM = {
    "prelu": ((("init_slope", "0.3"), ("random", "0.4")), (2, 5, 6, 4)),
    "insanity": ((("lb", "3"), ("ub", "8")), (4, 13)),
    "insanity_max_pooling": ((("kernel_size", "3"), ("stride", "2"),
                              ("keep", "0.6")), (2, 9, 8, 3)),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_layer_in_training_matches_jax_on_the_same_draws(
        monkeypatch, name):
    cfg, shape = RANDOM[name]
    jl, tl = _pair(name, cfg)
    tl.infer_shape([shape])
    jl.infer_shape([shape])
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    u = np.random.RandomState(3).rand(*shape).astype(np.float32)
    # _jax_run draws twice (the output, then the grad's forward)
    _patched_draws(monkeypatch, [u, u, u])
    params = _params(jl, shape) if name == "prelu" else {}
    ref = _jax_run(jl, params, x, train=True, rng=jax.random.PRNGKey(0))
    got = _port_run(tl, params, x, train=True, gen=torch.Generator())
    _close(got, ref)
    # the draws moved the output off the eval forward
    ev = tl.apply(tl.prepare({t: torch.from_numpy(v)
                              for t, v in params.items()}, torch.float32),
                  [torch.from_numpy(x)])[0].numpy()
    assert not np.array_equal(ev, got[0])


@pytest.mark.parametrize("step", [None, 0, 4, 10, 13, 17, 20, 31])
def test_insanity_anneal_matches_jax(monkeypatch, step):
    """The interval closes linearly over [calm_start, calm_end] = [10,
    20]: fixed before, moving inside, the midpoint after."""
    cfg = (("lb", "2"), ("ub", "9"), ("calm_start", "10"),
           ("calm_end", "20"))
    jl, tl = _pair("insanity", cfg)
    lb, ub = tl.interval(step)
    jlb, jub = jl._interval(None if step is None else jnp.int32(step))
    assert (lb, ub) == (float(jlb), float(jub))
    if step is not None and step >= 20:
        assert lb == ub == 5.5
    if step is None or step <= 10:
        assert (lb, ub) == (2.0, 9.0)
    x = np.random.RandomState(5).randn(6, 7).astype(np.float32)
    _close(_port_run(tl, {}, x, step=step), _jax_run(jl, {}, x, step=step))
    u = np.random.RandomState(6).rand(6, 7).astype(np.float32)
    _patched_draws(monkeypatch, [u, u, u])
    _close(_port_run(tl, {}, x, train=True, gen=torch.Generator(),
                     step=step),
           _jax_run(jl, {}, x, train=True, rng=jax.random.PRNGKey(0),
                    step=None if step is None else jnp.int32(step)))


# ----------------------------------------------------------------------
# conv rewrites

def _conv_pair(cfg, x_shape, seed=0):
    jl, tl = _pair("conv", cfg)
    jl.infer_shape([x_shape])
    tl.infer_shape([x_shape])
    rs = np.random.RandomState(seed)
    params = {t: (rs.randn(*v.shape) * (0.2 if t == "wmat" else 1.0)).astype(
        np.float32) for t, v in tl.init_params(torch.Generator(),
                                                [x_shape]).items()}
    return jl, tl, params


WINO_SHAPES = [(14, 1, 12, 8), (16, 1, 16, 8), (9, 0, 9, 4), (12, 1, 8, 8),
               (7, 1, 10, 6)]


@pytest.mark.parametrize("variant", ["1", "2"])
@pytest.mark.parametrize("hw,p,cin,cout", WINO_SHAPES)
def test_conv_wino_matches_jax_and_the_direct_conv(hw, p, cin, cout,
                                                   variant):
    x = np.random.RandomState(hw).randn(2, hw, hw + 3, cin).astype(
        np.float32)
    base = [("kernel_size", "3"), ("stride", "1"), ("pad", str(p)),
            ("nchannel", str(cout))]
    jl, tl, params = _conv_pair(base + [("conv_wino", variant)], x.shape)
    assert tl.rewrite(cin) == "conv_wino"
    _, direct, _ = _conv_pair(base, x.shape)
    tconv.REWRITE_USES.clear()
    got = _port_run(tl, params, x)
    assert tconv.REWRITE_USES == {"conv_wino": 1}
    # the JAX test's bounds against the direct conv
    ref = _port_run(direct, params, x)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-4, atol=2e-4)
    for a, b in [(got[1], ref[1])] + [(got[2][t], ref[2][t])
                                      for t in params]:
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    # and the JAX rewrite itself
    _close(got, _jax_run(jl, params, x), tol=1e-5, scaled=True)


@pytest.mark.parametrize("variant", [1, 2])
def test_conv_wino_bf16_matches_the_jax_bf16_output(variant):
    """Both packages round the transformed operands to bf16, take their
    product in f32 and cast once: the outputs differ only by f32
    summation order before that cast, within one bf16 rounding."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 14, 14, 16).astype(np.float32)
    w = (rs.randn(3, 3, 16, 16) * 0.2).astype(np.float32)
    ref = np.asarray(jconv._conv_winograd3(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1, 1,
        variant=variant).astype(jnp.float32))
    got = tconv.conv_winograd3(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1, 1,
        variant=variant)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= scale * 2.0 ** -8


S2D = [  # (kernel, stride, pad, h, w, cin, cout)
    (7, 2, 3, 19, 23, 3, 8),   # a GoogLeNet/ResNet-shaped stem
    (11, 4, 2, 27, 30, 3, 5),  # AlexNet-shaped, ragged extents
    (3, 2, 1, 9, 10, 4, 6),    # kernel not a multiple of the stride
]


@pytest.mark.parametrize("k,s,p,h,w,cin,cout", S2D)
def test_conv_s2d_matches_jax_and_the_direct_conv(k, s, p, h, w, cin, cout):
    x = np.random.RandomState(k).randn(2, h, w, cin).astype(np.float32)
    base = [("kernel_size", str(k)), ("stride", str(s)), ("pad", str(p)),
            ("nchannel", str(cout))]
    jl, tl, params = _conv_pair(base + [("conv_s2d", "1")], x.shape)
    assert tl.rewrite(cin) == "conv_s2d"
    _, direct, _ = _conv_pair(base, x.shape)
    tconv.REWRITE_USES.clear()
    got = _port_run(tl, params, x)
    assert tconv.REWRITE_USES == {"conv_s2d": 1}
    _close(got, _port_run(direct, params, x), tol=1e-5, scaled=True)
    _close(got, _jax_run(jl, params, x), tol=1e-5, scaled=True)
    ref = np.asarray(jconv._conv_s2d(jnp.asarray(x),
                                     jnp.asarray(params["wmat"]), s, p, p))
    y = tconv.conv_s2d(torch.from_numpy(x), torch.tensor(params["wmat"]),
                       s, p, p).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg,cin", [
    ((("kernel_size", "3"), ("stride", "2"), ("conv_wino", "1")), 16),
    ((("kernel_size", "3"), ("stride", "1"), ("conv_wino", "1")), 4),
    ((("kernel_size", "5"), ("stride", "1"), ("conv_wino", "2")), 16),
    ((("kernel_size", "3"), ("ngroup", "2"), ("conv_wino", "1")), 16),
    ((("kernel_size", "3"), ("stride", "1"), ("conv_s2d", "1")), 16),
    ((("kernel_size", "3"), ("stride", "2"), ("ngroup", "2"),
      ("conv_s2d", "1")), 16),
])
def test_conv_rewrites_keep_the_direct_conv_off_their_rule(cfg, cin):
    """Off its rule (wino: 3x3, stride 1, ngroup 1, cin >= 8; s2d:
    stride > 1, ngroup 1) the conv stays direct in both packages,
    bit for bit."""
    cfg = cfg + (("nchannel", "8"), ("pad", "1"))
    shape = (2, 12, 12, cin)
    jl, tl, params = _conv_pair(cfg, shape)
    _, direct, _ = _conv_pair(tuple(kv for kv in cfg if kv[0] not in (
        "conv_wino", "conv_s2d")), shape)
    assert tl.rewrite(cin) == ""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    tconv.REWRITE_USES.clear()
    np.testing.assert_array_equal(_port_run(tl, params, x)[0],
                                  _port_run(direct, params, x)[0])
    assert not tconv.REWRITE_USES
    with pytest.raises(ValueError, match="conv_wino must be"):
        tl.set_param("conv_wino", "3")


# ----------------------------------------------------------------------
# fixconn

def _sparse_file(path, nrow, ncol, triples):
    with open(path, "w") as f:
        f.write(f"{nrow} {ncol} {len(triples)}\n")
        for r, c, v in triples:
            f.write(f"{r} {c} {v}\n")
    return str(path)


def test_fixconn_matches_jax_and_is_frozen(tmp_path):
    rs = np.random.RandomState(0)
    triples = [(int(r), int(c), float(v)) for r, c, v in zip(
        rs.randint(0, 5, 12), rs.randint(0, 7, 12), rs.randn(12))]
    fname = _sparse_file(tmp_path / "w.txt", 5, 7, triples)
    cfg = (("nhidden", "5"), ("fixconn_weight", fname))
    jl, tl = _pair("fixconn", cfg)
    assert tl.infer_shape([(4, 7)]) == jl.infer_shape([(4, 7)]) == [(4, 5)]
    assert tl.init_params(torch.Generator(), [(4, 7)]) == {}
    x = rs.randn(4, 7).astype(np.float32)
    _close(_port_run(tl, {}, x), _jax_run(jl, {}, x))
    placed = tl._placed[(torch.device("cpu"), torch.float32)]
    tl.apply({}, [torch.from_numpy(x)])
    assert tl._placed[(torch.device("cpu"), torch.float32)] is placed


@pytest.mark.parametrize("body,nhidden,match", [
    ("5 7 1\n0 0 1.0\n", "4", "shape does not match"),
    ("5 7 2\n0 0 1.0\n", "5", "invalid sparse matrix format"),
    ("5 7 1\n5 0 1.0\n", "5", "index exceeds matrix shape"),
    (None, "5", "must specify fixconn_weight"),
])
def test_fixconn_file_errors_match_jax(tmp_path, body, nhidden, match):
    cfg = [("nhidden", nhidden)]
    if body is not None:
        (tmp_path / "w.txt").write_text(body)
        cfg.append(("fixconn_weight", str(tmp_path / "w.txt")))
    for make in (JL.create_layer, TL.create_layer):
        lay = _mk(make, "fixconn", cfg)
        with pytest.raises(ValueError, match=match):
            lay.infer_shape([(4, 7)])


# ----------------------------------------------------------------------
# torch: layers

TORCH_OPS = [
    ("torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), "
     "torch.nn.Tanh())", (2, 6, 5, 3)),
    ("torch.nn.Linear(7, 3)", (4, 7)),
]


@pytest.mark.parametrize("op,shape", TORCH_OPS)
def test_torch_layer_matches_the_jax_adapter(op, shape):
    jl, tl = _pair("torch", [("torch_op", op)])
    assert (tuple(tl.infer_shape([shape])[0])
            == tuple(jl.infer_shape([shape])[0]))
    params = {t: np.asarray(v) for t, v in jl.init_params(
        jax.random.PRNGKey(0), [shape]).items()}
    drawn = tl.init_params(torch.Generator().manual_seed(0), [shape])
    assert {t: tuple(v.shape) for t, v in drawn.items()} == {
        t: v.shape for t, v in params.items()}
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    for train in (False, True):
        _close(_port_run(tl, params, x, train=train),
               _jax_run(jl, params, x, train=train))


@pytest.mark.parametrize("op", [
    "__import__('os').system('true')",
    "torch.load('model.pt')",
    "torch.nn.Linear.__init__.__globals__",
    "torch.nn.Linear(8, 4).__class__",
    "torch.nn.modules.linear.Linear.mro()[1]",
    "torch.nn.Linear(open('model.pt'))",
    "torch.nn._reduction.get_enum('mean')",
    "torch.nn.Linear(3, n)",
    "torch.nn.Linear(**{'in_features': 3})",
    "(lambda: 1)()",
])
def test_torch_whitelist_rejects_as_the_jax_adapter_does(op):
    for build in (jadapter._build_torch_expr, tadapter._build_torch_expr):
        with pytest.raises(ValueError, match="torch_op"):
            build(op)


TORCH_NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 4
  pad = 1
layer[1->2] = torch:t1
  torch_op = "torch.nn.Conv2d(4, 6, 3, padding=1)"
layer[2->3] = relu
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 3
layer[5->5] = softmax
netconfig = end
input_shape = 3,6,6
batch_size = 4
dev = cpu
eta = 0.1
momentum = 0.9
"""


def test_torch_layer_trains_and_round_trips_its_blobs(tmp_path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(TORCH_NET))
    tr.init_model()
    assert set(tr.params["l1_t1"]) == {"blob0", "blob1"}
    assert tuple(tr.params["l1_t1"]["blob0"].shape) == (6, 4, 3, 3)
    rs = np.random.RandomState(0)
    x = rs.randn(4, 6, 6, 3).astype(np.float32)
    y = rs.randint(0, 3, (4, 1)).astype(np.float32)
    w0 = tr.params["l1_t1"]["blob0"].clone()
    tr.update_all(x, y)
    assert not torch.equal(tr.params["l1_t1"]["blob0"], w0)
    path = str(tmp_path / "t.model")
    tr.save_model(path)
    back = NetTrainer()
    back.set_params(tcfg.parse_pairs(TORCH_NET))
    back.load_model(path)
    for tag in ("blob0", "blob1"):
        assert torch.equal(back.params["l1_t1"][tag], tr.params["l1_t1"][tag])
    np.testing.assert_array_equal(back.predict(x), tr.predict(x))


# ----------------------------------------------------------------------
# pairtest

def test_pairtest_runs_the_master_and_compares_as_jax():
    name = "pairtest-conv-conv"
    cfg = [("kernel_size", "3"), ("nchannel", "8"), ("pad", "1")]
    jl, tl = _pair(name, cfg)
    tl.slave.set_param("conv_wino", "2")
    jl.slave.set_param("conv_wino", "2")
    shape = (2, 9, 9, 8)
    assert tl.infer_shape([shape]) == jl.infer_shape([shape])
    params = {t: np.asarray(v) for t, v in jl.init_params(
        jax.random.PRNGKey(0), [shape]).items()}
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    _close(_port_run(tl, params, x), _jax_run(jl, params, x), tol=1e-5,
           scaled=True)
    prep = tl.prepare({t: torch.from_numpy(v) for t, v in params.items()},
                      torch.float32)
    got = float(tl.compare(prep, [torch.from_numpy(x)]))
    ref = float(jl.compare({t: jnp.asarray(v) for t, v in params.items()},
                           [jnp.asarray(x)]))
    assert 0 < got < 1e-3 and 0 < ref < 1e-3
    pool = TL.create_layer("pairtest-max_pooling-insanity_max_pooling")
    for k, v in (("kernel_size", "3"), ("stride", "2"), ("keep", "0.5")):
        pool.set_param(k, v)
    pool.infer_shape([shape])
    assert float(pool.compare({}, [torch.from_numpy(x)])) == 0.0
    for bad in ("pairtest-conv", "pairtest-conv-nope"):
        with pytest.raises(ValueError, match="unknown layer type"):
            TL.create_layer(bad)


def test_create_layer_knows_every_jax_layer_type():
    """The whole JAX registry, the MoE and block-stack layers included."""
    from cxxnet_tpu.layers.base import layer_types
    from cxxnet_tpu_torch.layers.base import _REGISTRY

    JL.create_layer("torch")  # the plugin registers on demand
    TL.create_layer("torch")
    assert {"moe", "pipe_transformer", "pipe_mlp"} <= set(_REGISTRY)
    assert set(layer_types()) <= set(_REGISTRY)


def test_prelu_slope_is_a_bias_tag_for_the_updater():
    conf = """
netconfig = start
layer[0->1] = fullc:f
  nhidden = 6
layer[1->2] = prelu:p
layer[2->3] = fullc:o
  nhidden = 2
layer[3->3] = softmax
netconfig = end
input_shape = 1,1,5
batch_size = 2
dev = cpu
eta = 0.1
bias:lr = 0.5
bias:wd = 0.25
"""
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.init_model()
    up = tr.updaters[("l1_p", "bias")]
    assert up.param.base_lr == 0.5 and up.param.wd == 0.25
    assert tr.updaters[("l0_f", "wmat")].param.base_lr == 0.1
    raw = {k: {t: v.numpy() for t, v in tags.items()}
           for k, tags in tr.params.items()}
    assert sorted(params_from_numpy(raw)["l1_p"]) == ["bias"]
