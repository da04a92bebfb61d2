"""``remat = 1`` (activation recompute) in the port, on the CPU, against
the port's ``remat = 0`` and the JAX package's ``remat = 1``.

* A small LM with ``attn_impl = pallas`` (the flash kernels' plain
  versions): three steps under ``remat = 1`` give the weights of
  ``remat = 0`` (rtol 1e-4, atol 1e-6, the JAX test's bound; they read
  equal), with the flash forward run twice per attention layer a step
  and the backward once; one step against the JAX package's ``remat =
  1`` step from one checkpoint: the loss to rtol 1e-5, the updates and
  both Adam moments within 1e-3 of the tensor's largest (updates held
  where the gradient is at least 1e-3 of its largest, as in
  ``tests/test_torch_lm.py``).
* A batch-norm net under ``bn_eval = running``: weights and running
  statistics of four steps equal to ``remat = 0``'s (1e-6) and to the
  JAX package's ``remat = 1`` run (rtol 3e-4, atol 3e-5).  The running
  statistics move once a step.
* A net with ``dropout``, ``insanity`` and ``prelu``'s jitter: the
  gradients, the loss and the step generator's final state equal to
  ``remat = 0``'s bit for bit, and three trainer steps' weights too.
* The inception net of ``tests/test_torch_branch_embed.py``, f32 and
  bf16, branch-embed on and off (its sibling 1x1 group runs through the
  conv-block wrapper): ``remat = 1`` equal to ``remat = 0`` bit for
  bit; each update against the JAX package's ``remat = 1`` step within
  1e-3 of the tensor's largest in f32, and at cosine >= 0.99 in bf16
  (the two frameworks round different bf16 activations: a bias
  gradient, a sum over 2304 positions, reads a few per cent apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.models import transformer_lm_conf as jax_lm_conf
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.models import transformer_lm_conf
from cxxnet_tpu_torch.nnet.graph import NetGraph
from cxxnet_tpu_torch.nnet.net import FunctionalNet
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import flash
from test_torch_branch_embed import INCEPTION_CFG  # the inception net

UPDATE_TOL = 1e-3  # of each tensor's largest (the LM step)
BF16_UPDATE_COS = 0.99  # each update's cosine, bf16 nets
NET_RTOL, NET_ATOL = 3e-4, 3e-5


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


def _snapshot(params):
    return {(k, t): v.detach().clone() for k, tags in params.items()
            for t, v in tags.items()}


def _assert_equal(a, b, what):
    assert sorted(a) == sorted(b)
    for kt in a:
        assert torch.equal(a[kt], b[kt]), f"{what}: {kt}"


@pytest.mark.parametrize("val,want", [("0", 0), ("1", 1)])
def test_remat_is_parsed(val, want):
    g = NetGraph()
    g.configure(tcfg.parse_pairs(transformer_lm_conf(
        seq_len=8, dim=16, nhead=2, nlayer=1, dev="cpu"))
        + [("remat", val)])
    assert FunctionalNet(g).remat == want


# ----------------------------------------------------------------------
# the LM with the flash kernels' plain versions

LM_KW = dict(seq_len=16, dim=32, nhead=2, nlayer=2, batch_size=4,
             dev="cpu", compute_dtype="float32", attn_impl="pallas")


@pytest.fixture()
def flash_calls(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash.flash_fwd, flash.flash_bwd

    def counted_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(flash, "flash_fwd", counted_fwd)
    monkeypatch.setattr(flash, "flash_bwd", counted_bwd)
    return calls


def test_lm_remat_matches_no_remat_and_reruns_the_flash_forward(
        flash_calls):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (4, 16)).astype(np.float32)
    y = rng.randint(0, 255, (4, 16)).astype(np.float32)
    out = {}
    for remat in ("0", "1"):
        tr = NetTrainer()
        tr.set_params(tcfg.parse_pairs(transformer_lm_conf(**LM_KW))
                      + [("remat", remat)])
        tr.init_model()
        flash_calls.update(fwd=0, bwd=0)
        for _ in range(3):
            tr.update_all(x, y)
        per = 2 if remat == "1" else 1
        assert flash_calls == {"fwd": 3 * 2 * per, "bwd": 3 * 2}, remat
        out[remat] = _snapshot(tr.params)
    for kt, w in out["0"].items():
        np.testing.assert_allclose(out["1"][kt].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=str(kt))


def test_lm_remat_step_matches_jax_remat(tmp_path):
    kw = dict(LM_KW, batch_size=2, seq_len=32, eta=0.01)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(jax_lm_conf(**kw)) + [("remat", "1")])
    jt.init_model()
    assert jt.net.remat == 1
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(transformer_lm_conf(**kw))
                  + [("remat", "1")])
    tr.load_model(path)
    rng = np.random.RandomState(12)
    x = rng.randint(0, 256, (2, 32)).astype(np.float32)
    y = rng.randint(0, 256, (2, 32)).astype(np.float32)
    w0 = {k: {t: np.array(v, np.float32) for t, v in tags.items()}
          for k, tags in jt.params.items()}
    _, jloss = jt.net.forward(jt.params, jnp.asarray(x),
                              labels=jnp.asarray(y), train=True)
    _, tloss = tr.net.forward_train(tr.params, torch.from_numpy(x),
                                    torch.from_numpy(y), None, None)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jt.update_all(x, y)
    tr.update_all(x, y)
    for key, tags in w0.items():
        for tag, w in tags.items():
            dj = np.asarray(jt.params[key][tag]) - w
            dt = tr.params[key][tag].numpy() - w
            g = np.abs(np.asarray(jt.ustates[key][tag]["m1"]))
            resolved = g >= UPDATE_TOL * g.max()
            assert (np.abs(dt - dj)[resolved].max()
                    <= UPDATE_TOL * np.abs(dj).max()), f"{key}/{tag}"
            for m in ("m1", "m2"):
                mj = np.asarray(jt.ustates[key][tag][m])
                mt = tr.ustates[key][tag][m].numpy()
                assert (np.abs(mt - mj).max()
                        <= UPDATE_TOL * np.abs(mj).max()), f"{key}/{tag} {m}"


# ----------------------------------------------------------------------
# batch norm's running statistics

BN_CONF = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+0] = batch_norm:bn1
  bn_eval = running
  bn_momentum = 0.5
layer[+1:a1] = relu:a1
layer[a1->out] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 16
eta = 0.1
dev = cpu
"""


def _bn_batches():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 4, (64, 1)).astype(np.float32)
    return [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]


def test_bn_running_stats_under_remat(tmp_path):
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(BN_CONF + "remat = 1\n"))
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    runs = {}
    for remat in ("0", "1"):
        tr = NetTrainer()
        tr.set_params(tcfg.parse_pairs(BN_CONF + f"remat = {remat}\n"))
        tr.load_model(path)
        means = []
        for x, y in _bn_batches():
            tr.update_all(x, y)
            means.append(tr.aux["l1_bn1"]["rmean"].clone())
        runs[remat] = tr, means
    for x, y in _bn_batches():
        jt.update_all(x, y)
    (t0, m0), (t1, m1) = runs["0"], runs["1"]
    for a, b in zip(m0, m1):  # the EMA moved once a step
        assert torch.equal(a, b)
    _assert_equal(_snapshot(t1.params), _snapshot(t0.params), "weights")
    _assert_equal(_snapshot(t1.aux), _snapshot(t0.aux), "running stats")
    for store, jstore in ((t1.params, jt.params), (t1.aux, jt.aux)):
        for key, tags in jstore.items():
            for tag, w in tags.items():
                np.testing.assert_allclose(
                    store[key][tag].numpy(), np.asarray(w), rtol=NET_RTOL,
                    atol=NET_ATOL, err_msg=f"{key}/{tag}")


# ----------------------------------------------------------------------
# the random layers: the step generator's draws replayed

RANDOM_CONF = """
netconfig=start
layer[0->1] = fullc:fc1
  nhidden = 24
  init_sigma = 0.2
layer[1->2] = insanity:ins
  lb = 3
  ub = 8
layer[2->3] = dropout:d1
  threshold = 0.5
layer[3->4] = fullc:fc2
  nhidden = 16
  init_sigma = 0.2
layer[4->5] = prelu:pr
  random = 0.5
layer[5->6] = dropout:d2
  threshold = 0.3
layer[6->7] = fullc:fc3
  nhidden = 4
  init_sigma = 0.2
layer[7->7] = softmax
netconfig=end
input_shape = 1,1,10
batch_size = 8
eta = 0.1
seed = 3
dev = cpu
"""


def _random_trainer(remat):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(RANDOM_CONF + f"remat = {remat}\n"))
    tr.init_model()
    return tr


def test_random_layers_replay_the_generator_under_remat():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(8, 10).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, (8, 1)).astype(np.float32))
    grads, states, losses = {}, {}, {}
    params = None
    for remat in ("0", "1"):
        tr = _random_trainer(remat)
        if params is None:
            params = _snapshot(tr.params)
        leaves = {}
        for (k, t), w in params.items():
            leaves.setdefault(k, {})[t] = w.clone().requires_grad_(True)
        gen = torch.Generator().manual_seed(17)
        _, loss = tr.net.forward_train(leaves, x, y, None, gen, step=0)
        loss.backward()
        grads[remat] = {(k, t): w.grad for k, tags in leaves.items()
                        for t, w in tags.items()}
        states[remat] = gen.get_state()
        losses[remat] = loss.detach()
    assert torch.equal(losses["0"], losses["1"])
    _assert_equal(grads["1"], grads["0"], "gradients")
    assert all(g.abs().max() > 0 for g in grads["0"].values())
    assert torch.equal(states["1"], states["0"])
    # the generator ends where a second forward's draws would begin
    assert not torch.equal(states["0"],
                           torch.Generator().manual_seed(17).get_state())


def test_random_net_trains_alike_under_remat():
    out = {}
    for remat in ("0", "1"):
        tr = _random_trainer(remat)
        r = np.random.RandomState(6)
        for _ in range(3):
            tr.update_all(r.randn(8, 10).astype(np.float32),
                          r.randint(0, 4, (8, 1)).astype(np.float32))
        out[remat] = _snapshot(tr.params)
    _assert_equal(out["1"], out["0"], "weights")


# ----------------------------------------------------------------------
# branch-embed and the sibling 1x1 group, f32 and bf16


def _inception_cfg(bembed, remat, dtype):
    return INCEPTION_CFG + [("conv_branch_embed", str(bembed)),
                            ("compute_dtype", dtype),
                            ("remat", str(remat))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bembed", [0, 1])
def test_inception_under_remat(tmp_path, bembed, dtype):
    jt = JaxTrainer()
    jt.set_params(_inception_cfg(bembed, 1, dtype) + [("seed", "11")])
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    rng = np.random.RandomState(2)
    x = rng.randn(16, 12, 12, 8).astype(np.float32)
    y = rng.randint(0, 4, (16, 1)).astype(np.float32)
    w0 = {k: {t: np.array(v, np.float32) for t, v in tags.items()}
          for k, tags in jt.params.items()}
    out = {}
    for remat in (0, 1):
        tr = NetTrainer()
        tr.set_params(_inception_cfg(bembed, remat, dtype))
        tr.load_model(path)
        assert tr.net.use_branch_embed() is bool(bembed)
        assert tr.net._sibling_1x1_groups()[0]  # r3 and r5 fuse
        tr.update_all(x, y)
        out[remat] = tr
    _assert_equal(_snapshot(out[1].params), _snapshot(out[0].params),
                  "weights")
    jt.update_all(x, y)
    for key, tags in w0.items():
        for tag, w in tags.items():
            dj = (np.asarray(jt.params[key][tag]) - w).ravel()
            dt = (out[1].params[key][tag].numpy() - w).ravel()
            assert np.abs(dj).max() > 0, f"{key}/{tag}"
            if dtype == "float32":
                assert (np.abs(dt - dj).max()
                        <= UPDATE_TOL * np.abs(dj).max()), f"{key}/{tag}"
            else:
                cos = dt @ dj / (np.linalg.norm(dt) * np.linalg.norm(dj))
                assert cos >= BF16_UPDATE_COS, f"{key}/{tag} {cos}"
