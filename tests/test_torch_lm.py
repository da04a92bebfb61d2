"""The language-model slice, on the CPU, against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the
JAX package's flash kernel runs in interpret mode (``attn_impl =
pallas`` off a TPU), the port's flash wrapper takes its plain versions
(CPU tensors).

* Layers: ``gelu`` (the tanh form, 1e-6), ``embedding`` (no, learned and
  sinusoidal positions, and absolute positions under ``decode = 1``,
  exact), ``layer_norm`` (1e-6), ``attention`` with ``attn_impl =
  pallas`` forward and gradients (1e-5 / 2e-4), the KV-cache decode
  against the full causal forward (2e-5) in both packages; the routing
  of a full-sequence attention by head dim, device and ``attn_impl``
  (flash kernels only for the head dims they are built for on a card,
  the dense ``mha`` for the others, a raise under ``pallas``), and at
  head dim 128 the layer under ``auto`` and ``xla`` against the JAX
  package's, forward and gradients (1e-5 / 2e-4).
* Adam against ``AdamUpdater.apply`` over 3 epochs, with and without
  weight decay (rtol 1e-5: the host scalars are computed in numpy f32,
  the JAX package's in XLA f32).
* ``TextIterator``: windows, labels, padding and shards equal to the JAX
  package's.
* One training step of a small LM (T 64, d 32, 2 heads, 2 blocks, f32,
  batch 2) from one JAX checkpoint: the loss to rtol 1e-5, and the
  updates and both Adam moments of every tensor within 1e-3 of that
  tensor's largest.  The updates are held where the gradient is at
  least 1e-3 of the tensor's largest: Adam's first step is
  ``~ lr * g / (0.032 |g| + 1e-8)``, which turns the relative rounding
  noise of a near-zero gradient into a change of sign (the key part of
  the qkv bias has an exactly zero gradient), so there the moments,
  linear in ``g``, carry the comparison.
* Generation after a few JAX training steps on a repetitive corpus:
  the port loads the checkpoint; the probability rows of the windowed
  and the cached path within 1e-5 of the JAX package's, and the same
  greedy bytes on both paths.
* ``task=train`` on an ``iter = text`` conf, then ``task=generate`` from
  its checkpoint, through the port's CLI (``dev = cpu``); the JAX
  package scores the port's checkpoint like the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io.text import TextIterator as JaxText
from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.models import transformer_lm_conf as jax_lm_conf
from cxxnet_tpu.nnet import generate as jgen
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.updater import AdamUpdater as JaxAdam
from cxxnet_tpu.utils.metric import MetricSet as JaxMetricSet

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io.data import DataBatch, create_iterator
from cxxnet_tpu_torch.io.text import TextIterator
from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.models import transformer_lm_conf
from cxxnet_tpu_torch.nnet import generate as tgen
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops import attention, flash
from cxxnet_tpu_torch.updater import create_updater
from cxxnet_tpu_torch.utils.metric import MetricSet

UPDATE_TOL = 1e-3  # of each tensor's largest


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """The JAX trainer's compile listener registers the device plane's
    ``train_step_device_seconds`` histogram in the process-wide obs
    registry, and it stays empty unless steps are sampled; an exposition
    check later in the same process (``tests/test_obs.py``) rejects an
    empty histogram.  Leave the registry as this module found it."""
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


@pytest.fixture()
def corpus(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(("the quick brown fox jumps over the lazy dog. " * 300)
                  .encode())
    return str(p)


def _layers(name, **cfg):
    """The same layer in both packages, configured alike."""
    out = []
    for make in (create_layer, jax_layer):
        lay = make(name)
        for k, v in cfg.items():
            lay.set_param(k, str(v))
        out.append(lay)
    return out


def _np_params(shapes, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return {t: (rng.randn(*s) * scale).astype(np.float32)
            for t, s in shapes.items()}


def _both(params):
    return ({t: torch.from_numpy(v.copy()) for t, v in params.items()},
            {t: jnp.asarray(v) for t, v in params.items()})


# ----------------------------------------------------------------------
# layers
def test_gelu_is_the_tanh_form_of_the_jax_package():
    x = np.random.RandomState(0).randn(3, 5, 7).astype(np.float32) * 3
    ours, ref = _layers("gelu")
    got = ours.apply({}, [torch.from_numpy(x)])[0].numpy()
    want = np.asarray(ref.apply({}, [jnp.asarray(x)])[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos", ["none", "learned", "sin"])
@pytest.mark.parametrize("decode_step", [None, 5])
def test_embedding_matches_jax(pos, decode_step):
    cfg = dict(nvocab=300, nhidden=6, pos=pos)
    t = 4
    if decode_step is not None:
        cfg.update(decode=1, decode_window=16)
    ours, ref = _layers("embedding", **cfg)
    shapes = {"wmat": (300, 6)}
    if pos == "learned":
        shapes["pos"] = (16 if decode_step is not None else t, 6)
    pt, pj = _both(_np_params(shapes, 1))
    ids = np.random.RandomState(2).randint(0, 300, (2, t)).astype(np.float32)
    ids[0, 0] = 299.4  # rounds into the table; ids above 256 stay exact
    got = ours.apply(pt, [torch.from_numpy(ids)], step=decode_step)[0]
    kw = {} if decode_step is None else {"step": jnp.int32(decode_step)}
    want = np.asarray(ref.apply(pj, [jnp.asarray(ids)], **kw)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    ours, ref = _layers("layer_norm")
    x = np.random.RandomState(3).randn(2, 5, 8).astype(np.float32) * 4 + 1
    pt, pj = _both(_np_params({"wmat": (8,), "bias": (8,)}, 4))
    tdt = getattr(torch, dtype)
    # the net keeps norm parameters f32 under any compute dtype
    assert ours.prepare(pt, tdt)["wmat"].dtype == torch.float32
    got = ours.apply(pt, [torch.from_numpy(x).to(tdt)])[0]
    want = ref.apply(pj, [jnp.asarray(x).astype(getattr(jnp, dtype))])[0]
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-6 if dtype == "float32" else 1e-2,
                               atol=1e-6 if dtype == "float32" else 1e-2)


def _attention_pair(causal, extra=()):
    cfg = dict(nhead=2, causal=causal, attn_impl="pallas", **dict(extra))
    return _layers("attention", **cfg)


_ATT_SHAPES = {"wmat": (96, 32), "bias": (96,), "wproj": (32, 32),
               "bproj": (32,)}


@pytest.mark.parametrize("causal", [0, 1])
def test_attention_matches_jax_pallas(causal):
    ours, ref = _attention_pair(causal)
    params = _np_params(_ATT_SHAPES, 5, scale=0.2)
    x = np.random.RandomState(6).randn(2, 64, 32).astype(np.float32)
    g = np.random.RandomState(7).randn(2, 64, 32).astype(np.float32)

    def jf(p, xx):
        return ref.apply(p, [xx])[0]

    want, vjp = jax.vjp(jf, {t: jnp.asarray(v) for t, v in params.items()},
                        jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    pt = {t: torch.from_numpy(v.copy()).requires_grad_(True)
          for t, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ours.apply(pt, [xt])[0]
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-4)
    for t in params:
        np.testing.assert_allclose(pt[t].grad.numpy(), np.asarray(gp[t]),
                                   rtol=2e-4, atol=2e-4, err_msg=t)


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("head_dim", [8, 32, 128])
@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_attention_routes_by_head_dim_device_and_impl(impl, head_dim,
                                                      on_card):
    """On a card the flash kernels take the head dims they are built
    for under every ``attn_impl``; another head dim takes the dense
    ``mha`` under ``auto`` and ``xla`` and raises under ``pallas``, as
    the JAX package does when its flash probe fails.  On the CPU
    ``pallas`` takes the flash kernels' plain versions, the others
    ``mha``, whatever the head dim."""
    lay = create_layer("attention")
    lay.set_param("attn_impl", impl)
    built = head_dim in flash.HEAD_DIMS
    if on_card and impl == "pallas" and not built:
        with pytest.raises(NotImplementedError, match=f"not {head_dim}"):
            lay.attention_fn(head_dim, on_card)
        return
    flash_path = built if on_card else impl == "pallas"
    want = flash.flash_mha if flash_path else attention.mha
    assert lay.attention_fn(head_dim, on_card) is want


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_attention_at_head_dim_128_matches_jax(impl):
    """Head dim 128 (outside the flash kernels' dims): the dense path of
    both packages, forward and gradients."""
    ours, ref = _layers("attention", nhead=2, causal=1, attn_impl=impl)
    d = 256
    params = _np_params({"wmat": (3 * d, d), "bias": (3 * d,),
                         "wproj": (d, d), "bproj": (d,)}, 11, scale=0.05)
    x = np.random.RandomState(12).randn(2, 24, d).astype(np.float32)
    g = np.random.RandomState(13).randn(2, 24, d).astype(np.float32)

    def jf(p, xx):
        return ref.apply(p, [xx])[0]

    want, vjp = jax.vjp(jf, {t: jnp.asarray(v) for t, v in params.items()},
                        jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    pt = {t: torch.from_numpy(v.copy()).requires_grad_(True)
          for t, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ours.apply(pt, [xt])[0]
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-4)
    for t in params:
        np.testing.assert_allclose(pt[t].grad.numpy(), np.asarray(gp[t]),
                                   rtol=2e-4, atol=2e-4, err_msg=t)


def test_attention_decode_matches_the_full_causal_forward():
    """Token by token through the KV cache, in both packages, equals the
    full causal forward."""
    t_len = 8
    full, jfull = _attention_pair(1)
    dec, jdec = _attention_pair(1, (("decode", 1), ("decode_window",
                                                    t_len)))
    pt, pj = _both(_np_params(_ATT_SHAPES, 8, scale=0.2))
    x = np.random.RandomState(9).randn(2, t_len, 32).astype(np.float32)
    want = full.apply(pt, [torch.from_numpy(x)])[0].numpy()
    aux = dec.init_aux([(2, 1, 32)])
    jaux = jdec.init_aux([(2, 1, 32)])
    for t in range(t_len):
        (o,), aux = dec.apply_stateful(pt, aux, [torch.from_numpy(
            x[:, t:t + 1])], step=t)
        (oj,), jaux = jdec.apply_stateful(pj, jaux, [jnp.asarray(
            x[:, t:t + 1])], step=jnp.int32(t))
        np.testing.assert_allclose(o.numpy(), want[:, t:t + 1], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(aux["kcache"].numpy(),
                               np.asarray(jaux["kcache"]), rtol=1e-6,
                               atol=1e-6)


def test_attention_guards():
    lay = create_layer("attention")
    lay.set_param("nhead", "2")
    lay.set_param("decode", "1")
    with pytest.raises(ValueError, match="causal"):
        lay.init_aux([(1, 1, 8)])
    lay.set_param("causal", "1")
    with pytest.raises(ValueError, match="decode_window"):
        lay.init_aux([(1, 1, 8)])
    with pytest.raises(ValueError, match="attn_impl"):
        lay.set_param("attn_impl", "cudnn")
    # seq_parallel takes the JAX package's modes (the model axis itself:
    # tests/test_torch_seq_parallel.py)
    for sp, mode in (("ring", 1), ("1", 1), ("alltoall", 2), ("a2a", 2),
                     ("off", 0), ("0", 0)):
        lay.set_param("seq_parallel", sp)
        assert lay.seq_parallel == mode
    with pytest.raises(ValueError, match="seq_parallel must be one of"):
        lay.set_param("seq_parallel", "tree")


# ----------------------------------------------------------------------
# adam
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("tag", ["wmat", "bias"])
def test_adam_matches_jax_over_three_epochs(wd, tag):
    cfg = [("eta", "0.003"), ("wd", str(wd)), ("bias:eta", "0.01"),
           ("beta1", "0.2")]
    ours = create_updater("adam", tag)
    ref = JaxAdam(tag)
    for n, v in cfg:
        ours.set_param(n, v)
        ref.set_param(n, v)
    rng = np.random.RandomState(10)
    w = rng.randn(5, 7).astype(np.float32)
    wt = torch.from_numpy(w.copy())
    wj = jnp.asarray(w)
    st, sj = ours.init_state(wt), ref.init_state(wj)
    for epoch in range(3):
        g = rng.randn(5, 7).astype(np.float32)
        ours.apply(wt, torch.from_numpy(g), st, epoch)
        wj, sj = ref.apply(wj, jnp.asarray(g), sj, epoch)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                                   atol=1e-7)
        for m in ("m1", "m2"):
            np.testing.assert_allclose(st[m].numpy(), np.asarray(sj[m]),
                                       rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------------------
# data, metrics, builders
@pytest.mark.parametrize("kw", [
    dict(seq_len=16, batch_size=64),
    dict(seq_len=16, batch_size=64, round_batch=0),
    dict(seq_len=32, batch_size=8, stride=7, shuffle=1, seed_data=3),
    dict(seq_len=16, batch_size=4, shuffle=1, dist_num_worker=3,
         dist_worker_rank=1),
])
def test_text_iterator_matches_jax(corpus, kw):
    its = []
    for it in (TextIterator(), JaxText()):
        it.set_param("filename", corpus)
        it.set_param("silent", "1")
        for k, v in kw.items():
            it.set_param(k, str(v))
        it.init()
        it.before_first()
        its.append(it)
    n = 0
    while True:
        more = [it.next() for it in its]
        assert more[0] == more[1]
        if not more[0]:
            break
        a, b = (it.value() for it in its)
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
        assert a.num_batch_padd == b.num_batch_padd
        np.testing.assert_array_equal(a.data[:, 1:], a.label[:, :-1])
        n += 1
    assert n > 0


def test_text_is_an_iterator_of_the_conf(corpus):
    it = create_iterator([("iter", "text"), ("filename", corpus),
                          ("seq_len", "8"), ("batch_size", "2"),
                          ("silent", "1"), ("iter", "end")])
    assert isinstance(it, TextIterator)
    it.init()
    it.before_first()
    assert it.next() and it.value().data.shape == (2, 8)


@pytest.mark.parametrize("name", ["error", "logloss", "perplexity"])
def test_sequence_metrics_match_jax(name):
    rng = np.random.RandomState(11)
    logits = rng.randn(3, 5, 7)
    pred = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    label = rng.randint(0, 7, (3, 5)).astype(np.float32)
    vals = []
    for ms in (MetricSet(), JaxMetricSet()):
        ms.add_metric(name)
        ms.add_eval(pred, label, {"label": (0, 5)})
        vals.append(ms.metrics[0].get())
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-6)


def test_lm_conf_builder_emits_the_jax_text(corpus):
    for kw in (dict(), dict(seq_len=2048, dim=512, nhead=8, nlayer=4,
                            batch_size=8, text_file=corpus,
                            attn_impl="pallas", compute_dtype="float32")):
        assert transformer_lm_conf(**kw) == jax_lm_conf(**kw)


def test_lm_conf_keeps_ids_out_of_bf16():
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(transformer_lm_conf(
        vocab=300, seq_len=8, dim=16, nhead=2, nlayer=1, batch_size=2,
        dev="cpu")))
    tr.init_model()
    assert tr.net.compute_dtype == torch.bfloat16
    assert tr.net.input_node_shape(2) == (2, 8)
    assert tr.net._node0_wants_ints()
    ids = np.full((2, 8), 257, np.float32)
    nodes = tr.net.forward(tr.net.prepare(tr.params), torch.from_numpy(ids))
    emb = tr.params[tr.net.param_key[0]]["wmat"]
    # id 257 (not representable in bf16) picks its own row
    np.testing.assert_allclose(
        nodes[1][0, 0].float().numpy() - tr.params[tr.net.param_key[0]][
            "pos"][0].to(torch.bfloat16).float().numpy(),
        emb[257].to(torch.bfloat16).float().numpy(), atol=2e-2)


# ----------------------------------------------------------------------
# one training step, generation, the CLI
def _lm_pair(tmp_path, conf_kw, seed=0):
    """A JAX trainer with fresh weights, and the port's trainer loaded
    from its checkpoint."""
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(jax_lm_conf(**conf_kw)))
    jt.set_param("seed", str(seed))
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(transformer_lm_conf(**conf_kw)))
    tr.load_model(path)
    return jt, tr


def test_lm_step_matches_jax(tmp_path):
    jt, tr = _lm_pair(tmp_path, dict(
        seq_len=64, dim=32, nhead=2, nlayer=2, batch_size=2, dev="cpu",
        compute_dtype="float32", attn_impl="pallas", eta=0.01))
    rng = np.random.RandomState(12)
    x = rng.randint(0, 256, (2, 64)).astype(np.float32)
    y = rng.randint(0, 256, (2, 64)).astype(np.float32)
    w0 = {k: {t: np.array(v, np.float32) for t, v in tags.items()}
          for k, tags in jt.params.items()}
    _, jloss = jt.net.forward(jt.params, jnp.asarray(x),
                              labels=jnp.asarray(y), train=True)
    with torch.no_grad():
        _, tloss = tr.net.forward_train(tr.params, torch.from_numpy(x),
                                        torch.from_numpy(y), None, None)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jt.update_all(x, y)
    tr.update_all(x, y)
    assert sorted(jt.params) == sorted(tr.params)
    n = 0
    for key, tags in w0.items():
        for tag, w in tags.items():
            dj = np.asarray(jt.params[key][tag]) - w
            dt = tr.params[key][tag].numpy() - w
            assert np.abs(dj).max() > 0, f"{key}/{tag}: no update"
            g = np.abs(np.asarray(jt.ustates[key][tag]["m1"]))
            resolved = g >= UPDATE_TOL * g.max()
            assert (np.abs(dt - dj)[resolved].max()
                    <= UPDATE_TOL * np.abs(dj).max()), f"{key}/{tag}"
            for m in ("m1", "m2"):
                mj = np.asarray(jt.ustates[key][tag][m])
                mt = tr.ustates[key][tag][m].numpy()
                assert (np.abs(mt - mj).max()
                        <= UPDATE_TOL * np.abs(mj).max()), f"{key}/{tag} {m}"
            n += 1
    assert n == 2 + 2 * 12 + 4  # embed, blocks, ln_f and lm_head


@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """A small LM trained 24 steps by the JAX package on the repetitive
    corpus, and the port's trainer loaded from its checkpoint."""
    tmp = tmp_path_factory.mktemp("lm")
    text = str(tmp / "c.txt")
    with open(text, "wb") as f:
        f.write(("the quick brown fox jumps over the lazy dog. " * 300)
                .encode())
    kw = dict(seq_len=32, dim=32, nhead=2, nlayer=1, text_file=text,
              batch_size=16, dev="cpu", compute_dtype="float32", eta=0.01)
    pairs = jcfg.parse_pairs(jax_lm_conf(**kw))
    it = JaxText()
    for k, v in (("filename", text), ("seq_len", "32"), ("batch_size", "16"),
                 ("shuffle", "1"), ("silent", "1")):
        it.set_param(k, v)
    it.init()
    jt = JaxTrainer()
    jt.set_params(pairs)
    jt.init_model()
    it.before_first()
    for _ in range(24):
        if not it.next():
            it.before_first()
            it.next()
        b = it.value()
        jt.update_all(b.data, b.label)
    path = str(tmp / "0024.model")
    jt.save_model(path)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(transformer_lm_conf(**kw)))
    tr.load_model(path)
    return jt, tr


def test_generation_probabilities_match_jax(trained_pair):
    jt, tr = trained_pair
    ctx = list(b"the quick brown fox jumps")
    # the windowed path: the full forward's row after each prefix
    for n in (1, 7, len(ctx)):
        got = tgen.window_probs(tr, ctx[:n])
        t = 32
        data = np.zeros((1, t), np.float32)
        data[0, :n] = ctx[:n]
        want = jt.extract_feature(DataBatch(data=data, label=None),
                                  "top[-1]")[0, n - 1]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the cached path: the decode twins' rows, token by token
    dec = tgen._decode_twin(tr)
    aux = dec.net.init_aux(1, dec.device)
    jdec, jstep = jgen._decode_twin(jt)
    jaux = jdec.net.init_aux(1)
    for pos, tok in enumerate(ctx):
        got = tgen.decode_step(dec, aux, tok, pos)
        probs, jaux = jstep(jdec.params, jaux,
                            np.asarray([[tok]], np.float32),
                            jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(got, np.asarray(probs)[0, 0], rtol=1e-5,
                                   atol=1e-5, err_msg=f"position {pos}")


@pytest.mark.parametrize("cache", [True, False])
def test_greedy_generation_matches_jax(trained_pair, cache):
    jt, tr = trained_pair
    got = tgen.generate(tr, "the quick ", gen_len=16, cache=cache)
    want = jgen.generate(jt, "the quick ", gen_len=16, cache=cache)
    assert got == want
    assert len(got) == 16
    # same seed, same draws
    a = tgen.generate(tr, "the ", gen_len=8, temp=1.5, seed=1, cache=cache)
    assert a == tgen.generate(tr, "the ", gen_len=8, temp=1.5, seed=1,
                              cache=cache)


def test_cli_trains_on_text_and_generates(tmp_path, corpus, capsys):
    conf = tmp_path / "lm.conf"
    conf.write_text(transformer_lm_conf(
        seq_len=16, dim=32, nhead=2, nlayer=1, text_file=corpus,
        batch_size=32, num_round=1, dev="cpu", compute_dtype="float32"))
    mdir = tmp_path / "m"
    LearnTask().run([str(conf), "task=train", f"model_dir={mdir}",
                     "print_step=0", "silent=1"])
    assert sorted(f for f in os.listdir(mdir) if f.endswith(".model")) == [
        "0000.model", "0001.model"]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        LearnTask().run([str(conf), "task=generate",
                         f"model_in={mdir / '0001.model'}",
                         "gen_prompt=the quick", "gen_len=12"])
    finally:
        os.chdir(cwd)
    text = (tmp_path / "pred.txt").read_text(encoding="utf-8")
    assert len(text.encode()) >= 12 - 3 and text in capsys.readouterr().out
    # the JAX package reads the port's checkpoint and scores alike
    path = str(mdir / "0001.model")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf.read_text()))
    tr.load_model(path)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf.read_text()))
    jt.load_model(path)
    x = np.random.RandomState(13).randint(0, 256, (2, 16)).astype(np.float32)
    batch = DataBatch(data=x, label=None)
    np.testing.assert_allclose(tr.extract_feature(batch, "top[-1]"),
                               jt.extract_feature(batch, "top[-1]"),
                               rtol=1e-5, atol=1e-6)


def test_generate_reads_the_prompt_file_lazily_and_needs_a_model(tmp_path):
    task = LearnTask()
    task.set_param("gen_prompt_file", str(tmp_path / "missing.txt"))
    assert task.gen_prompt_file.endswith("missing.txt")  # stored, not read
    conf = tmp_path / "lm.conf"
    conf.write_text(transformer_lm_conf(seq_len=8, dim=16, nhead=2,
                                        nlayer=1, dev="cpu"))
    with pytest.raises(ValueError, match="model_in"):
        LearnTask().run([str(conf), "task=generate"])


def test_lm_checkpoint_round_trips_through_the_jax_package(tmp_path):
    """Port -> JAX -> port: every tag of the new layers (embed wmat and
    pos; attention wmat, bias, wproj, bproj; layer_norm wmat, bias)
    comes back bit for bit, in the same layout."""
    conf = transformer_lm_conf(seq_len=8, dim=16, nhead=2, nlayer=1,
                               dev="cpu", compute_dtype="float32")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.init_model()
    a = str(tmp_path / "a.model")
    tr.save_model(a)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf))
    jt.load_model(a)
    b = str(tmp_path / "b.model")
    jt.save_model(b)
    back = NetTrainer()
    back.set_params(tcfg.parse_pairs(conf))
    back.load_model(b)
    tags = {(k.split("_", 1)[1], t) for k, tt in tr.params.items()
            for t in tt}
    assert {("embed", "wmat"), ("embed", "pos"), ("b0_attn", "wmat"),
            ("b0_attn", "bias"), ("b0_attn", "wproj"), ("b0_attn", "bproj"),
            ("b0_ln1", "wmat"), ("b0_ln1", "bias")} <= tags
    for key, tt in tr.params.items():
        for tag, w in tt.items():
            assert np.asarray(jt.params[key][tag]).shape == tuple(w.shape)
            np.testing.assert_array_equal(back.params[key][tag].numpy(),
                                          w.numpy())
