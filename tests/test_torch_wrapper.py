"""The port's library API (``wrapper.py``) against the JAX package's.

* ``DataIter`` over the same section text gives the same batches and
  the same head/tail states in both packages;
* ``train`` on a small conv net of the UCI digits' width (1x8x8, 10
  classes), both packages started from one checkpoint, gives the same
  predictions, evaluation lines and ``get_weight`` views;
* ``set_weight`` round-trips, conv ``wmat`` in the visitor's
  ``(cout, cin*kh*kw)`` view included; an absent weight is ``None``;
* ``update_scan`` equals K ``update`` calls in the port (bit for bit)
  and the JAX ``update_scan`` (tolerance), and refuses what the JAX
  trainer refuses;
* ``extract`` / ``predict`` on an iterator trim the padded rows;
* raw arrays go through the bucket cache and equal the trainer's rows;
* the default device raises without a card; ``dist_num_proc`` without
  its coordinator is refused with the JAX package's message, and a device
  range in one process names ``dist_num_proc``.

Tolerances: predictions equal; scores, losses and weights after the
shared steps within rtol 1e-4, atol 1e-5 (f32 in two frameworks);
inside the port, exact.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu import wrapper as jw
from cxxnet_tpu.nnet import trainer as jtrainer
from cxxnet_tpu_torch import wrapper as tw
from cxxnet_tpu_torch.nnet import trainer as ttrainer

RTOL, ATOL = 1e-4, 1e-5

NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  pad = 1
  init_sigma = 0.1
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 2
  stride = 2
layer[3->4] = flatten
layer[4->5] = fullc:fc1
  nhidden = 10
  init_sigma = 0.1
layer[5->5] = softmax
netconfig = end
input_shape = 1,8,8
batch_size = 16
eta = 0.1
momentum = 0.9
wd = 0.0001
metric = error
"""


@pytest.fixture(autouse=True)
def _jax_obs_registry_as_found():
    """Drop the empty device-plane histogram the JAX trainer registers,
    which an exposition check later in the same process
    (``tests/test_obs.py``) rejects, as the other parity files do."""
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


def _digits(n, seed):
    """Digits-width data: 8x8 images in [0, 16], labels 0..9."""
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 17, (n, 64)).astype(np.float32),
            rs.randint(0, 10, n).astype(np.float32))


def _csv(tmp_path, n, seed, name, batch=16, extra=""):
    x, y = _digits(n, seed)
    path = os.path.join(str(tmp_path), name)
    np.savetxt(path, np.concatenate([y[:, None], x], 1), delimiter=",",
               fmt="%g")
    return f"""
data = train
iter = csv
  filename = {path}
  label_width = 1
  input_shape = 1,8,8
  batch_size = {batch}
{extra}iter = end
"""


def _batches(it):
    out = []
    it.before_first()
    while it.next():
        out.append((it.get_data().copy(), it.get_label().copy(),
                    it.value().num_batch_padd))
    return out


def test_dataiter_same_batches_and_states(tmp_path):
    sec = _csv(tmp_path, 40, 0, "a.csv", extra="  round_batch = 0\n")
    its = [jw.DataIter(sec), tw.DataIter(sec)]
    for it in its:
        assert it.head and not it.tail
        with pytest.raises(RuntimeError, match="head state"):
            it.get_data()
    got = [_batches(it) for it in its]
    assert len(got[0]) == len(got[1]) == 3
    for (dj, lj, pj), (dt, lt, pt) in zip(*got):
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(lj, lt)
        assert pj == pt
    assert got[1][-1][2] == 8  # 40 rows: the third batch pads 8
    for it in its:
        assert it.tail
        with pytest.raises(RuntimeError, match="reaches end"):
            it.value()
    assert [b.data.shape for b in its[1]] == [(16, 8, 8, 1)] * 3


def _shared_start(tmp_path):
    """One JAX-drawn checkpoint both packages start from."""
    path = str(tmp_path / "start.model")
    net = jw.Net(dev="cpu", cfg=NET)
    net.init_model()
    net.save_model(path)
    return path


def test_train_gives_the_same_model(tmp_path, monkeypatch, capsys):
    start = _shared_start(tmp_path)
    train_sec = _csv(tmp_path, 64, 1, "train.csv")
    eval_sec = _csv(tmp_path, 40, 2, "eval.csv")
    for mod in (jtrainer, ttrainer):
        monkeypatch.setattr(mod.NetTrainer, "init_model",
                            lambda self: self.load_model(start))
    out = {}
    for name, w in (("jax", jw), ("port", tw)):
        capsys.readouterr()
        net = w.train(NET, w.DataIter(train_sec), 2, {"eval_train": "0"},
                      eval_data=w.DataIter(eval_sec), dev="cpu",
                      print_step=2)
        text = capsys.readouterr()
        x, _ = _digits(20, 3)
        out[name] = dict(
            err=text.err, printed=text.out,
            pred=net.predict(x.reshape(20, 8, 8, 1)),
            scores=net.extract(x.reshape(20, 8, 8, 1), "top[-1]"),
            c1=net.get_weight("c1", "wmat"), b1=net.get_weight("c1", "bias"),
            fc=net.get_weight("fc1", "wmat"))
    j, t = out["jax"], out["port"]
    assert t["printed"] == j["printed"]
    assert "[1] 4 batch passed" in t["printed"]
    assert t["err"] == j["err"] and t["err"].count("eval-error:") == 2
    np.testing.assert_array_equal(t["pred"], j["pred"])
    np.testing.assert_allclose(t["scores"], j["scores"], RTOL, ATOL)
    assert t["c1"].shape == (8, 9) and t["b1"].shape == (1, 8)
    assert t["fc"].shape == (10, 128)
    for k in ("c1", "b1", "fc"):
        np.testing.assert_allclose(t[k], j[k], RTOL, ATOL)


def test_weight_views_and_set_weight_round_trip(tmp_path):
    start = _shared_start(tmp_path)
    nets = []
    for w in (jw, tw):
        net = w.Net(dev="cpu", cfg=NET)
        net.load_model(start)
        nets.append(net)
    jn, tn = nets
    for layer, tag in (("c1", "wmat"), ("c1", "bias"), ("fc1", "wmat"),
                       ("fc1", "bias")):
        np.testing.assert_array_equal(tn.get_weight(layer, tag),
                                      jn.get_weight(layer, tag))
    # the conv view is (cout, cin*kh*kw) in (cin, kh, kw) minor order
    hwio = tn.trainer.params[tn.trainer.net.param_key[0]]["wmat"].numpy()
    np.testing.assert_array_equal(tn.get_weight("c1", "wmat"),
                                  hwio.transpose(3, 2, 0, 1).reshape(8, 9))
    x, _ = _digits(8, 5)
    x = x.reshape(8, 8, 8, 1)
    before = tn.extract(x, "top[-1]")
    for layer, tag in (("c1", "wmat"), ("fc1", "bias")):
        v = tn.get_weight(layer, tag)
        new = v * 2 + 0.25
        tn.set_weight(new, layer, tag)
        jn.set_weight(new, layer, tag)
        np.testing.assert_array_equal(tn.get_weight(layer, tag), new)
        np.testing.assert_array_equal(jn.get_weight(layer, tag), new)
    # in place, and the prepared operands of the old weights are dropped
    np.testing.assert_allclose(tn.extract(x, "top[-1]"),
                               jn.extract(x, "top[-1]"), RTOL, ATOL)
    assert not np.array_equal(tn.extract(x, "top[-1]"), before)
    assert tn.get_weight("c1", "nope") is None
    assert tn.get_weight("fc1", "gamma") is None
    with pytest.raises(ValueError, match="wmat or bias"):
        tn.set_weight(np.zeros(8), "c1", "gamma")


def test_update_scan_matches_updates_in_both_packages(tmp_path):
    start = _shared_start(tmp_path)
    x, y = _digits(64, 7)
    stack = x.reshape(4, 16, 8, 8, 1)
    lstack = y.reshape(4, 16, 1)

    def net(w, extra=""):
        n = w.Net(dev="cpu", cfg=NET + "eval_train = 0\n" + extra)
        n.load_model(start)
        return n

    scan, loop, jscan = net(tw), net(tw), net(jw)
    losses = scan.update_scan(stack, lstack)
    for i in range(4):
        loop.update(stack[i], lstack[i])
    jl = jscan.update_scan(stack, lstack)
    assert losses.shape == (4,) and losses.dtype == np.float32
    np.testing.assert_allclose(losses, jl, RTOL, ATOL)
    for layer, tag in (("c1", "wmat"), ("fc1", "wmat"), ("fc1", "bias")):
        np.testing.assert_array_equal(scan.get_weight(layer, tag),
                                      loop.get_weight(layer, tag))
        np.testing.assert_allclose(scan.get_weight(layer, tag),
                                   jscan.get_weight(layer, tag), RTOL, ATOL)
    assert scan.trainer.epoch_counter == loop.trainer.epoch_counter == 4
    # one batch reused n_steps times
    again = scan.update_scan(stack[0], lstack[0], n_steps=2)
    assert again.shape == (2,)
    dev_losses = scan.trainer.update_scan(stack[:1], lstack[:1], sync=False)
    assert isinstance(dev_losses, torch.Tensor) and dev_losses.shape == (1,)


@pytest.mark.parametrize("extra,call,match", [
    ("update_period = 2\n", {}, "update_period == 1"),
    ("", {"n_steps": 3}, "n_steps=3 != leading data axis 4"),
    ("", {"single": True}, "single-batch mode needs n_steps"),
    ("eval_train = 1\n", {"sync": False}, "cannot overlap with eval_train"),
    ("eval_train = 1\nmetric[label,1] = error\n", {},
     "node-bound train metrics"),
])
def test_update_scan_refuses_what_the_jax_trainer_refuses(
        tmp_path, extra, call, match):
    x, y = _digits(64, 7)
    stack, lstack = x.reshape(4, 16, 8, 8, 1), y.reshape(4, 16, 1)
    for w in (jw, tw):
        net = w.Net(dev="cpu", cfg=NET + "eval_train = 0\n" + extra)
        net.init_model()
        data, label = (stack[0], lstack[0]) if call.get("single") else (
            stack, lstack)
        kw = {k: v for k, v in call.items() if k in ("n_steps", "sync")}
        with pytest.raises(ValueError, match=match.replace("[", r"\[")):
            net.trainer.update_scan(data, label, **kw)


def test_iterator_predict_and_extract_trim_padding(tmp_path):
    start = _shared_start(tmp_path)
    sec = _csv(tmp_path, 20, 4, "p.csv", extra="  round_batch = 0\n")
    out = {}
    for name, w in (("jax", jw), ("port", tw)):
        net = w.Net(dev="cpu", cfg=NET)
        net.load_model(start)
        it = w.DataIter(sec)
        rows = []
        while it.next():
            rows.append((net.predict(it), net.extract(it, "4"),
                         it.value().num_batch_padd))
        ev = net.evaluate(it, "held")
        with pytest.raises(RuntimeError, match="reaches end"):
            it.value()  # evaluate drained the iterator
        out[name] = rows, ev
    rows = out["port"][0]
    assert [(len(p), len(f), pad) for p, f, pad in rows] == [
        (16, 16, 0), (4, 4, 12)]
    assert rows[1][1].shape == (4, 128)
    assert out["port"][1] == out["jax"][1] and "held-error:" in out["port"][1]
    for (pt, ft, _), (pj, fj, _) in zip(rows, out["jax"][0]):
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_allclose(ft, fj, RTOL, ATOL)


def test_raw_arrays_take_the_bucket_cache(tmp_path):
    net = tw.Net(dev="cpu", cfg=NET)
    net.init_model()
    x, _ = _digits(100, 6)
    x = x.reshape(100, 8, 8, 1)
    got = net.predict(x)
    assert got.shape == (100,)
    np.testing.assert_array_equal(got, net.trainer.predict(x))
    cache = net._bucket_cache()
    assert cache.stats()["misses"] == 1  # one bucket of 128
    for n in (1, 3, 7, 100):
        np.testing.assert_array_equal(net.predict(x[:n]), got[:n])
        assert net.extract(x[:n], "4").shape == (n, 128)
    flat = net.predict(x.reshape(100, 64))  # the flat spelling
    np.testing.assert_array_equal(flat, got)
    # a reload rebuilds the cache for the new net
    path = str(tmp_path / "m.model")
    net.save_model(path)
    net.load_model(path)
    assert net._bucket_cache() is not cache


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = tw.Net(cfg=NET)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        net.init_model()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tw.train(NET, np.zeros((16, 8, 8, 1), np.float32), 1, {},
                 label=np.zeros(16, np.float32))
    # once refused; now the wrapper joins the job the dist_* keys name
    net = tw.Net(dev="cpu", cfg=NET + "dist_num_proc = 2\n")
    with pytest.raises(ValueError, match="needs all of dist_coordinator"):
        net.init_model()
    net = tw.Net(dev="cpu:0-1", cfg=NET)
    with pytest.raises(NotImplementedError, match="dist_num_proc"):
        net.init_model()
