"""The training slice end to end, on the CPU, against the JAX package.

* A weight update invalidates the operands ``predict`` prepared: the
  prediction after ``update`` equals a fresh trainer loaded from the
  updated weights.
* GoogLeNet at 64x64 (13 max pools: 4 through the general unpool
  backward, 9 through the stride-1 one; 2 LRNs; 9 sibling-1x1 groups),
  dropout threshold 0 in both packages: from one JAX checkpoint, one
  ``update`` of both packages on the same synthetic batch.  The UPDATES
  are compared, not the weights (one step at lr 0.01 barely moves a
  weight, so a tolerance on weights would pass a wrong gradient): for
  every tensor ``max|dw_port - dw_jax| <= 1e-3 * max|dw_jax|``, the same
  for the momentum, and the loss to rtol 1e-5.  oneDNN and XLA sum the
  conv products in other orders; nothing else differs.  The test first
  checks that both forwards zero the same activations (see the test).
* A small inception net with the same layer types (stride-1 and
  stride-2 max pools, an even-width LRN, a bias-less 1x1 member) runs 3
  steps under ``polydecay`` with ``wmat:``/``bias:`` keys and momentum
  carried across steps, the last one a short masked batch, to the same
  tolerance.
* The step's updates through the grouped path (every SGD tensor in one
  ``sgd_update_multi`` call a step) equal, bit for bit, weights and
  momenta updated tensor by tensor through ``SGDUpdater.apply``.
* ``task=train dev=cpu`` runs 2 rounds on a synthetic conf, writes
  ``0000-0002.model`` and the eval lines; the JAX ``NetTrainer`` loads
  the last checkpoint and scores like the port (atol 1e-5, rtol 1e-4).
  ``continue = 1`` resumes, and SIGTERM snapshots and exits 0.
"""

import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io.synth import SyntheticIterator as JaxSynth
from cxxnet_tpu.models import googlenet_conf
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io.synth import SyntheticIterator
from cxxnet_tpu_torch.nnet import trainer as trainer_mod
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.ops.kernels import update_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPDATE_TOL = 1e-3  # of each tensor's largest update

GN_CONF = googlenet_conf(input_size=64, batch_size=4, compute_dtype="float32",
                         dev="cpu").replace("threshold = 0.4",
                                            "threshold = 0.0")


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


SMALL_CONF = """
netconfig = start
layer[0->stem] = conv:stem
  kernel_size = 3
  pad = 1
  nchannel = 8
  init_sigma = 0.2
layer[stem->stem] = relu
layer[stem->p] = max_pooling
  kernel_size = 3
  stride = 1
  pad = 1
layer[p->n] = lrn
  local_size = 4
  alpha = 0.01
layer[n->b1] = conv:br1
  kernel_size = 1
  nchannel = 4
  init_sigma = 0.2
layer[n->b2] = conv:br2
  kernel_size = 1
  nchannel = 6
  init_sigma = 0.2
  no_bias = 1
layer[n->b3] = conv:br3
  kernel_size = 1
  nchannel = 2
  init_sigma = 0.2
layer[b1,b2,b3->cat] = ch_concat
layer[cat->cat] = relu
layer[cat->q] = max_pooling
  kernel_size = 3
  stride = 2
layer[q->fl] = flatten
layer[fl->fl] = dropout
  threshold = 0.0
layer[fl->out] = fullc:fc
  nhidden = 4
  init_sigma = 0.2
layer[+0] = softmax
netconfig = end
input_shape = 3,7,7
batch_size = 8
dev = cpu
updater = sgd
eta = 0.1
momentum = 0.9
wd = 0.001
wmat:lr = 0.2
bias:lr = 0.05
bias:wd = 0.0
lr:schedule = polydecay
lr:gamma = 0.5
lr:alpha = 0.5
metric = error
"""


def _synth_batch(shape, nclass, rows, seed=0):
    """The first ``rows`` of the shared synthetic stream, read through
    both packages' iterators (they must agree bit for bit)."""
    batches = []
    for it in (SyntheticIterator(), JaxSynth()):
        for k, v in (("nsample", str(rows)), ("input_shape", shape),
                     ("nclass", str(nclass)), ("batch_size", str(rows)),
                     ("seed_data", str(seed))):
            it.set_param(k, v)
        it.init()
        it.before_first()
        assert it.next()
        batches.append(it.value())
    ours, ref = batches
    np.testing.assert_array_equal(ours.data, ref.data)
    np.testing.assert_array_equal(ours.label, ref.label)
    return ours.data, ours.label


@pytest.mark.parametrize("workers,rank", [(1, 0), (2, 1)])
def test_synthetic_draws_match_jax_draws(workers, rank):
    """Two iterators of the same settings draw the JAX package's rows
    and labels, worker shards too, each in arrays of its own."""
    def made(cls):
        it = cls()
        for k, v in (("nsample", "6"), ("input_shape", "3,5,5"),
                     ("nclass", "4"), ("batch_size", "6"),
                     ("seed_data", "3"), ("dist_num_worker", str(workers)),
                     ("dist_worker_rank", str(rank))):
            it.set_param(k, v)
        it.init()
        it.before_first()
        assert it.next()
        return it

    ref = made(JaxSynth).value()
    first, again = made(SyntheticIterator), made(SyntheticIterator)
    for it in (first, again):
        np.testing.assert_array_equal(it.value().data, ref.data)
        np.testing.assert_array_equal(it.value().label, ref.label)
    assert not np.shares_memory(first._data, again._data)


def _snapshot(params):
    return {k: {t: np.array(v, dtype=np.float32, copy=True)
                for t, v in tags.items()} for k, tags in params.items()}


def _assert_updates_match(jt, tr, w0):
    """Per tensor: the weight update and the momentum of the port within
    ``UPDATE_TOL`` of the JAX package's largest."""
    assert sorted(jt.params) == sorted(tr.params)
    for key, tags in w0.items():
        for tag, w in tags.items():
            dj = np.asarray(jt.params[key][tag]) - w
            dt = tr.params[key][tag].numpy() - w
            mj = np.asarray(jt.ustates[key][tag]["m"])
            mt = tr.ustates[key][tag]["m"].numpy()
            scale = np.abs(dj).max()
            assert scale > 0, f"{key}/{tag}: no update"
            assert np.abs(dt - dj).max() <= UPDATE_TOL * scale, f"{key}/{tag}"
            assert (np.abs(mt - mj).max()
                    <= UPDATE_TOL * np.abs(mj).max()), f"{key}/{tag} m"


def _pair(conf, tmp_path, seed):
    """A JAX trainer with fresh weights, and the port's trainer loaded
    from its checkpoint."""
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf))
    jt.set_param("seed", str(seed))
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.load_model(path)
    return jt, tr


def test_update_invalidates_the_prepared_operands(tmp_path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(SMALL_CONF))
    tr.init_model()
    x, y = _synth_batch("3,7,7", 4, 8)
    before = tr.predict_fn()(tr.params, tr.aux, x, ()).numpy()
    tr.update_all(x, y)
    after = tr.predict_fn()(tr.params, tr.aux, x, ()).numpy()
    path = str(tmp_path / "0001.model")
    tr.save_model(path, round_=1)
    fresh = NetTrainer()
    fresh.set_params(tcfg.parse_pairs(SMALL_CONF))
    fresh.load_model(path)
    ref = fresh.predict_fn()(fresh.params, fresh.aux, x, ()).numpy()
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, ref)


def test_googlenet_step_matches_jax(tmp_path):
    jt, tr = _pair(GN_CONF, tmp_path, seed=1)
    assert len([w for tags in tr.params.values() for w in tags]) == 116
    x, y = _synth_batch("3,64,64", 1000, 4)
    w0 = _snapshot(jt.params)
    nodes_j, jloss = jt.net.forward(jt.params, jnp.asarray(x),
                                    labels=jnp.asarray(y), train=True)
    with torch.no_grad():
        nodes_t, _ = tr.net.forward_train(tr.params, torch.from_numpy(x),
                                          torch.from_numpy(y), None, None)
    # precondition: every relu output is zero at the same places in both
    # packages.  A near-zero activation whose sign the two packages'
    # rounding decides differently moves a max-pool gradient from one
    # input to another, a legitimate change of ~1% in the gradients
    # upstream of it (seen at 64x64 with other weight seeds); the update
    # tolerance only means something without such a flip
    out = tr.net.out_node_index()
    for i, (a, b) in enumerate(zip(nodes_j, nodes_t)):
        if a is not None and i != out:
            np.testing.assert_array_equal(np.asarray(a) == 0,
                                          b.numpy() == 0, err_msg=str(i))
    jt.update_all(x, y)
    tr.update_all(x, y)
    assert tr.epoch_counter == jt.epoch_counter == 1
    np.testing.assert_allclose(float(tr.last_loss), float(jloss), rtol=1e-5)
    _assert_updates_match(jt, tr, w0)


def test_small_inception_three_steps_match_jax(tmp_path):
    jt, tr = _pair(SMALL_CONF, tmp_path, seed=7)
    x, y = _synth_batch("3,7,7", 4, 24, seed=2)
    w0 = _snapshot(jt.params)
    for lo, hi in ((0, 8), (8, 16), (16, 22)):  # the last batch is short
        jt.update_all(x[lo:hi], y[lo:hi])
        tr.update_all(x[lo:hi], y[lo:hi])
    assert tr.epoch_counter == 3
    _assert_updates_match(jt, tr, w0)
    assert tr.evaluate(None, "train") == jt.evaluate(None, "train")


def test_grouped_sgd_step_equals_the_per_tensor_updates(monkeypatch):
    trainers = []
    for _ in range(2):
        tr = NetTrainer()
        tr.set_params(tcfg.parse_pairs(SMALL_CONF))
        tr.init_model()
        trainers.append(tr)
    grouped, per_tensor = trainers
    x, y = _synth_batch("3,7,7", 4, 16, seed=3)
    calls = []
    multi = update_step.sgd_update_multi

    def counted(*args):
        calls.append(len(args[0]))
        multi(*args)

    monkeypatch.setattr(update_step, "sgd_update_multi", counted)
    for lo in (0, 8):
        grouped.update_all(x[lo:lo + 8], y[lo:lo + 8])
    n_tensors = sum(len(t) for t in grouped.params.values())
    assert calls == [n_tensors, n_tensors]  # one call a step, every tensor

    def one_by_one(items, epoch):
        for up, w, g, state in items:
            up.apply(w, g, state, epoch)

    monkeypatch.setattr(trainer_mod, "apply_all", one_by_one)
    for lo in (0, 8):
        per_tensor.update_all(x[lo:lo + 8], y[lo:lo + 8])
    assert len(calls) == 2
    for key, tags in grouped.params.items():
        for tag, w in tags.items():
            assert torch.equal(w, per_tensor.params[key][tag]), (key, tag)
            assert torch.equal(grouped.ustates[key][tag]["m"],
                               per_tensor.ustates[key][tag]["m"])
            assert not torch.equal(grouped.ustates[key][tag]["m"],
                                   torch.zeros_like(w)), (key, tag)


TRAIN_CONF = """
data = train
iter = synthetic
  nsample = 32
  input_shape = 3,8,8
  nclass = 4
iter = threadbuffer
iter = end
eval = test
iter = synthetic
  nsample = 16
  input_shape = 3,8,8
  nclass = 4
  seed_data = 1
iter = end
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  pad = 1
layer[1->1] = relu
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = lrn
  local_size = 5
layer[3->4] = flatten
layer[4->4] = dropout
  threshold = 0.3
layer[4->5] = fullc:fc
  nhidden = 4
layer[5->5] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 8
dev = cpu
eta = 0.1
momentum = 0.9
metric = error
metric = rec@2
num_round = 2
scan_steps = 8
silent = 1
"""


def test_cli_trains_writes_rounds_and_jax_scores_alike(tmp_path, capfd):
    conf = tmp_path / "t.conf"
    conf.write_text(TRAIN_CONF)
    mdir = tmp_path / "m"
    assert LearnTask().run([str(conf), "task=train", f"model_dir={mdir}"]) == 0
    err = capfd.readouterr().err
    for r in (1, 2):
        assert f"[{r}]\ttrain-error:" in err and "\ttest-rec@2:" in err
    for r in range(3):
        assert (mdir / f"{r:04d}.model").exists()
        assert (mdir / f"{r:04d}.model.manifest.json").exists()
    assert not (mdir / "0003.model").exists()

    x, _ = _synth_batch("3,8,8", 4, 8, seed=5)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(TRAIN_CONF))
    tr.load_model(str(mdir / "0002.model"))
    assert tr.epoch_counter == 8  # 2 rounds of 4 batches
    got = tr.predict_fn()(tr.params, tr.aux, x, ()).numpy()
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(TRAIN_CONF))
    jt.load_model(str(mdir / "0002.model"))
    ref = np.asarray(jt.predict_fn()(jt.params, jt.aux, x, ()))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)

    # continue = 1 resumes from the newest checkpoint
    LearnTask().run([str(conf), "task=train", f"model_dir={mdir}",
                     "continue=1", "num_round=3"])
    assert (mdir / "0003.model").exists()
    tr.load_model(str(mdir / "0003.model"))
    assert tr.epoch_counter == 12


def test_cli_sigterm_snapshots_and_exits_clean(tmp_path):
    conf = tmp_path / "t.conf"
    conf.write_text(TRAIN_CONF.replace("silent = 1", "silent = 0"))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", str(conf), "task=train",
         f"model_dir={tmp_path / 'm'}", "num_round=100000"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(tmp_path), env=env)
    try:
        for line in proc.stdout:
            if line.startswith("update round 2"):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "preemption: state saved through round" in out
    saved = sorted(p for p in os.listdir(tmp_path / "m")
                   if p.endswith(".model"))
    assert len(saved) >= 3


def test_train_refuses_what_is_not_ported(tmp_path):
    # the divergence guard, the integrity plane, (data parallelism) the
    # cross-process weight check and the elastic pod are ported
    LearnTask().set_param("test_on_server", "1")
    for key in ("elastic", "elastic_join"):
        task = LearnTask()
        task.set_param(key, "1")
        assert task.cfg[-1] == (key, "1")
    with pytest.raises(ValueError, match="abort or rollback"):
        NetTrainer().set_param("divergence_policy", "retry")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(SMALL_CONF + "dev = gpu:0-1\n"))
    with pytest.raises(NotImplementedError, match="dist_num_proc"):
        tr.init_model()
    conf = tmp_path / "t.conf"
    conf.write_text(TRAIN_CONF.replace("iter = synthetic", "iter = service",
                                       1))
    # the data service is ported: a service section needs its address
    with pytest.raises(ValueError, match="data_service_addr"):
        LearnTask().run([str(conf), "task=train",
                         f"model_dir={tmp_path / 'm'}"])
