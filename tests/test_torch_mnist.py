"""The MNIST slice of the port against the JAX package, on the CPU.

The idx reader and writer, ``MNISTIterator`` (batch for batch, under
``shuffle``, ``input_flat`` and ``index_offset``), the digits tool
(byte-equal files), ``digits.conf`` trained 3 rounds in both packages
from one JAX-written checkpoint (the eval lines equal, the weights
within ``DIGITS_WEIGHT_TOL``), the JAX quick accuracy bar in the port,
the checkpoints of each MNIST conf read both ways, the CLI tasks
``pred``, ``pred_raw``, ``extract`` and ``summary`` against the JAX
CLI's on one checkpoint (``pred`` and ``.meta`` byte-equal, the floats
within ``TASK_ATOL``), ``finetune`` from either package's checkpoint,
and ``update_period = 2`` against the JAX trainer for SGD and Adam over
four micro-batches with batch norm's running statistics.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io import mnist as jmnist
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io import mnist as tmnist
from cxxnet_tpu_torch.io.data import create_iterator
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.tools.make_digits_idx import write_digits_idx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_DIR = os.path.join(REPO, "example", "MNIST")
MNIST_CONFS = ("MNIST.conf", "MNIST_CONV.conf", "digits.conf",
               "digits_conv.conf")
# scores of one checkpoint in both packages (f32; oneDNN and XLA sum
# the conv and GEMM products in other orders)
SCORE_ATOL = 1e-6
# the digits MLP's weights after 3 rounds (90 SGD steps) in both
# packages, from one checkpoint, within this share of each tensor's
# largest magnitude; the largest reading was 1.1e-6
DIGITS_WEIGHT_TOL = 1e-5
# the CLI's printed floats ({v:g}: 6 significant digits) across packages
TASK_ATOL = 1e-5
# update_period = 2: each tensor within this share of its largest
# magnitude, by updater, and the running statistics within the sgd one.
# Readings: sgd 6.3e-7, the statistics 2.7e-7; adam 9.5e-6, as its first
# steps move a weight by about lr * sign(g), and the sign of a gradient
# near 0 differs between the packages' summation orders
ACCUM_TOL = {"sgd": 1e-5, "adam": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer registers, which an exposition check later
    in the same process (``tests/test_obs.py``) rejects."""
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


def _templated_digits(n, side, seed):
    """``n`` uint8 images of ``side`` x ``side`` drawn around ten class
    templates, and their labels: a set a net learns in a round."""
    rng = np.random.RandomState(seed)
    templates = np.random.RandomState(99).randint(0, 256, (10, side, side))
    labels = rng.randint(0, 10, n)
    noise = rng.randint(-40, 41, (n, side, side))
    return np.clip(templates[labels] + noise, 0, 255).astype(np.uint8), labels


def _write_mnist(d, n_train=400, n_test=200, side=28):
    os.makedirs(d, exist_ok=True)
    for name, n, seed in (("train", n_train, 1), ("t10k", n_test, 2)):
        imgs, labels = _templated_digits(n, side, seed)
        tmnist.write_idx_images(os.path.join(d, f"{name}-images-idx3-ubyte"),
                                imgs)
        tmnist.write_idx_labels(os.path.join(d, f"{name}-labels-idx1-ubyte"),
                                labels)


# ----------------------------------------------------------------------
# idx files and the iterator

def test_idx_reader_and_writer_match_jax(tmp_path):
    imgs, labels = _templated_digits(17, 9, 0)
    for pkg in ("jax", "port"):
        w = jmnist if pkg == "jax" else tmnist
        w.write_idx_images(str(tmp_path / f"{pkg}.img"), imgs)
        w.write_idx_labels(str(tmp_path / f"{pkg}.lab"), labels)
    for ext in ("img", "lab"):
        assert ((tmp_path / f"jax.{ext}").read_bytes()
                == (tmp_path / f"port.{ext}").read_bytes())
    for r in (jmnist, tmnist):
        np.testing.assert_array_equal(
            r.read_idx_images(str(tmp_path / "port.img")), imgs)
        np.testing.assert_array_equal(
            r.read_idx_labels(str(tmp_path / "jax.lab")), labels)


@pytest.mark.parametrize("shuffle,input_flat,index_offset,seed_data", [
    (0, 1, 0, 0), (1, 1, 0, 0), (1, 0, 5, 0), (1, 0, 0, 3), (0, 0, 7, 0)])
def test_mnist_iterator_batches_equal_jax(tmp_path, shuffle, input_flat,
                                          index_offset, seed_data):
    _write_mnist(str(tmp_path), n_train=103, n_test=1, side=6)
    entries = [("iter", "mnist"),
               ("path_img", str(tmp_path / "train-images-idx3-ubyte")),
               ("path_label", str(tmp_path / "train-labels-idx1-ubyte")),
               ("shuffle", str(shuffle)), ("input_flat", str(input_flat)),
               ("index_offset", str(index_offset)),
               ("seed_data", str(seed_data)), ("batch_size", "10"),
               ("silent", "1"), ("iter", "end")]
    from cxxnet_tpu.io.data import create_iterator as jcreate

    ours, ref = create_iterator(entries), jcreate(entries)
    assert isinstance(ours, tmnist.MNISTIterator)
    ours.init()
    ref.init()
    n = 0
    for it in (ours, ref):
        it.before_first()
    while ref.next():
        assert ours.next()
        a, b = ours.value(), ref.value()
        assert a.data.dtype == np.float32 and a.data.shape == b.data.shape
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.label, b.label)
        np.testing.assert_array_equal(a.inst_index, b.inst_index)
        n += 1
    assert not ours.next() and n == 10  # the last 3 rows are dropped
    want = (10, 36) if input_flat else (10, 6, 6, 1)
    assert a.data.shape == want


def test_mnist_iterator_refuses_data_sharding(tmp_path):
    """Once refused; now ``dist_num_worker`` shards as the JAX iterator
    does (both ``dist_shard`` rules), and a bad rule is refused."""
    from cxxnet_tpu.io.mnist import MNISTIterator as JaxMNIST

    rng = np.random.RandomState(4)
    img, lab = str(tmp_path / "i.idx"), str(tmp_path / "l.idx")
    tmnist.write_idx_images(img, rng.randint(0, 256, (50, 4, 4)))
    tmnist.write_idx_labels(lab, rng.randint(0, 10, 50))
    for shard in ("interleave", "block"):
        for rank in range(3):
            rows = []
            for it in (tmnist.MNISTIterator(), JaxMNIST()):
                for k, v in (("path_img", img), ("path_label", lab),
                             ("batch_size", "4"), ("shuffle", "1"),
                             ("silent", "1"), ("dist_num_worker", "3"),
                             ("dist_worker_rank", str(rank)),
                             ("dist_shard", shard)):
                    it.set_param(k, v)
                it.init()
                it.before_first()
                got = []
                while it.next():
                    v = it.value()
                    got.append((v.data.copy(), v.label.copy(),
                                np.asarray(v.inst_index).copy()))
                rows.append(got)
            assert len(rows[0]) == len(rows[1]) > 0
            for (d0, l0, i0), (d1, l1, i1) in zip(*rows):
                assert d0.tobytes() == d1.tobytes()
                assert l0.tobytes() == l1.tobytes()
                np.testing.assert_array_equal(i0, i1)
    with pytest.raises(ValueError, match="interleave or block"):
        tmnist.MNISTIterator().set_param("dist_shard", "stripe")


def test_digits_tool_writes_the_jax_tools_files(tmp_path):
    from tools.make_digits_idx import write_digits_idx as jax_write

    jax_write(str(tmp_path / "jax"))
    write_digits_idx(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for f in names:
        assert ((tmp_path / "jax" / f).read_bytes()
                == (tmp_path / "port" / f).read_bytes()), f
    assert len(tmnist.read_idx_labels(
        str(tmp_path / "port" / "digits-t10k-labels-idx1-ubyte"))) == 297


# ----------------------------------------------------------------------
# checkpoints of each MNIST conf, both ways

def _conf_entries(name, **over):
    entries = tcfg.parse_file(os.path.join(MNIST_DIR, name))
    return entries + [(k, str(v)) for k, v in over.items()]


@pytest.mark.parametrize("name", MNIST_CONFS)
def test_mnist_conf_checkpoints_both_ways(tmp_path, name):
    cfg = _conf_entries(name, dev="cpu", silent=1)
    jt = JaxTrainer()
    jt.set_params(cfg)
    jt.init_model()
    jt.save_model(str(tmp_path / "jax.model"))
    tt = NetTrainer()
    tt.set_params(cfg)
    tt.init_model()
    tt.save_model(str(tmp_path / "port.model"))
    shape = tuple(tt.net.input_node_shape(4))
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    for path in ("jax.model", "port.model"):
        tt.load_model(str(tmp_path / path))
        jt.load_model(str(tmp_path / path))
        ours = tt.predict_fn()(tt.params, tt.aux, x, ()).numpy()
        ref = np.asarray(jt.predict_fn()(jt.params, jt.aux, x, ()))
        np.testing.assert_allclose(ours, ref, atol=SCORE_ATOL, rtol=0)


# ----------------------------------------------------------------------
# training on real digits

def _digits_iters(data_dir, batch_size):
    def entries(split, shuffle):
        return [("iter", "mnist"),
                ("path_img", f"{data_dir}/digits-{split}-images-idx3-ubyte"),
                ("path_label", f"{data_dir}/digits-{split}-labels-idx1-ubyte"),
                ("shuffle", str(shuffle)), ("batch_size", str(batch_size)),
                ("silent", "1"), ("iter", "end")]

    from cxxnet_tpu.io.data import create_iterator as jcreate

    out = []
    for make in (create_iterator, jcreate):
        pair = (make(entries("train", 1)), make(entries("t10k", 0)))
        for it in pair:
            it.init()
        out.append(pair)
    return out


def test_digits_three_rounds_match_jax(tmp_path):
    """digits.conf in f32, 3 rounds from one JAX-written checkpoint: the
    round-end eval lines are equal and the weights agree."""
    data = str(tmp_path / "data")
    write_digits_idx(data)
    cfg = _conf_entries("digits.conf", silent=1)
    jt = JaxTrainer()
    jt.set_params(cfg)
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    tt = NetTrainer()
    tt.set_params(cfg)
    tt.load_model(path)
    (t_train, t_test), (j_train, j_test) = _digits_iters(data, 50)
    for r in range(1, 4):
        for tr, it in ((tt, t_train), (jt, j_train)):
            tr.start_round(r)
            it.before_first()
            while it.next():
                tr.update(it.value())
        assert (tt.evaluate(t_test, "test")
                == jt.evaluate(j_test, "test")), f"round {r}"
    jp = jt.params if isinstance(jt.params, dict) else dict(jt.params)
    for key, tags in tt.params.items():
        for tag, w in tags.items():
            ref = np.asarray(jp[key][tag])
            err = np.abs(w.numpy() - ref).max() / np.abs(ref).max()
            assert err <= DIGITS_WEIGHT_TOL, (key, tag, err)
    assert tt.epoch_counter == jt.epoch_counter == 90


def _run_port_cli(cwd, argv):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return LearnTask().run(argv)
    finally:
        os.chdir(old)


def _last_test_error(capsys):
    lines = [l for l in capsys.readouterr().err.splitlines()
             if l.startswith("[")]
    return float(lines[-1].split("test-error:")[1].split()[0])


def test_real_digits_quick(tmp_path, capsys):
    """The JAX package's ``test_real_digits_quick`` bar in the port:
    digits.conf through the CLI, 5 rounds at eta 0.5, <= 15 %."""
    write_digits_idx(str(tmp_path / "data"))
    shutil.copy(os.path.join(MNIST_DIR, "digits.conf"), tmp_path)
    assert _run_port_cli(tmp_path, ["digits.conf", "num_round=5",
                                    "max_round=5", "eta=0.5"]) == 0
    assert _last_test_error(capsys) <= 0.15


# ----------------------------------------------------------------------
# the CLI's tasks against the JAX CLI's on one checkpoint

PRED_SECTION = """
pred = {out}
iter = mnist
  path_img = ./data/t10k-images-idx3-ubyte
  path_label = ./data/t10k-labels-idx1-ubyte
  input_flat = 0
iter = end
"""

# (task, extra args, output file): MNIST_CONV.conf's node "2" is the
# pool's (7, 7, 32) output and "4" fc1's (its nodes are numbered)
TASKS = (("pred", (), "pred.txt"),
         ("pred_raw", (), "raw.txt"),
         ("extract", ("extract_node_name=2", "output_format=bin"), "pool.bin"),
         ("extract", ("extract_node_name=4", "output_format=txt"), "fc1.txt"),
         ("summary", (), None))

_JAX_TASKS = """
import contextlib, io, json, sys
from cxxnet_tpu.cli import LearnTask
out = []
for argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        LearnTask().run(argv)
    out.append(buf.getvalue())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mnist_conv_run(tmp_path_factory):
    """MNIST_CONV.conf as it stands (f32, batch 100, 28x28) with a pred
    section: the port trains 2 rounds on seeded idx files and writes
    ``0002.model``; then every task of ``TASKS`` runs in both packages on
    it, each in a directory of its own."""
    import json

    root = tmp_path_factory.mktemp("mnist_conv")
    _write_mnist(str(root / "data"))
    results = {}
    for pkg in ("port", "jax"):
        d = root / pkg
        d.mkdir()
        os.symlink(root / "data", d / "data")
    conf_text = open(os.path.join(MNIST_DIR, "MNIST_CONV.conf")).read()
    common = ["dev=cpu", "silent=1"]
    (root / "port" / "train.conf").write_text(conf_text)
    assert _run_port_cli(root / "port", ["train.conf", "num_round=2",
                                         "max_round=2", "model_dir=models",
                                         *common]) == 0
    model = str(root / "port" / "models" / "0002.model")
    argvs = {}
    for task, extra, out in TASKS:
        name = f"{task}-{out}.conf"
        for pkg in ("port", "jax"):
            (root / pkg / name).write_text(
                conf_text + PRED_SECTION.format(out=out or "unused.txt"))
        argvs[(task, out)] = [name, f"task={task}", f"model_in={model}",
                              *extra, *common]
    import contextlib
    import io

    for key, argv in argvs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert _run_port_cli(root / "port", argv) == 0
        results[("port",) + key] = buf.getvalue()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_TASKS,
                        json.dumps(list(argvs.values()))],
                       cwd=root / "jax", env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for key, text in zip(argvs, json.loads(r.stdout.splitlines()[-1])):
        results[("jax",) + key] = text
    return root, results


def _floats(path, binary):
    if binary:
        return np.fromfile(path, "<f4")
    return np.array([float(v) for v in open(path).read().split()])


@pytest.mark.parametrize("task,extra,out", TASKS)
def test_cli_task_output_matches_jax(mnist_conv_run, task, extra, out):
    root, results = mnist_conv_run
    port, jax = root / "port", root / "jax"
    if task == "summary":
        def table(text):
            return [l for l in text.splitlines()
                    if l and not l.startswith(("mesh:", "initializing"))]

        ours = table(results[("port", task, out)])
        assert ours == table(results[("jax", task, out)])
        assert ours[-1] == "total parameters: 158,230 (0.6 MB f32)"
        return
    a, b = (port / out).read_bytes(), (jax / out).read_bytes()
    if task == "pred":
        assert a == b and a.count(b"\n") == 200
        return
    binary = out.endswith(".bin")
    ours, ref = _floats(port / out, binary), _floats(jax / out, binary)
    assert ours.shape == ref.shape and ours.size > 0
    np.testing.assert_allclose(ours, ref, atol=TASK_ATOL, rtol=0)
    if task == "pred_raw":
        rows = a.decode().split("\n")[:-1]
        assert len(rows) == 200 and all(r.endswith(" ") for r in rows)
        assert len(rows[0].split()) == 10
    else:
        meta = (port / (out + ".meta")).read_bytes()
        assert meta == (jax / (out + ".meta")).read_bytes()
        assert meta == (b"200,7,7,32\n" if binary else b"200,100,1,1\n")


def test_cli_update_period_and_finetune(mnist_conv_run, capsys):
    """MNIST_CONV.conf trains with ``update_period = 2`` (one update per
    two batches: 2 a round of 4 batches) and finetunes from the round-2
    model, each layer copied."""
    root, _ = mnist_conv_run
    d = root / "port"
    model = str(d / "models" / "0002.model")
    assert _run_port_cli(d, ["train.conf", "dev=cpu", "update_period=2",
                             "num_round=3", "max_round=1", f"model_in={model}",
                             "model_dir=up"]) == 0
    tr = NetTrainer()
    tr.set_params(tcfg.parse_file(str(d / "train.conf")) + [("dev", "cpu")])
    tr.load_model(str(d / "up" / "0003.model"))
    assert tr.epoch_counter == 2 * 4 + 2
    capsys.readouterr()
    assert _run_port_cli(d, ["train.conf", "dev=cpu", "task=finetune",
                             f"model_in={model}", "num_round=0",
                             "max_round=1", "model_dir=ft"]) == 0
    out = capsys.readouterr().out
    assert [l for l in out.splitlines() if l.startswith("Copying")] == [
        "Copying layer cv1", "Copying layer fc1", "Copying layer fc2"]
    tr.load_model(str(d / "ft" / "0000.model"))
    src = NetTrainer()
    src.set_params(tcfg.parse_file(str(d / "train.conf")) + [("dev", "cpu")])
    src.load_model(model)
    assert tr.epoch_counter == 4  # one finetune round from 0
    assert src.epoch_counter == 8


# ----------------------------------------------------------------------
# finetune: copy_model_from

FT_BASE = """
netconfig = start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 4
  init_sigma = 0.3
layer[1->2] = relu
layer[2->3] = flatten
layer[3->4] = fullc:fc1
  nhidden = 6
  init_sigma = 0.3
layer[4->5] = fullc:{head}
  nhidden = {nout}
  init_sigma = 0.3
layer[5->5] = softmax
netconfig = end
input_shape = 1,5,5
batch_size = 4
dev = cpu
seed = {seed}
"""


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_copy_model_from_either_package(tmp_path, writer, capsys):
    """A checkpoint of the same net with a 10-way head: the port copies
    cv1 and fc1 (names and shapes match), keeps its own fresh fc2 (5-way:
    the shapes differ) and starts at epoch 0, as the JAX package does."""
    src_conf = FT_BASE.format(head="fc2", nout=10, seed=7)
    path = str(tmp_path / "src.model")
    if writer == "jax":
        src = JaxTrainer()
        src.set_params(jcfg.parse_pairs(src_conf))
        src.init_model()
        src.epoch_counter = 5
        src.save_model(path)
        src_params = {k: {t: np.asarray(w) for t, w in tags.items()}
                      for k, tags in src.params.items()}
    else:
        src = NetTrainer()
        src.set_params(tcfg.parse_pairs(src_conf))
        src.init_model()
        src.epoch_counter = 5
        src.save_model(path)
        src_params = {k: {t: w.numpy() for t, w in tags.items()}
                      for k, tags in src.params.items()}
    new_conf = FT_BASE.format(head="fc2", nout=5, seed=1)
    fresh = NetTrainer()
    fresh.set_params(tcfg.parse_pairs(new_conf))
    fresh.init_model()
    capsys.readouterr()
    ft = NetTrainer()
    ft.set_params(tcfg.parse_pairs(new_conf))
    ft.copy_model_from(path)
    printed = capsys.readouterr().out.splitlines()
    jft = JaxTrainer()
    jft.set_params(jcfg.parse_pairs(new_conf))
    jft.copy_model_from(path)
    assert printed == ["Copying layer cv1", "Copying layer fc1"]
    assert capsys.readouterr().out.splitlines() == printed
    assert ft.epoch_counter == jft.epoch_counter == 0
    for key in ("l0_cv1", "l3_fc1"):
        for tag, w in ft.params[key].items():
            np.testing.assert_array_equal(w.numpy(), src_params[key][tag])
            np.testing.assert_array_equal(
                w.numpy(), np.asarray(jft.params[key][tag]))
    for tag, w in ft.params["l4_fc2"].items():
        np.testing.assert_array_equal(w.numpy(),
                                      fresh.params["l4_fc2"][tag].numpy())
    x = np.random.RandomState(0).rand(4, 5, 5, 1).astype(np.float32)
    assert ft.predict(x).shape == (4,)


# ----------------------------------------------------------------------
# update_period = 2 against the JAX trainer

ACCUM_CONF = """
netconfig = start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 8
  no_bias = 1
  init_sigma = 0.2
layer[1->2] = batch_norm:bn1
layer[2->2] = relu
layer[2->3] = max_pooling
  kernel_size = 2
  stride = 2
layer[3->4] = flatten
layer[4->5] = fullc:fc1
  nhidden = 10
  init_sigma = 0.2
layer[5->5] = softmax
netconfig = end
input_shape = 1,8,8
batch_size = 6
dev = cpu
update_period = 2
bn_eval = running
updater = {updater}
eta = 0.05
momentum = 0.9
wd = 0.001
metric = error
"""


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_update_period_two_matches_jax(tmp_path, updater):
    conf = ACCUM_CONF.format(updater=updater)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf))
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    tt = NetTrainer()
    tt.set_params(tcfg.parse_pairs(conf))
    tt.load_model(path)
    assert tt.update_period == 2
    rng = np.random.RandomState(0)
    from cxxnet_tpu.io.data import DataBatch as JBatch
    from cxxnet_tpu_torch.io.data import DataBatch

    counters = []
    for i in range(4):
        x = rng.rand(6, 8, 8, 1).astype(np.float32)
        y = rng.randint(0, 10, (6, 1)).astype(np.float32)
        before = {k: {t: w.clone() for t, w in tags.items()}
                  for k, tags in tt.params.items()}
        tt.update(DataBatch(data=x, label=y))
        jt.update(JBatch(data=x, label=y))
        counters.append((tt.epoch_counter, tt.sample_counter))
        moved = any(not torch.equal(w, before[k][t])
                    for k, tags in tt.params.items() for t, w in tags.items())
        assert moved == (i % 2 == 1), i
        for key, tags in tt.aux.items():
            for tag, w in tags.items():
                ref = np.asarray(jt.aux[key][tag])
                err = np.abs(w.numpy() - ref).max() / np.abs(ref).max()
                assert err <= ACCUM_TOL["sgd"], (i, key, tag, err)
    assert counters == [(0, 1), (1, 0), (1, 1), (2, 0)]
    assert jt.epoch_counter == 2
    for key, tags in tt.params.items():
        for tag, w in tags.items():
            ref = np.asarray(jt.params[key][tag])
            err = np.abs(w.numpy() - ref).max() / np.abs(ref).max()
            assert err <= ACCUM_TOL[updater], (key, tag, err)
