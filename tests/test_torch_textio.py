"""The text iterators and side inputs against the JAX package, on the CPU.

* ``iter = csv`` (under the batch adapter), ``libsvm``, ``membuffer``
  and ``attachtxt``: each package builds the chain from one conf
  section, and the batches of two epochs are equal field for field
  (data, labels, instance indices, ``num_batch_padd``, ``extra_data``
  and the CSR fields), with ``round_batch`` 0 and 1, headers,
  comments, flat and image rows, ``densify`` 0 and 1.
* ``max_bad_records``: the same rows skipped and the same
  ``.quarantine`` sidecar lines; past the budget both raise.
* The fault sites ``csv.read``, ``csv.row``, ``libsvm.read`` and
  ``libsvm.row``: each package's injector, armed alike, fires at the
  same visits, so the retried reads and the quarantined rows agree.
* A side-input net (``extra_data_num = 1``, fed by ``csv`` +
  ``attachtxt``; ``xelu``, ``prelu``, ``fixconn``, ``bias``,
  ``softplus``, ``conv_s2d``, ``conv_wino = 2``, f32): the port loads
  the JAX package's checkpoint; the eval scores agree at 1e-5, then one
  SGD step on a full batch and one on a short batch (its side input
  padded like its data) agree: the losses at rtol 1e-5, every updated
  weight within 1e-5 of its tensor's largest.  ``predict``,
  ``extract`` and the CLI's ``task=pred`` read the side input.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io import data as jdata
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils import faults as jfaults

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io import data as tdata
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils import faults as tfaults


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


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


def _chain(create, text):
    it = create([(n, v) for n, v in jcfg.parse_pairs(text)])
    it.init()
    return it


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        it.before_first()
        while it.next():
            out.append(dataclasses.replace(it.value()))
    return out


FIELDS = ("data", "label", "inst_index", "sparse_row_ptr", "sparse_index",
          "sparse_value")


def _same_batches(jb, tb):
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a.num_batch_padd == b.num_batch_padd
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.asarray(x).dtype == np.asarray(y).dtype, f
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f)
        assert len(a.extra_data) == len(b.extra_data)
        for x, y in zip(a.extra_data, b.extra_data):
            np.testing.assert_array_equal(x, y)


def _both(text, epochs=2):
    jb = _epochs(_chain(jdata.create_iterator, text), epochs)
    tb = _epochs(_chain(tdata.create_iterator, text), epochs)
    _same_batches(jb, tb)
    return tb


def _write_csv(path, rows, ncol, label_width, header=False, seed=0):
    rs = np.random.RandomState(seed)
    lines = ["# comment line"] + (["h" * ncol] if header else [])
    for r in range(rows):
        lab = rs.randint(0, 3, label_width)
        feat = rs.randn(ncol - label_width).round(4)
        lines.append(",".join([str(v) for v in lab]
                              + [f"{v:g}" for v in feat]) + f"  # row {r}")
    if header:
        lines.insert(0, lines.pop(1))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("shape,label_width,round_batch,header", [
    ("1,1,6", 2, 0, 0),
    ("1,1,6", 1, 1, 1),
    ("2,3,3", 1, 1, 0),
    ("2,3,3", 2, 0, 1),
])
def test_csv_batches_equal_the_jax_chain(tmp_path, shape, label_width,
                                         round_batch, header):
    c, h, w = (int(t) for t in shape.split(","))
    f = _write_csv(tmp_path / "d.csv", 10, label_width + c * h * w,
                   label_width, header=bool(header))
    if header:  # the header is the file's first line
        lines = (tmp_path / "d.csv").read_text().splitlines()
        (tmp_path / "d.csv").write_text(
            "\n".join(["a,b,c"] + [ln for ln in lines if not
                                   ln.startswith("h")]) + "\n")
    tb = _both(f"""
iter = csv
  filename = {f}
  has_header = {header}
  silent = 1
iter = end
input_shape = {shape}
label_width = {label_width}
batch_size = 4
round_batch = {round_batch}
""")
    assert tb[0].data.shape == ((4, w) if c == h == 1 else (4, h, w, c))
    assert [b.num_batch_padd for b in tb[:3]] == [0, 0, 2]


def _bad_csv(tmp_path):
    f = _write_csv(tmp_path / "d.csv", 9, 5, 1)
    lines = (tmp_path / "d.csv").read_text().splitlines()
    lines[3] = "1,0.5,abc,2,3"
    lines[6] = "1,2,3"
    (tmp_path / "d.csv").write_text("\n".join(lines) + "\n")
    return f


CSV_SECTION = """
iter = csv
  filename = {f}
  silent = 1
  max_bad_records = {budget}
  quarantine_dir = {q}
iter = end
input_shape = 1,1,4
batch_size = 3
"""


def test_csv_quarantine_equals_the_jax_chain(tmp_path):
    f = _bad_csv(tmp_path)
    jq, tq = tmp_path / "qj", tmp_path / "qt"
    jb = _epochs(_chain(jdata.create_iterator, CSV_SECTION.format(
        f=f, budget=2, q=jq)))
    tb = _epochs(_chain(tdata.create_iterator, CSV_SECTION.format(
        f=f, budget=2, q=tq)))
    _same_batches(jb, tb)
    side = (tq / "d.csv.quarantine").read_text()
    assert side == (jq / "d.csv.quarantine").read_text()
    assert [ln.split("\t")[0] for ln in side.splitlines()] == [
        "line4", "line7"]
    for create, exc in ((jdata.create_iterator, jfaults.BadDataError),
                        (tdata.create_iterator, tfaults.BadDataError)):
        with pytest.raises(exc, match="bad-record budget exceeded"):
            _chain(create, CSV_SECTION.format(f=f, budget=1,
                                              q=tmp_path / "q1"))
        with pytest.raises(ValueError):  # strict: np.loadtxt's error
            _chain(create, CSV_SECTION.format(f=f, budget=0,
                                              q=tmp_path / "q0"))


LIBSVM = """\
1 0:1.5 3:2
0 1:-1 2:0.25 5:3

2,1 4:1
0
x 1:2
1 -3:2
1 2:7 0:1
"""


@pytest.mark.parametrize("round_batch,densify,label_width", [
    (1, 1, 1), (0, 1, 2), (1, 0, 2)])
def test_libsvm_batches_equal_the_jax_chain(tmp_path, round_batch, densify,
                                            label_width):
    (tmp_path / "d.svm").write_text(LIBSVM)
    text = f"""
iter = libsvm
  data_path = {tmp_path / "d.svm"}
  densify = {densify}
  round_batch = {round_batch}
  max_bad_records = 2
  quarantine_dir = {tmp_path / "q"}
  silent = 1
iter = end
label_width = {label_width}
batch_size = 4
"""
    tb = _both(text)
    assert tb[0].is_sparse() and len(tb) == 4
    idx, val = tb[0].get_row_sparse(1)
    np.testing.assert_array_equal(idx, [1, 2, 5])
    np.testing.assert_array_equal(val, np.float32([-1, 0.25, 3]))
    assert tb[1].num_batch_padd == 3
    assert tb[0].data.shape == ((4, 6) if densify else (4, 0))
    # both packages appended their lines to the one sidecar
    side = (tmp_path / "q" / "d.svm.quarantine").read_text().splitlines()
    assert side[:2] == side[2:]
    assert [ln.split("\t")[0] for ln in side[:2]] == ["line6", "line7"]


def test_membuffer_and_attachtxt_equal_the_jax_chain(tmp_path):
    f = _write_csv(tmp_path / "d.csv", 11, 4, 1)
    (tmp_path / "side.txt").write_text(
        "".join(f"{i} {i * 0.5:g} {-i:g}\n" for i in range(0, 11, 2)))
    (tmp_path / "d.svm").write_text(LIBSVM)
    for base in (f"iter = csv\n  filename = {f}\n  silent = 1\n",
                 f"iter = libsvm\n  data_path = {tmp_path / 'd.svm'}\n"
                 "  max_bad_records = 2\n  silent = 1\n"):
        tb = _both(base + f"""
iter = attachtxt
  attach_file = {tmp_path / "side.txt"}
iter = membuffer
  max_nbatch = 2
iter = end
input_shape = 1,1,3
batch_size = 3
""", epochs=3)
        assert len(tb) == 6  # two cached batches, replayed each epoch
        assert [e.shape for e in tb[0].extra_data] == [(3, 2)]
        np.testing.assert_array_equal(tb[0].extra_data[0][1], [0, 0])
        np.testing.assert_array_equal(tb[0].extra_data[0][2], [1, -2])
    with pytest.raises(ValueError, match="must specify input of membuffer"):
        tdata.create_iterator([("iter", "membuffer")])
    with pytest.raises(ValueError, match="data_service_addr"):
        tdata.create_iterator([("iter", "service")]).init()
    with pytest.raises(ValueError, match="service cannot chain"):
        tdata.create_iterator([("iter", "synthetic"), ("iter", "service")])


@pytest.mark.parametrize("site,section", [
    ("csv.read:ioerror:1:2", "csv"),
    ("csv.row:corrupt:0.3", "csv"),
    ("libsvm.read:ioerror:1:3", "libsvm"),
    ("libsvm.row:corrupt:0.4", "libsvm"),
])
def test_text_fault_sites_fire_as_in_the_jax_chain(tmp_path, site, section):
    f = _write_csv(tmp_path / "d.csv", 12, 5, 1)
    (tmp_path / "d.svm").write_text(LIBSVM * 3)
    src = (f"iter = csv\n  filename = {f}\n" if section == "csv" else
           f"iter = libsvm\n  data_path = {tmp_path / 'd.svm'}\n")
    text = src + """  silent = 1
  max_bad_records = 20
  quarantine_dir = {q}
  retry_attempts = 4
  retry_base_delay = 0
iter = end
input_shape = 1,1,4
batch_size = 4
"""
    out = {}
    for name, create, fl in (("jax", jdata.create_iterator, jfaults),
                             ("port", tdata.create_iterator, tfaults)):
        fl.reset()
        fl.configure([("fault_seed", "3"), ("fault_inject", site)])
        batches = _epochs(_chain(create, text.format(q=tmp_path / name)))
        out[name] = (batches, fl.injector().fire_counts())
        fl.reset()
    _same_batches(out["jax"][0], out["port"][0])
    assert out["jax"][1] == out["port"][1] and sum(out["port"][1].values())
    qname = "d.csv.quarantine" if section == "csv" else "d.svm.quarantine"
    if "corrupt" in site:
        assert ((tmp_path / "port" / qname).read_text()
                == (tmp_path / "jax" / qname).read_text())


# ----------------------------------------------------------------------
# a side-input net

SIDE_NET = """
extra_data_num = 1
extra_data_shape[0] = 1,1,2
data = train
iter = csv
  filename = {csv}
  silent = 1
iter = attachtxt
  attach_file = {side}
  silent = 1
iter = end
pred = {pred}
iter = csv
  filename = {csv}
  silent = 1
iter = attachtxt
  attach_file = {side}
  silent = 1
iter = end
netconfig = start
layer[0->1] = conv:stem
  kernel_size = 5
  stride = 2
  pad = 2
  nchannel = 8
  conv_s2d = 1
layer[1->2] = xelu
  b = 4
layer[2->3] = conv:c3
  kernel_size = 3
  pad = 1
  nchannel = 8
  conv_wino = 2
layer[3->4] = prelu:pr
layer[4->5] = flatten
layer[in_1->6] = fixconn:fx
  nhidden = 3
  fixconn_weight = {fix}
layer[6->7] = bias:b
  init_bias = 0.1
layer[7->8] = softplus
layer[5,8->9] = concat
layer[9->10] = fullc:fc
  nhidden = 4
layer[10->10] = softmax
netconfig = end
input_shape = 3,8,8
label_width = 1
batch_size = 4
dev = cpu
eta = 0.05
momentum = 0.9
wd = 0.001
random_type = xavier
compute_dtype = float32
"""


def _side_files(tmp_path, rows=10):
    rs = np.random.RandomState(11)
    lines = [",".join([str(rs.randint(0, 4))]
                      + [f"{v:.4f}" for v in rs.randn(192)])
             for _ in range(rows)]
    (tmp_path / "d.csv").write_text("\n".join(lines) + "\n")
    (tmp_path / "side.txt").write_text("".join(
        f"{i} {rs.randn():.4f} {rs.randn():.4f}\n" for i in range(rows)))
    (tmp_path / "fix.txt").write_text("3 2 4\n0 0 1.5\n1 1 -0.5\n2 0 0.25\n"
                                      "2 1 2\n")
    conf = SIDE_NET.format(csv=tmp_path / "d.csv", side=tmp_path / "side.txt",
                           fix=tmp_path / "fix.txt", pred=tmp_path / "p.txt")
    (tmp_path / "side.conf").write_text(conf)
    return conf


def _first_batches(create, conf, n=3):
    split = tcfg.split_sections(tcfg.parse_pairs(conf))
    sec = next(s for s in split.sections if s.kind == "data")
    it = create(list(sec.entries) + list(split.global_entries))
    it.init()
    it.before_first()
    out = []
    while it.next() and len(out) < n:
        out.append(dataclasses.replace(it.value()))
    return out


def test_side_input_net_steps_as_the_jax_trainer(tmp_path):
    conf = _side_files(tmp_path)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(conf))
    jt.set_param("seed", "5")
    jt.init_model()
    path = str(tmp_path / "0000.model")
    jt.save_model(path)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.load_model(path)
    assert tr.net.node_shapes[1] == (4, 2)
    jb = _first_batches(jdata.create_iterator, conf)
    tb = _first_batches(tdata.create_iterator, conf)
    _same_batches(jb, tb)
    # eval scores, and the nodes the side input reaches
    ref = np.asarray(jt._run_sharded(jt._eval_fn(), jb[0].data,
                                     tuple(jb[0].extra_data)))
    got = tr.predict_fn()(tr.params, tr.aux, tb[0].data,
                          tb[0].extra_data).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tr.predict(tb[0].data, tb[0].extra_data),
                                  jt.predict(jb[0]))
    np.testing.assert_allclose(tr.extract_feature(tb[0], "8"),
                               jt.extract_feature(jb[0], "8"),
                               rtol=1e-5, atol=1e-5)
    # a full batch, then a short one: 3 rows, padded with the side input
    short_j = dataclasses.replace(
        jb[1], data=jb[1].data[:3], label=jb[1].label[:3],
        extra_data=[e[:3] for e in jb[1].extra_data])
    short_t = dataclasses.replace(
        tb[1], data=tb[1].data[:3], label=tb[1].label[:3],
        extra_data=[e[:3] for e in tb[1].extra_data])
    for bj, bt in ((jb[0], tb[0]), (short_j, short_t)):
        data, label, extras, mask, _ = jt._pad_train_batch(bj)
        jloss = jt.net.forward(
            jt.params, jnp.asarray(data), labels=jnp.asarray(label),
            extras=[jnp.asarray(e) for e in extras], train=True,
            sample_mask=jnp.asarray(mask))[1]
        jt.update(bj)
        tr.update(bt)
        np.testing.assert_allclose(float(tr.last_loss), float(jloss),
                                   rtol=1e-5)
        for key, tags in jt.params.items():
            for tag, w in tags.items():
                w = np.asarray(w)
                np.testing.assert_allclose(
                    tr.params[key][tag].numpy(), w, rtol=0,
                    atol=1e-5 * np.abs(w).max(), err_msg=f"{key}/{tag}")
    assert tr.epoch_counter == jt.epoch_counter == 2
    with pytest.raises(ValueError, match="extra_data node"):
        tr.predict(tb[0].data)


def test_side_input_cli_pred_reads_attachtxt(tmp_path):
    conf = _side_files(tmp_path)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf))
    tr.init_model()
    tr.save_model(str(tmp_path / "m.model"))
    LearnTask().run([str(tmp_path / "side.conf"), "task=pred",
                     f"model_in={tmp_path / 'm.model'}", "silent=1"])
    got = [float(v) for v in (tmp_path / "p.txt").read_text().split()]
    want = []
    for b in _first_batches(tdata.create_iterator, conf, n=10):
        n = b.batch_size - b.num_batch_padd
        want += list(tr.predict(b.data, b.extra_data)[:n])
    assert got == want and len(got) == 10
    # the side input moves the answer
    x = _first_batches(tdata.create_iterator, conf, n=1)[0]
    moved = tr.predict_fn()(tr.params, tr.aux, x.data,
                            [e + 5 for e in x.extra_data]).numpy()
    base = tr.predict_fn()(tr.params, tr.aux, x.data, x.extra_data).numpy()
    assert not np.allclose(moved, base)
