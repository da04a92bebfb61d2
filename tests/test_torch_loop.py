"""The closed loop of the port (``cxxnet_tpu_torch/loop/``, the publish
pointer, ``ModelRouter``, ``/feedback`` and ``capture_predict``, the
tenant sections, ``task=serve_train`` and ``task=loop_fleet``) against
the JAX package's, on the CPU.

Held against the JAX package: the feedback log's bytes (shards, commit
sidecars, the sequence reservation, the cursor) for the same records,
each package reading the other's log, the faults of ``loop.append`` and
``loop.commit`` under one seed, the gate's primitives, the publish
pointer read by JAX's ``read_publish_pointer`` and by
``tools/obs_dump.resolve_lineage``, retention's deletions, the tenant
sections' outputs and errors, the tasks' refusals, and one closed-loop
cycle of a small conv net in each package from one seeded checkpoint
(a rejected cycle and a published one: the same gate decision and
lineage, the candidate's weights within ``WEIGHT_ATOL`` /
``WEIGHT_RTOL``, the tolerance of ``tests/test_torch_train.py``).  The
port alone: the log under torn tails, CRC rot, rotation, reopen,
crashes and concurrent batches; every crash state of a retention sweep;
the HTTP routes; two tenants on one pool; both tasks through the CLI in
a subprocess.
"""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu import config as jcfg
from cxxnet_tpu import loop as jloop
from cxxnet_tpu import serve as jserve
from cxxnet_tpu.cli import LearnTask as JaxTask
from cxxnet_tpu.io.data import DataBatch as JBatch
from cxxnet_tpu.loop import publisher as jpub
from cxxnet_tpu.loop import retention as jret
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils import checkpoint as jckpt
from cxxnet_tpu.utils import faults as jfaults

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import loop as tloop
from cxxnet_tpu_torch import serve as tserve
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io.data import DataBatch as TBatch
from cxxnet_tpu_torch.loop import feedback_log as tfl
from cxxnet_tpu_torch.loop import publisher as tpub
from cxxnet_tpu_torch.loop import retention as tret
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.obs import recent as trecent
from cxxnet_tpu_torch.obs.registry import registry as tregistry
from cxxnet_tpu_torch.serve import wire as twire
from cxxnet_tpu_torch.utils import checkpoint as tckpt
from cxxnet_tpu_torch.utils import diskio as tdiskio
from cxxnet_tpu_torch.utils import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import obs_dump  # noqa: E402  (the JAX repo tool, read-only here)

MLP_CFG = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[+1:a1] = relu:a1
layer[a1->out] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = 32
dev = cpu
eta = 0.05
metric = error
"""
# MNIST_CONV's shape, narrowed: conv, max pool, two fullc
CONV_CFG = """
netconfig = start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  stride = 1
  nchannel = 4
  init_sigma = 0.1
layer[1->2] = max_pooling
  kernel_size = 2
  stride = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc1
  nhidden = 12
  init_sigma = 0.1
layer[4->5] = relu
layer[5->6] = fullc:fc2
  nhidden = 4
  init_sigma = 0.1
layer[6->6] = softmax
netconfig = end
input_shape = 1,8,8
batch_size = 16
dev = cpu
eta = 0.1
momentum = 0.9
wd = 0.0001
metric = error
"""
CONV_ROW = (8, 8, 1)
CONV_LAYERS = (("cv1", "wmat"), ("cv1", "bias"), ("fc1", "wmat"),
               ("fc1", "bias"), ("fc2", "wmat"), ("fc2", "bias"))
# the candidate's weights after a cycle in both packages: the tolerance
# of tests/test_torch_train.py's SGD steps
WEIGHT_ATOL, WEIGHT_RTOL = 1e-5, 1e-4
PKG = {"port": (tloop, tckpt), "jax": (jloop, jckpt)}


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    yield
    tfaults.reset()


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


def _files(d):
    """Every file of a directory tree: relative path -> bytes."""
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _counter(name, **labels):
    fam = tregistry().snapshot().get(name, {})
    for key, v in fam.items():
        if all(f'{k}="{val}"' in key for k, val in labels.items()):
            return v
    return 0


def _rows(n, width=16, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(n, width).astype(np.float32),
            r.randint(0, 4, size=(n, 1)).astype(np.float32))


# ----------------------------------------------------------------------
# records, pages, the cursor: byte for byte
@pytest.mark.parametrize("shape,labels", [((2, 3, 4), [2.0, 7.0]),
                                          ((16,), 3), ((8, 8, 1), [1.0])])
def test_record_bytes_equal_jax(shape, labels):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    blob = tfl.encode_record(x, labels)
    assert blob == jloop.encode_record(x, labels)
    for dec in (tfl.decode_record, jloop.decode_record):
        rec = dec(blob)
        np.testing.assert_array_equal(rec.data.reshape(-1), x.reshape(-1))
        np.testing.assert_array_equal(rec.labels, np.atleast_1d(labels))
    with pytest.raises(ValueError):
        tfl.encode_record(np.zeros((2, 2)), 0)


def _write_log(pkg, d, x, y, page_bytes=512, rotate_bytes=1024):
    w = PKG[pkg][0].FeedbackWriter(d, page_bytes=page_bytes,
                                   rotate_bytes=rotate_bytes)
    ids = [w.append_batch_ids(x[:25], y[:25]),
           (w.append_seq(x[25], y[25]),), w.append_batch_ids(x[26:], y[26:])]
    w.flush()
    w.close()
    return ids


def test_shards_sidecars_and_cursor_byte_equal_jax(tmp_path):
    x, y = _rows(60)
    ids = {p: _write_log(p, str(tmp_path / p), x, y) for p in PKG}
    assert ids["port"] == ids["jax"]
    tfiles, jfiles = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(tfiles) == sorted(jfiles)
    assert sum(n.endswith(".bin") for n in tfiles) > 2  # rotated
    assert tfiles == jfiles
    # each package tails the other's log to the same records and cursor
    for src in PKG:
        d = str(tmp_path / src)
        (trecs, tcur) = tloop.FeedbackReader(d).read_since(None)
        (jrecs, jcur) = jloop.FeedbackReader(d).read_since(None)
        assert tcur == jcur and len(trecs) == len(jrecs) == 60
        for a, b in zip(trecs, jrecs):
            assert a.seq == b.seq
            assert a.data.tobytes() == b.data.tobytes()
            assert a.labels.tobytes() == b.labels.tobytes()
        part, cur = tloop.FeedbackReader(d).read_since(None, max_records=9)
        assert (part, cur) != ([], None) and len(part) >= 9
        assert jloop.FeedbackReader(d).pending(cur) == 60 - len(part)
    # the cursor file
    tloop.CursorFile(str(tmp_path / "tc.json")).store({"shard": 2,
                                                      "off": 4096})
    jloop.CursorFile(str(tmp_path / "jc.json")).store({"shard": 2,
                                                      "off": 4096})
    assert ((tmp_path / "tc.json").read_bytes()
            == (tmp_path / "jc.json").read_bytes())
    assert jloop.CursorFile(str(tmp_path / "tc.json")).load() == {
        "shard": 2, "off": 4096}


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_writer_resumes_the_other_packages_log(tmp_path, first, second):
    d = str(tmp_path / "log")
    w = PKG[first][0].FeedbackWriter(d)
    assert w.append_batch_ids(*_rows(5)) == (5, 0, 4)
    w.close()  # commits the partial page, shrinks the reservation
    w2 = PKG[second][0].FeedbackWriter(d)
    assert w2.append_batch_ids(*_rows(3, seed=1)) == (3, 5, 7)
    w2.close()
    recs, _ = PKG[first][0].FeedbackReader(d).read_since(None)
    assert [r.seq for r in recs] == list(range(8))


def test_uncommitted_page_invisible_until_flush(tmp_path):
    d = str(tmp_path / "log")
    w = tloop.FeedbackWriter(d, page_bytes=1 << 20)
    x, y = _rows(10)
    assert w.append_batch(x, y) == 10
    r = tloop.FeedbackReader(d)
    assert r.read_since(None)[0] == [] and r.pending(None) == 0
    assert w.flush() == 10
    recs, _ = r.read_since(None)
    np.testing.assert_array_equal(recs[3].data.reshape(-1), x[3])
    w.close()


@pytest.mark.parametrize("damage", ["torn_tail", "crc", "torn_sidecar"])
def test_log_damage_read_alike_by_both_packages(tmp_path, damage):
    d = str(tmp_path / "log")
    w = tloop.FeedbackWriter(d)
    w.append_batch(*_rows(4))
    w.flush()
    w.close()
    (_, shard), = tfl.list_shards(d)
    if damage == "torn_tail":  # bytes with no commit entry: invisible
        with open(shard, "ab") as f:
            f.write(b"\x12garbage-torn-page")
    elif damage == "crc":  # rot inside a committed page: skipped, counted
        with open(shard, "r+b") as f:
            f.seek(20)
            f.write(b"\xff\xff")
    else:  # a crash mid-commit
        with open(shard + tfl.COMMIT_SUFFIX, "a", encoding="utf-8") as f:
            f.write('{"off": 999, "byt')
    before = _counter("loop_feedback_bad_pages_total")
    trecs, tcur = tloop.FeedbackReader(d).read_since(None)
    jrecs, jcur = jloop.FeedbackReader(d).read_since(None)
    assert tcur == jcur and len(trecs) == len(jrecs)
    assert len(trecs) == (0 if damage == "crc" else 4)
    assert _counter("loop_feedback_bad_pages_total") == before + (
        damage == "crc")
    # a writer reopened on the damage cuts the torn bytes and goes on
    w = tloop.FeedbackWriter(d)
    w.append_batch(*_rows(2, seed=1))
    w.close()
    assert len(tloop.FeedbackReader(d).read_since(None)[0]) == (
        len(trecs) + 2)


def test_rotation_and_cross_shard_tailing(tmp_path):
    d = str(tmp_path / "log")
    w = tloop.FeedbackWriter(d, page_bytes=512, rotate_bytes=1024)
    x, _ = _rows(40, seed=1)
    y = np.arange(40, dtype=np.float32)[:, None]
    w.append_batch(x, y)
    w.flush()
    assert len(tfl.list_shards(d)) > 1
    r = tloop.FeedbackReader(d)
    recs, cur = r.read_since(None)
    np.testing.assert_array_equal(
        np.concatenate([rec.labels for rec in recs]), y.reshape(-1))
    w.append_batch(x[:7], y[:7])
    w.flush()
    recs2, cur2 = r.read_since(cur)
    assert len(recs2) == 7 and r.pending(cur2) == 0
    w.close()


def test_acknowledged_seq_ids_never_reused_after_crash(tmp_path):
    d = str(tmp_path / "log")
    x, y = _rows(3)
    w = tloop.FeedbackWriter(d)
    w.append_batch_ids(x, y)
    w.flush()
    assert w.append_batch_ids(x, y)[1:] == (3, 5)  # buffered only
    w._f.close()  # a crash: the buffered page never commits
    w2 = tloop.FeedbackWriter(d)
    first2 = w2.append_batch_ids(x, y)[1]
    assert first2 > 5
    w2.close()
    w3 = tloop.FeedbackWriter(d)
    assert w3.append_batch_ids(x, y)[1] == first2 + 3
    w3.close()
    # the JAX writer honours the port's reservation the same way
    w4 = jloop.FeedbackWriter(d)
    assert w4.append_batch_ids(x, y)[1] == first2 + 6
    w4.close()


def test_concurrent_feedback_batches_get_disjoint_contiguous_ranges(tmp_path):
    w = tloop.FeedbackWriter(str(tmp_path / "log"))
    x, y = _rows(20)
    ranges, lock = [], threading.Lock()

    def poster():
        for _ in range(10):
            out = w.append_batch_ids(x, y)
            with lock:
                ranges.append(out)

    threads = [threading.Thread(target=poster) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = sorted((first, last) for n, first, last in ranges
                   if n == 20 and last - first == 19)
    assert len(spans) == 40
    for (_, a_last), (b_first, _) in zip(spans, spans[1:]):
        assert b_first == a_last + 1
    w.close()


@pytest.mark.parametrize("spec", ["loop.append:ioerror:1:2",
                                  "loop.append:enospc:1:2",
                                  "loop.commit:ioerror:1:1",
                                  "loop.commit:enospc:1:1",
                                  "loop.commit:short:1:1"])
def test_loop_faults_drop_and_count_alike(tmp_path, spec):
    """The same spec and seed in both packages: the same records are
    dropped and counted, the same ones committed, the same bytes left."""
    out = {}
    for pkg, faults in (("port", tfaults), ("jax", jfaults)):
        d = str(tmp_path / pkg)
        w = PKG[pkg][0].FeedbackWriter(d, page_bytes=200)
        faults.configure([("fault_seed", "4"), ("fault_inject", spec)])
        try:
            got = [w.append_batch(*_rows(2, seed=i)) for i in range(4)]
            w.flush()
        finally:
            faults.reset()
        recs, _ = PKG[pkg][0].FeedbackReader(d).read_since(None)
        out[pkg] = (got, w.dropped, [r.seq for r in recs])
        w.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] > 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("site", ["loop.append:ioerror:1:1",
                                  "loop.commit:enospc:1:1"])
def test_loop_faults_raise_when_drop_is_off(tmp_path, site):
    w = tloop.FeedbackWriter(str(tmp_path / "log"), drop_on_error=False,
                             page_bytes=64)
    tfaults.install(site)
    with pytest.raises(OSError):
        w.append(np.ones(16, np.float32), 0.0)
    tfaults.reset()
    w.close()


def test_cursor_file_roundtrip_and_corruption(tmp_path):
    cf = tloop.CursorFile(str(tmp_path / "cursor.json"))
    assert cf.load() == {"shard": 0, "off": 0}
    cf.store({"shard": 2, "off": 4096})
    assert cf.load() == {"shard": 2, "off": 4096}
    (tmp_path / "cursor.json").write_text("{corrupt")
    assert cf.load() == {"shard": 0, "off": 0}


# ----------------------------------------------------------------------
# the gate's primitives and the publish pointer
@pytest.mark.parametrize("line,name,prefix", [
    ("\ttrain-error:0\teval-error:0.25\teval-logloss:1.5", "", "eval-"),
    ("\ttrain-error:0\teval-error:0.25\teval-logloss:1.5", "logloss",
     "eval-"),
    ("\tval-rec@1:0.5\tval-rec@5:0.75", "rec@5", "val-"),
    ("\ttrain-error:0", "", "eval-"),
    ("", "", "eval-"),
])
def test_parse_eval_metric_equal_jax(line, name, prefix):
    def call(f):
        try:
            return f(line, name, prefix=prefix)
        except ValueError as e:
            return str(e)

    assert call(tpub.parse_eval_metric) == call(jpub.parse_eval_metric)


@pytest.mark.parametrize("name,a,b", [("eval-error", 0.5, 0.3),
                                      ("eval-logloss[f]", 1.0, 1.2),
                                      ("eval-rec@5", 0.5, 0.7),
                                      ("eval-rmse", 2.0, 2.0)])
def test_metric_improvement_equal_jax(name, a, b):
    assert (tpub.metric_improvement(name, a, b)
            == jpub.metric_improvement(name, a, b))


def test_cohort_counts_and_accuracy_equal_jax():
    r = np.random.RandomState(3)
    preds = r.randint(0, 4, size=40).astype(np.float32)
    labels = np.stack([r.randint(0, 4, size=40),
                       r.randint(0, 3, size=40)], 1).astype(np.float32)
    out = {}
    for tag, mod in (("port", tpub), ("jax", jpub)):
        counts = {}
        mod.accumulate_cohort_counts(counts, preds, labels, source_field=1)
        mod.accumulate_cohort_counts(counts, preds[:7], labels[:7, 0])
        out[tag] = (counts, mod.cohort_accuracy(counts, min_count=9))
    assert out["port"] == out["jax"]
    assert any(k.startswith("source:") for k in out["port"][0])


def test_publish_pointer_keys_values_and_jax_reads_it(tmp_path):
    args = (5, "0005.model")
    kw = dict(net_fp="abcd1234", prev_round=4,
              metric={"name": "eval-error", "value": 0.125,
                      "cohorts": {"class:0": 0.5}},
              lineage={"first_seq": 3, "last_seq": 9, "records": 7,
                       "cycles": 1})
    for pkg in ("t", "j"):
        os.makedirs(tmp_path / pkg)
    tptr = tckpt.write_publish_pointer(str(tmp_path / "t"), *args, **kw)
    jptr = jckpt.write_publish_pointer(str(tmp_path / "j"), *args, **kw)
    assert tptr.keys() == jptr.keys()
    assert {k: v for k, v in tptr.items() if k != "time"} == {
        k: v for k, v in jptr.items() if k != "time"}
    assert jckpt.read_publish_pointer(str(tmp_path / "t")) == tptr
    assert tckpt.read_publish_pointer(str(tmp_path / "j")) == jptr
    assert tckpt.read_publish_pointer(str(tmp_path)) is None
    assert tckpt.pointer_path("m") == jckpt.pointer_path("m")
    assert tckpt.publish_path("m", 7) == jckpt.publish_path("m", 7)
    report, problems = obs_dump.resolve_lineage(str(tmp_path / "t"))
    assert problems == [] and report["lineage"] == kw["lineage"]


# ----------------------------------------------------------------------
# retention
def _rotated_log(pkg, d, n=60):
    w = PKG[pkg][0].FeedbackWriter(d, page_bytes=256, rotate_bytes=512)
    w.append_batch_ids(_rows(n)[0], np.arange(n, dtype=np.float32)[:, None])
    w.flush()
    return w


@pytest.mark.parametrize("opts", [(0, 0), (2, 0), (0, 1 << 30), (1, 3000)])
def test_retention_deletes_what_jax_deletes(tmp_path, opts):
    out = {}
    for pkg, mod in (("port", tret), ("jax", jret)):
        d = str(tmp_path / pkg)
        w = _rotated_log(pkg, d)
        _, cur = PKG[pkg][0].FeedbackReader(d).read_since(None)
        res = mod.Sweeper(d, mod.RetentionOptions(*opts)).sweep(cur)
        w.close()
        out[pkg] = (res, cur)
    assert out["port"] == out["jax"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_retention_pending_lineage_and_stale_cursor(tmp_path):
    d = str(tmp_path / "log")
    w = _rotated_log("port", d)
    n = len(tfl.list_shards(d))
    _, cur = tloop.FeedbackReader(d).read_since(None)
    sw = tret.Sweeper(d, tret.RetentionOptions(0, 0), tenant="t0")
    assert tret.safe_boundary(d, cur, pending_first_seq=0) == 0
    assert sw.sweep(cur, pending_first_seq=0)["deleted_shards"] == 0
    assert sw.sweep({"shard": 0, "off": 0})["deleted_shards"] == 0
    assert len(tfl.list_shards(d)) == n
    out = sw.sweep(cur)
    assert out["deleted_shards"] >= 3
    assert _counter("loop_compactions_total", tenant="t0") >= 1
    for reader in (tloop.FeedbackReader(d), jloop.FeedbackReader(d)):
        with pytest.raises((tloop.StaleCursorError, jloop.StaleCursorError)):
            reader.read_since({"shard": 0, "off": 0})
    # the writer never resumes below the boundary
    w.close()
    w = tloop.FeedbackWriter(d)
    assert w._shard_idx >= out["compacted_below"]
    w.close()


def test_every_crash_state_of_a_sweep_is_safe(tmp_path):
    """Every ``diskio.simulate_crash`` state between the boundary's write
    and the last unlink: the records above the boundary read back whole
    in both packages and the next sweep finishes the job."""
    d = str(tmp_path / "log")
    w = _rotated_log("port", d)
    w.close()
    _, cur = tloop.FeedbackReader(d).read_since(None)
    want = len(tloop.FeedbackReader(d).read_since(
        {"shard": cur["shard"], "off": 0})[0])
    with tdiskio.recording(d) as rec:
        for name in os.listdir(d):
            rec.ensure_known(os.path.join(d, name))
        tret.Sweeper(d, tret.RetentionOptions(0, 0)).sweep(cur)
    states = 0
    for k in range(len(rec.ops) + 1):
        for variant in ("sync", "flush"):
            tree = tdiskio.simulate_crash(rec.ops, k, variant)
            if tree is None:
                continue
            out = tmp_path / f"s{k}{variant}"
            out.mkdir()
            tdiskio.write_tree(tree, str(out))
            below = tfl.read_retention(str(out))["compacted_below"]
            start = {"shard": max(below, cur["shard"]), "off": 0}
            for reader in (tloop.FeedbackReader, jloop.FeedbackReader):
                assert len(reader(str(out)).read_since(start)[0]) == want
            tret.Sweeper(str(out), tret.RetentionOptions(0, 0)).sweep(cur)
            assert all(i >= cur["shard"]
                       for i, _ in tfl.list_shards(str(out)))
            states += 1
    assert states > 4


# ----------------------------------------------------------------------
# one closed-loop cycle in each package
class _ArrayIter:
    """A fixed (data, label) set in batches of ``bs`` (the last one
    padded by repeating its rows), with the package's ``DataBatch``."""

    def __init__(self, batch_cls, x, y, bs):
        self.cls, self.x, self.y, self.bs = batch_cls, x, y, bs
        self.pos = 0
        self.cur = None

    def before_first(self):
        self.pos = 0

    def next(self):
        if self.pos >= len(self.x):
            return False
        lo, hi = self.pos, min(self.pos + self.bs, len(self.x))
        idx = list(range(lo, hi)) + [hi - 1] * (self.bs - (hi - lo))
        self.cur = self.cls(data=self.x[idx], label=self.y[idx],
                            num_batch_padd=self.bs - (hi - lo))
        self.pos = hi
        return True

    def value(self):
        return self.cur


def _conv_rows(n, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, *CONV_ROW).astype(np.float32)
    y = (x[:, :4].sum(axis=(1, 2, 3)) > 0).astype(np.float32) \
        + 2 * (x[:, 4:].sum(axis=(1, 2, 3)) > 0)
    return x, y[:, None].astype(np.float32)


def _loop_in(pkg, tmp_path, min_delta, feedback):
    """One cycle of ``pkg``'s ContinuousLoop over a model_dir holding the
    port-written seeded round 1; returns what the test compares."""
    loop_mod, ckpt_mod = PKG[pkg]
    serve_mod = tserve if pkg == "port" else jserve
    cfg_mod = tcfg if pkg == "port" else jcfg
    batch = TBatch if pkg == "port" else JBatch
    root = tmp_path / pkg
    mdir = str(root / "models")
    os.makedirs(mdir)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(CONV_CFG))
    tr.set_param("seed", "7")
    tr.init_model()
    tr.save_model(tckpt.publish_path(mdir, 1), round_=1)
    cfg = cfg_mod.parse_pairs(CONV_CFG)
    eng = serve_mod.Engine(cfg=cfg, model_dir=mdir, max_batch_size=16,
                           batch_timeout_ms=0)
    w = loop_mod.FeedbackWriter(str(root / "feedback"))
    try:
        bx, by = _conv_rows(40, 11)
        ex, ey = _conv_rows(48, 12)
        lp = loop_mod.ContinuousLoop(
            eng, cfg, feedback_dir=w.dir,
            base_iter=_ArrayIter(batch, bx, by, 16),
            eval_iter=_ArrayIter(batch, ex, ey, 16),
            rounds_per_cycle=2, replay_ratio=0.25, min_records=32,
            publish_min_delta=min_delta, feedback_writer=w, silent=True)
        cands = []
        consider = lp.publisher.consider

        def snap(trainer, **kw):
            cands.append({f"{n}/{t}": np.array(trainer.get_weight(n, t))
                          for n, t in CONV_LAYERS})
            return consider(trainer, **kw)

        lp.publisher.consider = snap
        fx, fy = feedback
        w.append_batch(fx, fy)
        outcome = lp.run_cycle()
        after = {f"{n}/{t}": np.array(lp.trainer.get_weight(n, t))
                 for n, t in CONV_LAYERS}
        ptr = ckpt_mod.read_publish_pointer(mdir)
        return {"outcome": outcome, "round": eng.round,
                "cursor": lp.cursor_file.load(), "candidate": cands[0],
                "after": after, "ptr": ptr,
                "baseline": lp.publisher.serving_metric, "mdir": mdir,
                "fdir": w.dir}
    finally:
        w.close()
        eng.close()


@pytest.mark.parametrize("min_delta,outcome", [(1.0, "rejected"),
                                               (-1.0, "published")])
def test_one_cycle_agrees_with_jax(tmp_path, min_delta, outcome):
    feedback = _conv_rows(56, 13)
    got = {p: _loop_in(p, tmp_path, min_delta, feedback) for p in PKG}
    t, j = got["port"], got["jax"]
    assert t["outcome"] == j["outcome"] == outcome
    assert t["cursor"] == j["cursor"] != {"shard": 0, "off": 0}
    for k in t["candidate"]:
        np.testing.assert_allclose(t["candidate"][k], j["candidate"][k],
                                   rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL,
                                   err_msg=k)
    tp, jp = dict(t["ptr"]), dict(j["ptr"])
    assert tp.keys() == jp.keys()
    assert tp["lineage"] == jp["lineage"]
    assert tp["metric"]["name"] == jp["metric"]["name"]
    assert tp["metric"]["value"] == pytest.approx(jp["metric"]["value"])
    assert tp["net_fingerprint"] == jp["net_fingerprint"]
    assert (tp["round"], tp["prev"]) == (jp["round"], jp["prev"])
    if outcome == "rejected":
        # rolled back: the trainer holds round 1 again, nothing served moved
        assert t["round"] == j["round"] == 1 and tp["round"] == 1
        for k in t["after"]:
            assert not np.array_equal(t["after"][k], t["candidate"][k])
        assert tp["lineage"] is None
    else:
        assert t["round"] == j["round"] == 2 and tp["round"] == 2
        assert tp["lineage"] == {"first_seq": 0, "last_seq": 55,
                                 "records": 56, "cycles": 1}
        # each package loads the other's published round
        tr = JaxTrainer()
        tr.set_params(jcfg.parse_pairs(CONV_CFG))
        tr.load_model(tp["path"])
        np.testing.assert_array_equal(tr.get_weight("fc2", "wmat"),
                                      t["candidate"]["fc2/wmat"])
        report, problems = obs_dump.resolve_lineage(t["mdir"], t["fdir"])
        assert problems == []
        assert report["resolved"]["records_in_range"] == 56


def test_baseline_recorded_once_across_restarts(tmp_path):
    cfg = tcfg.parse_pairs(MLP_CFG)
    mdir = str(tmp_path / "m")
    os.makedirs(mdir)
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.init_model()
    tr.save_model(tckpt.publish_path(mdir, 1), round_=1)
    eng = tserve.Engine(cfg=cfg, model_dir=mdir, max_batch_size=32)
    try:
        x, y = _rows(64, seed=5)
        ev = _ArrayIter(TBatch, x, y, 32)
        pub = tloop.EvalGatedPublisher(eng, ev)
        bar = pub.record_serving_baseline(tr)
        ptr = tckpt.read_publish_pointer(mdir)
        assert ptr["round"] == 1 and ptr["metric"]["value"] == bar
        pub2 = tloop.EvalGatedPublisher(eng, ev, metric_name="error")

        def boom(trainer):
            raise AssertionError("a pinned metric must not re-evaluate")

        pub2.evaluate = boom
        assert pub2.record_serving_baseline(tr) == bar
        ev_kinds = [e for e in trecent(10) if e["kind"] == "loop.baseline"]
        assert [e["source"] for e in ev_kinds[-2:]] == ["evaluated",
                                                        "recorded"]
        # the JAX publisher reads the port's recorded bar back
        jeng = jserve.Engine(cfg=jcfg.parse_pairs(MLP_CFG), model_dir=mdir,
                             max_batch_size=32)
        try:
            jp = jloop.EvalGatedPublisher(jeng, None, metric_name="error")
            jp.evaluate = boom
            assert jp.record_serving_baseline(None) == bar
        finally:
            jeng.close()
        # the slice gate names its worst cohort
        pub3 = tloop.EvalGatedPublisher(eng, ev, slice_floor=0.05,
                                        slice_min_count=1)
        pub3.evaluate = lambda trainer: ("eval-error", 0.3)
        pub3.evaluate_cohorts = lambda trainer: {"class:0": 0.9,
                                                 "class:1": 0.8}
        ckpt_ptr = tckpt.read_publish_pointer(mdir)
        tckpt.write_publish_pointer(mdir, 1, ckpt_ptr["path"],
                                    metric={"name": "eval-error",
                                            "value": 0.3})
        pub3.record_serving_baseline(tr)
        pub3.evaluate = lambda trainer: ("eval-error", 0.1)
        pub3.evaluate_cohorts = lambda trainer: {"class:0": 0.95,
                                                 "class:1": 0.6}
        assert pub3.consider(tr, cycle=3) is False
        rej = [e for e in trecent(10) if e["kind"] == "loop.reject"][-1]
        assert rej["cohort"] == "class:1" and eng.round == 1
    finally:
        eng.close()


# ----------------------------------------------------------------------
# HTTP: /feedback, capture, routing
def _mlp_engine(tmp_path, name="m", seed=0):
    cfg = tcfg.parse_pairs(MLP_CFG)
    mdir = str(tmp_path / name)
    os.makedirs(mdir)
    tr = NetTrainer()
    tr.set_params(cfg)
    tr.set_param("seed", str(seed))
    tr.init_model()
    tr.save_model(tckpt.publish_path(mdir, 1), round_=1)
    return tserve.Engine(cfg=cfg, model_dir=mdir, max_batch_size=32,
                         batch_timeout_ms=1)


def _post(port, path, body, ctype="application/json"):
    data = (bytes(body) if isinstance(body, (bytes, bytearray))
            else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=20) as r:
        raw = r.read()
    return raw if ctype == twire.CONTENT_TYPE else json.loads(raw)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=20) as r:
        return r.read().decode()


def _serving(httpd):
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return th


def _http_error(port, path, body, ctype="application/json"):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, path, body, ctype)
    return e.value.code, json.loads(e.value.read())


def test_http_feedback_and_capture_json_and_binary(tmp_path):
    eng = _mlp_engine(tmp_path)
    w = tloop.FeedbackWriter(str(tmp_path / "fb"))
    httpd = tserve.make_server(eng, port=0, feedback=w, capture_predict=True)
    th = _serving(httpd)
    port = httpd.server_port
    x, _ = _rows(6)
    try:
        out = _post(port, "/feedback", {"data": x.tolist(),
                                        "label": [0, 1, 2, 3, 0, 1]})
        assert (out["appended"], out["dropped"], out["seq"]) == (6, 0,
                                                                 [0, 5])
        assert isinstance(out["rid"], str) and out["rid"]
        assert _http_error(port, "/feedback", {"data": x.tolist(),
                                               "label": [1]})[0] == 400
        assert _http_error(port, "/feedback", {"data": x.tolist()})[0] == 400
        code, body = _http_error(port, "/feedback",
                                 twire.encode_request(x), twire.CONTENT_TYPE)
        assert (code, body["reason"]) == (400, "wire_unsupported_route")
        pred = _post(port, "/predict", {"data": x[:3].tolist()})["pred"]
        raw = _post(port, "/predict", twire.encode_request(x[3:5]),
                    twire.CONTENT_TYPE)
        bpred = twire.decode_response(raw)[2]
        _post(port, "/predict", {"data": x[:2].tolist(), "raw": True})
        w.flush()
        recs, _ = tloop.FeedbackReader(w.dir).read_since(None)
        assert len(recs) == 11  # 6 feedback, 3 JSON and 2 binary captured
        np.testing.assert_array_equal([float(r.labels[0]) for r in recs[6:9]],
                                      pred)
        np.testing.assert_array_equal(
            [float(r.labels[0]) for r in recs[9:]],
            np.asarray(bpred, np.float32).reshape(-1))
        np.testing.assert_array_equal(recs[9].data.reshape(-1), x[3])
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        w.close()
        eng.close()


def test_feedback_route_404_when_unarmed(tmp_path):
    eng = _mlp_engine(tmp_path)
    httpd = tserve.make_server(eng, port=0)
    th = _serving(httpd)
    try:
        code, body = _http_error(httpd.server_port, "/feedback",
                                 {"data": [[0.0] * 16], "label": [1]})
        assert code == 404 and "no feedback log armed" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        eng.close()


def test_model_router_resolve_default_and_unknown():
    from cxxnet_tpu.serve.router import ModelRouter as JRouter
    from cxxnet_tpu_torch.serve.router import ModelRouter, UnknownModelError

    ea, eb = object(), object()
    for cls in (ModelRouter, JRouter):
        r = cls()
        r.add("a", ea).add("b", eb, feedback="fb")
        assert r.resolve(None) == ("a", ea, None) == r.resolve("")
        assert r.resolve("b") == ("b", eb, "fb")
        assert r.models() == ["a", "b"]
        with pytest.raises(KeyError) as e:
            r.resolve("nope")
        assert (e.value.reason, e.value.known) == ("unknown_model",
                                                   ["a", "b"])
        assert str(e.value) == "unknown model 'nope'; serving: a, b"
        for bad in ("a", ""):
            with pytest.raises(ValueError):
                r.add(bad, ea)
        assert cls().add("x", ea).add("y", eb, default=True).resolve()[0] \
            == "y"
    assert issubclass(UnknownModelError, KeyError)


def test_http_per_model_routing(tmp_path):
    ea = _mlp_engine(tmp_path, "a", seed=0)
    eb = _mlp_engine(tmp_path, "b", seed=1)
    wa = tloop.FeedbackWriter(str(tmp_path / "fa"))
    wb = tloop.FeedbackWriter(str(tmp_path / "fb"))
    router = tserve.ModelRouter()
    router.add("alpha", ea, feedback=wa).add("beta", eb, feedback=wb)
    httpd = tserve.make_server(ea, port=0, feedback=wa, router=router,
                               capture_predict=True)
    th = _serving(httpd)
    port = httpd.server_port
    x, _ = _rows(4)
    try:
        h = json.loads(_get(port, "/healthz"))
        assert set(h["models"]) == {"alpha", "beta"}
        assert h["models"]["alpha"]["default"] is True
        assert (h["models"]["beta"]["model_crc32"]
                == eb.healthz()["model_crc32"])
        assert json.loads(_get(port, "/statsz"))["models"] == ["alpha",
                                                               "beta"]
        pb = _post(port, "/predict", {"data": x.tolist(), "model": "beta"})
        assert pb["pred"] == eb.predict(x).tolist()
        raw = _post(port, "/predict", twire.encode_request(x, model="beta"),
                    twire.CONTENT_TYPE)
        assert raw  # a CXR1 reply from beta's engine
        _post(port, "/feedback", {"data": x.tolist(), "label": [0, 1, 2, 3],
                                  "model": "beta"})
        _post(port, "/feedback", {"data": x.tolist(), "label": [0, 1, 2, 3]})
        for w in (wa, wb):
            w.flush()
        na = len(tloop.FeedbackReader(wa.dir).read_since(None)[0])
        nb = len(tloop.FeedbackReader(wb.dir).read_since(None)[0])
        assert (na, nb) == (4, 12)  # beta: 4 JSON + 4 binary captured + 4
        for path in ("/predict", "/feedback", "/extract", "/reloadz"):
            code, body = _http_error(port, path, {
                "data": x.tolist(), "label": [0] * 4, "node": "fc1",
                "model": "ghost"})
            assert (code, body["reason"], body["models"]) == (
                404, "unknown_model", ["alpha", "beta"])
        code, body = _http_error(port, "/predict",
                                 twire.encode_request(x, model="ghost"),
                                 twire.CONTENT_TYPE)
        assert (code, body["reason"]) == (404, "unknown_model")
        out = _post(port, "/reloadz", {"model": "beta"})
        assert out["ok"] and out["round"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        for c in (wa, wb, ea, eb):
            c.close()


# ----------------------------------------------------------------------
# tenants and the CLI
_TENANT_CASES = [
    [("eta", "0.1"), ("tenant", "alpha"), ("model_dir", "ma"),
     ("eta", "0.2"), ("tenant", "end"), ("tenant", "beta"),
     ("model_dir", "mb"), ("tenant", "end"), ("seed", "1")],
    [("tenant", "a"), ("x", "1")],
    [("tenant", "end")],
    [("tenant", "a"), ("tenant", "b")],
    [("tenant", "a"), ("tenant", "end"), ("tenant", "a"),
     ("tenant", "end")],
    [("tenant", "a"), ("data", "start"), ("tenant", "end")],
    [("tenant", ""), ("tenant", "end")],
]


@pytest.mark.parametrize("case", range(len(_TENANT_CASES)))
def test_split_tenant_sections_equal_jax(case):
    cfg = _TENANT_CASES[case]

    def call(mod):
        try:
            rest, secs = mod.split_tenant_sections(cfg)
            return rest, [(s.name, s.entries) for s in secs]
        except mod.ConfigError as e:
            return f"ConfigError: {e}"

    assert call(tcfg) == call(jcfg)


def test_cli_set_param_passes_tenant_sections_through():
    t = LearnTask()
    t.set_param("model_dir", "task_models")
    t.set_param("tenant", "a")
    t.set_param("model_dir", "tenant_models")
    t.set_param("task", "loop_fleet")  # inside the section: the tenant's
    t.set_param("tenant", "end")
    t.set_param("loop_min_records", "5")
    assert t.name_model_dir == "task_models" and t.task == "train"
    assert t.loop_min_records == 5
    _, tenants = tcfg.split_tenant_sections(t.cfg)
    assert tenants[0].entries[0] == ("model_dir", "tenant_models")
    # the one table of defaults is the JAX package's
    from cxxnet_tpu.loop.tenant import TenantOptions as JOpts
    from cxxnet_tpu_torch.loop.tenant import TenantOptions

    assert TenantOptions.DEFAULTS == JOpts.DEFAULTS


def _tenant_manager(tmp_path, names=("alpha", "beta")):
    from cxxnet_tpu_torch.loop.tenant import TenantManager

    secs = []
    for i, name in enumerate(names):
        eng = _mlp_engine(tmp_path, name, seed=i)
        mdir = eng.model_dir
        eng.close()
        secs.append(tcfg.TenantSection(name, [
            ("model_dir", mdir),
            ("feedback_dir", str(tmp_path / name / "feedback")),
            ("feedback_page_bytes", "2048"), ("feedback_rotate_bytes", "4096"),
            ("feedback_retain_shards", "0"), ("loop_min_records", "32")]))
    x, y = _rows(96, seed=9)
    return TenantManager(
        tcfg.parse_pairs(MLP_CFG), secs,
        engine_factory=lambda cfg, mdir: tserve.Engine(
            cfg=cfg, model_dir=mdir, max_batch_size=32),
        make_iters=lambda cfg: (_ArrayIter(TBatch, x, y, 32),
                                _ArrayIter(TBatch, x, y, 32), "eval"),
        loop_dir=str(tmp_path / "loop"))


def test_tenant_manager_two_tenants_share_one_pool(tmp_path):
    mgr = _tenant_manager(tmp_path)
    try:
        alpha, beta = mgr.tenants
        assert mgr.tick_once() == {"alpha": "idle", "beta": "idle"}
        alpha.loop.publisher.min_delta = -1.0  # alpha publishes
        beta.loop.publisher.min_delta = 1.0  # beta cannot
        x, y = _rows(64, seed=3)
        alpha.feedback.append_batch(x, y)
        beta.feedback.append_batch(x, y)
        assert mgr.tick_once() == {"alpha": "published", "beta": "rejected"}
        assert mgr.arbiter.work() >= 1.0
        hz = mgr.healthz_tenants()
        assert (hz["alpha"]["round"], hz["beta"]["round"]) == (2, 1)
        assert _counter("tenant_cycles_total", tenant="beta",
                        outcome="rejected") >= 1
        mgr.arbiter.slo_firing = lambda: ["serve_p99_high"]
        assert mgr.tick_once() == {"alpha": "shed", "beta": "shed"}
        assert any(e["kind"] == "tenant.shed" for e in trecent(10))
        mgr.arbiter.slo_firing = lambda: []
        mgr.tick_once()
        assert not mgr.arbiter.shedding
        # knobs: one per tenant, each bound to its own loop
        knobs = {k.name: k for k in mgr.arbiter.controller.knobs}
        assert sorted(knobs) == ["tenant_rounds:alpha", "tenant_rounds:beta"]
        knobs["tenant_rounds:alpha"].apply(5)
        assert (alpha.loop.rounds_per_cycle, beta.loop.rounds_per_cycle) == (
            5, 2)
        knobs["tenant_rounds:alpha"].apply(0)
        assert alpha.loop.rounds_per_cycle == 1
        # one tenant's broken cycle does not starve the other
        beta.loop.run_cycle = None
        assert mgr.tick_once()["beta"] == "error"
        r = mgr.router()
        assert r.models() == ["alpha", "beta"] and r.resolve()[0] == "alpha"
    finally:
        mgr.close()
    with pytest.raises(ValueError, match="at least one"):
        from cxxnet_tpu_torch.loop.tenant import TenantManager

        TenantManager(tcfg.parse_pairs(MLP_CFG), [], engine_factory=None,
                      make_iters=None)


# the replay chain ends in a threadbuffer, which produces nothing
# before its first rewind
_SERVE_TRAIN_CONF = MLP_CFG + """
data = train
iter = synthetic
nsample = 64
nclass = 4
iter = threadbuffer
iter = end
{eval}
"""
_EVAL = "eval = test\niter = synthetic\nnsample = 32\nnclass = 4\niter = end"


@pytest.mark.parametrize("task,conf,extra", [
    ("serve_train", "", []),
    ("serve_train", _EVAL, ["quant=int8"]),
    ("loop_fleet", _EVAL, []),
    ("loop_fleet", _EVAL, ["quant=int8", "tenant=a", "model_dir=x",
                           "tenant=end"]),
    ("loop_fleet", "", ["tenant=a", "model_dir=x", "tenant=end"]),
])
def test_task_refusals_give_the_jax_messages(tmp_path, task, conf, extra):
    path = tmp_path / "t.conf"
    path.write_text(_SERVE_TRAIN_CONF.format(eval=conf))
    argv = [str(path), f"task={task}", f"model_dir={tmp_path / 'm'}",
            f"loop_dir={tmp_path / 'loop'}", *extra]
    msgs = []
    for cls in (LearnTask, JaxTask):
        task = cls()
        with pytest.raises(ValueError) as e:
            task.run(list(argv))
        msgs.append(str(e.value))
        # the JAX task builds its iterators before it refuses
        for it in [getattr(task, "itr_train", None),
                   *getattr(task, "itr_evals", [])]:
            if it is not None:
                it.close()
    assert msgs[0] == msgs[1]


def _cli(tmp_path, argv, wait_for, send):
    """Run the port's CLI in a subprocess until ``wait_for`` is printed,
    call ``send(port)``, SIGTERM it; its output."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", *argv], cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(s) for s in proc.stdout], daemon=True)
    reader.start()
    seen, sent = [], False
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                continue
            seen.append(line)
            m = re.search(r"http://[\d.]+:(\d+)", line)
            if m and not sent:
                send(int(m.group(1)))
                sent = True
            if wait_for in line:
                break
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    while not lines.empty():
        seen.append(lines.get())
    return "".join(seen), proc.returncode


def test_cli_serve_train_publishes_and_drains(tmp_path):
    conf = tmp_path / "st.conf"
    conf.write_text(_SERVE_TRAIN_CONF.format(eval=_EVAL))
    mdir = tmp_path / "m"
    mdir.mkdir()
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(MLP_CFG))
    tr.init_model()
    tr.save_model(str(mdir / "0001.model"), round_=1)
    x, y = _rows(40, seed=2)

    def send(port):
        _post(port, "/predict", {"data": x[:8].tolist()})
        _post(port, "/feedback", {"data": x.tolist(),
                                  "label": y[:, 0].tolist()})

    out, rc = _cli(tmp_path, [str(conf), "task=serve_train", "serve_port=0",
                              f"model_dir={mdir}", "loop_min_records=40",
                              "loop_cycle_period_s=0.2", "loop_max_cycles=1",
                              "publish_min_delta=-1", "capture_predict=1",
                              "silent=0"], "loop: PUBLISHED", send)
    assert rc == 0, out
    assert "serve_train: serving model round 1" in out
    assert "loop: PUBLISHED round 2" in out
    assert "serve_train: shutdown complete" in out
    ptr = jckpt.read_publish_pointer(str(mdir))
    assert ptr["round"] == 2 and ptr["lineage"]["records"] == 48


def test_cli_loop_fleet_routes_and_publishes_per_tenant(tmp_path):
    conf = tmp_path / "lf.conf"
    conf.write_text(_SERVE_TRAIN_CONF.format(eval=_EVAL))
    dirs = {}
    for i, name in enumerate(("a", "b")):
        d = tmp_path / f"m_{name}"
        d.mkdir()
        tr = NetTrainer()
        tr.set_params(tcfg.parse_pairs(MLP_CFG))
        tr.set_param("seed", str(i))
        tr.init_model()
        tr.save_model(str(d / "0001.model"), round_=1)
        dirs[name] = str(d)
    x, y = _rows(40, seed=4)
    seen = {}

    def send(port):
        _post(port, "/feedback", {"data": x.tolist(),
                                  "label": y[:, 0].tolist(), "model": "b"})
        seen["ghost"] = _http_error(port, "/predict", {
            "data": x[:1].tolist(), "model": "ghost"})[1]["reason"]
        seen["health"] = json.loads(_get(port, "/healthz"))["models"]

    out, rc = _cli(tmp_path, [
        str(conf), "task=loop_fleet", "serve_port=0", "silent=0",
        f"loop_dir={tmp_path / 'loop'}", "loop_cycle_period_s=0.2",
        "loop_min_records=40", "publish_min_delta=-1",
        "tenant=a", f"model_dir={dirs['a']}", "tenant=end",
        "tenant=b", f"model_dir={dirs['b']}", "tenant=end"],
        "loop: PUBLISHED", send)
    assert rc == 0, out
    assert "loop_fleet: serving 2 tenant(s) [a, b]" in out
    assert "loop_fleet: shutdown complete" in out
    assert seen["ghost"] == "unknown_model"
    assert set(seen["health"]) == {"a", "b"}
    assert tckpt.read_publish_pointer(dirs["b"])["round"] == 2
    assert tckpt.read_publish_pointer(dirs["a"])["round"] == 1
