"""The port's disk layer (``cxxnet_tpu_torch/utils/diskio.py``) against
the JAX package's, on the CPU.

* The same sequence of writes (an atomic publish over an older file, an
  append handle with a truncate, a replace, an unlink, a mark) records
  the same journal in both modules; the journals hold paths relative to
  the recording's root, so they are equal outright.
* ``simulate_crash`` of that journal gives equal ``tree_fingerprint``s
  for every prefix in every variant (``torn`` at two cut sizes).
* ``CXXNET_DISKIO_KILL_AT`` SIGKILLs a subprocess just before the named
  op: the published name never appears.
* A port checkpoint save and a JAX one of the same params record the
  same kinds of operation on the same paths in the same order, and the
  model files hold equal headers (but the JAX package's PRNG state) and
  byte-equal arrays.
* Every crash state of a port save over round 0 loads through the
  port's ``find_latest_valid``: round 0 or round 1, never a torn model
  (each state's pick loads into a fresh trainer); ``checkpoint.write``
  with ``enospc`` aborts the save atomically and counts
  ``disk_full_total{site="checkpoint.write"}``; ``checkpoint.read``
  fires in ``validate_checkpoint``.
* The event log's rotation and append and the span trace's export go
  through the layer (a recording sees them).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils import diskio as jdiskio

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.obs import events as tevents
from cxxnet_tpu_torch.obs import trace as ttrace
from cxxnet_tpu_torch.obs.registry import registry as tregistry
from cxxnet_tpu_torch.utils import checkpoint as tck
from cxxnet_tpu_torch.utils import diskio as tdiskio
from cxxnet_tpu_torch.utils import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONF = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 4
  init_sigma = 0.2
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 3
  init_sigma = 0.2
layer[4->4] = softmax
netconfig = end
input_shape = 3,6,6
batch_size = 2
updater = sgd
eta = 0.1
momentum = 0.9
save_ustate = 1
dev = cpu
seed = 5
"""


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


def _sequence(mod, root):
    """One sequence of durable ops through ``mod`` under ``root``."""
    a = os.path.join(root, "d", "a.bin")
    b = os.path.join(root, "d", "b.log")
    mod.write_atomic(a, b"old-bytes", site=None)
    with mod.recording(root) as rec:
        mod.write_atomic(a, b"new-bytes-of-a", site=None)
        h = mod.open_append(b)
        h.write(b"one\n")
        h.write(b"two\n")
        h.fsync()
        h.truncate(4)
        h.close()
        mod.append_bytes(b, b"three\n", site=None)
        mod.mark("round", n=1)
        mod.replace(b, os.path.join(root, "d", "c.log"))
        mod.unlink(a)
        mod.fsync_dir(os.path.join(root, "d"))
    return rec.ops


def _strip(ops):
    return [{k: (v.hex() if isinstance(v, bytes) else v)
             for k, v in op.items()} for op in ops]


def test_same_writes_record_the_same_journal_and_crash_states(tmp_path):
    tops = _sequence(tdiskio, str(tmp_path / "port"))
    jops = _sequence(jdiskio, str(tmp_path / "jax"))
    assert len(tops) > 10
    assert _strip(tops) == _strip(jops)
    n = 0
    for k in range(len(tops) + 1):
        for variant in tdiskio.VARIANTS:
            for keep in ((None,) if variant != "torn" else (1, 3)):
                t = tdiskio.simulate_crash(tops, k, variant, torn_keep=keep)
                j = jdiskio.simulate_crash(jops, k, variant, torn_keep=keep)
                assert (t is None) == (j is None)
                if t is not None:
                    assert (tdiskio.tree_fingerprint(t)
                            == jdiskio.tree_fingerprint(j))
                    n += 1
    assert n > len(tops)
    assert tdiskio.KILL_ENV == jdiskio.KILL_ENV
    assert tdiskio.VARIANTS == jdiskio.VARIANTS


def test_the_kill_hook_fires_in_a_subprocess(tmp_path):
    code = ("import sys\n"
            "from cxxnet_tpu_torch.utils import diskio\n"
            "diskio.write_atomic(sys.argv[1], b'x' * 10)\n"
            "print('survived')\n")
    target = tmp_path / "0002.model"
    env = dict(os.environ, PYTHONPATH=REPO,
               CXXNET_DISKIO_KILL_AT="0002.model:1")
    r = subprocess.run([sys.executable, "-c", code, str(target)], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == -9, (r.returncode, r.stderr)
    assert "survived" not in r.stdout and not target.exists()
    env.pop("CXXNET_DISKIO_KILL_AT")
    r = subprocess.run([sys.executable, "-c", code, str(target)], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and target.read_bytes() == b"x" * 10


def _port_trainer():
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(CONF))
    tr.init_model()
    return tr


def _model_arrays(path):
    hdr, params, _aux, ust = NetTrainer._read_model_file(str(path))
    flat = {f"{k}/{t}": np.asarray(w) for k, tags in params.items()
            for t, w in tags.items()}
    for k, tags in (ust or {}).items():
        for t, slots in tags.items():
            for s, w in slots.items():
                flat[f"ust:{k}/{t}@{s}"] = np.asarray(w)
    return hdr, flat


def test_checkpoint_saves_take_the_same_path_in_both_packages(tmp_path):
    tr = _port_trainer()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    src = tmp_path / "0000.model"
    tr.save_model(str(src), round_=0)
    jt = JaxTrainer()
    from cxxnet_tpu import config as jcfg

    jt.set_params(jcfg.parse_pairs(CONF))
    jt.load_model(str(src))
    with tdiskio.recording(str(tmp_path / "port")) as trec:
        tr.save_model(str(tmp_path / "port" / "0001.model"), round_=1)
    with jdiskio.recording(str(tmp_path / "jax")) as jrec:
        jt.save_model(str(tmp_path / "jax" / "0001.model"), round_=1)
    kinds = [(op["op"], op.get("path", op.get("dst"))) for op in trec.ops]
    assert kinds == [(op["op"], op.get("path", op.get("dst")))
                     for op in jrec.ops]
    assert [k for k, _ in kinds].count("rename") == 2  # model, manifest
    th, ta = _model_arrays(tmp_path / "port" / "0001.model")
    jh, ja = _model_arrays(tmp_path / "jax" / "0001.model")
    # the JAX header adds its PRNG state (``rng_key``, ``rng_impl``)
    assert th == {k: v for k, v in jh.items() if not k.startswith("rng_")}
    assert sorted(ta) == sorted(ja)
    for name in ta:
        assert ta[name].dtype == ja[name].dtype
        assert ta[name].tobytes() == ja[name].tobytes(), name
    tman = tck.read_manifest(str(tmp_path / "port" / "0001.model"))
    jman = json.load(open(tmp_path / "jax" / "0001.model.manifest.json"))
    assert set(tman) <= set(jman)  # the JAX one adds mesh and time
    assert tman["round"] == jman["round"] == 1


def test_every_crash_state_of_a_port_save_loads(tmp_path):
    tr = _port_trainer()
    mdir = tmp_path / "m"
    mdir.mkdir()
    tr.save_model(str(mdir / "0000.model"), round_=0)
    tr.update(type("B", (), {"data": np.random.RandomState(1).rand(
        2, 6, 6, 3).astype(np.float32), "label": np.array([[0.], [2.]],
        np.float32), "extra_data": [], "num_batch_padd": 0})())
    with tdiskio.recording(str(mdir)) as rec:
        # round 0 predates the recording: a durable prologue of it
        for name in ("0000.model", "0000.model.manifest.json"):
            rec.ensure_known(str(mdir / name))
        tr.save_model(str(mdir / "0001.model"), round_=1)
    seen = set()
    for k in range(len(rec.ops) + 1):
        for variant in ("sync", "flush", "torn"):
            tree = tdiskio.simulate_crash(rec.ops, k, variant, torn_keep=7)
            if tree is None:
                continue
            out = tmp_path / f"s{k}{variant}"
            out.mkdir()
            tdiskio.write_tree(tree, str(out))
            found = tck.find_latest_valid(str(out), silent=True)
            assert found is not None and found[0] in (0, 1), (k, variant)
            t2 = NetTrainer()
            t2.set_params(tcfg.parse_pairs(CONF))
            t2.load_model(found[1])
            seen.add(found[0])
    assert seen == {0, 1}


def test_checkpoint_sites_fire_and_a_full_disk_aborts_atomically(tmp_path):
    tr = _port_trainer()
    path = tmp_path / "0000.model"
    tr.save_model(str(path), round_=0)
    before = path.read_bytes()

    def count():
        return tregistry().counter(
            "disk_full_total", "", labelnames=("site",)
        ).labels(site="checkpoint.write").value

    n0 = count()
    tfaults.configure([("fault_seed", "3"),
                       ("fault_inject", "checkpoint.write:enospc:1:1")])
    try:
        with pytest.raises(OSError) as ei:
            tr.save_model(str(path), round_=1)
        assert ei.value.errno == 28
        assert path.read_bytes() == before
        assert tck.validate_checkpoint(str(path)) is None
        assert count() == n0 + 1
        tfaults.install("checkpoint.write:short:1:1")
        with pytest.raises(OSError):
            tr.save_model(str(path), round_=1)
        assert path.read_bytes() == before
        tfaults.install("checkpoint.read:ioerror:1:1")
        assert "unreadable" in tck.validate_checkpoint(str(path))
        assert tck.validate_checkpoint(str(path)) is None
    finally:
        tfaults.reset()
    tr.save_model(str(path), round_=1)
    assert tck.validate_checkpoint(str(path)) is None


def _log(path, **keys):
    log = tevents.EventLog()
    log.configure([("event_log", str(path)), ("event_log_holdoff_s", "0"),
                   *((k, str(v)) for k, v in keys.items())])
    return log


def test_event_log_and_trace_go_through_the_disk_layer(tmp_path):
    log = _log(tmp_path / "ev.jsonl", event_log_max_bytes=1024,
               event_log_backups=2)
    with tdiskio.recording(str(tmp_path)) as rec:
        for i in range(40):
            log.emit("test.event", i=i, pad="x" * 60)
        tr = ttrace.Tracer()
        tr.enable()
        with tr.span("unit"):
            pass
        tr.export(str(tmp_path / "t" / "trace.json"))
    ops = {op["op"] for op in rec.ops}
    assert {"write", "rename", "unlink"} <= ops
    paths = {op.get("path", op.get("dst")) for op in rec.ops}
    assert "ev.jsonl.1" in paths and os.path.join("t", "trace.json") in paths
    assert json.load(open(tmp_path / "t" / "trace.json"))["traceEvents"]
    tfaults.configure([("fault_inject", "obs.append:ioerror:1:1")])
    try:
        log2 = _log(tmp_path / "ev2.jsonl")
        log2.emit("test.event", i=0)
        log2.emit("test.event", i=1)
    finally:
        tfaults.reset()
    lines = (tmp_path / "ev2.jsonl").read_text().splitlines()
    assert [json.loads(x)["i"] for x in lines] == [1]
    assert log2.dropped == 1
