"""The port's profiler, build cache, stage timers, telemetry and
``test_io`` against the JAX package's, on the CPU.

* ``PipelineStats`` and ``StepTimer`` are the same code: fed the same
  samples, their snapshots, reports, collector families and summaries
  are equal (exactly: the same float operations in the same order).
* ``TraceController`` opens and closes its window at the same steps as
  the JAX one (whose ``jax.profiler`` calls are recorded, not run), and
  the port's window writes a Chrome trace that loads, on the CPU with
  CPU activity only.
* ``compile_cache.configure`` moves both build directories and warns
  (``compile_cache.mid_process_enable``) once a kernel library is loaded;
  the build keys carry the toolchain and the machine.
* The imgbin chain (raw pages, serial and a 3-worker pool) adds the same
  stages with the same counts and rows in both packages.
* A small CLI train (``telemetry = 1``, ``eval_train = 0``, ``eta = 0``
  from one port-written ``0000.model``) writes records with the same
  keys and the same ``round``, ``steps``, ``batches`` and ``eval`` in
  both packages, stage counts equal for decode/augment/batch and rows
  equal for h2d/device_wait; ``test_io = 1`` prints the same line
  sequence (numbers masked).  The JAX CLI runs in one subprocess.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from cxxnet_tpu.io import data as jdata
from cxxnet_tpu.utils import profiler as jprofiler

from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io import data as tdata
from cxxnet_tpu_torch.io import imgbin as timgbin
from cxxnet_tpu_torch.obs import events as tevents
from cxxnet_tpu_torch.ops import _build
from cxxnet_tpu_torch.utils import compile_cache
from cxxnet_tpu_torch.utils import profiler as tprofiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _feed(stats, seed):
    rng = np.random.RandomState(seed)
    for i in range(300):
        stage = ("decode", "augment", "batch", "h2d", "device_wait",
                 "custom")[rng.randint(6)]
        stats.add(stage, float(rng.rand() * 1e-2), rows=int(rng.randint(9)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_stats_are_the_jax_code(seed):
    t, j = tprofiler.PipelineStats(), jprofiler.PipelineStats()
    _feed(t, seed)
    _feed(j, seed)
    assert t.snapshot() == j.snapshot()
    assert t.report() == j.report() and t.report()
    assert t.collect() == j.collect()
    t.reset()
    j.reset()
    assert t.snapshot() == j.snapshot()
    assert tprofiler.PipelineStats.STAGES == jprofiler.PipelineStats.STAGES


@pytest.mark.parametrize("n,scan", [(1, 1), (3, 1), (9, 1), (12, 4)])
def test_step_timer_summaries_are_equal(n, scan):
    t, j = tprofiler.StepTimer(), jprofiler.StepTimer()
    rng = np.random.RandomState(n)
    for _ in range(n):
        dt = float(rng.rand() * 0.05)
        t.add(dt, scan)
        j.add(dt, scan)
    assert t.count == j.count == n * scan
    for bs in (0, 128):
        assert t.summary(bs) == j.summary(bs)
        assert t.report(bs) == j.report(bs) and t.report(bs).startswith(
            "step ")
    t.clear()
    assert t.summary() == {} and t.report() == ""


@pytest.mark.parametrize("start,steps,last", [(2, 2, 8), (0, 3, 10),
                                              (5, 10, 7), (4, 1, 4)])
def test_trace_window_opens_and_closes_at_the_jax_steps(
        tmp_path, monkeypatch, start, steps, last):
    import jax

    jcalls, tcalls = [], []
    step = {"i": -1}
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: jcalls.append(("start", step["i"])))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: jcalls.append(("stop", step["i"])))
    cfg = [("profile", "1"), ("profile_dir", str(tmp_path / "p")),
           ("profile_start", str(start)), ("profile_steps", str(steps))]
    jt, tt = jprofiler.TraceController(), tprofiler.TraceController()
    jt.configure(cfg)
    tt.configure(cfg)
    real_start, real_stop = tt._start, tt._stop
    monkeypatch.setattr(tt, "_start", lambda: (
        tcalls.append(("start", step["i"])), real_start()))
    monkeypatch.setattr(tt, "_stop", lambda: (
        tcalls.append(("stop", step["i"])), real_stop()))
    import torch

    for i in range(last + 1):
        step["i"] = i
        jt.step(i)
        tt.step(i)
        torch.ones(4).add_(1)  # something for the window to record
    step["i"] = "close"
    jt.close()
    tt.close()
    assert tcalls == jcalls
    if tcalls:
        trace = json.load(open(tt.trace_path))
        names = {e.get("name") for e in trace["traceEvents"]}
        assert any("add_" in str(n) for n in names)
        assert os.path.dirname(tt.trace_path) == str(tmp_path / "p")


def test_compile_cache_moves_both_build_directories(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", _build.HOST_BUILD_DIR)
    monkeypatch.setattr(_build, "LOADED", [])
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    assert compile_cache.configure([("x", "1")]) is False
    assert _build.BUILD_DIR == os.path.join(_build.DEFAULT_CACHE_ROOT,
                                            "kernels")
    d = tmp_path / "cc"
    assert compile_cache.configure([("compile_cache_dir", "nope"),
                                    ("compile_cache_dir", str(d))])
    assert compile_cache.enabled_dir() == str(d)
    assert _build.BUILD_DIR == str(d / "kernels")
    assert _build.HOST_BUILD_DIR == str(d / "host")
    k = _build.Kernel("maxpool_fwd", "none")
    assert k.library_path().startswith(str(d / "kernels"))
    assert _build.host_path("libcxxnet_io").startswith(str(d / "host"))
    assert compile_cache.enable(str(d)) is False  # idempotent
    # once a library is loaded, a move warns and leaves it loaded
    _build.LOADED.append("/x/lib.so")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert compile_cache.enable(str(tmp_path / "cc2"))
    assert "WARNING: compile_cache_dir set after" in out.getvalue()
    assert tevents.recent(5, kind="compile_cache.mid_process_enable")
    assert _build.LOADED == ["/x/lib.so"]


def test_build_keys_carry_the_toolchain(monkeypatch):
    assert "\n" in _build.toolchain_id("g++")  # version, then the machine
    k = _build.Kernel("maxpool_fwd", "none")
    here = k.library_path()
    host = _build.host_path("libcxxnet_io")
    monkeypatch.setattr(_build, "toolchain_id",
                        lambda c: f"{c}: another release\nx86_64")
    assert k.library_path() != here
    assert _build.host_path("libcxxnet_io") != host


# ----------------------------------------------------------------------
# the imgbin chain's stages

def _shard(d, name, n, seed):
    imgs = (np.random.RandomState(seed).rand(n, 12, 12, 3) * 255).astype(
        np.float32)
    w = timgbin.BinPageWriter(os.path.join(str(d), name + ".bin"),
                              page_size=2000)
    with open(os.path.join(str(d), name + ".lst"), "w") as f:
        for i, img in enumerate(imgs):
            w.push(timgbin.encode_raw(img))
            f.write(f"{i}\t{i % 4}\timg{i}.jpg\n")
    w.close()


def _entries(d, workers):
    return [("iter", "imgbin"), ("native_decoder", "0"),
            ("image_bin", str(d / "tr.bin")), ("image_list", str(d / "tr.lst")),
            ("raw_pixels", "1"), ("rand_crop", "1"), ("rand_mirror", "1"),
            ("num_decode_workers", str(workers)), ("decode_chunk", "4"),
            ("silent", "1"), ("iter", "end"), ("input_shape", "3,8,8"),
            ("batch_size", "8")]


def _counts(snap):
    return {k: (v["count"], v["rows"]) for k, v in snap.items()}


@pytest.mark.parametrize("workers", [1, 3])
def test_imgbin_chain_adds_the_same_stages(tmp_path, workers):
    _shard(tmp_path, "tr", 21, 0)
    out = {}
    for pkg, mod, stats in (("jax", jdata, jprofiler.pipeline_stats()),
                            ("port", tdata, tprofiler.pipeline_stats())):
        it = mod.create_iterator(_entries(tmp_path, workers))
        it.init()
        try:
            stats.reset()
            it.before_first()
            n = 0
            while it.next():
                n += 1
            out[pkg] = (n, _counts(stats.snapshot()))
        finally:
            it.close()
    assert out["port"] == out["jax"]
    n, c = out["port"]
    assert n == 3 and c["decode"][0] == 21 and c["batch"] == (3.0, 24.0)
    assert c["augment"][1] == 21


# ----------------------------------------------------------------------
# the CLI: telemetry and test_io in both packages

NET = """
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
  nhidden = 4
  init_sigma = 0.2
layer[4->4] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 8
updater = sgd
eta = 0.0
momentum = 0.9
metric = error
eval_train = 0
dev = cpu
seed = 3
"""

SECTIONS = """
data = train
iter = imgbin
  image_list = ./tr.lst
  image_bin = ./tr.bin
  raw_pixels = 1
  native_decoder = 0
  rand_crop = 1
  rand_mirror = 1
  num_decode_workers = 2
  decode_chunk = 4
iter = end
eval = val
iter = imgbin
  image_list = ./va.lst
  image_bin = ./va.bin
  raw_pixels = 1
  native_decoder = 0
iter = end
"""

_JAX_CLI = """
import contextlib, io, json, os, sys
from cxxnet_tpu.cli import LearnTask
out = []
for cwd, argv in json.loads(sys.argv[1]):
    os.chdir(cwd)
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        LearnTask().run(argv)
    out.append([so.getvalue(), se.getvalue()])
print(json.dumps(out))
"""

ARGS = {"telemetry": ["t.conf", "model_in=0000.model", "num_round=2",
                      "model_dir=m", "telemetry=1", "save_model=0"],
        "test_io": ["t.conf", "model_in=0000.model", "num_round=2",
                    "model_dir=m", "test_io=1", "save_model=0"]}


def _run_port(cwd, argv):
    old = os.getcwd()
    os.chdir(cwd)
    so, se = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            assert LearnTask().run(argv) == 0
    finally:
        os.chdir(old)
    return so.getvalue(), se.getvalue()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    root = tmp_path_factory.mktemp("cli")
    out, jobs = {}, []
    for case, argv in ARGS.items():
        for pkg in ("port", "jax"):
            d = root / f"{case}_{pkg}"
            d.mkdir()
            _shard(d, "tr", 20, 0)
            _shard(d, "va", 8, 1)
            (d / "t.conf").write_text(SECTIONS + NET)
            tr = NetTrainer()
            tr.set_params(tcfg.parse_pairs(NET))
            tr.init_model()
            tr.save_model(str(d / "0000.model"), round_=0)
            if pkg == "port":
                out[(case, pkg)] = (d, _run_port(d, argv))
            else:
                jobs.append(((case, pkg), d, [str(d), argv]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _JAX_CLI,
                        json.dumps([job for _, _, job in jobs])],
                       cwd=str(root), env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for (key, d, _), res in zip(jobs, json.loads(r.stdout.splitlines()[-1])):
        out[key] = (d, tuple(res))
    return out


def _records(d):
    return [json.loads(x) for x in
            (d / "telemetry.jsonl").read_text().splitlines()]


def test_telemetry_records_match_the_jax_cli(cli_runs):
    (dt, _), (dj, _) = cli_runs[("telemetry", "port")], \
        cli_runs[("telemetry", "jax")]
    tr, jr = _records(dt), _records(dj)
    assert len(tr) == len(jr) == 2
    for t, j in zip(tr, jr):
        assert set(t) == set(j) - {"async", "elastic"}
        assert set(t) >= {"ts", "round", "steps", "batches", "elapsed_s",
                          "lr", "eval", "step", "stages", "device"}
        for key in ("round", "steps", "batches", "lr"):
            assert t[key] == j[key], key
        assert t["eval"] == j["eval"] and "val-error" in t["eval"]
        assert set(t["step"]) == set(j["step"])
        assert set(t["stages"]) == set(j["stages"])
        for st in ("decode", "augment", "batch"):
            assert t["stages"][st]["count"] == j["stages"][st]["count"], st
        for st in ("decode", "augment", "batch", "h2d", "device_wait"):
            assert t["stages"][st]["rows"] == j["stages"][st]["rows"], st
            assert t["stages"][st]["count"] > 0
    assert [t["round"] for t in tr] == [0, 1]


def _lines(text):
    keep = ("start I/O test", "update round", "round ")
    return [re.sub(r"[0-9]+(\.[0-9]+)?", "#", ln)
            for ln in text.splitlines() if ln.startswith(keep)]


def test_test_io_prints_the_jax_line_sequence(cli_runs):
    (_, (tout, terr)), (_, (jout, jerr)) = (cli_runs[("test_io", "port")],
                                            cli_runs[("test_io", "jax")])
    assert _lines(tout) == _lines(jout)
    seq = _lines(tout)
    assert seq[0] == "start I/O test"
    assert sum(" pipeline: decode " in ln for ln in seq) == 2
    assert not any("step" in ln for ln in seq)
    assert "[1]" not in terr and "[1]" not in jerr  # no round's eval


def test_the_train_round_lines_match_the_jax_cli(cli_runs):
    (_, (tout, _)), (_, (jout, _)) = (cli_runs[("telemetry", "port")],
                                      cli_runs[("telemetry", "jax")])
    assert _lines(tout) == _lines(jout)
    assert any(re.match(r"round +\d+: step [\d.]+ ms avg \(p50 [\d.]+, "
                        r"p99 [\d.]+\), [\d.]+ samples/sec$", ln)
               for ln in tout.splitlines())
