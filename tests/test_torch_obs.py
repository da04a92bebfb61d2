"""The port's observability plane against the JAX package's ``obs/``.

* the registry renders byte for byte what the JAX registry renders for
  one sequence of operations (label escaping, histogram buckets, a
  failing gauge function, a collector), and both expositions pass the
  Prometheus text validator of ``tools/obs_dump.py``;
* the event logs keep equal records but for their timestamps, dedupe
  alike and rotate into the same files;
* the span trees (names, parents, threads, args) and the exported
  Chrome trace window are equal;
* the alert evaluators walk the same states under one fake clock;
* a CPU scrape is valid and carries no device-memory series; the
  sampled step wait lands in ``train_step_device_seconds``;
* the same request sequence moves the same ``serve_*`` families on
  both servers (the JAX server in a subprocess, so the JAX process-wide
  registry of this process stays as it was);
* a small CLI train writes the same sequence of event kinds in both
  packages (each CLI in its own subprocess), but for the JAX package's
  ``device.program`` events, which read XLA's cost analysis.

Tolerances: none; every comparison here is exact.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from cxxnet_tpu.obs import alerts as jalerts
from cxxnet_tpu.obs import events as jevents
from cxxnet_tpu.obs import trace as jtrace
from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import obs as tobs
from cxxnet_tpu_torch.obs import alerts as talerts
from cxxnet_tpu_torch.obs import events as tevents
from cxxnet_tpu_torch.obs import trace as ttrace

# the packages export a ``registry()`` function under the module's name
jregistry = importlib.import_module("cxxnet_tpu.obs.registry")
tregistry = importlib.import_module("cxxnet_tpu_torch.obs.registry")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import obs_dump  # noqa: E402 - the JAX package's exposition validator

def _problems(text):
    """The validator's findings but one: a histogram family created and
    never observed renders no ``_bucket`` line, in both packages alike
    (the registry tests hold that byte for byte)."""
    return [p for p in obs_dump.validate_prometheus_text(text)
            if not p.endswith("histogram with no _bucket samples")]


PKGS = {"jax": (jregistry, jevents, jtrace, jalerts),
        "port": (tregistry, tevents, ttrace, talerts)}


def _drive_registry(mod):
    """One sequence of registry operations; returns the registry."""
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", 'tricky "help"\nwith a newline',
                    labelnames=("path", "code"))
    c.labels(path='a\\b"c\nd', code=200).inc()
    c.labels(path="/x", code="500").inc(2.5)
    reg.counter("plain_total", "no labels").inc(3)
    g = reg.gauge("depth", "live")
    g.set(-1.5)
    broken = reg.gauge("broken", "raises at scrape")
    broken.set_function(lambda: 1 / 0)
    reg.gauge("big", "a large value").set(1e17)
    h = reg.histogram("lat_seconds", "latency", labelnames=("op",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.001, 0.05, 0.5, 3.0, float("nan")):
        h.labels(op="predict").observe(v)
    reg.histogram("empty_seconds", "no observations")
    reg.histogram("inf_seconds", "", buckets=(1,)).observe(float("inf"))

    def collector():
        return [("rows_total", "counter", "collected",
                 [({"stage": "decode", "a": 'q"'}, 7)])]

    reg.register_collector(collector)
    reg.register_collector(lambda: 1 / 0)  # a bad collector is skipped
    return reg


def test_registry_renders_byte_equal_to_the_jax_registry():
    out = {}
    for name, (reg_mod, *_rest) in PKGS.items():
        reg = _drive_registry(reg_mod)
        out[name] = (reg.render_prometheus(), reg.snapshot())
        with pytest.raises(ValueError):
            reg.gauge("req_total")  # a kind conflict raises in both
        with pytest.raises(ValueError):
            reg.histogram("lat_seconds", labelnames=("op",), buckets=(1, 2))
    assert out["jax"][0] == out["port"][0]
    # the snapshots hold a NaN sum: compare their JSON spelling
    assert (json.dumps(out["jax"][1], sort_keys=True)
            == json.dumps(out["port"][1], sort_keys=True))
    assert _problems(out["port"][0]) == []
    assert 'path="a\\\\b\\"c\\nd"' in out["port"][0]


@pytest.mark.parametrize("window,values", [
    (4, [3.0, 1.0, 2.0]), (3, [float(v) for v in range(10)]), (1, [5.0])])
def test_percentile_window_equal(window, values):
    got = []
    for reg_mod, *_rest in PKGS.values():
        w = reg_mod.PercentileWindow(window)
        for v in values:
            w.add(v)
        got.append((w.summary(scale=1e3), w.percentiles((10, 50, 99)),
                    w.count))
    assert got[0] == got[1]


def _no_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def _drive_events(mod, path=None, max_bytes=1024, backups=2):
    log = mod.EventLog(ring=8)
    if path:
        log.configure([("event_log", path),
                       ("event_log_max_bytes", str(max_bytes)),
                       ("event_log_backups", str(backups))])
    log.emit("checkpoint.save", ok=True, path="m/0001.model", round=1,
             bytes=np.int64(3183))
    log.emit("serve.reload", ts=5, kind="shadowed", detail=("a", 1),
             arr={"x": np.float32(0.5)}, obj=object.__name__)
    for i in range(40):
        log.emit("data.quarantined", what="imgbin", source="a.bin",
                 offset=i, reason="ValueError: bad " + "x" * 20)
    assert log.emit_once("k", "serve.skip", round=3)
    assert not log.emit_once("k", "serve.skip", round=3)
    log.log_exception_once("e", ValueError("boom"), kind="obs.err", n=1)
    log.log_exception_once("e", ValueError("boom"), kind="obs.err", n=1)
    return log


def test_event_records_equal_but_for_timestamps(tmp_path):
    recs, files = {}, {}
    for name, (_r, ev_mod, *_rest) in PKGS.items():
        d = tmp_path / name
        log = _drive_events(ev_mod, str(d / "events.jsonl"))
        recs[name] = (_no_ts(log.recent(50)), log.recent(3, "serve.skip"),
                      log.suppressed_count("e"), log.dropped)
        files[name] = {
            f: _no_ts([json.loads(x) for x in (d / f).read_text()
                       .splitlines()])
            for f in sorted(os.listdir(d))}
    assert recs["jax"][0] == recs["port"][0]
    assert len(recs["port"][0]) == 8  # the ring keeps the newest 8
    assert _no_ts(recs["jax"][1]) == _no_ts(recs["port"][1])
    assert recs["jax"][2:] == recs["port"][2:] == (2, 0)
    # rotation: the same backups with the same records in each
    assert files["jax"] == files["port"]
    assert sorted(files["port"]) == ["events.jsonl", "events.jsonl.1",
                                     "events.jsonl.2"]


def test_event_log_holdoff_and_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    out = {}
    for name, (_r, ev_mod, *_rest) in PKGS.items():
        log = ev_mod.EventLog()
        # the sink's directory is a file: every write fails, emit does not
        log.configure([("event_log", str(blocker / "events.jsonl")),
                       ("event_log_holdoff_s", "60")])
        for _ in range(3):
            log.emit("x", a=1)
        out[name] = (log.dropped, len(log.recent()))
    assert out["jax"] == out["port"] == (3, 3)


def _span_tree(tr_mod, tmp_path):
    tr = tr_mod.Tracer(ring=64)
    tr.configure([("trace_dir", str(tmp_path)), ("trace_steps", "2")])

    def work(tag):
        with tr.span("serve.batch", kind="scores", rows=np.int64(7)) as s:
            with tr.span("inner", tag=tag):
                pass
            s.set(done=True)

    with tr.span("train.round", round=1):
        for step in range(3):
            tr.step(step)
            with tr.span("train.dispatch", steps=1):
                pass
        th = threading.Thread(target=work, args=("t",), name="worker")
        th.start()
        th.join()
    work("main")
    by_id = {s.span_id: s for s in tr.spans()}
    tree = [(s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else s.parent_id, s.thread_name, s.args) for s in tr.spans()]
    exported = sorted(os.listdir(tmp_path))
    events = json.loads((tmp_path / exported[0]).read_text())["traceEvents"]
    keep = [(e["name"], e["ph"], {k: v for k, v in e["args"].items()
                                  if k not in ("span_id", "parent_id")})
            for e in events if e["ph"] == "X"]
    return tree, exported, keep, tr.enabled


def test_span_trees_and_the_exported_window_are_equal(tmp_path):
    out = {n: _span_tree(m[2], tmp_path / n) for n, m in PKGS.items()}
    assert out["jax"] == out["port"]
    tree, exported, keep, enabled = out["port"]
    assert exported == ["host_trace_000000-000001.json"]
    assert not enabled  # one window a process, then off
    assert [k[0] for k in keep] == ["train.dispatch"]


def test_disabled_tracing_is_a_shared_noop():
    tr = ttrace.Tracer()
    assert tr.span("a") is tr.span("b")
    with tr.span("a") as s:
        s.set(x=1)
    assert tr.spans() == []


def _alert_run(reg_mod, ev_mod, al_mod):
    reg = reg_mod.MetricsRegistry()
    ev = al_mod.AlertEvaluator(registry=reg, period_s=1.0)
    ev.configure([
        ("alert", "deep:depth:>:5"),
        ("alert", "slow:lat_seconds_mean:>=:0.5:2"),
        ("alert", 'shed:req_rate{code="429"}:gt:1'),
        ("alert", 'mem:xla_device_memory_bytes{device="cuda:0",'
                  'stat="peak_bytes_in_use"}:>:100'),
        ("alert_period_s", "0.5"),
    ])
    with pytest.raises(ValueError):
        al_mod.parse_rule("bad:metric:~:1")
    g = reg.gauge("depth")
    c = reg.counter("req_total", labelnames=("code",))
    h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))

    def mem():
        return [("xla_device_memory_bytes", "gauge", "",
                 [({"device": "cuda:0", "stat": "peak_bytes_in_use"},
                   mem.v)])]

    mem.v = 50.0
    reg.register_collector(mem)
    states = []
    script = [(0.0, 1, 0, None, 50), (1.0, 7, 3, 0.9, 150),
              (2.0, 7, 4, 0.9, 150), (3.5, 7, 4, 0.8, 150),
              (4.0, 2, 4, None, 50), (5.0, 2, 0, 0.01, 50)]
    for now, depth, n429, lat, peak in script:
        g.set(depth)
        c.labels(code="429").inc(n429)
        if lat is not None:
            h.observe(lat)
        mem.v = float(peak)
        emitted = ev.evaluate_once(now=now)
        st = ev.status()
        states.append(([(r["name"], r["state"], r["value"])
                        for r in st["rules"]], st["firing"], ev.firing(),
                       [{k: v for k, v in e.items() if k != "ts"}
                        for e in emitted]))
    return states, ev.period_s, ev.evaluations


def test_alert_states_equal_under_one_fake_clock():
    out = {n: _alert_run(m[0], m[1], m[3]) for n, m in PKGS.items()}
    assert out["jax"] == out["port"]
    states = out["port"][0]
    assert states[1][1] == ["deep", "mem", "shed"]
    assert states[2][1] == ["deep", "mem", "shed"]  # slow: pending
    assert states[3][1] == ["deep", "mem", "shed", "slow"]  # held 2 s
    assert states[4][1] == ["shed"]
    assert states[5][1] == []


def test_cpu_scrape_is_valid_and_has_no_memory_series():
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.obs import device as tdevice

    tdevice.configure([("device_sample_every", "2")])
    try:
        tr = NetTrainer()
        tr.set_params(tcfg.parse_pairs(NET))
        tr.init_model()
        rs = np.random.RandomState(0)
        before = tdevice.summary()["sampled_steps"]
        tr.update_scan(rs.rand(4, 4, 5, 5, 2).astype(np.float32),
                       rs.randint(0, 3, (4, 4)).astype(np.float32))
        assert tdevice.summary()["sampled_steps"] - before == 2
    finally:
        tdevice.configure([("device_sample_every", "0")])
    text = tobs.registry().render_prometheus()
    assert _problems(text) == []
    assert "xla_device_memory_bytes" not in text
    assert tdevice.memory_samples() == []
    assert "train_step_device_seconds_count" in text
    assert 'train_state_shard_bytes{device="cpu:0"}' in text


NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 4
  pad = 1
layer[1->2] = relu
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 3
layer[4->4] = softmax
netconfig = end
input_shape = 2,5,5
batch_size = 4
dev = cpu
eta = 0.1
momentum = 0.9
eval_train = 0
metric = error
"""

_JAX_SERVER = r"""
import json, sys, threading, urllib.request
import numpy as np
from cxxnet_tpu import config as cfgmod
from cxxnet_tpu.nnet.trainer import NetTrainer
from cxxnet_tpu.serve.engine import Engine
from cxxnet_tpu.serve.server import make_server
from cxxnet_tpu.serve import wire
conf, model, reqs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
cfg = cfgmod.parse_pairs(open(conf).read())
eng = Engine(cfg, model_in=model, max_batch_size=8)
httpd = make_server(eng, port=0)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
port = httpd.server_port
def get(path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}").read()
before = get("/metricsz").decode()
for kind, n, seed in reqs:
    rows = np.random.RandomState(seed).rand(n, 5, 5, 2).astype(np.float32)
    if kind == "json":
        body, ctype = json.dumps({"data": rows.tolist()}).encode(), "application/json"
    else:
        body, ctype = wire.encode_request(rows, kind="scores"), wire.CONTENT_TYPE
    urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": ctype})).read()
after = get("/metricsz").decode()
print(json.dumps({"before": before, "after": after,
                  "alertz": json.loads(get("/alertz"))}))
httpd.shutdown(); eng.close()
"""

REQS = [["json", 1, 0], ["json", 3, 1], ["binary", 2, 2], ["json", 8, 3]]
SERVE_COUNTERS = ("serve_requests_total", "serve_request_rows_total",
                  "serve_batches_total", "serve_batch_rows_total",
                  "serve_bucket_rows_total", "serve_request_outcomes_total",
                  "serve_request_bucket_total", "serve_wire_requests_total",
                  "serve_wire_bytes_total", "serve_request_latency_seconds_count")


def _samples(text):
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def _families(text, prefix="serve_"):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ") and line.split()[2].startswith(prefix)}


def _deltas(before, after):
    b, a = _samples(before), _samples(after)
    return {k: v - b.get(k, 0.0) for k, v in a.items()
            if k.split("{")[0] in SERVE_COUNTERS and v - b.get(k, 0.0)}


def test_same_requests_move_the_same_metricsz_families(tmp_path):
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import wire as twire
    from cxxnet_tpu_torch.serve.engine import Engine
    from cxxnet_tpu_torch.serve.server import make_server

    conf = tmp_path / "net.conf"
    conf.write_text(NET)
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET))
    tr.init_model()
    model = str(tmp_path / "0001.model")
    tr.save_model(model, round_=1)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SERVER, str(conf), model,
                        json.dumps(REQS)], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    jax_out = json.loads(r.stdout.strip().splitlines()[-1])

    eng = Engine(tcfg.parse_pairs(NET), model_in=model, max_batch_size=8)
    httpd = make_server(eng, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        before = urllib.request.urlopen(url + "/metricsz").read().decode()
        for kind, n, seed in REQS:
            rows = np.random.RandomState(seed).rand(n, 5, 5, 2).astype(
                np.float32)
            if kind == "json":
                body = json.dumps({"data": rows.tolist()}).encode()
                ctype = "application/json"
            else:
                body = twire.encode_request(rows, kind="scores")
                ctype = twire.CONTENT_TYPE
            urllib.request.urlopen(urllib.request.Request(
                url + "/predict", data=body,
                headers={"Content-Type": ctype})).read()
        resp = urllib.request.urlopen(url + "/metricsz")
        ctype = resp.headers["Content-Type"]
        after = resp.read().decode()
        alertz = json.loads(urllib.request.urlopen(url + "/alertz").read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.close()
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    assert _problems(after) == []
    assert _families(after) == _families(jax_out["after"])
    got = _deltas(before, after)
    assert got == _deltas(jax_out["before"], jax_out["after"])
    assert got["serve_requests_total"] == len(REQS)
    assert got["serve_request_rows_total"] == sum(n for _k, n, _s in REQS)
    assert got['serve_wire_requests_total{wire="binary"}'] == 1
    assert _samples(after)["serve_model_round"] == 1
    assert set(alertz) == set(jax_out["alertz"])


def _cli_events(pkg, conf, tmp_path):
    d = tmp_path / pkg
    d.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", pkg, str(conf), "model_dir=m",
         "event_log=ev/events.jsonl", "trace_dir=tr", "trace_steps=1000",
         "dev=cpu", "silent=1"],
        capture_output=True, text=True, cwd=str(d), env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(x) for x in
            (d / "ev" / "events.jsonl").read_text().splitlines()]
    tr = json.loads(next((d / "tr").iterdir()).read_text())["traceEvents"]
    return recs, tr, r.stderr


def test_cli_train_writes_the_same_event_kinds(tmp_path):
    conf = tmp_path / "train.conf"
    conf.write_text(CLI_CONF)
    out = {pkg: _cli_events(pkg, conf, tmp_path)
           for pkg in ("cxxnet_tpu", "cxxnet_tpu_torch")}
    kinds = {pkg: [r["kind"] for r in recs
                   if not r["kind"].startswith("device.")]
             for pkg, (recs, _tr, _err) in out.items()}
    assert kinds["cxxnet_tpu"] == kinds["cxxnet_tpu_torch"]
    assert kinds["cxxnet_tpu_torch"] == [
        "checkpoint.save", "train.start", "checkpoint.save",
        "checkpoint.save", "train.end"]
    fields = {pkg: [{k: v for k, v in r.items()
                     if k not in ("ts", "elapsed_s")} for r in recs
                    if not r["kind"].startswith("device.")]
              for pkg, (recs, _tr, _err) in out.items()}
    assert fields["cxxnet_tpu"] == fields["cxxnet_tpu_torch"]
    # the eval lines agree too, and the port's spans nest under rounds
    assert out["cxxnet_tpu"][2].splitlines()[-1] == \
        out["cxxnet_tpu_torch"][2].splitlines()[-1]
    spans = [e for e in out["cxxnet_tpu_torch"][1] if e["ph"] == "X"]
    rounds = {e["args"]["span_id"] for e in spans
              if e["name"] == "train.round"}
    assert len(rounds) == 2
    assert {e["args"]["parent_id"] for e in spans
            if e["name"] in ("train.dispatch", "train.device_wait")} == rounds
    assert sum(e["name"] == "train.dispatch" for e in spans) == 8


CLI_CONF = """
data = train
iter = synthetic
  nsample = 32
  input_shape = 2,5,5
  nclass = 3
  seed = 1
iter = end
eval = test
iter = synthetic
  nsample = 16
  input_shape = 2,5,5
  nclass = 3
  seed = 2
iter = end
""" + NET.replace("batch_size = 4", "batch_size = 8").replace(
    "eval_train = 0", "num_round = 2")
