"""The serving fleet (``serve/fleet.py``, ``serve/router.py``,
``serve/stub.py``) in the port, against the JAX package, on the CPU.

* ``FleetOptions.from_cfg``: the same fields and the same ``ValueError``
  messages as the JAX package over a parametrised set of confs;
  ``cli_spawn_fn``'s argv equals the JAX package's but for the module.
* Both stubs answer byte-equal to the same JSON and ``CXB1`` requests.
* One scenario script (:func:`scenarios`) runs on either package's
  fleet over that package's stubs: the admission sequence, the deadline
  split, a canary promote and a canary rollback driven one compared row
  at a time (so the decision and the publish pointer are deterministic;
  the pointer's clock is fixed), and the front door's ``/healthz``,
  ``/statsz`` and ``/metricsz`` with a ``CXB1`` relay.  The JAX side runs
  in a subprocess (its fleet families must not land in this process's
  JAX registry, which ``tests/test_obs.py`` checks); the results, the
  pointer files byte for byte and the key sets and family names must be
  equal.
* The port's fleet over the port's stubs: kill-one-of-three under load
  (zero non-200), the integrity quarantine, a rolling reload, the
  breaker abort, with the JAX tests' assertions.
* The ``serve.replica`` site on a real port server: ``hang`` wedges
  ``/healthz`` (in process, released by the injector's reset),
  ``ioerror`` ends a ``task=serve`` process with code 13 and a
  ``serve.replica_crash`` event.
* A real fleet of the port's CLI (``task=serve replicas=2 dev=cpu``) on
  a checkpoint the JAX package wrote: JSON and ``CXB1`` answers equal to
  the JAX engine's (scores within ``SCORE_ATOL``), then SIGTERM drains;
  a fleet whose replicas cannot reach their device (``dev=gpu`` here)
  exits non-zero after ``fleet_start_timeout_s``.
"""

import http.client
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTER_TIME = 1700000000.25  # the publish pointer's clock, both sides
SCORE_ATOL = 1e-6  # f32 scores of one checkpoint in both packages


# ----------------------------------------------------------------------
# the scenario script, package-agnostic (run in process for the port,
# as ``python tests/test_torch_fleet.py cxxnet_tpu <dir>`` for JAX)
def _mods(pkg):
    return types.SimpleNamespace(
        fleet=importlib.import_module(pkg + ".serve.fleet"),
        wire=importlib.import_module(pkg + ".serve.wire"),
        ckpt=importlib.import_module(pkg + ".utils.checkpoint"),
        alerts=importlib.import_module(pkg + ".obs.alerts"))


def make_opts(m, **kw):
    base = dict(
        replicas=2, probe_period_s=0.1, probe_timeout_s=0.5,
        slow_probes=3, start_timeout_s=60.0, restart_backoff_s=0.2,
        restart_backoff_max_s=0.5, replica_inflight=16,
        dispatch_retries=2, dispatch_timeout_s=5.0)
    base.update(kw)
    return m.fleet.FleetOptions(**base)


def start_stub_fleet(m, opts, per_replica=None, extra=(), model_dir=None):
    """A ServingFleet over stub replicas, started and ready (no front
    door bound: the caller drives ``fleet.router.route``)."""
    fleet = m.fleet.ServingFleet(opts, spawn_fn=m.fleet.stub_spawn_fn(
        extra=extra, per_replica=per_replica), model_dir=model_dir)
    fleet.supervisor.start()
    if not fleet.supervisor.wait_ready(timeout_s=60.0):
        snaps = [r.snapshot() for r in fleet.supervisor.replicas]
        fleet.close(drain_timeout_s=0.0)
        raise AssertionError(f"stub fleet never became ready: {snaps}")
    return fleet


def _admission(m):
    """The JAX ``test_admission_priority_ordering_unit`` sequence: every
    ``admit`` result, then the stats."""
    opts = make_opts(m, replica_inflight=10, batch_shed_ratio=0.5)
    fleet = m.fleet.ServingFleet(opts, spawn_fn=None)
    seq = []
    try:
        sup, router = fleet.supervisor, fleet.router
        r0 = sup.add_replica()
        r0.state = "healthy"
        seq.append(router.capacity())
        for _ in range(5):
            seq.append(router.admit("interactive"))
        seq += [router.admit("batch"), router.admit("interactive")]
        for _ in range(4):
            seq.append(router.admit("interactive"))
        seq += [router.admit("interactive"), router.admit("batch"),
                router.stats.inflight]
        r1 = sup.add_replica()
        r1.state = "healthy"
        seq += [router.capacity(), router.admit("interactive"),
                router.admit("batch")]
        for _ in range(11):
            router.stats.leave()
        seq.append(router.admit("batch"))
        router.stats.leave()
        seq.append(router.stats.snapshot())
    finally:
        fleet.close(drain_timeout_s=0.0)
    return seq


def _deadline(m):
    """The JAX ``test_deadline_budget_split_route_and_execute`` steps."""
    opts = make_opts(m, replicas=1, dispatch_retries=0)
    fleet = start_stub_fleet(m, opts, extra=("--delay-ms", "100"))
    out = {}
    try:
        route = fleet.router.route
        s, body = route("/predict", {"data": [[0.1] * 4],
                                     "deadline_ms": 10000})
        out["full"] = [s, 0 < body["deadline_ms"] < 10000, body["pred"]]
        s, body = route("/predict", {"data": [[0.1] * 4], "deadline_ms": 50})
        out["execute_spent"] = [s, body]
        before = fleet.supervisor.replicas[0].dispatched
        s, body = route("/predict", {"data": [[0.1] * 4], "deadline_ms": 1e-4})
        out["route_spent"] = [s, body]
        s, body = route("/predict", {"data": [[0.1] * 4],
                                     "deadline_ms": "abc"})
        out["bad"] = [s, body]
        out["dispatched_unchanged"] = (
            fleet.supervisor.replicas[0].dispatched == before)
        out["stats"] = fleet.router.stats.snapshot()
    finally:
        fleet.close(drain_timeout_s=0.0)
    return out


class _FixedClock:
    """``time`` for the checkpoint module with ``time()`` pinned, so two
    pointer files written in one scenario are byte-comparable."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return POINTER_TIME


def _canary(m, workdir, disagree):
    """A canary fleet (2 baselines, 1 int8 canary stub), every baseline
    answer mirrored (``canary_slice = 0``, ``canary_sample = 1``), driven
    one single-row request at a time until ``canary_min_requests`` rows
    are compared, then one ``decide``."""
    os.makedirs(workdir, exist_ok=True)
    opts = make_opts(
        m, replicas=3, canary="int8", canary_replicas=1, canary_slice=0.0,
        canary_sample=1.0, canary_min_requests=10,
        canary_min_agreement=0.99, canary_decision_period_s=999.0)

    def per_replica(r):
        if r.role == "canary":
            return ("--quant", "int8", "--disagree", str(disagree))
        return ()

    metrics = m.fleet.fleet_metrics()
    totals0 = {d: metrics.canary_total.labels(decision=d).value
               for d in ("promote", "rollback")}
    fleet = start_stub_fleet(m, opts, per_replica=per_replica,
                             model_dir=workdir)
    fleet.canary._arm_rule()  # the rule only: the test decides
    saved = m.ckpt.time
    m.ckpt.time = _FixedClock()
    out = {}
    try:
        canary = fleet.canary.canaries()[0]
        statuses = []
        for i in range(opts.canary_min_requests):
            want = fleet.canary.compared + 1
            s, _ = fleet.router.route("/predict",
                                      {"data": [[0.01 * (i % 50)] * 4]})
            statuses.append(s)
            deadline = time.monotonic() + 20.0
            while (fleet.canary.compared < want
                   and time.monotonic() < deadline):
                time.sleep(0.002)
        out["statuses"] = statuses
        out["compared"] = fleet.canary.compared
        out["agreement"] = fleet.canary.agreement()
        out["healthz_canary"] = sorted(fleet.healthz()["canary"])
        out["statsz_canary"] = sorted(fleet.statsz()["canary"])
        out["decision"] = fleet.canary.decide()
        out["state"] = fleet.canary.state
        out["reason"] = fleet.canary.decision_reason
        with open(m.ckpt.pointer_path(workdir), "rb") as f:
            out["pointer"] = f.read().decode("utf-8")
        out["totals"] = {d: metrics.canary_total.labels(decision=d).value
                         - totals0[d] for d in totals0}
        out["canary_role"] = canary.role
        out["canary_restarts"] = canary.restarts
        out["canary_down_reason"] = canary.down_reason
        out["canary_in_rotation"] = "canary" in {
            r.role for r in fleet.supervisor.rotation()}
        out["canary_live"] = fleet.router._canary_live()
        ev = m.alerts.evaluator()
        ev.evaluate_once()
        out["firing_after"] = ev.firing()
    finally:
        m.ckpt.time = saved
        fleet.close(drain_timeout_s=0.0)
        m.alerts.reset()
    return out


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=20) as r:
        return r.read()


def _post(port, path, body, ctype="application/json", headers=()):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": ctype, **dict(headers)})
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _surface(m):
    """The front door over two stubs: statuses, key sets, the fleet and
    canary family names in ``/metricsz``, a ``CXB1`` relay."""
    opts = make_opts(m, replicas=2)
    fleet = m.fleet.ServingFleet(opts, spawn_fn=m.fleet.stub_spawn_fn(),
                                 port=0)
    httpd = fleet.start()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_port
    out = {}
    try:
        body = json.dumps({"data": [[0.3] * 4]}).encode()
        s, raw, _ = _post(port, "/predict", body)
        out["predict"] = [s, json.loads(raw)]
        s, _, _ = _post(port, "/predict", body, headers=[("X-Priority",
                                                           "batch")])
        out["batch"] = [s, fleet.router.stats.requests["batch"]]
        s, raw, _ = _post(port, "/predict", json.dumps(
            {"data": [[0.3] * 4], "priority": "bulk"}).encode())
        out["bulk"] = [s, json.loads(raw)]
        s, raw, _ = _post(port, "/nope", body)
        out["unknown_route"] = s
        frame = m.wire.encode_request(
            [[[0.25, 0.5], [1.0, -2.0]], [[3.0, 0.0], [0.125, 4.0]]],
            kind="scores", priority="batch")
        s, raw, ctype = _post(port, "/predict", bytes(frame),
                              m.wire.CONTENT_TYPE)
        out["wire"] = [s, raw.hex(), ctype]
        s, raw, _ = _post(port, "/feedback", bytes(frame),
                          m.wire.CONTENT_TYPE)
        out["wire_feedback"] = [s, json.loads(raw)]
        h = json.loads(_get(port, "/healthz"))
        out["healthz"] = [sorted(h), sorted(h["replicas"]), h["status"],
                          h["replicas"]["healthy"]]
        st = json.loads(_get(port, "/statsz"))
        out["statsz"] = [sorted(st), sorted(st["replicas"][0]),
                         sorted(st["reload_breaker"]), len(st["replicas"])]
        text = _get(port, "/metricsz").decode()
        out["families"] = sorted(
            ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")
            and ln.split()[2].startswith(("fleet_", "canary_")))
        out["alertz"] = sorted(json.loads(_get(port, "/alertz")))
    finally:
        httpd.shutdown()
        thread.join(timeout=10)
        fleet.close(drain_timeout_s=0.0)
    return out


def scenarios(pkg, workdir):
    m = _mods(pkg)
    out = {"admission": _admission(m), "deadline": _deadline(m)}
    for name, disagree in (("promote", 0), ("rollback", 7)):
        out[name] = _canary(m, os.path.join(workdir, name), disagree)
    out["surface"] = _surface(m)
    return out


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    print(json.dumps(scenarios(sys.argv[1], sys.argv[2])), flush=True)
    sys.exit(0)


# ----------------------------------------------------------------------
# the tests (pytest imports below: the script above needs none of them)
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cxxnet_tpu.serve import fleet as jfleet  # noqa: E402

from cxxnet_tpu_torch.serve import fleet as tfleet  # noqa: E402
from cxxnet_tpu_torch.serve import router as trouter  # noqa: E402
from cxxnet_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from cxxnet_tpu_torch.utils import faults as tfaults  # noqa: E402

PORT = _mods("cxxnet_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _port_registry_as_found():
    """The fleet's families (an empty ``fleet_restart_seconds``
    histogram among them) leave the port's registry with this module, so
    a later exposition check in the same process sees what it saw
    before; the canary rule leaves the alert evaluator."""
    from cxxnet_tpu_torch.obs import registry

    before = {mm.name for mm in registry().metrics()}
    yield
    reg = registry()
    with reg._lock:
        for name in [n for n in reg._metrics if n not in before]:
            reg._metrics.pop(name, None)
    tfleet._METRICS = None
    # the engines' cached handles too: a serve_* family made here and
    # popped above would otherwise take a later engine's updates out of
    # the registry
    from cxxnet_tpu_torch.serve import metrics as tmetrics

    tmetrics._METRICS = None
    PORT.alerts.reset()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The scenario results of both packages: the JAX side in a
    subprocess started first, the port's in this process meanwhile."""
    work = tmp_path_factory.mktemp("fleet_scenarios")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "cxxnet_tpu",
         str(work / "jax")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(work), env=env)
    try:
        port = scenarios("cxxnet_tpu_torch", str(work / "port"))
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return {"port": port, "jax": json.loads(out.strip().splitlines()[-1])}


# ----------------------------------------------------------------------
# the config surface
CONFS = {
    "defaults": [],
    "full": [("replicas", "3"), ("fleet_probe_period_s", "0.5"),
             ("fleet_probe_timeout_s", "1.5"), ("fleet_slow_probes", "5"),
             ("fleet_start_timeout_s", "30"),
             ("fleet_restart_backoff_s", "0.25"),
             ("fleet_restart_backoff_max_s", "4"),
             ("fleet_max_restarts", "2"), ("fleet_replica_inflight", "8"),
             ("fleet_batch_shed_ratio", "0.75"),
             ("fleet_dispatch_retries", "1"),
             ("fleet_dispatch_timeout_s", "9"), ("fleet_pool_size", "3"),
             ("fleet_log_dir", "logs"), ("fleet_reload_timeout_s", "11"),
             ("fleet_reload_breaker_threshold", "2"), ("canary", "int8"),
             ("canary_replicas", "1"), ("canary_slice", "0.2"),
             ("canary_sample", "0.5"), ("canary_min_requests", "7"),
             ("canary_min_agreement", "0.95"),
             ("canary_decision_period_s", "0.5"), ("unrelated", "1")],
    "canary_off_0": [("canary", "0")],
    "canary_off_word": [("canary", "off")],
    "canary_none": [("canary", "none"), ("canary_replicas", "9")],
    "replicas_0": [("replicas", "0")],
    "slow_probes_0": [("fleet_slow_probes", "0")],
    "inflight_0": [("fleet_replica_inflight", "0")],
    "pool_0": [("fleet_pool_size", "0")],
    "shed_0": [("fleet_batch_shed_ratio", "0")],
    "shed_over": [("fleet_batch_shed_ratio", "1.5")],
    "no_baseline": [("replicas", "2"), ("canary", "int8"),
                    ("canary_replicas", "2")],
    "canary_0": [("replicas", "2"), ("canary", "int8"),
                 ("canary_replicas", "0")],
    "slice_over": [("replicas", "3"), ("canary", "int8"),
                   ("canary_slice", "1.5")],
    "sample_neg": [("replicas", "3"), ("canary", "int8"),
                   ("canary_sample", "-0.1")],
    "agreement_0": [("replicas", "3"), ("canary", "int8"),
                    ("canary_min_agreement", "0")],
    "bad_int": [("replicas", "two")],
}


def _options(mod, cfg):
    try:
        import dataclasses

        return dataclasses.asdict(mod.FleetOptions.from_cfg(cfg))
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("name", sorted(CONFS))
def test_fleet_options_match_jax(name):
    ours = _options(tfleet, CONFS[name])
    assert ours == _options(jfleet, CONFS[name])
    if name == "full":
        assert ours["canary"] == "int8" and ours["pool_size"] == 3


def test_cli_spawn_fn_argv_matches_jax(monkeypatch, tmp_path):
    """Same argv but the module name; only the fleet keys are pinned, a
    ``quant=`` override passes through unless a canary owns precision."""
    captured = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: captured.append((cmd, kw)) or object())
    overrides = ["quant=int8", "alert=slow:m:>:1", "replicas=5",
                 "serve_port=1234", "batch_timeout_ms=1", "controller=1",
                 "serve_reload_period=3", "task=serve", "serve_host=0.0.0.0"]
    cases = [({"replicas": 2}, "serve"),
             ({"replicas": 3, "canary": "int8", "canary_replicas": 1},
              "serve"),
             ({"replicas": 3, "canary": "int8", "canary_replicas": 1},
              "canary")]
    for kw, role in cases:
        argvs = []
        for mod in (tfleet, jfleet):
            opts = mod.FleetOptions(**kw)
            spawn = mod.cli_spawn_fn("net.conf", overrides, host="127.0.0.1",
                                     opts=opts, log_dir=str(tmp_path / "l"))
            spawn(mod.Replica(1, 7001, role=role))
            argvs.append(captured[-1][0])
            captured[-1][1]["stdout"].close()
        ours, ref = argvs
        assert ours[2] == "cxxnet_tpu_torch" and ref[2] == "cxxnet_tpu"
        assert ours[:2] + ours[3:] == ref[:2] + ref[3:]
        assert "replicas=1" in ours and "replicas=5" not in ours
        assert "serve_port=7001" in ours and "serve_port=1234" not in ours
        assert "alert=slow:m:>:1" in ours and "batch_timeout_ms=1" in ours
        if "canary" not in kw:
            assert "quant=int8" in ours
        elif role == "canary":
            assert "quant=int8" in ours
        else:
            assert "quant=0" in ours and "quant=int8" not in ours
    assert os.path.exists(tmp_path / "l" / "replica-1.log")


# ----------------------------------------------------------------------
# the stubs
def _start_stub(path, *args):
    port = tfleet.free_port()
    proc = subprocess.Popen([sys.executable, path, "--port", str(port),
                             *args], stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == f"STUB READY {port}"
    return proc, port


def test_stubs_answer_byte_equal(tmp_path):
    from cxxnet_tpu_torch.serve import wire

    round_file = tmp_path / "round.txt"
    round_file.write_text("4")
    args = ("--round-file", str(round_file), "--disagree", "2",
            "--quant", "int8", "--model", "m.model")
    stubs = [_start_stub(os.path.join(REPO, pkg, "serve", "stub.py"), *args)
             for pkg in ("cxxnet_tpu_torch", "cxxnet_tpu")]
    try:
        rng = np.random.RandomState(0)
        rows = rng.randn(3, 2, 2, 2).astype(np.float32)
        requests = [
            ("GET", "/healthz", None, None),
            ("GET", "/nope", None, None),
            ("POST", "/predict", json.dumps({"data": rows.reshape(3, -1)
                                             .tolist()}), "application/json"),
            ("POST", "/predict", json.dumps({"data": [0.5, 1.5],
                                             "deadline_ms": 40}),
             "application/json"),
            ("POST", "/predict", bytes(wire.encode_request(
                rows, kind="scores", deadline_ms=30)), wire.CONTENT_TYPE),
            ("POST", "/predict", b"CXB1\x00", wire.CONTENT_TYPE),
            ("POST", "/predict", b"XXXX" + bytes(20), wire.CONTENT_TYPE),
            ("POST", "/extract", bytes(wire.encode_request(rows)),
             wire.CONTENT_TYPE),
            ("POST", "/integrity", json.dumps({"failed": True}),
             "application/json"),
            ("GET", "/healthz", None, None),
            ("POST", "/integrity", json.dumps({"failed": False}),
             "application/json"),
            ("POST", "/reloadz", "", "application/json"),
            ("POST", "/nope", "{}", "application/json"),
        ]
        replies = []
        for _proc, port in stubs:
            got = []
            for method, path, body, ctype in requests:
                if path == "/reloadz":
                    round_file.write_text("5" if not replies else "6")
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                conn.request(method, path, body=body,
                             headers={"Content-Type": ctype} if ctype
                             else {})
                r = conn.getresponse()
                got.append((r.status, r.getheader("Content-Type"), r.read()))
                conn.close()
            replies.append(got)
        ours, ref = replies
        reload_at = [p for _m, p, _b, _c in requests].index("/reloadz")
        for i, (a, b) in enumerate(zip(ours, ref)):
            if i == reload_at:  # each stub read its own round file
                assert json.loads(a[2])["round"] == 5
                assert json.loads(b[2])["round"] == 6
                continue
            assert a == b, requests[i][:2]
        statuses = [s for s, _c, _b in ours]
        assert statuses == [200, 404, 200, 200, 200, 400, 400, 400, 200,
                            200, 200, 200, 404]
        _k, _rid, scores = wire.decode_response(ours[4][2])
        assert scores.shape == (3,)
    finally:
        for proc, _port in stubs:
            proc.kill()
            proc.wait()


# ----------------------------------------------------------------------
# the scenario script in both packages
def test_admission_sequence_matches_jax(both):
    ours, ref = both["port"]["admission"], both["jax"]["admission"]
    assert ours == ref
    stats = ours[-1]
    assert stats["requests"] == {"interactive": 12, "batch": 4}
    assert stats["shed"] == {"interactive": 1, "batch": 3}
    assert ours[0] == 10 and ours[12].startswith("at capacity")


def test_deadline_split_matches_jax(both):
    ours, ref = both["port"]["deadline"], both["jax"]["deadline"]
    assert ours == ref
    assert ours["full"][:2] == [200, True]
    assert ours["execute_spent"][0] == 504
    assert ours["route_spent"][0] == 504
    assert "before a replica" in ours["route_spent"][1]["error"]
    assert ours["bad"][0] == 400 and "deadline_ms" in ours["bad"][1]["error"]
    assert ours["dispatched_unchanged"] and ours["stats"]["expired"] == 1


def test_canary_promote_matches_jax(both):
    ours, ref = both["port"]["promote"], both["jax"]["promote"]
    assert ours == ref  # the pointer file byte for byte among them
    assert ours["statuses"] == [200] * 10 and ours["compared"] == 10
    assert ours["decision"] == "promote" and ours["state"] == "promoted"
    assert ours["agreement"] == 1.0
    ptr = json.loads(ours["pointer"])
    assert ptr["round"] == 1 and ptr["metric"]["scheme"] == "int8"
    assert ptr["time"] == POINTER_TIME
    assert ours["totals"] == {"promote": 1, "rollback": 0}
    assert ours["canary_in_rotation"] and ours["canary_live"] is False


def test_canary_rollback_matches_jax(both):
    ours, ref = both["port"]["rollback"], both["jax"]["rollback"]
    assert ours == ref
    assert ours["decision"] == "rollback" and ours["state"] == "rolled_back"
    assert ours["agreement"] < 0.99
    assert "canary_agreement firing" in ours["reason"]
    ptr = json.loads(ours["pointer"])
    assert ptr["round"] == 1 and ptr["metric"]["canary_agreement"] == 0.0
    assert ours["totals"] == {"promote": 0, "rollback": 1}
    assert ours["canary_role"] == "serve" and ours["canary_restarts"] >= 1
    assert ours["canary_down_reason"] == "canary_rollback"
    assert "canary_agreement" not in ours["firing_after"]


def test_front_door_surface_matches_jax(both):
    ours, ref = both["port"]["surface"], both["jax"]["surface"]
    assert ours == ref
    assert ours["predict"][0] == 200 and ours["predict"][1]["pred"]
    assert ours["batch"] == [200, 1]
    assert ours["bulk"][0] == 400
    assert "unknown priority" in ours["bulk"][1]["error"]
    assert ours["wire"][0] == 200 and ours["wire"][2] == "application/x-cxb"
    assert ours["wire_feedback"][0] == 400
    assert ours["healthz"][2:] == ["ok", 2]
    assert "fleet_requests_total" in ours["families"]


# ----------------------------------------------------------------------
# the port's fleet over the port's stubs (the JAX tests' assertions)
def test_kill_one_of_three_zero_nonshed_failures():
    opts = make_opts(PORT, replicas=3, probe_period_s=0.1, slow_probes=2,
                     probe_timeout_s=0.4, restart_backoff_s=0.2)
    fleet = start_stub_fleet(PORT, opts)
    try:
        statuses, stop, lock = [], threading.Event(), threading.Lock()

        def loader(i):
            k = 0
            while not stop.is_set():
                k += 1
                if k % 2:
                    s, body = fleet.router.route("/predict",
                                                 {"data": [[0.2] * 4]})
                else:
                    s, raw, _ = fleet.router.route_wire(
                        "/predict", PORT.wire.encode_request(
                            [[0.2] * 4], kind="scores"))
                    body = raw if s != 200 else None
                with lock:
                    statuses.append((s, body if s != 200 else None))
                time.sleep(0.01)

        loaders = [threading.Thread(target=loader, args=(i,))
                   for i in range(4)]
        for t in loaders:
            t.start()
        time.sleep(0.5)
        victim = fleet.supervisor.replicas[1]
        victim.proc.kill()  # SIGKILL, mid-load
        degraded_seen = False
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if fleet.healthz()["status"] != "ok":
                degraded_seen = True
            if (degraded_seen and victim.restarts >= 1
                    and victim.state == "healthy"):
                break
            time.sleep(0.05)
        time.sleep(0.3)
        stop.set()
        for t in loaders:
            t.join(timeout=30)
        assert degraded_seen
        assert victim.restarts >= 1 and victim.state == "healthy"
        assert fleet.supervisor.last_restart_wall_s > 0
        bad = [(s, b) for s, b in statuses if s != 200]
        assert not bad, f"{len(bad)} non-200 of {len(statuses)}: {bad[:5]}"
        assert len(statuses) > 50
    finally:
        fleet.close(drain_timeout_s=0.0)


def test_integrity_quarantine_ejects_without_kill_then_readmits():
    from cxxnet_tpu_torch.obs import events as obs_events

    fleet = start_stub_fleet(PORT, make_opts(PORT, replicas=3))
    try:
        victim = fleet.supervisor.replicas[1]
        pid, restarts = victim.pid, victim.restarts

        def flip(failed, want):
            s, raw, _ = _post(victim.port, "/integrity",
                              json.dumps({"failed": failed}).encode())
            assert s == 200 and json.loads(raw)["failed"] is failed
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline and victim.state != want:
                fleet.supervisor.probe_once()
                time.sleep(0.02)
            assert victim.state == want

        flip(True, "quarantined")
        assert victim not in fleet.supervisor.rotation()
        assert "integrity_failed" in victim.reasons
        s, body = fleet.router.route("/predict", {"data": [[0.2] * 4]})
        assert s == 200, body
        assert victim.pid == pid and victim.restarts == restarts
        assert victim.proc.poll() is None
        assert [e for e in obs_events.recent(
            200, kind="fleet.replica_quarantined")
            if e.get("replica") == victim.idx]
        flip(False, "healthy")
        assert victim in fleet.supervisor.rotation()
        assert victim.pid == pid and victim.restarts == restarts
        assert [e for e in obs_events.recent(
            200, kind="fleet.replica_readmitted")
            if e.get("replica") == victim.idx]
    finally:
        fleet.close(drain_timeout_s=0.0)


def test_rolling_reload_walks_rotation_then_breaker_aborts(tmp_path):
    round_file = tmp_path / "round.txt"
    round_file.write_text("1")
    fleet = start_stub_fleet(PORT, make_opts(PORT, replicas=2),
                             extra=("--round-file", str(round_file)))
    try:
        assert fleet.healthz()["round"] == 1
        round_file.write_text("2")
        out = fleet.rolling_reload(target_round=2)
        assert not out["aborted"]
        assert [x["ok"] for x in out["replicas"]] == [True, True]
        assert [x["swapped"] for x in out["replicas"]] == [True, True]
        assert fleet.healthz()["round"] == 2
        out = fleet.rolling_reload()
        assert [x["swapped"] for x in out["replicas"]] == [False, False]
        assert fleet.reload_breaker.state == "closed"
    finally:
        fleet.close(drain_timeout_s=0.0)

    opts = make_opts(PORT, replicas=2, reload_breaker_threshold=1,
                     reload_timeout_s=2.0)
    fleet = start_stub_fleet(PORT, opts)
    opts.probe_period_s = 30.0  # probes dormant from the next wait on
    time.sleep(0.3)  # past the wait that was running
    try:
        fleet.supervisor.replicas[0].proc.kill()
        time.sleep(0.2)
        out = fleet.rolling_reload(target_round=9)
        assert out["aborted"] is True
        assert len(out["replicas"]) == 1
        assert out["replicas"][0]["ok"] is False
        assert fleet.reload_breaker.state in ("open", "half-open")
    finally:
        fleet.close(drain_timeout_s=0.0)


def test_feedback_is_never_replayed():
    """A ``/feedback`` whose replica dies is relayed as 502, never
    retried on another replica or on a fresh connection."""
    opts = make_opts(PORT, replicas=2)
    fleet = start_stub_fleet(PORT, opts)
    opts.probe_period_s = 30.0  # the supervisor must not eject them first
    time.sleep(0.3)  # past the wait that was running
    try:
        for r in fleet.supervisor.replicas:
            r.proc.kill()
            r.proc.wait()
        s, body = fleet.router.route("/feedback", {"data": [[0.1] * 4]})
        assert s == 502 and "feedback is not retried" in body["error"]
        assert fleet.router.stats.failovers == 0
    finally:
        fleet.close(drain_timeout_s=0.0)


def test_pool_reuses_connections_and_retires_on_eject():
    pool = trouter._ReplicaPool("127.0.0.1:1", size=1)
    a, reused_a = pool.acquire(1.0)
    b, _ = pool.acquire(1.0)
    assert not reused_a
    assert pool.release(a) is True and pool.release(b) is False
    c, reused_c = pool.acquire(2.0)
    assert c is a and reused_c and c.timeout == 2.0
    pool.release(c)
    assert pool.retire_all() == 1 and pool.idle_count() == 0


# ----------------------------------------------------------------------
# the serve.replica site on a real port server
SMALL_CONF = """
netconfig = start
layer[0->c] = conv:cv1
  kernel_size = 3
  pad = 1
  nchannel = 4
  init_sigma = 0.3
layer[c->c] = relu
layer[c->f] = flatten
layer[f->fc1] = fullc:fc1
  nhidden = 6
  init_sigma = 0.3
layer[fc1->fc1] = softmax
netconfig = end
input_shape = 2,4,4
batch_size = 8
dev = cpu
seed = 5
"""
ROW = (4, 4, 2)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A checkpoint of the small net written by the JAX package."""
    from cxxnet_tpu import config as jcfg
    from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

    d = tmp_path_factory.mktemp("fleet_model")
    (d / "net.conf").write_text(SMALL_CONF)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(SMALL_CONF))
    jt.init_model()
    os.makedirs(d / "models")
    jt.save_model(str(d / "models" / "0001.model"))
    return d


def test_replica_site_hang_wedges_healthz(jax_model):
    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch import serve as tserve

    eng = tserve.Engine(cfg=tcfg.parse_pairs(SMALL_CONF),
                        model_in=str(jax_model / "models" / "0001.model"))
    httpd = tserve.make_server(eng, port=0)
    t = threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    port = httpd.server_port
    try:
        assert json.loads(_get(port, "/healthz"))["status"] == "ok"
        tfaults.reset()  # no other test's firings in the counts
        tfaults.configure([("fault_inject", "serve.replica:hang:1:1")])
        box = {}

        def probe():
            box["body"] = _get(port, "/healthz")

        hung = threading.Thread(target=probe, daemon=True)
        hung.start()
        hung.join(timeout=0.5)
        assert hung.is_alive()  # the probe is wedged
        assert json.loads(_get(port, "/statsz"))  # other routes answer
        assert tfaults.injector().fire_counts() == {"serve.replica:hang": 1}
        tfaults.reset()  # releases the hang
        hung.join(timeout=10)
        assert json.loads(box["body"])["status"] == "ok"
        assert json.loads(_get(port, "/healthz"))["status"] == "ok"
    finally:
        tfaults.reset()
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        eng.close()


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", *args], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait_port(port, proc, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()
        try:
            return json.loads(_get(port, "/healthz"))
        except (OSError, ValueError):
            time.sleep(0.1)
    raise AssertionError("server never answered /healthz")


@pytest.fixture(scope="module")
def replica_procs(jax_model):
    """Two ``task=serve`` processes of the port's CLI started together
    (their imports overlap): ``ioerror`` with ``serve.replica:ioerror``
    armed, ``no_device`` with ``dev=gpu`` on this card-less machine."""
    port = tfleet.free_port()
    model = f"model_in={jax_model / 'models' / '0001.model'}"
    conf = str(jax_model / "net.conf")
    procs = {
        "ioerror": (_cli([conf, "task=serve", "dev=cpu", model,
                          f"serve_port={port}",
                          f"event_log={jax_model / 'crash_events.jsonl'}",
                          "fault_inject=serve.replica:ioerror:1"],
                         str(jax_model)), port),
        "no_device": (_cli([conf, "task=serve", "dev=gpu", model,
                            f"serve_port={tfleet.free_port()}", "replicas=1"],
                           str(jax_model)), None)}
    yield procs
    for proc, _port in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_replica_site_ioerror_crashes_with_13(jax_model, replica_procs):
    proc, port = replica_procs["ioerror"]
    deadline = time.monotonic() + 60.0
    while proc.poll() is None and time.monotonic() < deadline:
        try:
            _get(port, "/healthz")
        except (OSError, ValueError):
            time.sleep(0.1)
    assert proc.wait(timeout=30) == 13
    kinds = [json.loads(ln)["kind"] for ln in
             (jax_model / "crash_events.jsonl").read_text().splitlines()]
    assert "serve.replica_crash" in kinds and "fault.injected" in kinds


def test_replica_without_its_device_raises(replica_procs):
    """The replica's own command line with ``dev=gpu`` on a machine
    without a card: it raises and exits non-zero, no CPU fallback."""
    proc, _port = replica_procs["no_device"]
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "needs a CUDA device and none is available" in out, out[-2000:]


def test_replica_exports_its_launches_by_c_entry(monkeypatch):
    """A replica's launches are read from outside its process:
    ``kernel_launches_total{kernel,name}`` in ``/metricsz`` counts each
    C entry's launches since the process began, and ``reset_counts``
    (which zeroes ``launches`` and ``by_symbol``) leaves it alone."""
    from cxxnet_tpu_torch.obs import registry
    from cxxnet_tpu_torch.ops import _build

    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    k = _build.Kernel("fleet_test_kernel", "test:1")
    monkeypatch.setattr(k, "_load", lambda: types.SimpleNamespace(
        fleet_test_kernel_f32=entry))
    reg = registry()
    had = _build.launch_collector in reg._collectors
    try:
        assert "fleet_test_kernel" not in reg.render_prometheus()
        for _ in range(3):
            k.launch("fleet_test_kernel_f32", [])
        k.reset_counts()
        k.launch("fleet_test_kernel_f32", [])
        text = reg.render_prometheus()
        assert (k.launches, k.by_symbol, len(calls)) == (
            1, {"fleet_test_kernel_f32": 1}, 4)
        assert ('kernel_launches_total{kernel="fleet_test_kernel",'
                'name="fleet_test_kernel_f32"} 4') in text
        assert "# TYPE kernel_launches_total counter" in text
        assert ('kernel_selected{name="fleet_test_kernel_f32",'
                'backend="cuda"} 1') in text
    finally:
        _build.INSTANCES.remove(k)
        if not had:
            reg.unregister_collector(_build.launch_collector)


# ----------------------------------------------------------------------
# a real fleet of the port's CLI
def _run_fleet_task(argv, drive):
    """``LearnTask().run(argv)`` of a fleet on this (the main) thread;
    ``drive()`` runs on a thread and SIGTERM ends the task when it
    returns or fails.  Returns drive's result."""
    from cxxnet_tpu_torch.cli import LearnTask

    box = {}

    def drive_then_stop():
        try:
            box["out"] = drive()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    # the task installs its own handlers while it runs; ours catches a
    # SIGTERM that lands outside them
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    t = threading.Thread(target=drive_then_stop, daemon=True)
    t.start()
    try:
        LearnTask().run(argv)
    except SystemExit:  # a SIGTERM while the replicas booted
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        t.join(timeout=30)
    if "err" in box:
        raise box["err"]
    return box["out"]


def test_cli_fleet_answers_like_the_jax_engine(jax_model, capsys):
    """The fleet task runs in this process; its two replicas are real
    ``task=serve`` children of the port's CLI."""
    from cxxnet_tpu import config as jcfg
    from cxxnet_tpu import serve as jserve
    from cxxnet_tpu_torch.serve import wire

    port = tfleet.free_port()
    jeng = jserve.Engine(cfg=jcfg.parse_pairs(SMALL_CONF),
                         model_in=str(jax_model / "models" / "0001.model"),
                         max_batch_size=8, batch_timeout_ms=1)
    x = np.random.RandomState(3).randn(5, *ROW).astype(np.float32)

    def drive():
        deadline = time.monotonic() + 60.0
        while True:
            try:
                h = json.loads(_get(port, "/healthz"))
                break
            except (OSError, ValueError):
                assert time.monotonic() < deadline, "no front door"
                time.sleep(0.1)
        assert h["fleet"] is True and h["rotation"] == 2 and h["round"] == 1
        out = {}
        for name, body, ctype in (
                ("json", json.dumps({"data": x.tolist(), "raw": True}),
                 "application/json"),
                ("wire", bytes(wire.encode_request(x, kind="scores")),
                 wire.CONTENT_TYPE),
                ("pred", json.dumps({"data": x.tolist()}),
                 "application/json")):
            s, raw, rtype = _post(port, "/predict", body.encode()
                                  if isinstance(body, str) else body, ctype)
            assert s == 200 and rtype.startswith(ctype), raw
            out[name] = raw
        out["statsz"] = json.loads(_get(port, "/statsz"))
        return out

    try:
        out = _run_fleet_task([
            str(jax_model / "net.conf"), "task=serve", "replicas=2",
            "dev=cpu", f"model_dir={jax_model / 'models'}",
            f"serve_port={port}", "fleet_probe_period_s=0.2",
            "batch_timeout_ms=1"], drive)
        ref = np.asarray(jeng.submit(x, kind="scores"))
        np.testing.assert_allclose(np.asarray(json.loads(out["json"])[
            "scores"]), ref, atol=SCORE_ATOL, rtol=0)
        _k, _rid, scores = wire.decode_response(out["wire"])
        np.testing.assert_allclose(scores, ref, atol=SCORE_ATOL, rtol=0)
        assert json.loads(out["pred"])["pred"] == np.asarray(
            jeng.submit(x)).tolist()
    finally:
        jeng.close()
    st = out["statsz"]
    assert sum(r["dispatched"] for r in st["replicas"]) == 3
    assert all(r["state"] == "healthy" for r in st["replicas"])
    assert sorted(os.listdir(jax_model / "models" / "fleet_logs")) == [
        "replica-0.log", "replica-1.log"]
    text = capsys.readouterr().out
    assert "fleet: serving 2/2 replica(s) (round 1)" in text
    assert "fleet: shutdown complete" in text


def test_cli_fleet_that_cannot_start_raises(jax_model, monkeypatch):
    """Replicas that exit at start are seen GONE, and a fleet with no
    healthy replica after ``fleet_start_timeout_s`` raises from the CLI
    task (a non-zero exit), its children reaped."""
    import subprocess as sp

    from cxxnet_tpu_torch.cli import LearnTask
    from cxxnet_tpu_torch.obs import events as obs_events

    procs = []

    def spawn_fn(*_a, **_k):
        def spawn(r):
            p = sp.Popen([sys.executable, "-c", "raise SystemExit(3)"])
            procs.append(p)
            return p
        return spawn

    monkeypatch.setattr(tfleet, "cli_spawn_fn", spawn_fn)
    with pytest.raises(RuntimeError,
                       match="no replica became healthy within 2s"):
        LearnTask().run([
            str(jax_model / "net.conf"), "task=serve", "replicas=2",
            "dev=cpu", f"serve_port={tfleet.free_port()}",
            "fleet_probe_period_s=0.1", "fleet_start_timeout_s=2",
            "fleet_restart_backoff_s=0.2"])
    gone = [e for e in obs_events.recent(500, kind="fleet.replica_gone")
            if e.get("detail") == "process exited rc=3"]
    assert len(gone) >= 2
    assert len(procs) >= 3  # restarted with backoff meanwhile
    assert all(p.poll() is not None for p in procs)
