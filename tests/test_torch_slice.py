"""The serving slice end to end: GoogLeNet through a shared checkpoint.

The JAX ``NetTrainer`` builds the full GoogLeNet graph at 64x64 (still
13 max pools, 2 LRNs and 9 sibling-1x1 groups, and partial ceil windows
at the first pool), writes a checkpoint, and the port loads it on the
CPU (plain versions of the kernels).  Scores agree to atol 1e-5 /
rtol 1e-4: both sides compute in f32, but oneDNN and XLA sum the conv
and GEMM products in other orders.  The reverse direction (a checkpoint
the port writes, loaded by the JAX package) holds to the same bound.
The port's ``Engine`` and its HTTP server answer exactly what the
direct ``predict_fn`` computes at the request's bucket, and the CLI
serves and drains on SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.models import googlenet_conf
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import Engine, make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = googlenet_conf(input_size=64, batch_size=4, compute_dtype="float32",
                      dev="cpu")
ATOL, RTOL = 1e-5, 1e-4


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


def _batch(n, seed=0):
    return np.random.RandomState(seed).rand(n, 64, 64, 3).astype(np.float32)


def _assert_scores_close(got, ref):
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(got.argmax(1)[clear], ref.argmax(1)[clear])


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A GoogLeNet checkpoint written by the JAX package, and its scores."""
    tr = JaxTrainer()
    tr.set_params(jcfg.parse_pairs(CONF))
    tr.set_param("seed", "3")
    tr.init_model()
    path = str(tmp_path_factory.mktemp("gn") / "0001.model")
    tr.save_model(path)
    x = _batch(4)
    ref = np.asarray(tr.predict_fn()(tr.params, tr.aux, x, ()))
    return path, x, ref


def _torch_trainer(path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(CONF))
    tr.load_model(path)
    return tr


def test_googlenet_graph_has_the_slice_kernels(jax_ckpt):
    tr = _torch_trainer(jax_ckpt[0])
    layers = tr.net.layer_objs
    assert sum(type(l).__name__ == "MaxPoolingLayer" for l in layers) == 13
    assert sum(type(l).__name__ == "LRNLayer" for l in layers) == 2
    groups, _ = tr.net._sibling_1x1_groups()
    assert len(groups) == 9 and all(len(g) == 3 for g in groups.values())


def test_jax_checkpoint_scores_match_in_the_port(jax_ckpt):
    path, x, ref = jax_ckpt
    tr = _torch_trainer(path)
    assert tr.device == torch.device("cpu")
    got = tr.predict_fn()(tr.params, tr.aux, x, ()).numpy()
    assert got.shape == ref.shape == (4, 1000)
    _assert_scores_close(got, ref)


def test_port_checkpoint_scores_match_in_jax(tmp_path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(CONF))
    tr.set_param("seed", "5")
    tr.init_model()
    path = str(tmp_path / "0002.model")
    tr.save_model(path, round_=2)
    x = _batch(4, seed=1)
    got = tr.predict_fn()(tr.params, tr.aux, x, ()).numpy()

    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(CONF))
    jt.load_model(path)
    ref = np.asarray(jt.predict_fn()(jt.params, jt.aux, x, ()))
    _assert_scores_close(got, ref)
    # same structure, same fingerprint: each package validates the other's
    from cxxnet_tpu.utils import checkpoint as jckpt
    assert jckpt.validate_checkpoint(path, net_fp=jt.net_fp()) is None
    assert tr.net_fp() == jt.net_fp()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_engine_and_http_answers_equal_predict_fn(jax_ckpt):
    import threading

    path, _, _ = jax_ckpt
    x = _batch(4, seed=2)
    with Engine(cfg=CONF, model_in=path, max_batch_size=4,
                batch_timeout_ms=0.0) as eng:
        tr = eng.trainer
        httpd = make_server(eng, port=0)
        th = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
        th.start()
        try:
            for n in (1, 3, 4):
                bucket = 1 << (n - 1).bit_length()
                padded = np.zeros((bucket, 64, 64, 3), np.float32)
                padded[:n] = x[:n]
                direct = tr.predict_fn()(tr.params, tr.aux, padded,
                                         ()).numpy()[:n]
                np.testing.assert_array_equal(eng.scores(x[:n]), direct)
                np.testing.assert_array_equal(
                    eng.predict(x[:n]), direct.argmax(1).astype(np.float32))
                got = _post(httpd.server_port,
                            {"data": x[:n].tolist(), "raw": True})
                np.testing.assert_array_equal(
                    np.asarray(got["scores"], np.float32), direct)
                pred = _post(httpd.server_port, {"data": x[:n].tolist()})
                assert pred["pred"] == direct.argmax(1).tolist()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{httpd.server_port}/healthz",
                    timeout=10) as r:
                h = json.loads(r.read())
            assert h["status"] == "ok" and h["round"] == 0  # the manifest's
            assert h["net_fp"] == tr.net_fp() and h["device"] == "cpu"
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=10)
    assert not th.is_alive()


def test_cli_serves_and_drains_on_sigterm(jax_ckpt, tmp_path):
    conf = tmp_path / "gn64.conf"
    conf.write_text(CONF)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cxxnet_tpu_torch", str(conf), "task=serve",
         f"model_in={jax_ckpt[0]}", "serve_port=0", "silent=1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path), env=env)
    try:
        line = proc.stdout.readline()
        assert "serving model round 0" in line and "on cpu" in line, line
        port = int(line.rsplit(":", 1)[1])
        got = _post(port, {"data": _batch(2).tolist()})
        assert len(got["pred"]) == 2
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "serve: shutdown complete" in out


def test_cli_refuses_tasks_of_later_slices(tmp_path):
    """The serving fleet is a later slice; the closed loop's tasks run
    and refuse what the JAX package refuses."""
    from cxxnet_tpu_torch.cli import LearnTask

    conf = tmp_path / "gn64.conf"
    conf.write_text(CONF)
    with pytest.raises(ValueError, match="single-replica"):
        LearnTask().run([str(conf), "task=serve_train", "replicas=2"])
    with pytest.raises(ValueError, match="at least one tenant section"):
        LearnTask().run([str(conf), "task=loop_fleet"])
    with pytest.raises(NotImplementedError, match="fleet"):
        LearnTask().run([str(conf), "task=serve", "replicas=2"])
