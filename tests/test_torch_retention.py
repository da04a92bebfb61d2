"""``keep_latest = N`` (ROADMAP.md C7): the port's CLI leaves the
checkpoints and manifests the JAX CLI leaves.

A small train conf (``TRAIN_CONF`` of ``tests/test_torch_train.py``
without its dropout, 4 rounds, ``keep_latest = 1``) through both CLIs,
on one device and on two (``dev = cpu:0-1``: the port's CLI starts two
gloo ranks, the JAX package runs two CPU devices in one process, both
with ``async_overlap = 1, staleness = 1``).  The JAX CLI runs in one
subprocess (its obs registry stays out of this process), beside the
port's two CLI subprocesses.  The same files are left in ``model_dir``
(the newest round and its manifest); the two-rank run's telemetry
carries each round's ``async`` block with the JAX block's keys and
nothing pending.  ``apply_retention`` itself against the JAX function on
one directory.
"""

import json
import os
import subprocess
import sys

import pytest

from cxxnet_tpu.utils import checkpoint as jckpt

from cxxnet_tpu_torch.utils import checkpoint as tckpt

from test_torch_train import TRAIN_CONF  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 300
CONF = TRAIN_CONF.replace("layer[4->4] = dropout\n  threshold = 0.3\n", "")
KEYS = ["num_round=4", "keep_latest=1", "silent=1"]
TWO = ["dev=cpu:0-1", "async_overlap=1", "staleness=1", "telemetry=1"]

_JAX_RUNS = r"""
import json, os, sys
from cxxnet_tpu.cli import main
for d, args in json.loads(sys.argv[1]):
    os.chdir(d)
    rc = main(["run.conf", *args])
    if rc:
        raise SystemExit(f"{d}: exit {rc}")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("keep")
    dirs, jobs, procs = {}, [], []
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for pkg in ("port", "jax"):
        for case, extra in (("one", []), ("two", TWO)):
            d = root / f"{pkg}_{case}"
            d.mkdir()
            (d / "run.conf").write_text(CONF)
            args = [*KEYS, *extra, "model_dir=models",
                    f"telemetry_path={d / 'telemetry.jsonl'}"]
            dirs[(pkg, case)] = d
            if pkg == "jax":
                jobs.append([str(d), args])
            else:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "cxxnet_tpu_torch", "run.conf",
                     *args], cwd=str(d), env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT))
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX_RUNS, json.dumps(jobs)], cwd=str(root),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return dirs


@pytest.mark.parametrize("case", ["one", "two"])
def test_keep_latest_leaves_what_jax_leaves(runs, case):
    port = sorted(os.listdir(runs[("port", case)] / "models"))
    jax = sorted(os.listdir(runs[("jax", case)] / "models"))
    assert port == jax
    assert port == ["0004.model", "0004.model.manifest.json"]


def _async_blocks(path):
    with open(path) as f:
        return [json.loads(line).get("async") for line in f if line.strip()]


def test_two_rank_telemetry_has_the_async_block(runs):
    """Each rank appends its record a round (the JAX process one).  A
    rank's synthetic shard holds ``nsample`` rows of its own, as the JAX
    iterator's worker does, so a rank makes 8 steps of 4 rows a round
    where the one JAX process makes 4 of 8: the counts follow."""
    port = _async_blocks(runs[("port", "two")] / "telemetry.jsonl")
    jax = _async_blocks(runs[("jax", "two")] / "telemetry.jsonl")
    assert len(port) == 2 * len(jax) == 8
    for i, p in enumerate(port):
        j = jax[i // 2]
        assert set(p) == set(j)
        for key in ("groups", "staleness", "generation", "pending",
                    "dropped", "resync_period"):
            assert p[key] == j[key], key
        steps = 8 * (i // 2 + 1)
        assert p["pushes"] == p["applies"] == steps * p["groups"]
        assert p["pending"] == [0] * p["groups"]
        assert 0.0 <= p["overlap_fraction"] <= 1.0


def test_apply_retention_is_jax_s(tmp_path):
    removed = {}
    for pkg, mod in (("port", tckpt), ("jax", jckpt)):
        d = tmp_path / pkg
        d.mkdir()
        for r in (0, 1, 2, 5, 12):
            (d / f"{r:04d}.model").write_bytes(b"x")
            if r != 2:
                (d / f"{r:04d}.model.manifest.json").write_text("{}")
        (d / "notes.model").write_bytes(b"x")
        assert mod.apply_retention(str(d), 0) == []
        removed[pkg] = [os.path.basename(p)
                        for p in mod.apply_retention(str(d), 2)]
        removed[pkg + "_left"] = sorted(os.listdir(d))
    assert removed["port"] == removed["jax"] == [
        "0000.model", "0001.model", "0002.model"]
    assert removed["port_left"] == removed["jax_left"]
