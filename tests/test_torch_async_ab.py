"""The lane tools' devices and ``tools/async_ab.py``'s verdict.

* ``cxxnet_tpu_torch.tools.async_ab`` and ``tools.mesh_parity`` run on
  the card unless ``--dev cpu`` is passed: their parsers' default is
  ``gpu:0``, read without launching anything.
* ``async_ab --smoke --ranks 2 --dev cpu`` (the parity gate: the async
  ``staleness = 0`` leg's checkpoint CRCs equal the ``det_reduce`` sync
  leg's; the A/B's sync and staleness-0 legs on the UCI digits) exits 0
  with the JAX tool's verdict: its ``validate_doc`` finds nothing, and
  the document, the parity block, the A/B block and each leg carry the
  JAX tool's keys (``tools/async_ab.py``, loaded as a module).
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_async_ab", os.path.join(REPO, "tools", "async_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool", ["async_ab", "mesh_parity"])
def test_lane_tools_default_to_the_card(tool):
    mod = __import__(f"cxxnet_tpu_torch.tools.{tool}", fromlist=["x"])
    args = mod.build_parser().parse_args([])
    assert args.dev == "gpu:0"
    assert mod.build_parser().parse_args(["--dev", "cpu"]).dev == "cpu"


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("async_ab")
    r = subprocess.run(
        [sys.executable, "-m", "cxxnet_tpu_torch.tools.async_ab", "--smoke",
         "--ranks", "2", "--dev", "cpu", "--out", str(out),
         "--timeout", "120"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=400)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with open(out / "async_ab.json") as f:
        return json.load(f)


def test_smoke_verdict_has_the_jax_tools_schema(smoke):
    jax_tool = _jax_tool()
    assert jax_tool.validate_doc(smoke) == []
    assert smoke["verdict"] == "ok" and smoke["problems"] == []
    assert {"bench", "ts", "parity", "ab", "problems",
            "verdict"} <= set(smoke)
    assert set(smoke["parity"]) == {"crc_equal", "rounds", "sync_wall_sec",
                                    "async_wall_sec", "crcs", "problems"}
    assert set(smoke["ab"]) == {"legs", "deltas", "tol", "dataset",
                                "problems"}
    assert set(smoke["ab"]["legs"]) == {"sync", "staleness0"}


def test_smoke_parity_and_exactness(smoke):
    assert smoke["parity"]["crc_equal"] is True
    assert len(smoke["parity"]["crcs"]) == 3  # rounds 0, 1 and 2
    legs = smoke["ab"]["legs"]
    assert legs["sync"]["verdict"] == "baseline"
    assert legs["staleness0"]["verdict"] == "exact"
    assert legs["staleness0"]["final_err"] == legs["sync"]["final_err"]
    assert {"final_err", "wall_sec", "rounds", "overlap_fraction",
            "pushes", "applies", "verdict"} == set(legs["staleness0"])
    assert legs["staleness0"]["pushes"] == legs["staleness0"]["applies"] > 0
