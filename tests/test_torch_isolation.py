"""The port stands alone: no JAX, no ``cxxnet_tpu``, no silent CPU.

* ``import cxxnet_tpu_torch`` (with its serving package, its CLI, the
  language-model modules, the quantized ones, the layer zoo with its
  ``torch:`` plugin, the text iterators, the closed loop, the data
  service and the serving fleet with its stub) leaves ``jax``
  and ``cxxnet_tpu`` out of ``sys.modules``.  Checked in a subprocess,
  because this test process imports jax in ``conftest.py``.
* No file of the port, nor ``chip_smoke.py``, imports either by name.
* ``dev`` other than ``cpu`` means the card and raises without one; a
  device range raises ``NotImplementedError``.
* The conf surfaces the JAX package validates (``pool_impl``,
  ``lrn_impl``, ``kernel_lib``) are validated the same way, and a
  quantized checkpoint loads with its int8 and bf16 leaves as stored.
"""

import ast
import glob
import io
import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.nnet import trainer as ttrainer
from cxxnet_tpu_torch.nnet.net import FunctionalNet
from cxxnet_tpu_torch.nnet.graph import NetGraph
from cxxnet_tpu_torch.utils.checkpoint import MODEL_MAGIC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "cxxnet_tpu")


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        "import cxxnet_tpu_torch, cxxnet_tpu_torch.serve, "
        "cxxnet_tpu_torch.cli, cxxnet_tpu_torch.models, "
        "cxxnet_tpu_torch.nnet.generate, cxxnet_tpu_torch.io.text, "
        "cxxnet_tpu_torch.layers.sequence, cxxnet_tpu_torch.ops.flash, "
        "cxxnet_tpu_torch.ops.quant, cxxnet_tpu_torch.nnet.quant, "
        "cxxnet_tpu_torch.io.pipeline, cxxnet_tpu_torch.io.img, "
        "cxxnet_tpu_torch.layers.pairtest, cxxnet_tpu_torch.plugin, "
        "cxxnet_tpu_torch.io.csv, cxxnet_tpu_torch.io.libsvm, "
        "cxxnet_tpu_torch.io.membuffer, cxxnet_tpu_torch.io.attach_txt, "
        "cxxnet_tpu_torch.wrapper, cxxnet_tpu_torch.capi_shim, "
        "cxxnet_tpu_torch.io.native, cxxnet_tpu_torch.obs, "
        "cxxnet_tpu_torch.utils.diskio, cxxnet_tpu_torch.utils.profiler, "
        "cxxnet_tpu_torch.utils.compile_cache, cxxnet_tpu_torch.integrity, "
        "cxxnet_tpu_torch.integrity.plane, cxxnet_tpu_torch.tune, "
        "cxxnet_tpu_torch.loop, cxxnet_tpu_torch.loop.tenant, "
        "cxxnet_tpu_torch.loop.retention, cxxnet_tpu_torch.serve.router, "
        "cxxnet_tpu_torch.serve.fleet, cxxnet_tpu_torch.serve.stub, "
        "cxxnet_tpu_torch.io.dataservice, "
        "cxxnet_tpu_torch.io.dataservice.client\n"
        "from cxxnet_tpu_torch.layers import create_layer\n"
        "create_layer('torch'); create_layer('pairtest-conv-conv')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        f" in {FORBIDDEN!r})))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    files = glob.glob(os.path.join(REPO, "cxxnet_tpu_torch", "**", "*.py"),
                      recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"cxxnet_tpu_torch/ops/flash.py", "cxxnet_tpu_torch/ops/attention.py",
            "cxxnet_tpu_torch/layers/sequence.py",
            "cxxnet_tpu_torch/layers/embed.py", "cxxnet_tpu_torch/io/text.py",
            "cxxnet_tpu_torch/nnet/generate.py",
            "cxxnet_tpu_torch/models/builders.py",
            "cxxnet_tpu_torch/layers/pairtest.py",
            "cxxnet_tpu_torch/plugin/torch_adapter.py",
            "cxxnet_tpu_torch/io/csv.py", "cxxnet_tpu_torch/io/libsvm.py",
            "cxxnet_tpu_torch/io/membuffer.py",
            "cxxnet_tpu_torch/io/attach_txt.py",
            "cxxnet_tpu_torch/wrapper.py", "cxxnet_tpu_torch/capi_shim.py",
            "cxxnet_tpu_torch/io/native.py",
            "cxxnet_tpu_torch/obs/registry.py",
            "cxxnet_tpu_torch/obs/device.py",
            "cxxnet_tpu_torch/utils/diskio.py",
            "cxxnet_tpu_torch/utils/profiler.py",
            "cxxnet_tpu_torch/utils/compile_cache.py",
            "cxxnet_tpu_torch/integrity/fingerprint.py",
            "cxxnet_tpu_torch/integrity/plane.py",
            "cxxnet_tpu_torch/tune/controller.py",
            "cxxnet_tpu_torch/tune/targets.py",
            *(f"cxxnet_tpu_torch/{m}" for m in _LOOP_AND_SERVICE)} <= names
    bad = {f: sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


@pytest.mark.parametrize("mod", [
    "utils/diskio.py", "utils/profiler.py", "utils/compile_cache.py",
    "integrity/fingerprint.py", "integrity/plane.py", "tune/controller.py",
    "tune/targets.py"])
def test_ported_utilities_sit_at_the_jax_path_and_need_no_device(mod):
    """Each module of the utilities, the integrity plane and the tuner
    keeps its JAX counterpart's path, and importing it builds nothing
    and touches no card (their device work starts inside a call)."""
    assert os.path.exists(os.path.join(REPO, "cxxnet_tpu", mod))
    path = os.path.join(REPO, "cxxnet_tpu_torch", mod)
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    top = {a.name.split(".")[0] for n in tree.body
           if isinstance(n, ast.Import) for a in n.names}
    assert "torch" not in top and "triton" not in top


_LOOP_AND_SERVICE = (
    "loop/__init__.py", "loop/feedback_log.py", "loop/publisher.py",
    "loop/retention.py", "loop/continuous.py", "loop/tenant.py",
    "serve/router.py", "io/dataservice/__init__.py",
    "io/dataservice/wire.py", "io/dataservice/cache.py",
    "io/dataservice/server.py", "io/dataservice/client.py")


@pytest.mark.parametrize("mod", _LOOP_AND_SERVICE)
def test_loop_and_service_modules_sit_at_the_jax_path(mod):
    """Each module of the closed loop and the data service keeps its JAX
    counterpart's path, imports neither JAX nor the JAX package (not
    even its JAX-free modules: it keeps its own copy), and imports no
    torch at module level (host code; the card is reached through the
    trainer and the engine)."""
    assert os.path.exists(os.path.join(REPO, "cxxnet_tpu", mod))
    path = os.path.join(REPO, "cxxnet_tpu_torch", mod)
    assert not set(_imported_roots(path)) & set(FORBIDDEN)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    top = {a.name.split(".")[0] for n in tree.body
           if isinstance(n, ast.Import) for a in n.names}
    top |= {n.module.split(".")[0] for n in tree.body
            if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert "torch" not in top


def test_host_sources_import_only_the_port():
    """The C ABI's library embeds Python: every module its source
    imports (``PyImport_ImportModule``, the bootstrap's ``import``
    lines) is the port's or the standard library's."""
    srcs = glob.glob(os.path.join(REPO, "cxxnet_tpu_torch", "csrc", "host",
                                  "*.c*"))
    assert {os.path.basename(f) for f in srcs} == {
        "cxxnet_capi.cc", "capi_smoke.c", "cxxnet_io.cc"}
    found = set()
    for path in srcs:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        found |= set(re.findall(r'PyImport_ImportModule\("([\w.]+)"\)',
                                text))
        found |= set(re.findall(r'"\s*import ([\w., ]+?)\s*(?:#[^"]*)?'
                                r'(?:\\n)?"', text))
    mods = {m.strip().split(".")[0] for item in found
            for m in item.split(",")}
    assert "cxxnet_tpu_torch" in mods
    assert mods <= {"cxxnet_tpu_torch", "numpy", "os", "sys"}, mods
    assert "cxxnet_tpu_torch.capi_shim" in found


@pytest.mark.parametrize("dev", ["gpu", "cuda", "tpu", "gpu:0", "cuda:0"])
def test_dev_other_than_cpu_needs_a_card(monkeypatch, dev):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ttrainer.resolve_device(dev)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ttrainer.resolve_device(dev) == torch.device("cuda:0")


@pytest.mark.parametrize("dev", ["tpu:0-7", "gpu:0-1", "gpu:0,1"])
def test_device_ranges_are_a_later_slice(dev):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        ttrainer.resolve_device(dev)


def test_cpu_is_taken_only_when_asked():
    assert ttrainer.resolve_device("cpu") == torch.device("cpu")
    assert ttrainer.resolve_device(" CPU ") == torch.device("cpu")


NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 8
  pad = 1
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = lrn
  local_size = 5
layer[3->4] = flatten
layer[4->5] = fullc:fc
  nhidden = 4
layer[5->5] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 2
dev = cpu
"""


def _net(extra=""):
    g = NetGraph()
    g.configure(tcfg.parse_pairs(NET + extra))
    return FunctionalNet(g)


@pytest.mark.parametrize("key,good,bad", [
    ("pool_impl", "pallas", "cuda"),
    ("lrn_impl", "xla", "fast"),
    ("kernel_lib", "conv_block,int8_gemm", "conv_blok"),
])
def test_kernel_switches_are_parsed_and_validated(key, good, bad):
    _net(f"{key} = {good}\n")
    with pytest.raises(ValueError):
        _net(f"{key} = {bad}\n")


def test_quantized_checkpoints_name_their_roadmap_item(tmp_path):
    """Quantized serving is ported (ROADMAP.md queue A item 3): a
    checkpoint whose header carries ``quant`` loads, its int8 codes stay
    int8 and its bf16 kernels stay bf16, bit for bit."""
    header = json.dumps({"structure": {}, "epoch_counter": 0,
                         "quant": {"scheme": "int8"}}).encode()
    codes = np.array([[-127, 0], [5, 127]], np.int8)
    words = np.array([0x3FC0, 0xC010], np.uint16)  # 1.5, -2.25 in bf16
    buf = io.BytesIO()
    np.savez(buf, **{"l0_fc/wmat_q8": codes,
                     "l0_fc/wscale": np.ones(2, np.float32),
                     "l1_fc/wmat~bf16": words})
    path = tmp_path / "q.model"
    path.write_bytes(MODEL_MAGIC + struct.pack("<I", len(header)) + header
                     + buf.getvalue())
    head, params, _, _ = ttrainer.NetTrainer._read_model_file(str(path))
    assert head["quant"] == {"scheme": "int8"}
    np.testing.assert_array_equal(params["l0_fc"]["wmat_q8"], codes)
    bf = params["l1_fc"]["wmat"]
    assert bf.dtype == torch.bfloat16
    assert bf.float().tolist() == [1.5, -2.25]
    moved = ttrainer.params_from_numpy(params)
    assert moved["l0_fc"]["wmat_q8"].dtype == torch.int8
    assert moved["l1_fc"]["wmat"].dtype == torch.bfloat16


def test_bf16_checkpoint_entries_widen_exactly(tmp_path):
    vals = np.array([1.5, -2.25, 3.0e-3], np.float32)
    words = (vals.view(np.uint32) >> 16).astype(np.uint16)
    header = json.dumps({"structure": {}, "epoch_counter": 0}).encode()
    buf = io.BytesIO()
    np.savez(buf, **{"l0_fc/wmat~bf16": words})
    path = tmp_path / "b.model"
    path.write_bytes(MODEL_MAGIC + struct.pack("<I", len(header)) + header
                     + buf.getvalue())
    _, params, _, _ = ttrainer.NetTrainer._read_model_file(str(path))
    want = (words.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(params["l0_fc"]["wmat"], want)


def test_params_numpy_round_trip_keeps_layouts():
    raw = {"l0_c1": {"wmat": np.random.rand(3, 3, 3, 8).astype(np.float32),
                     "bias": np.zeros(8, np.float32)},
           "l4_fc": {"wmat": np.random.rand(4, 72).astype(np.float32)}}
    back = ttrainer.params_to_numpy(ttrainer.params_from_numpy(raw))
    for key, tags in raw.items():
        for tag, arr in tags.items():
            np.testing.assert_array_equal(back[key][tag], arr)


def test_small_net_serves_in_bf16_on_the_cpu(tmp_path):
    tr = ttrainer.NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET + "compute_dtype = bfloat16\n"))
    tr.init_model()
    x = np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    out = tr.predict_fn()(tr.params, tr.aux, x, ())
    assert out.dtype == torch.float32 and out.shape == (2, 4)
    ref_tr = ttrainer.NetTrainer()
    ref_tr.set_params(tcfg.parse_pairs(NET))
    path = str(tmp_path / "m.model")
    tr.save_model(path)
    ref_tr.load_model(path)
    ref = ref_tr.predict_fn()(ref_tr.params, ref_tr.aux, x, ())
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, rtol=1e-5)
