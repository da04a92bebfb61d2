"""The port's C ABI (``csrc/host/``, ``capi_shim.py``) against the JAX
package's (``native/``, ``cxxnet_tpu/capi_shim.py``).

* the port's library and its C host build here (``ops/_build.py``,
  ``build/host/``) and the host passes its checks on the CPU;
* every ``shim_call`` site of the port's source has its shim function,
  and the port's shim has the JAX shim's functions;
* the port's header is the JAX package's ``CXN*`` header, byte for byte;
* one C call sequence (load a shared checkpoint, train off an iterator,
  evaluate, predict, extract, weights, the error path) through the JAX
  library (its source compiled into the test's directory, nothing
  written under ``native/``) and through the port's, each in its own
  process by ``ctypes``, gives the same evaluation line format, the same
  predictions and weights within tolerance;
* the library leaves the Python C API's symbols to the process that
  loads it, so one interpreter serves both ``ctypes`` and the C host.

Skips, as ``tests/test_capi.py`` does, where ``g++``/``gcc`` or
``Python.h`` is missing.  Tolerances: predictions equal; scores and
weights within rtol 1e-4, atol 1e-5.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

from cxxnet_tpu_torch import capi_shim as tshim
from cxxnet_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(REPO, "cxxnet_tpu_torch", "csrc", "host")
NATIVE = os.path.join(REPO, "native")


def _toolchain_ok():
    return (shutil.which("g++") and shutil.which("gcc") and os.path.exists(
        os.path.join(sysconfig.get_paths()["include"], "Python.h")))


needs_toolchain = pytest.mark.skipif(not _toolchain_ok(),
                                     reason="no g++/gcc or Python.h")


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", CXXNET_TPU_HOME=REPO,
                PYTHONPATH="")


@needs_toolchain
def test_c_host_passes_on_the_cpu(tmp_path):
    host = _build.build_host("capi_smoke")
    lib = _build.host_path("libcxxnet_capi")
    assert os.path.dirname(host) == os.path.join(REPO, "build", "host")
    assert os.path.exists(lib)
    # the library takes the Python C API from the process that loads it
    nm = subprocess.run(["nm", "-D", "--undefined-only", lib],
                        capture_output=True, text=True)
    if nm.returncode == 0:
        assert "PyGILState_Ensure" in nm.stdout
    env = dict(_env(), TMPDIR=str(tmp_path))
    # PYTHONPATH empty: the library puts CXXNET_TPU_HOME on sys.path
    r = subprocess.run([host, "cpu"], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "capi_smoke: device cpu" in r.stderr
    assert "capi_smoke: all checks passed" in r.stderr
    assert os.listdir(tmp_path) == []  # its checkpoint was removed
    # a second build finds the keyed paths and builds nothing
    assert _build.build_host("capi_smoke") == host


def test_shim_functions_match_the_call_sites():
    with open(os.path.join(HOST, "cxxnet_capi.cc")) as f:
        called = set(re.findall(r'(?:shim|void)_call\(\s*"([a-z_0-9]+)"',
                                f.read()))
    assert len(called) == 20
    for fn in called:
        assert callable(getattr(tshim, fn)), fn
    from cxxnet_tpu import capi_shim as jshim

    def public(mod):
        return {n for n, v in vars(mod).items() if callable(v)
                and getattr(v, "__module__", "") == mod.__name__
                and not n.startswith("_")}

    assert public(tshim) == public(jshim) == called


def test_header_is_the_jax_header():
    with open(os.path.join(HOST, "cxxnet_capi.h"), "rb") as f:
        port = f.read()
    with open(os.path.join(NATIVE, "cxxnet_capi.h"), "rb") as f:
        assert port == f.read()
    decl = set(re.findall(rb"\b(CXN[A-Za-z]+)\s*\(", port))
    assert len(decl) == 23
    with open(os.path.join(HOST, "cxxnet_capi.cc"), "rb") as f:
        src = f.read()
    for name in decl:
        assert re.search(rb"\b" + name + rb"\s*\([^;]*\)\s*\{", src), name


def test_shim_marshalling():
    assert tshim._from_c4(np.zeros((3, 1, 1, 5))).shape == (3, 5)
    assert tshim._from_c4(np.zeros((3, 2, 2, 5))).shape == (3, 2, 2, 5)
    out = tshim._c_f32(np.arange(6, dtype=np.float64).reshape(2, 3).T)
    assert out.dtype == np.float32 and out.flags.c_contiguous


NET = """netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  nchannel = 4
  pad = 1
  init_sigma = 0.1
layer[1->2] = relu
layer[2->3] = flatten
layer[3->4] = fullc:fc
  nhidden = 4
  init_sigma = 0.1
layer[4->4] = softmax
netconfig = end
input_shape = 2,4,4
batch_size = 8
eta = 0.1
momentum = 0.9
metric = error
eval_train = 0
"""

ITER = """iter = synthetic
  nsample = 24
  input_shape = 2,4,4
  nclass = 4
  seed = 5
batch_size = 8
input_shape = 2,4,4
"""

# one C call sequence, driven by ctypes: argv = library, model, net conf
_DRIVER = r"""
import ctypes, json, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
P, U = ctypes.c_void_p, ctypes.c_uint
F = ctypes.POINTER(ctypes.c_float)
lib.CXNGetLastError.restype = ctypes.c_char_p
lib.CXNIOCreateFromConfig.restype = P
lib.CXNIOCreateFromConfig.argtypes = [ctypes.c_char_p]
lib.CXNNetCreate.restype = P
lib.CXNNetCreate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
for fn in ("CXNIONext", "CXNNetInitModel", "CXNNetLoadModel",
           "CXNNetUpdateIter", "CXNNetStartRound", "CXNNetSetWeight"):
    getattr(lib, fn).restype = ctypes.c_int
lib.CXNIONext.argtypes = [P]
lib.CXNIOBeforeFirst.argtypes = [P]
lib.CXNNetLoadModel.argtypes = [P, ctypes.c_char_p]
lib.CXNNetInitModel.argtypes = [P]
lib.CXNNetStartRound.argtypes = [P, ctypes.c_int]
lib.CXNNetUpdateIter.argtypes = [P, P]
lib.CXNNetEvaluate.restype = ctypes.c_char_p
lib.CXNNetEvaluate.argtypes = [P, P, ctypes.c_char_p]
lib.CXNIOGetData.restype = F
lib.CXNIOGetData.argtypes = [P, U * 4, ctypes.POINTER(U)]
lib.CXNNetPredictBatch.restype = F
lib.CXNNetPredictBatch.argtypes = [P, F, U * 4, ctypes.POINTER(U)]
lib.CXNNetExtractBatch.restype = F
lib.CXNNetExtractBatch.argtypes = [P, F, U * 4, ctypes.c_char_p, U * 2]
lib.CXNNetGetWeight.restype = F
lib.CXNNetGetWeight.argtypes = [P, ctypes.c_char_p, ctypes.c_char_p, U * 2]
lib.CXNNetSetWeight.argtypes = [P, F, U, ctypes.c_char_p, ctypes.c_char_p]
lib.CXNNetFree.argtypes = [P]
lib.CXNIOFree.argtypes = [P]
conf = open(sys.argv[3]).read().encode()
it = lib.CXNIOCreateFromConfig(open(sys.argv[4]).read().encode())
net = lib.CXNNetCreate(b"cpu", conf)
assert lib.CXNNetLoadModel(net, sys.argv[2].encode()) == 0, lib.CXNGetLastError()
for r in range(2):
    assert lib.CXNNetStartRound(net, r) == 0
    lib.CXNIOBeforeFirst(it)
    while lib.CXNIONext(it) == 1:
        assert lib.CXNNetUpdateIter(net, it) == 0, lib.CXNGetLastError()
line = lib.CXNNetEvaluate(net, it, b"smoke").decode()
lib.CXNIOBeforeFirst(it)
assert lib.CXNIONext(it) == 1
shp, stride, n = (ctypes.c_uint * 4)(), ctypes.c_uint(), ctypes.c_uint()
data = lib.CXNIOGetData(it, shp, ctypes.byref(stride))
pred = lib.CXNNetPredictBatch(net, data, shp, ctypes.byref(n))
preds = [pred[i] for i in range(n.value)]
es = (ctypes.c_uint * 2)()
feat = lib.CXNNetExtractBatch(net, data, shp, b"top[-1]", es)
feats = np.ctypeslib.as_array(feat, (es[0], es[1])).tolist()
ws = (ctypes.c_uint * 2)()
w = lib.CXNNetGetWeight(net, b"c1", b"wmat", ws)
wmat = np.ctypeslib.as_array(w, (ws[0], ws[1])).copy()
wmat[0, 0] += 1.0
assert lib.CXNNetSetWeight(net, wmat.ctypes.data_as(F), wmat.size,
                           b"c1", b"wmat") == 0
w2 = lib.CXNNetGetWeight(net, b"c1", b"wmat", ws)
back = np.ctypeslib.as_array(w2, (ws[0], ws[1])).tolist()
ms = (ctypes.c_uint * 2)()
missing = lib.CXNNetGetWeight(net, b"c1", b"gamma", ms)
miss_err = lib.CXNGetLastError().decode()
unknown = lib.CXNNetGetWeight(net, b"no_such_layer", b"wmat", ms)
unknown_err = lib.CXNGetLastError().decode()
bad = lib.CXNNetCreate(b"cpu", b"netconfig = start\nlayer[0->1] = nope\n"
                       b"netconfig = end\ninput_shape = 1,1,8\nbatch_size = 4\n")
rc = lib.CXNNetInitModel(bad)
err = lib.CXNGetLastError().decode()
lib.CXNNetFree(bad); lib.CXNNetFree(net); lib.CXNIOFree(it)
print(json.dumps({"line": line, "shape": list(shp), "preds": preds,
                  "feats": feats, "wshape": list(ws), "wmat": back,
                  "missing": bool(missing), "miss_err": miss_err,
                  "unknown": bool(unknown), "unknown_err": unknown_err,
                  "bad_rc": rc, "bad_err": err}))
"""


def _jax_capi_lib(tmp_path):
    """The JAX package's C ABI source, compiled into ``tmp_path`` (the
    Makefile would write into ``native/``)."""
    out = str(tmp_path / "libcxxnet_capi_jax.so")
    inc, _ = _build.python_build_flags()
    r = subprocess.run(["g++", *_build.HOST_CXXFLAGS, *inc, "-shared", "-o",
                        out, os.path.join(NATIVE, "cxxnet_capi.cc")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return out


@needs_toolchain
def test_same_c_sequence_through_both_libraries(tmp_path):
    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET + "dev = cpu\n"))
    tr.init_model()
    model = str(tmp_path / "start.model")
    tr.save_model(model)
    (tmp_path / "net.conf").write_text(NET)
    (tmp_path / "iter.conf").write_text(ITER)
    libs = {"jax": _jax_capi_lib(tmp_path),
            "port": _build.build_host("libcxxnet_capi")}
    out = {}
    for name, lib in libs.items():
        r = subprocess.run(
            [sys.executable, "-c", _DRIVER, lib, model,
             str(tmp_path / "net.conf"), str(tmp_path / "iter.conf")],
            capture_output=True, text=True, timeout=600, env=_env(),
            cwd=str(tmp_path))
        assert r.returncode == 0, r.stdout + r.stderr[-3000:]
        out[name] = json.loads(r.stdout.strip().splitlines()[-1])
    j, t = out["jax"], out["port"]
    fmt = re.compile(r"^\tsmoke-error:[0-9.e-]+$")
    assert fmt.match(t["line"]) and fmt.match(j["line"]), (t, j)
    assert t["line"] == j["line"]
    assert t["shape"] == j["shape"] == [8, 4, 4, 2]
    assert t["preds"] == j["preds"]
    np.testing.assert_allclose(t["feats"], j["feats"], 1e-4, 1e-5)
    assert t["wshape"] == j["wshape"] == [4, 18]
    np.testing.assert_allclose(t["wmat"], j["wmat"], 1e-4, 1e-5)
    assert not t["missing"] and t["miss_err"] == j["miss_err"] == \
        "no such weight"
    assert not t["unknown"] and t["unknown_err"] == j["unknown_err"]
    assert t["unknown_err"].startswith("net_get_weight: ")
    assert t["bad_rc"] == j["bad_rc"] == -1
    assert t["bad_err"].startswith("net_init_model: ")
    assert "nope" in t["bad_err"] and "nope" in j["bad_err"]
