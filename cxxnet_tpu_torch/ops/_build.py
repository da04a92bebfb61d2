"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
functions that launch on a caller-given stream and return
``cudaGetLastError()``).  It is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v

into ``build/kernels/<name>-<hash>.so`` at the repository root (listed
in ``.gitignore``; ``compile_cache_dir`` moves it, see
``utils/compile_cache.py``), keyed by a hash of the source, the
``csrc/`` headers it includes, the flags and the toolchain (the
compiler's ``--version`` and ``platform.machine()``: a library built by
another toolchain or for another machine is never loaded), and loaded
with ``ctypes``.  A file with a plain C interface builds in
seconds; one that includes PyTorch's headers takes minutes, which is
why the port does not use ``torch.utils.cpp_extension``.

Nothing is built or loaded at import: the CPU tests import every module
on machines without ``nvcc`` or a card.

Host sources (``csrc/host/``: the C ABI's library and its C host, the
native page reader) are built by :func:`build_host` with ``g++`` /
``gcc`` into ``build/host/<name>-<hash>``, under the same hash key
(source, local headers, flags, toolchain and machine, plus the Python
ABI from ``sysconfig``) and the same write-then-rename, and serialised
across processes by an ``fcntl`` lock.  They need no
``nvcc``, so they build wherever a C++ toolchain is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import re
import shutil
import subprocess
import sysconfig
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
DEFAULT_CACHE_ROOT = os.path.join(os.path.dirname(_PKG), "build")
BUILD_DIR = os.path.join(DEFAULT_CACHE_ROOT, "kernels")
#: the kernel libraries this process has loaded (a library once loaded
#: is never reloaded, wherever the cache moves)
LOADED: List[str] = []
#: every :class:`Kernel` made in this process, for the launch collector
INSTANCES: List["Kernel"] = []
_LOCAL_INCLUDE = re.compile(rb'#include\s+"([^"]+)"')
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class KernelError(RuntimeError):
    """A kernel failed to build, to load, or to launch."""


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found on PATH or under CUDA_HOME")


@functools.lru_cache(maxsize=None)
def toolchain_id(compiler: str) -> str:
    """The compiler's identity: its ``--version`` output (nvcc's first
    line names no release, so the whole output is taken) and the
    machine.  A compiler that is not on this machine gives
    ``"<compiler>: not found"``, a key no build here can have made."""
    try:
        exe = nvcc_path() if compiler == "nvcc" else compiler
        out = subprocess.run([exe, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=60).stdout
    except (KernelError, OSError, subprocess.TimeoutExpired):
        out = f"{compiler}: not found"
    return f"{out.strip()}\n{platform.machine()}"


def set_cache_root(root: str) -> None:
    """Build and load kernels under ``<root>/kernels`` and host sources
    under ``<root>/host`` from now on (``compile_cache_dir``)."""
    global BUILD_DIR, HOST_BUILD_DIR
    BUILD_DIR = os.path.join(root, "kernels")
    HOST_BUILD_DIR = os.path.join(root, "host")


class Kernel:
    """One hand-written kernel: its source, its library (built and
    loaded on first launch) and its launch count.

    ``launches`` counts successful launches of the CUDA kernel and
    nothing else: a wrapper that takes the plain PyTorch version (for a
    CPU tensor) does not count; ``by_symbol`` splits the count by C
    entry (a source with several kernel variants); ``lifetime`` is
    ``by_symbol`` since the process began, which :meth:`reset_counts`
    leaves alone and ``/metricsz`` exports as
    ``kernel_launches_total{kernel,name}`` (one serving replica's
    launches, read from outside its process).  ``dtypes`` are the C
    entry suffixes the source exports (``<name>_<suffix>``)."""

    def __init__(self, name: str, replaces: str,
                 dtypes: Sequence[str] = ("f32", "bf16")) -> None:
        self.name = name
        self.source = os.path.join(CSRC, name + ".cu")
        self.replaces = replaces   # "file:line function" of the TPU kernel
        self.dtypes = tuple(dtypes)
        self.launches = 0
        self.by_symbol: Dict[str, int] = {}
        self.lifetime: Dict[str, int] = {}
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, ctypes._CFuncPtr] = {}
        self._lock = threading.Lock()
        INSTANCES.append(self)

    def library_path(self) -> str:
        """The library's path, keyed by the source, the local headers it
        includes (``#include "x.cuh"`` from ``csrc/``), the flags, and
        nvcc's identity and the machine (:func:`toolchain_id`)."""
        with open(self.source, "rb") as f:
            src = f.read()
        h = hashlib.sha256(src)
        for name in _LOCAL_INCLUDE.findall(src):
            with open(os.path.join(CSRC, name.decode()), "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        h.update(toolchain_id("nvcc").encode())
        return os.path.join(BUILD_DIR, f"{self.name}-{h.hexdigest()[:12]}.so")

    def _compile_cmd(self, out: str) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, self.source]

    def _load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self.library_path()
                if not os.path.exists(path):
                    build([self])
                try:
                    self._lib = ctypes.CDLL(path)
                except OSError as e:
                    raise KernelError(
                        f"{self.name}: cannot load {path}: {e}") from e
                LOADED.append(path)
            return self._lib

    def launch(self, symbol: str, argtypes: Sequence, *args) -> None:
        """Call ``symbol`` (C return type int = cudaError_t) and raise
        unless it returned 0; count the launch.  Binding an entry (its
        first call) sets ``kernel_selected{name=symbol,backend=cuda}``
        in ``/metricsz`` and plugs in :func:`launch_collector`."""
        fn = self._fns.get(symbol)
        if fn is None:
            fn = getattr(self._load(), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
            from ..obs import device as obs_device

            from ..obs.registry import registry as obs_registry

            obs_device.mark_kernel_selected(symbol, "cuda", True)
            obs_registry().register_collector(launch_collector)
        rc = fn(*args)
        if rc != 0:
            raise KernelError(
                f"{self.name}: {symbol} returned CUDA error {rc}")
        self.launches += 1
        self.by_symbol[symbol] = self.by_symbol.get(symbol, 0) + 1
        self.lifetime[symbol] = self.lifetime.get(symbol, 0) + 1

    def reset_counts(self) -> None:
        """Set ``launches`` and ``by_symbol`` to 0 (not ``lifetime``)."""
        self.launches = 0
        self.by_symbol = {}


def launch_collector():
    """Collector: ``kernel_launches_total{kernel,name}``, each C entry's
    launches in this process (:attr:`Kernel.lifetime`), read at scrape
    time, so a launch costs no registry lookup."""
    samples = [({"kernel": k.name, "name": sym}, float(n))
               for k in INSTANCES for sym, n in sorted(k.lifetime.items())]
    if not samples:
        return []
    return [("kernel_launches_total", "counter",
             "Launches of each C entry of the hand-written kernels in "
             "this process.", samples)]


def build(kernels: Sequence[Kernel]) -> Dict[str, float]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together; returns seconds per kernel built.
    Each library is written under a temporary name and renamed into
    place, so a concurrent build never loads a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for k in kernels:
        out = k.library_path()
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        p = subprocess.Popen(k._compile_cmd(tmp), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((k, p, tmp, out, time.monotonic()))
    secs: Dict[str, float] = {}
    failed = []
    for k, p, tmp, out, t0 in procs:
        log, _ = p.communicate()
        secs[k.name] = time.monotonic() - t0
        k.build_log = log
        if p.returncode != 0:
            failed.append(f"{k.name} (nvcc exit {p.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return secs


# ----------------------------------------------------------------------
# wrapper-side checks shared by the kernel modules
_SUFFIX = {"torch.float32": "f32", "torch.bfloat16": "bf16"}


def dtype_suffix(t) -> str:
    """``f32`` / ``bf16``: the C symbol suffix for a tensor's dtype."""
    s = _SUFFIX.get(str(t.dtype))
    if s is None:
        raise TypeError(f"unsupported dtype {t.dtype}; the kernels take "
                        "float32 and bfloat16")
    return s


def check_cuda(name: str, t, ndim: int, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of rank ``ndim``
    (and of ``dtype`` when given) — what the kernel's raw pointer
    arithmetic assumes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device — kernels launch where the surrounding PyTorch ops run."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------------------------------------------------
# host sources: csrc/host/*.cc|*.c built with g++ / gcc
HOST_SRC = os.path.join(CSRC, "host")
HOST_BUILD_DIR = os.path.join(DEFAULT_CACHE_ROOT, "host")
HOST_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread")


class HostBuildError(RuntimeError):
    """A host source failed to build; ``log`` holds the compiler's
    output, and the message its first ``error`` line (else its last
    line): the reason, where g++ ends with "compilation terminated."."""

    def __init__(self, name: str, log: str) -> None:
        self.name, self.log = name, log
        lines = log.strip().splitlines() or ["no output"]
        why = next((ln for ln in lines if "error" in ln), lines[-1])
        super().__init__(f"host build of {name} failed: {why.strip()}")


def python_build_flags() -> Tuple[List[str], List[str]]:
    """``(include flags, link flags)`` of this interpreter's C API, from
    ``sysconfig`` (the C host links ``libpython``; the library does
    not)."""
    paths = sysconfig.get_paths()
    inc = []
    for d in (paths["include"], paths.get("platinclude")):
        if d and f"-I{d}" not in inc:
            inc.append(f"-I{d}")
    var = sysconfig.get_config_var
    libdir = var("LIBDIR") or ""
    link = [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{var('LDVERSION') or var('VERSION')}"]
    link += (var("LIBS") or "").split() + (var("SYSLIBS") or "").split()
    return inc, link


def _host_spec(name: str) -> Tuple[str, List[str], List[str]]:
    """``(source, compiler and flags before -o, flags after the
    source)`` of one host target."""
    if name == "libcxxnet_io":
        return ("cxxnet_io.cc", ["g++", *HOST_CXXFLAGS, "-shared"],
                ["-ljpeg"])
    if name == "libcxxnet_capi":
        inc, _ = python_build_flags()
        return ("cxxnet_capi.cc", ["g++", *HOST_CXXFLAGS, *inc, "-shared"],
                [])
    if name == "capi_smoke":
        lib = host_path("libcxxnet_capi")
        _, link = python_build_flags()
        return ("capi_smoke.c", ["gcc", "-O2", "-Wall", f"-I{HOST_SRC}"],
                [lib, "-Wl,-rpath,$ORIGIN", "-Wl,--no-as-needed", *link])
    raise ValueError(f"unknown host target {name!r}")


def host_path(name: str) -> str:
    """The target's path under ``build/host/``, keyed by its source, the
    local headers it includes, its flags (for the C host, the library's
    path, itself keyed), the compiler's identity and the machine
    (:func:`toolchain_id`) and the Python ABI (``sysconfig``'s
    ``SOABI``), so a target built elsewhere is never loaded here."""
    src, pre, post = _host_spec(name)
    path = os.path.join(HOST_SRC, src)
    with open(path, "rb") as f:
        text = f.read()
    h = hashlib.sha256(text)
    for inc in _LOCAL_INCLUDE.findall(text):
        with open(os.path.join(HOST_SRC, inc.decode()), "rb") as f:
            h.update(f.read())
    h.update(" ".join(pre + post).encode())
    h.update(toolchain_id(pre[0]).encode())
    h.update(str(sysconfig.get_config_var("SOABI")).encode())
    ext = ".so" if name.startswith("lib") else ""
    return os.path.join(HOST_BUILD_DIR, f"{name}-{h.hexdigest()[:12]}{ext}")


def build_host(name: str) -> str:
    """Build one host target if its keyed path is missing and return
    the path.  Raises :class:`HostBuildError` with the compiler's log.
    The C host builds its library first."""
    import fcntl

    if name == "capi_smoke":
        build_host("libcxxnet_capi")
    out = host_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    src, pre, post = _host_spec(name)
    with open(os.path.join(HOST_BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        soname = ([f"-Wl,-soname,{os.path.basename(out)}"]
                  if name.startswith("lib") else [])
        cmd = [*pre, "-o", tmp, os.path.join(HOST_SRC, src), *soname, *post]
        try:
            r = subprocess.run(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True,
                               timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise HostBuildError(name, f"{type(e).__name__}: {e}") from e
        if r.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise HostBuildError(name, r.stdout)
        os.replace(tmp, out)
    return out
