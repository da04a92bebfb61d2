"""Device times of the conv block's bf16 main-path kernel (K6,
``csrc/conv_block_gemm.cu``) and of variants of its source, at the nine
sibling-1x1 groups of GoogLeNet's b128 step, beside ``torch.addmm``.

    python -m cxxnet_tpu_torch.tools.conv_block_variants

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``.  Each variant is the source with one change, built with the
port's ``nvcc`` flags into ``build/variants/`` (all at once) and loaded
with ``ctypes``:

* ``as built``, and ``width N`` for N = 128 to 256 by 32: the tile
  width the source picks, or N forced;
* ``unpadded W``: W's rows read at O columns, off 32-byte boundaries at
  O = 280 and 296 (the wrapper pads them to a multiple of 16 columns);
* ``no bias``: the call without the bias (the bias row's cost);
* ``no Y stores``: the epilogue's TMA stores not issued (a wrong result:
  the cost of writing Y).

Every variant that computes the function is first held against the
plain version (2e-2, as ``chip_smoke.py`` holds K6).  Times are device
times: CUDA events around 20 launches behind a device sleep that covers
the host's enqueue, median of 5 such runs.  The last line is one JSON
object with the nine shapes' times and their sums per variant.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.kernels import conv_block

WIDTHS = (128, 160, 192, 224, 256)
_FORCE = """
int g_force_bn = 0;
extern "C" void set_force_bn(int v) { g_force_bn = v; }
"""
# (name, [(old, new)], computes the function)
VARIANTS = (
    ("as built", [], True),
    ("unpadded W", [("const int ldw = (o + 15) / 16 * 16;",
                     "const int ldw = o;")], True),
    ("no Y stores", [("bx < BN / 32 && n0 + 32 * bx < o;",
                      "bx < BN / 32 && n0 + 32 * bx < o && relu == 7;")],
     False),
)


def googlenet_groups(batch: int = 128):
    """(M, K, O) of each sibling-1x1 group of GoogLeNet's step at
    ``batch`` rows, from the port's own shape inference."""
    from .. import config as cfgmod
    from ..nnet.trainer import NetTrainer

    conf = os.path.join(os.path.dirname(_build.CSRC), os.pardir, "example",
                        "ImageNet", "googlenet.conf")
    tr = NetTrainer()
    tr.set_params(cfgmod.parse_file(conf) + [("dev", "cpu"),
                                             ("batch_size", str(batch))])
    tr.init_model()
    net = tr.net
    shapes = net.infer_shapes(batch)
    groups, _ = net._sibling_1x1_groups()
    out = []
    for i, members in groups.items():
        spec = tr.graph.layers[i]
        n, oh, ow, _ = shapes[spec.nindex_out[0]]
        o = sum(net.layer_objs[j].param.num_channel for j in members)
        out.append((n * oh * ow, shapes[spec.nindex_in[0]][3], o))
    return out


def build_variants():
    """Each variant's library, built in parallel: ``{name: CDLL}``."""
    with open(conv_block.KERNEL.source) as f:
        src = f.read()
    marker = '#include "wgmma_tiles.cuh"\n'
    pick = "switch (pick_bn(m, k, o, sms))"
    src = src.replace(marker, marker + _FORCE).replace(
        pick, "switch (g_force_bn ? g_force_bn : pick_bn(m, k, o, sms))")
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, (name, edits, _) in enumerate(VARIANTS):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in "
                                   "the source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"v{i}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
               "-o", so, cu]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(so)
        lib.conv_block_gemm_bf16.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.conv_block_gemm_bf16.restype = ctypes.c_int
        lib.set_force_bn.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def device_ms(fn, n: int = 20, runs: int = 5) -> float:
    """Median over ``runs`` of the mean device time of ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[runs // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_block_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    libs = build_variants()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator().manual_seed(0)
    rows, sums = [], {}
    for m, k, o in googlenet_groups():
        x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(k, o, generator=gen) * k ** -0.5).to(
            dev, torch.bfloat16)
        wp = F.pad(w, (0, -o % 16))  # the wrapper's rows of 32 bytes
        b = (torch.randn(o, generator=gen) * 0.1).to(dev, torch.bfloat16)
        y = torch.empty(m, o, dtype=torch.bfloat16, device=dev)
        ref = conv_block.conv_block_plain(x, w, b)
        times = {"torch.addmm": device_ms(lambda: torch.addmm(b, x, w))}
        cases = [(name, lib, 0, w if name == "unpadded W" else wp, b,
                  checked) for (name, _, checked), lib in
                 zip(VARIANTS, libs.values())
                 if name != "unpadded W" or o % 16]
        base = libs["as built"]
        cases += [(f"width {bn}", base, bn, wp, b, True) for bn in WIDTHS]
        cases.append(("no bias", base, 0, wp, None, False))
        for name, lib, bn, wt, bias, checked in cases:
            lib.set_force_bn(bn)

            def run(lib=lib, wt=wt, bias=bias):
                rc = lib.conv_block_gemm_bf16(
                    x.data_ptr(), wt.data_ptr(),
                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                    m, k, o, 0, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            if checked and not bool(torch.isclose(
                    y.float(), ref.float(), rtol=2e-2, atol=2e-2).all()):
                raise RuntimeError(f"{name} at {(m, k, o)} disagrees with "
                                   "the plain version")
            times[name] = device_ms(run)
            lib.set_force_bn(0)
        rows.append({"shape": [m, k, o], "ms": times})
        for name, t in times.items():
            sums[name] = sums.get(name, 0.0) + t
        print(f"M{m} K{k} O{o}: " + ", ".join(
            f"{n} {t * 1e3:.2f}" for n, t in times.items()) + " us",
            flush=True)
        del x, w, wp, b, y, ref
    print("sums, ms: " + ", ".join(f"{n} {t:.4f}" for n, t in sums.items()),
          flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shapes": rows, "sum_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
