"""How well-conditioned ResNet-50's first step and bf16 forward are, in
both packages, from one random-init checkpoint.

The PyTorch port (``cxxnet_tpu_torch``) is held against the JAX package
(``cxxnet_tpu``) by comparing updates.  From ``resnet50_conf``'s random
init, a step's updates move far more under tiny input changes than a
tolerance on each tensor's largest update allows, and a bf16 step's
updates have little to do with the float32 step's -- in the JAX package
as in the port.  This script measures that on the CPU, so the limits
of ``chip_smoke.py``'s ResNet parity phase have a source:

* the port's float32 step, input multiplied by ``1 + 1e-6 N(0, 1)``:
  each tensor's update against the unperturbed one (max error over the
  tensor's largest update, and cosine);
* the port's float32 step against the JAX package's;
* bf16 against float32, each package on its own: each tensor's update
  cosine, and the ``pool`` features' largest error over their largest.

Usage (CPU, about a minute at the defaults)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/resnet_conditioning.py \\
        [--size 64] [--rows 8] [--seed 12]

It prints one line per comparison: min and median cosine, max and
median error over each tensor's largest.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def _stats(name, a, b):
    cos = [float((a[k] * b[k]).sum()
                 / (np.linalg.norm(a[k]) * np.linalg.norm(b[k]))) for k in b]
    rel = [float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()) for k in b]
    print(f"{name:34s} cosine min {min(cos):.4f} median "
          f"{np.median(cos):.5f}; error max {max(rel):.3g} median "
          f"{np.median(rel):.3g}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args()

    from cxxnet_tpu import config as jcfg
    from cxxnet_tpu.io.data import DataBatch as JaxBatch
    from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

    from cxxnet_tpu_torch import config as tcfg
    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.models import resnet50_conf
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer

    def conf(dtype):
        return resnet50_conf(batch_size=args.rows, input_size=args.size,
                             dev="cpu", compute_dtype=dtype)

    path = os.path.join(tempfile.mkdtemp(), "0000.model")
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(conf("float32")))
    tr.init_model()
    tr.save_model(path)
    rng = np.random.RandomState(args.seed)
    x = rng.randn(args.rows, args.size, args.size, 3).astype(np.float32)
    y = rng.randint(0, 1000, (args.rows, 1)).astype(np.float32)
    xp = x * (1 + 1e-6 * rng.randn(*x.shape)).astype(np.float32)

    def port(dtype, data):
        t = NetTrainer()
        t.set_params(tcfg.parse_pairs(conf(dtype)))
        t.load_model(path)
        feats = t.extract_feature(DataBatch(data=data, label=y), "pool")
        w0 = {(k, g): w.clone() for k, tags in t.params.items()
              for g, w in tags.items()}
        t.update_all(data, y)
        return feats, {kt: (t.params[kt[0]][kt[1]] - w).double().numpy()
                       for kt, w in w0.items()}

    def jax(dtype):
        t = JaxTrainer()
        t.set_params(jcfg.parse_pairs(conf(dtype)))
        t.load_model(path)
        feats = np.asarray(t.extract_feature(JaxBatch(data=x, label=y),
                                             "pool"))
        w0 = {(k, g): np.array(w) for k, tags in t.params.items()
              for g, w in tags.items()}
        t.update_all(x, y)
        return feats, {kt: (np.asarray(t.params[kt[0]][kt[1]]) - w).astype(
            np.float64) for kt, w in w0.items()}

    pf, p32 = port("float32", x)
    _, p32p = port("float32", xp)
    pf16, p16 = port("bfloat16", x)
    jf, j32 = jax("float32")
    jf16, j16 = jax("bfloat16")
    print(f"ResNet-50 at {args.size}x{args.size}, {args.rows} rows, seed "
          f"{args.seed}, one SGD step from random init (CPU)")
    _stats("port f32, input moved by 1e-6", p32p, p32)
    _stats("port f32 vs JAX f32", p32, j32)
    _stats("port bf16 vs port f32", p16, p32)
    _stats("JAX bf16 vs JAX f32", j16, j32)
    for name, a, b in (("port", pf16, pf), ("JAX", jf16, jf)):
        print(f"{name} bf16 vs f32 pool features: error max "
              f"{np.abs(a - b).max() / np.abs(b).max():.3g} of the largest")


if __name__ == "__main__":
    main()
