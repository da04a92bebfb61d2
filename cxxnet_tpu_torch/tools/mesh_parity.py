"""N ranks against one: the data-parallel parity lane of the port.

The port's ``tools/mesh_parity.py``.  It trains the MNIST MLP conf the
JAX lane trains (16 pixels, 2 classes, 128 seeded images, ``dist_shard =
block``, ``shard_weight_update = 1``, 2 rounds) through the CLI, once as
``--ranks`` rank processes (``tools/_ranks.py``: ``dev`` and the
``dist_*`` keys on each) and once as one process, and
holds them to (every rank on ``--dev``: ``gpu:0`` by default, the ranks
sharing the card over gloo; ``--dev cpu`` on the CPU):

* **the ranks agree**: in a group every checkpoint's bytes are compared
  across the ranks before rank 0 writes it (``cli.py``; a difference
  stops the run), so a finished N-rank run IS the CRC check; rank 0
  alone writes;
* **N ranks against one**: every checkpoint of the N-rank run within
  ``--tol`` (absolute, f32 weights) of the one-rank run's, the largest
  deviation and whether the bytes are equal reported.  With ``block``
  shards the ranks' batches together are the one-rank run's batch row
  for row; the sums of the gradient run in another order (each rank's
  backward, then the all-reduce), so the weights differ by rounding.

Usage::

    python -m cxxnet_tpu_torch.tools.mesh_parity --out /tmp/_mesh \
        [--ranks 4] [--dev gpu:0|cpu]

Prints one JSON verdict (also ``<out>/mesh_parity.json``); exit 0 when
both hold, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NUM_ROUND = 2
GLOBAL_BATCH = 32
N_IMAGES = 128
TOL = 1e-5


def make_data(out_dir: str) -> None:
    import numpy as np

    from ..io.mnist import write_idx_images, write_idx_labels

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (N_IMAGES, 4, 4)).astype(np.uint8)
    labels = (imgs.reshape(N_IMAGES, -1).mean(1) > 127).astype(np.uint8)
    write_idx_images(os.path.join(out_dir, "img.idx"), imgs)
    write_idx_labels(os.path.join(out_dir, "lab.idx"), labels)


def make_conf(out_dir: str) -> str:
    """The conf both runs share (the JAX lane's); ``dist_shard = block``
    makes each rank's local batch its contiguous slice of the global
    batch."""
    conf = os.path.join(out_dir, "mesh.conf")
    with open(conf, "w", encoding="utf-8") as f:
        f.write(f"""
data = train
iter = mnist
  path_img = "{out_dir}/img.idx"
  path_label = "{out_dir}/lab.idx"
  shuffle = 1
  dist_shard = block
iter = end
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 8
  init_sigma = 0.1
layer[fc1->out] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = {GLOBAL_BATCH}
num_round = {NUM_ROUND}
eval_train = 0
eta = 0.1
momentum = 0.9
seed = 7
shard_weight_update = 1
metric = error
silent = 1
""")
    return conf


def run_job(conf: str, workdir: str, ranks: int, dev: str,
            timeout: float) -> None:
    """One side through the CLI, its checkpoints in
    ``<workdir>/models``."""
    from ._ranks import run_ranks

    os.makedirs(workdir, exist_ok=True)
    try:
        run_ranks(conf, workdir, [f"model_dir={workdir}/models"], ranks,
                  dev, timeout)
    except RuntimeError as e:
        raise RuntimeError(f"mesh_parity: {ranks}-rank run failed: "
                           f"{e}") from None


def read_rounds(workdir: str) -> dict:
    """{round: (manifest crc32, {leaf: ndarray})} of every checkpoint."""
    from ..nnet.trainer import NetTrainer
    from ..utils import checkpoint as ckpt

    out = {}
    for round_, path in ckpt.list_checkpoints(os.path.join(workdir,
                                                           "models")):
        man = ckpt.read_manifest(path) or {}
        _h, params, _aux, _ust = NetTrainer._read_model_file(path)
        out[round_] = (man.get("crc32"), man.get("mesh"),
                       {f"{k}/{t}": w for k, tags in params.items()
                        for t, w in tags.items()})
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="mesh_parity_out",
                    help="scratch and verdict directory")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--dev", default="gpu:0",
                    help="every rank's dev (cpu: the ranks on the CPU)")
    ap.add_argument("--tol", type=float, default=TOL)
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="each side's wall-clock budget (seconds)")
    return ap


def main() -> int:
    import numpy as np

    args = build_parser().parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    make_data(out)
    conf = make_conf(out)
    t0 = time.time()
    run_job(conf, os.path.join(out, "multi"), args.ranks, args.dev,
            args.timeout)
    multi_s = time.time() - t0
    t1 = time.time()
    run_job(conf, os.path.join(out, "single"), 1, args.dev, args.timeout)
    single_s = time.time() - t1
    multi = read_rounds(os.path.join(out, "multi"))
    single = read_rounds(os.path.join(out, "single"))
    problems = []
    if sorted(multi) != sorted(single) or len(single) != NUM_ROUND + 1:
        problems.append(f"rounds written: {args.ranks} ranks "
                        f"{sorted(multi)}, one rank {sorted(single)}")
    worst, equal = 0.0, True
    for r in sorted(set(multi) & set(single)):
        a, b = multi[r][2], single[r][2]
        for leaf in b:
            d = float(np.abs(a[leaf] - b[leaf]).max())
            worst = max(worst, d)
            equal = equal and np.array_equal(a[leaf], b[leaf])
    if worst > args.tol:
        problems.append(f"{args.ranks} ranks vs one: max |dw| {worst:g} > "
                        f"{args.tol:g}")
    doc = {
        "bench": "mesh_parity", "ranks": args.ranks, "dev": args.dev,
        "rounds": NUM_ROUND,
        "global_batch": GLOBAL_BATCH, "max_abs_dw": worst, "tol": args.tol,
        "bit_equal": equal,
        "crcs": {str(k): f"{v[0]:#010x}" for k, v in sorted(multi.items())},
        "mesh": multi[max(multi)][1] if multi else None,
        "multi_wall_s": round(multi_s, 3), "single_wall_s": round(single_s, 3),
        "problems": problems, "verdict": "ok" if not problems else "fail",
    }
    with open(os.path.join(out, "mesh_parity.json"), "w",
              encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc, indent=1))
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
