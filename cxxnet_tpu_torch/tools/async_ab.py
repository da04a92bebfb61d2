"""The async lane: bitwise parity and the bounded-staleness convergence
A/B, on the port.

The port's ``tools/async_ab.py``.  The async data-parallel step
(``parallel/async_ps``, ``async_overlap = 1``) makes two claims, and
this tool runs both through the port's CLI, every leg as ``--ranks``
rank processes on ``--dev`` (``gpu:0`` by default, the ranks sharing the
card over gloo; ``--dev cpu`` on the CPU; ``tools/_ranks.py``):

* ``--parity``: **bitwise**.  A CLI train with ``async_overlap = 1,
  staleness = 0`` must write checkpoint CRCs identical to the
  synchronous ``det_reduce = 1`` step of the same conf and seed (the
  same all-gather and rank-order fold, the same updater math).  A CRC
  mismatch fails.
* the default (A/B): **measured convergence**.  ``staleness > 0``
  changes the math (k-step-delayed aggregates), so it is gated on the
  real handwritten digits (``tools/digits_uci.npz`` through
  ``make_digits_idx``, the digits MLP, fixed seeds): sync against
  staleness 0, 1 and 2 on the same stream, the final test error and
  the wall-clock deltas in the JAX tool's verdict JSON.  ``staleness =
  0`` must match sync exactly; ``staleness = 1`` must stay within
  ``--tol`` of sync at full lr; ``staleness = 2`` at full lr is
  measured and recorded (a reject is expected: delay times momentum),
  and must pass within ``--tol`` under the standard mitigation (lr
  halved, rounds doubled) against the same-lr sync baseline.
* ``--overlap-bench``: the step wall of the sync step (a fence each
  step) against the async step (one fence a round) over the same
  stream, ``--steps`` steps of a ``--hidden``-wide MLP on every rank
  (rank processes of this tool, ``--overlap-rank``).
* ``--smoke``: the parity gate at 2 rounds and the A/B's sync and
  staleness-0 legs at 3 rounds on 64 images.

Usage::

    python -m cxxnet_tpu_torch.tools.async_ab --parity --out /tmp/_async
    python -m cxxnet_tpu_torch.tools.async_ab --out /tmp/_async
    python -m cxxnet_tpu_torch.tools.async_ab --smoke --out /tmp/_async \\
        [--ranks 2] [--dev gpu:0|cpu]

Prints the verdict JSON (also ``<out>/async_ab.json``); exit 0 when
every gate holds, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N_IMAGES = 256
GLOBAL_BATCH = 32


def make_data(out_dir: str, n_images: int) -> None:
    import numpy as np

    from ..io.mnist import write_idx_images, write_idx_labels

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (n_images, 4, 4)).astype(np.uint8)
    labels = (imgs.reshape(n_images, -1).mean(1) > 127).astype(np.uint8)
    write_idx_images(os.path.join(out_dir, "img.idx"), imgs)
    write_idx_labels(os.path.join(out_dir, "lab.idx"), labels)


def make_conf(out_dir: str, rounds: int, save_model: int) -> str:
    """The MNIST-MLP conf the parity legs share (fixed seed; a leg's keys
    ride as CLI overrides); an eval section scores the set each round,
    so the telemetry carries ``test-error``."""
    conf = os.path.join(out_dir, "async_ab.conf")
    with open(conf, "w", encoding="utf-8") as f:
        f.write(f"""
data = train
iter = mnist
  path_img = "{out_dir}/img.idx"
  path_label = "{out_dir}/lab.idx"
  shuffle = 1
  dist_shard = block
iter = end
eval = test
iter = mnist
  path_img = "{out_dir}/img.idx"
  path_label = "{out_dir}/lab.idx"
iter = end
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 16
  init_sigma = 0.1
layer[fc1->out] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = {GLOBAL_BATCH}
num_round = {rounds}
eval_train = 0
eta = 0.1
momentum = 0.9
seed = 7
save_model = {save_model}
metric = error
silent = 1
telemetry = 1
""")
    return conf


def read_telemetry(rank_dir: str) -> dict:
    """The last telemetry record of a leg (the final round's eval and
    the async block)."""
    last = {}
    try:
        with open(os.path.join(rank_dir, "telemetry.jsonl"), "r",
                  encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    last = json.loads(line)
    except (OSError, ValueError):
        return {}
    return last


def read_crcs(rank_dir: str) -> dict:
    from ..utils import checkpoint as ckpt

    out = {}
    for round_, path in ckpt.list_checkpoints(
            os.path.join(rank_dir, "models")):
        man = ckpt.read_manifest(path)
        if man is not None:
            out[round_] = man["crc32"]
    return out


def final_error(tele: dict) -> float:
    ev = tele.get("eval") or {}
    for k in sorted(ev):
        if "test-" in k and "error" in k:
            return float(ev[k])
    return float("nan")


def run_parity(out_dir: str, rounds: int, ranks: int, dev: str,
               timeout: float) -> dict:
    """The hard gate: the async (staleness = 0) leg's checkpoint CRCs
    equal the ``det_reduce`` sync leg's, checkpoint for checkpoint."""
    from ._ranks import run_ranks

    workdir = os.path.join(out_dir, "parity")
    conf = make_conf(out_dir, rounds, save_model=1)
    legs = {}
    for name, over in (("sync", ["det_reduce=1"]),
                       ("async0", ["async_overlap=1", "staleness=0"])):
        wall = run_ranks(conf, os.path.join(workdir, name), over, ranks,
                         dev, timeout)
        crcs = read_crcs(os.path.join(workdir, name, "p0"))
        legs[name] = {"wall_sec": round(wall, 3), "crcs": crcs}
    problems = []
    if not legs["sync"]["crcs"]:
        problems.append("parity: sync leg wrote no checkpoints")
    if legs["sync"]["crcs"] != legs["async0"]["crcs"]:
        problems.append(
            f"BITWISE PARITY FAILED: sync CRCs {legs['sync']['crcs']} "
            f"!= async CRCs {legs['async0']['crcs']}")
    return {
        "crc_equal": legs["sync"]["crcs"] == legs["async0"]["crcs"]
        and bool(legs["sync"]["crcs"]),
        "rounds": rounds,
        "sync_wall_sec": legs["sync"]["wall_sec"],
        "async_wall_sec": legs["async0"]["wall_sec"],
        "crcs": {str(k): f"{v:#010x}" for k, v in
                 sorted(legs["sync"]["crcs"].items())},
        "problems": problems,
    }


def make_digits_conf(out_dir: str) -> str:
    """The real-data A/B conf: the digits MLP on the UCI digits
    (``make_digits_idx``), batch 48 so that 2, 3, 4 or 6 ranks divide
    it; eta, num_round and the async keys ride a leg as overrides."""
    from .make_digits_idx import write_digits_idx

    data_dir = os.path.join(out_dir, "data")
    write_digits_idx(data_dir)
    conf = os.path.join(out_dir, "async_digits.conf")
    with open(conf, "w", encoding="utf-8") as f:
        f.write(f"""
data = train
iter = mnist
  path_img = "{data_dir}/digits-train-images-idx3-ubyte"
  path_label = "{data_dir}/digits-train-labels-idx1-ubyte"
  shuffle = 1
iter = end
eval = test
iter = mnist
  path_img = "{data_dir}/digits-t10k-images-idx3-ubyte"
  path_label = "{data_dir}/digits-t10k-labels-idx1-ubyte"
iter = end
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 100
  init_sigma = 0.01
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = 10
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end
input_shape = 1,1,64
batch_size = 48
eval_train = 0
random_type = gaussian
seed = 1
eta = 0.1
momentum = 0.9
save_model = 0
metric[label] = error
silent = 1
telemetry = 1
""")
    return conf


def run_ab(out_dir: str, rounds: int, tol: float, ranks: int, dev: str,
           timeout: float, smoke: bool = False) -> dict:
    """The convergence A/B on the digits, ``save_model = 0`` (no
    checkpoint drains the staleness pipeline; the resync period caps
    it).  Each leg's verdict: ``exact`` (the same-math leg), ``pass`` /
    ``reject`` by ``tol`` for the stale legs; a reject is a recorded
    measurement and fails the run only where the contract says the leg
    must pass."""
    from ._ranks import run_ranks

    workdir = os.path.join(out_dir, "ab")
    conf = make_digits_conf(out_dir)
    asynck = ["async_overlap=1", "async_resync_period=1000"]
    specs = [
        # name, overrides, baseline leg, must_pass
        ("sync", ["det_reduce=1", f"num_round={rounds}"], None, True),
        ("staleness0", asynck + ["staleness=0", f"num_round={rounds}"],
         "sync", True),
        ("staleness1", asynck + ["staleness=1", f"num_round={rounds}"],
         "sync", True),
        ("staleness2", asynck + ["staleness=2", f"num_round={rounds}"],
         "sync", False),  # full-lr delay 2: measured, a reject expected
        ("sync_lr_backoff",
         ["det_reduce=1", "eta=0.05", f"num_round={2 * rounds}"],
         None, True),
        ("staleness2_lr_backoff",
         asynck + ["staleness=2", "eta=0.05", f"num_round={2 * rounds}"],
         "sync_lr_backoff", True),  # the standard mitigation must work
    ]
    if smoke:  # exactness and the schema only
        specs = [s for s in specs if s[0] in ("sync", "staleness0")]
    legs, problems = {}, []
    for name, over, _base, _must in specs:
        d = os.path.join(workdir, name)
        wall = run_ranks(conf, d, over, ranks, dev, timeout)
        tele = read_telemetry(os.path.join(d, "p0"))
        err = final_error(tele)
        leg = {"final_err": err, "wall_sec": round(wall, 3),
               "rounds": tele.get("round")}
        a = tele.get("async")
        if a:
            leg["overlap_fraction"] = a.get("overlap_fraction")
            leg["pushes"] = a.get("pushes")
            leg["applies"] = a.get("applies")
        legs[name] = leg
        if err != err:  # NaN
            problems.append(f"{name}: no test-error in telemetry")
    deltas = {}
    for name, _over, base, must_pass in specs:
        if base is None:
            legs[name]["verdict"] = "baseline"
            continue
        base_err = legs[base]["final_err"]
        delta = abs(legs[name]["final_err"] - base_err)
        if name == "staleness0":
            ok = legs[name]["final_err"] == base_err
            legs[name]["verdict"] = "exact" if ok else "reject"
            if not ok:
                problems.append(
                    f"staleness=0 final error {legs[name]['final_err']} "
                    f"!= sync {base_err} (must be exact: the same math)")
            continue
        deltas[name] = {
            "err_delta": round(delta, 6),
            "vs": base,
            "wall_delta_sec": round(
                legs[name]["wall_sec"] - legs[base]["wall_sec"], 3),
        }
        ok = delta <= tol
        legs[name]["verdict"] = "pass" if ok else "reject"
        if must_pass and not ok:
            problems.append(
                f"{name}: final error {legs[name]['final_err']} drifted "
                f"{delta:.4f} > tol {tol} from {base} {base_err}")
    return {"legs": legs, "deltas": deltas, "tol": tol,
            "dataset": "uci-digits (cxxnet_tpu_torch/tools/digits_uci.npz)",
            "problems": problems}


# ----------------------------------------------------------------------
# --overlap-bench: one process per rank
def overlap_rank(spec_path: str, rank: int) -> int:
    """One rank of the overlap bench: the sync and the async trainer
    over the same stream; rank 0 writes the timings to the spec's
    ``result``."""
    import numpy as np

    from ..io.data import DataBatch
    from ..nnet.trainer import NetTrainer
    from ..parallel import distributed as pdist

    spec = json.load(open(spec_path))
    ranks, steps, hidden = spec["ranks"], spec["steps"], spec["hidden"]
    pdist.init_distributed(spec["coord"], ranks, rank, dev=spec["dev"],
                           timeout_s=spec["timeout"])
    bs, nin, nout = 64, 64, 8
    local = bs // ranks
    cfg = [
        ("dev", spec["dev"]), ("batch_size", str(bs)),
        ("input_shape", f"1,1,{nin}"), ("seed", "7"), ("eta", "0.05"),
        ("eval_train", "0"),
        ("netconfig", "start"),
        ("layer[0->1]", "fullc:fc1"), ("nhidden", str(hidden)),
        ("layer[1->2]", "sigmoid"),
        ("layer[2->3]", "fullc:fc2"), ("nhidden", str(nout)),
        ("layer[3->3]", "softmax"),
        ("netconfig", "end"),
    ]
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(steps):
        data = rng.randn(bs, nin).astype(np.float32)
        label = rng.randint(0, nout, (bs, 1)).astype(np.float32)
        rows = slice(rank * local, (rank + 1) * local)
        batches.append(DataBatch(data=data[rows], label=label[rows]))
    out = {"dev": spec["dev"], "ranks": ranks, "steps": steps,
           "hidden": hidden}
    for name, extra in (("sync", [("det_reduce", "1")]),
                        ("async", [("async_overlap", "1"),
                                   ("staleness", "1"),
                                   ("async_resync_period", "1")])):
        tr = NetTrainer()
        tr.set_params(cfg + extra)
        tr.init_model()
        if name == "async" and not tr._async_active():
            raise SystemExit("overlap-bench: async mode inactive")
        tr.update(batches[0])  # the first step's set-up off the clock
        tr.sync() if name == "sync" else tr.async_round_end(0)
        pdist.barrier("overlap-bench")
        t0 = time.perf_counter()
        for b in batches:
            tr.update(b)
            if name == "sync":
                tr.sync()
        if name == "async":
            tr.async_round_end(1)
        wall = time.perf_counter() - t0
        out[f"{name}_step_wall_sec"] = round(wall / steps, 6)
        if name == "async":
            out["overlap_fraction"] = round(
                tr.async_snapshot()["overlap_fraction"], 4)
    out["speedup"] = round(
        out["sync_step_wall_sec"] / out["async_step_wall_sec"], 3)
    pdist.barrier("overlap-bench-end")
    pdist.shutdown_distributed()
    if rank == 0:
        with open(spec["result"], "w", encoding="utf-8") as f:
            json.dump(out, f)
    return 0


def run_overlap_bench(out_dir: str, ranks: int, dev: str, steps: int,
                      hidden: int, timeout: float) -> dict:
    """The step-wall bench as ``ranks`` processes of this tool."""
    from ..parallel.elastic import free_port
    from ._ranks import REPO, rank_devices

    if ranks < 2:
        raise SystemExit("--overlap-bench needs --ranks >= 2 (async mode "
                         "is a no-op on one rank)")
    spec = {"ranks": ranks, "steps": steps, "hidden": hidden,
            "coord": f"127.0.0.1:{free_port()}", "timeout": timeout,
            "result": os.path.join(out_dir, "overlap.json")}
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for r, rdev in enumerate(rank_devices(dev, ranks)):
        path = os.path.join(out_dir, f"overlap_spec{r}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dict(spec, dev=rdev), f)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch.tools.async_ab",
             "--overlap-rank", path, str(r)], env=env))
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"overlap-bench ranks exited {codes}")
    with open(spec["result"], encoding="utf-8") as f:
        return json.load(f)


def validate_doc(doc: dict):
    problems = []
    for key in ("bench", "ts", "verdict"):
        if key not in doc:
            problems.append(f"verdict missing key {key!r}")
    if doc.get("verdict") not in ("ok", "fail"):
        problems.append(f"bad verdict {doc.get('verdict')!r}")
    legs = (doc.get("ab") or {}).get("legs")
    if legs is not None:
        for name, leg in legs.items():
            for f in ("final_err", "wall_sec"):
                if not isinstance(leg.get(f), (int, float)):
                    problems.append(f"leg {name}: missing {f}")
    return problems


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="async_ab_out")
    ap.add_argument("--rounds", type=int, default=15,
                    help="A/B rounds at full lr (the digits.conf budget; "
                         "the lr-backoff legs run 2x)")
    ap.add_argument("--tol", type=float, default=0.1,
                    help="allowed |final_err - sync| for staleness > 0")
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="each leg's wall budget (seconds)")
    ap.add_argument("--parity", action="store_true",
                    help="only the bitwise parity gate")
    ap.add_argument("--smoke", action="store_true",
                    help="the parity gate and a tiny A/B")
    ap.add_argument("--overlap-bench", action="store_true",
                    help="the sync and async step walls on --ranks ranks")
    ap.add_argument("--ranks", type=int, default=4,
                    help="rank processes of every leg")
    ap.add_argument("--dev", default="gpu:0",
                    help="every rank's dev (cpu: the ranks on the CPU; "
                         "a list of one device a rank)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--json", dest="json_path", default="")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 3 and argv[0] == "--overlap-rank":
        return overlap_rank(argv[1], int(argv[2]))
    args = build_parser().parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    doc = {"bench": "async_ab", "ts": time.time(), "ranks": args.ranks,
           "dev": args.dev}
    problems = []
    if args.overlap_bench:
        doc["overlap"] = run_overlap_bench(out, args.ranks, args.dev,
                                           args.steps, args.hidden,
                                           args.timeout)
        o = doc["overlap"]
        print(f"bench[async_overlap:{o['dev']}] "
              f"sync_step={o['sync_step_wall_sec']}s "
              f"async_step={o['async_step_wall_sec']}s "
              f"speedup={o['speedup']}x "
              f"overlap_fraction={o['overlap_fraction']}")
    else:
        try:
            make_data(out, 64 if args.smoke else N_IMAGES)
            # the parity gate always runs in data mode: a verdict
            # without the bitwise proof is half the contract
            doc["parity"] = run_parity(out, 2 if args.smoke else 3,
                                       args.ranks, args.dev, args.timeout)
            problems += doc["parity"]["problems"]
            if not args.parity:
                doc["ab"] = run_ab(out, 3 if args.smoke else args.rounds,
                                   args.tol, args.ranks, args.dev,
                                   args.timeout, smoke=args.smoke)
                problems += doc["ab"]["problems"]
        except RuntimeError as e:
            # a failed or timed-out leg still writes a fail verdict with
            # the ranks' output
            problems.append(f"leg failure: {str(e)[:6000]}")
    doc["problems"] = problems
    doc["verdict"] = "ok" if not problems else "fail"
    schema_problems = validate_doc(doc)
    if schema_problems:
        problems += schema_problems
        doc["problems"] = problems
        doc["verdict"] = "fail"
    json_path = args.json_path or os.path.join(out, "async_ab.json")
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc, indent=1))
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
