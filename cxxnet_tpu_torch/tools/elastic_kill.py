"""The elastic pod's kill-and-rejoin lane: a replica lost mid-round,
recovered bit for bit.

The port's ``tools/elastic_kill.py``, through the port's CLI on gloo
ranks, every rank on ``--dev`` (``gpu:0`` by default: the ranks share
the card; ``--dev cpu`` runs them on the CPU):

* **Run A (churn)**: ``--ranks`` processes (4 by default) train an MLP
  on MNIST-format idx files with ``elastic = 1``.  The highest rank is
  SIGKILLed mid-round, once ``KILL_AFTER_CKPT``'s checkpoint is
  durable; the survivors detect the loss, tear the group down, join a
  group one rank smaller within the same invocation, reload the
  consensus round and train on.  A process started with
  ``elastic_join = 1`` waits out the churn and is admitted at a pinned
  later boundary, growing the group back.
* **Run B (planned)**: the same shrink and grow, by ``elastic_drop_at``
  and ``elastic_join_at``, with no kill.  Its boundaries are the ones
  the coordinator gives run A: the shrink at the round after
  ``KILL_AFTER_CKPT``, the grow at ``max(JOIN_AT, that round + 2)``
  (the coordinator's rule); the two runs go at the same time, and the
  rounds run A resumed and grew at are checked against them.
  (``--sequential`` runs B after A at A's observed rounds, as the JAX
  lane does.)
* **Parity**: the manifest CRC32 of every checkpoint of the two runs
  must be equal.  ``det_reduce = 1`` fixes the order of the gradient
  sums, ``dist_shard = block`` the rows of each rank, and ``save_ustate
  = 1`` carries the updater state across every rebuild.
* ``--kill-checkpoint``: 3 ranks shrink to 2 at ``CKPT_DROP_AT``; rank
  0 is SIGKILLed inside the first checkpoint write after it (between
  the temp file's fsync and its rename, ``CXXNET_DISKIO_KILL_AT``), the
  others too; a fresh 2-rank job with ``continue = 1`` must resume from
  the round before, every surviving checkpoint valid.

It prints a verdict JSON (the rebuild's seconds, the recovered
samples/s, the CRC equality) and writes it to ``<out>/elastic.json``
(``elastic_crash.json`` for ``--kill-checkpoint``).

Usage::

    python -m cxxnet_tpu_torch.tools.elastic_kill --out /tmp/elastic \\
        [--ranks 3] [--dev gpu:0|cpu] [--kill-checkpoint]

Exit code 0 when the schedule replayed and every CRC matches, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NUM_ROUND = 8
GLOBAL_BATCH = 12          # divides 4, 3 and 2 ranks
N_IMAGES = 1920            # 160 global batches a round
N_HIDDEN = 256             # enough work a round to kill in the middle
KILL_AFTER_CKPT = 3        # SIGKILL once 0003.model is durable
JOIN_AT = 7                # the grow boundary (start_counter units)
# --kill-checkpoint: shrink 3 -> 2 at this boundary, then SIGKILL rank
# 0 inside the first checkpoint write after the rebuild
CKPT_DROP_AT = 4
KILL_CKPT_ROUND = 5


def _free_port() -> int:
    from cxxnet_tpu_torch.parallel.elastic import free_port

    return free_port()


def make_data(out_dir: str) -> None:
    import numpy as np

    from cxxnet_tpu_torch.io.mnist import write_idx_images, write_idx_labels

    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (N_IMAGES, 4, 4)).astype(np.uint8)
    labels = (imgs.reshape(N_IMAGES, -1).mean(1) > 127).astype(np.uint8)
    write_idx_images(os.path.join(out_dir, "img.idx"), imgs)
    write_idx_labels(os.path.join(out_dir, "lab.idx"), labels)


def make_conf(out_dir: str, dev: str, heartbeat_s: float,
              timeout_s: float) -> str:
    """One conf for every process of both runs; the per-run and per-rank
    keys are overrides.  ``model_dir`` is one absolute directory a run:
    the consensus reload and the joiner read rank 0's checkpoints."""
    conf = os.path.join(out_dir, "elastic.conf")
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
  nhidden = {N_HIDDEN}
  init_sigma = 0.1
layer[fc1->out] = fullc:fc2
  nhidden = 2
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,16
batch_size = {GLOBAL_BATCH}
dev = {dev}
num_round = {NUM_ROUND}
eval_train = 0
eta = 0.1
momentum = 0.9
seed = 7
save_ustate = 1
det_reduce = 1
metric = error
silent = 1
telemetry = 1
print_step = 0
dist_timeout_s = 60
elastic = 1
elastic_min_replicas = 2
elastic_heartbeat_s = {heartbeat_s:g}
elastic_timeout_s = {timeout_s:g}
collective_timeout_s = 30
""")
    return conf


def launch_rank(conf: str, workdir: str, model_dir: str, rank: int,
                nproc: int, dist_port: int, elastic_port: int,
                extra=(), extra_env=None, tag=None):
    """One rank process (``rank = -1``: a joiner, no ``dist_*`` keys),
    its output in ``<workdir>/p<rank>/out.log``."""
    tag = rank if tag is None else tag
    d = os.path.join(workdir, f"p{tag}")
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("CXN_COORDINATOR", "CXN_NUM_PROC", "CXN_PROC_ID", "PS_RANK"):
        env.pop(k, None)
    if extra_env:
        env.update(extra_env)
    over = [f"model_dir={model_dir}",
            f"elastic_coordinator=127.0.0.1:{elastic_port}",
            "event_log=events.jsonl"]
    if rank >= 0:
        over += [f"dist_coordinator=127.0.0.1:{dist_port}",
                 f"dist_num_proc={nproc}", f"dist_proc_id={rank}"]
    over += list(extra)
    log = open(os.path.join(d, "out.log"), "wb")
    p = subprocess.Popen(
        [sys.executable, "-u", "-m", "cxxnet_tpu_torch", conf] + over,
        env=env, cwd=d, stdout=log, stderr=subprocess.STDOUT)
    p._log_file = log  # type: ignore[attr-defined]
    p._workdir = workdir  # type: ignore[attr-defined]
    p._rank = tag  # type: ignore[attr-defined]
    return p


def rank_log(workdir: str, rank) -> str:
    try:
        with open(os.path.join(workdir, f"p{rank}", "out.log"), "r",
                  encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def rank_events(workdir: str, rank) -> list:
    out = []
    try:
        with open(os.path.join(workdir, f"p{rank}", "events.jsonl"), "r",
                  encoding="utf-8") as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    except OSError:
        pass
    return out


def wait_for_checkpoint(model_dir: str, round_: int, procs,
                        timeout: float) -> bool:
    """Wait until ``<round>.model``'s manifest is durable (False when
    every process exited or the time ran out)."""
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    want = ckpt.manifest_path(os.path.join(model_dir, f"{round_:04d}.model"))
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(want):
            return True
        if all(p.poll() is not None for p in procs):
            return False
        time.sleep(0.01)
    return False


def drain(procs, timeout: float, problems, tag: str,
          expect_fail_ranks=()) -> None:
    deadline = time.time() + timeout
    for p in procs:
        left = max(1.0, deadline - time.time())
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            problems.append(f"{tag}: rank {p._rank} process timed out")
        finally:
            p._log_file.close()
    for p in procs:
        if p._rank in expect_fail_ranks:
            continue
        if p.returncode != 0:
            problems.append(
                f"{tag}: rank {p._rank} exited rc={p.returncode}; "
                "tail:\n" + rank_log(p._workdir, p._rank)[-2500:])


def read_crcs(model_dir: str) -> dict:
    from cxxnet_tpu_torch.utils import checkpoint as ckpt

    out = {}
    for round_, path in ckpt.list_checkpoints(model_dir):
        man = ckpt.read_manifest(path)
        if man is not None:
            out[round_] = man["crc32"]
    return out


def read_telemetry(workdir: str, rank=0) -> list:
    path = os.path.join(workdir, f"p{rank}", "telemetry.jsonl")
    recs = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    recs.append(json.loads(line))
    except (OSError, ValueError):
        pass
    return recs


def _resumes(log: str, reason: str) -> list:
    return [int(m) for m in re.findall(
        reason + r" -> rebuilding.*?\n.*?resuming at round (\d+)", log, re.S)]


def start_churn(conf, workdir, model_dir, ranks: int, join_at: int):
    """Run A's processes: ``ranks`` ranks and one waiting joiner."""
    os.makedirs(model_dir, exist_ok=True)
    dist_port, elastic_port = _free_port(), _free_port()
    procs = [launch_rank(conf, workdir, model_dir, r, ranks, dist_port,
                         elastic_port) for r in range(ranks)]
    joiner = launch_rank(
        conf, workdir, model_dir, -1, 0, dist_port, elastic_port,
        extra=["elastic_join=1", f"elastic_join_at={join_at}",
               "elastic_rejoin_s=240"], tag="j")
    return procs, joiner


def finish_churn(workdir, model_dir, procs, joiner, timeout: float,
                 problems) -> dict:
    """Kill the highest rank once ``KILL_AFTER_CKPT``'s checkpoint is
    durable; wait for the rest."""
    kill_rank = len(procs) - 1  # never rank 0: it hosts the coordinator
    killed_at = None
    if wait_for_checkpoint(model_dir, KILL_AFTER_CKPT, procs,
                           timeout=timeout / 2):
        time.sleep(0.05)  # the next round under way
        procs[kill_rank].send_signal(signal.SIGKILL)
        killed_at = time.time()
        print(f"churn: SIGKILLed rank {kill_rank} after checkpoint "
              f"{KILL_AFTER_CKPT:04d}.model", flush=True)
    else:
        problems.append(f"churn: checkpoint {KILL_AFTER_CKPT:04d}.model "
                        "never appeared; cannot stage the kill")
    drain(procs + [joiner], timeout, problems, "churn",
          expect_fail_ranks={kill_rank})
    if procs[kill_rank].returncode == 0:
        problems.append("churn: the killed rank exited 0 (the kill landed "
                        "after training ended)")
    log0 = rank_log(workdir, 0)
    resume = _resumes(log0, "replica_lost")
    grows = _resumes(log0, "grow")
    if not resume:
        problems.append("churn: rank 0 never rebuilt after the kill; log "
                        "tail:\n" + log0[-2500:])
    if not grows:
        problems.append("churn: the group never grew back (joiner log "
                        "tail:\n" + rank_log(workdir, "j")[-1500:] + ")")
    tele = read_telemetry(workdir)
    rebuild_s = max((r.get("elastic", {}).get("last_rebuild_s", 0.0)
                     for r in tele), default=0.0)
    post = [r for r in tele if r.get("elastic", {}).get("rebuilds", 0)]
    rate = (post[-1].get("step", {}).get("samples_per_sec", 0.0)
            if post else 0.0)
    starts = [e for e in rank_events(workdir, 0)
              if e.get("kind") == "mesh.rebuild_start"]
    detect = (starts[0]["ts"] - killed_at
              if starts and killed_at is not None else None)
    return {
        "resume_round": resume[0] if resume else None,
        "grow_round": grows[0] if grows else None,
        "rebuild_wall_s": rebuild_s,
        "kill_to_rebuild_start_s": detect,
        "recovered_samples_per_sec": rate,
        "kill_staged": killed_at is not None,
    }


def start_planned(conf, workdir, model_dir, ranks: int, drop_at: int,
                  join_at: int):
    """Run B's processes: the same schedule, resized on purpose."""
    os.makedirs(model_dir, exist_ok=True)
    dist_port, elastic_port = _free_port(), _free_port()
    procs = [launch_rank(conf, workdir, model_dir, r, ranks, dist_port,
                         elastic_port, extra=[f"elastic_drop_at={drop_at}"])
             for r in range(ranks)]
    joiner = launch_rank(
        conf, workdir, model_dir, -1, 0, dist_port, elastic_port,
        extra=["elastic_join=1", f"elastic_join_at={join_at}",
               "elastic_rejoin_s=240"], tag="j")
    return procs, joiner


def finish_planned(workdir, procs, joiner, timeout: float, problems) -> dict:
    drain(procs + [joiner], timeout, problems, "planned")
    last = len(procs) - 1
    log = rank_log(workdir, last)
    if "left the mesh" not in log:
        problems.append(f"planned: rank {last} never left as planned; log "
                        "tail:\n" + log[-2000:])
    tele = read_telemetry(workdir)
    rebuild_s = max((r.get("elastic", {}).get("last_rebuild_s", 0.0)
                     for r in tele), default=0.0)
    return {"rebuild_wall_s": rebuild_s}


def run_kill_checkpoint(conf: str, workdir: str, model_dir: str,
                        timeout: float, problems) -> dict:
    """``--kill-checkpoint``: kill -9 inside the consensus checkpoint's
    write.  A 3-rank group shrinks to 2 at ``CKPT_DROP_AT`` (a planned
    departure); rank 0 carries ``CXXNET_DISKIO_KILL_AT=<round>.model:2``,
    so its SIGKILL lands between the temp file's fsync and its rename:
    the torn temp file is on disk, the published name is not.  The
    survivor is killed too (the whole group's power lost).  A fresh
    2-rank group with ``continue = 1`` must resume from the round
    before, every surviving manifest valid."""
    from cxxnet_tpu_torch.utils import checkpoint as ckpt
    from cxxnet_tpu_torch.utils import diskio

    os.makedirs(model_dir, exist_ok=True)
    dist_port, elastic_port = _free_port(), _free_port()
    kill_env = {diskio.KILL_ENV: f"{KILL_CKPT_ROUND:04d}.model:2"}
    procs = [launch_rank(conf, workdir, model_dir, r, 3, dist_port,
                         elastic_port,
                         extra=[f"elastic_drop_at={CKPT_DROP_AT}"],
                         extra_env=kill_env if r == 0 else None)
             for r in range(3)]
    t0 = time.time()
    while procs[0].poll() is None and time.time() - t0 < timeout:
        time.sleep(0.1)
    if procs[0].poll() is None:
        problems.append("kill-checkpoint: rank 0 never reached the staged "
                        f"kill inside the round-{KILL_CKPT_ROUND} checkpoint "
                        "write")
    for p in procs[1:]:
        p.send_signal(signal.SIGKILL)
    drain(procs, 60, problems, "kill-checkpoint",
          expect_fail_ranks={0, 1, 2})
    if procs[0].returncode != -signal.SIGKILL:
        problems.append("kill-checkpoint: rank 0 exited "
                        f"rc={procs[0].returncode}, expected SIGKILL; "
                        "tail:\n" + rank_log(workdir, 0)[-2000:])
    # the crash window: a torn temp file, no published name, every
    # surviving checkpoint valid, the resume target the round before
    target = os.path.join(model_dir, f"{KILL_CKPT_ROUND:04d}.model")
    tmp_orphan = any(f".{KILL_CKPT_ROUND:04d}.model.tmp." in n
                     for n in os.listdir(model_dir))
    if os.path.exists(target):
        problems.append(f"kill-checkpoint: {os.path.basename(target)} was "
                        "published despite the kill inside its write")
    if not tmp_orphan:
        problems.append("kill-checkpoint: no torn temp file: the kill did "
                        "not land inside the write")
    for round_, path in ckpt.list_checkpoints(model_dir):
        reason = ckpt.validate_checkpoint(path)
        if reason is not None:
            problems.append(f"kill-checkpoint: surviving round {round_} "
                            f"invalid after the crash: {reason}")
    latest = ckpt.find_latest_valid(model_dir, silent=True)
    if latest is None or latest[0] != KILL_CKPT_ROUND - 1:
        problems.append("kill-checkpoint: the resume target is "
                        f"{latest and latest[0]}, expected round "
                        f"{KILL_CKPT_ROUND - 1}")
    # the restart: a fresh 2-rank group goes on from that round
    t1 = time.time()
    restart_dir = os.path.join(workdir, "restart")
    dist_port, elastic_port = _free_port(), _free_port()
    rprocs = [launch_rank(conf, restart_dir, model_dir, r, 2, dist_port,
                          elastic_port, extra=["continue=1"])
              for r in range(2)]
    drain(rprocs, timeout, problems, "kill-checkpoint-restart")
    restart_s = time.time() - t1
    log0 = rank_log(restart_dir, 0)
    if f"Continue training from round {KILL_CKPT_ROUND}" not in log0:
        problems.append("kill-checkpoint: the restart did not resume from "
                        f"round {KILL_CKPT_ROUND - 1}; tail:\n" + log0[-2000:])
    crcs = read_crcs(model_dir)
    if len(crcs) != NUM_ROUND + 1:
        problems.append(f"kill-checkpoint: the restart ended with rounds "
                        f"{sorted(crcs)}, expected {NUM_ROUND + 1}")
    for round_, path in ckpt.list_checkpoints(model_dir):
        reason = ckpt.validate_checkpoint(path)
        if reason is not None:
            problems.append(f"kill-checkpoint: round {round_} invalid after "
                            f"the restart: {reason}")
    return {"tmp_orphan": tmp_orphan,
            "resumed_from": latest[0] if latest else None,
            "restart_wall_s": round(restart_s, 3),
            "rounds_final": len(crcs)}


def _verdict(doc: dict, problems: list, path: str) -> int:
    doc.update(problems=problems, verdict="ok" if not problems else "fail")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc, indent=1))
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    return 1 if problems else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="elastic_lane",
                    help="scratch and verdict directory")
    ap.add_argument("--ranks", type=int, default=4,
                    help="run A's and run B's ranks before the shrink")
    ap.add_argument("--dev", default="gpu:0",
                    help="every rank's dev (cpu: the ranks on the CPU)")
    ap.add_argument("--timeout", type=float, default=420.0,
                    help="each run's wall-clock budget (seconds)")
    ap.add_argument("--heartbeat-s", type=float, default=0.25)
    ap.add_argument("--elastic-timeout-s", type=float, default=3.0)
    ap.add_argument("--json", dest="json_path", default="",
                    help="the verdict's path (default <out>/elastic.json)")
    ap.add_argument("--sequential", action="store_true",
                    help="run B after run A, at A's observed rounds")
    ap.add_argument("--kill-checkpoint", action="store_true",
                    help="run only the kill inside the consensus "
                    "checkpoint's write (<out>/elastic_crash.json)")
    args = ap.parse_args(argv)
    if args.ranks < 3:
        ap.error("--ranks must be at least 3 (elastic_min_replicas = 2)")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    make_data(out)
    conf = make_conf(out, args.dev, args.heartbeat_s, args.elastic_timeout_s)
    problems: list = []
    t0 = time.time()
    if args.kill_checkpoint:
        crash_dir = os.path.join(out, "killckpt")
        res = run_kill_checkpoint(conf, crash_dir,
                                  os.path.join(crash_dir, "models"),
                                  args.timeout, problems)
        doc = {"bench": "elastic_crash", "ts": time.time(),
               "wall_sec": round(time.time() - t0, 3), **res}
        return _verdict(doc, problems, args.json_path or os.path.join(
            out, "elastic_crash.json"))
    churn_dir, planned_dir = (os.path.join(out, "churn"),
                              os.path.join(out, "planned"))
    churn_models = os.path.join(churn_dir, "models")
    planned_models = os.path.join(planned_dir, "models")
    drop_at = KILL_AFTER_CKPT + 1
    join_at = max(JOIN_AT, drop_at + 2)
    a = start_churn(conf, churn_dir, churn_models, args.ranks, JOIN_AT)
    b = None
    if not args.sequential:
        b = start_planned(conf, planned_dir, planned_models, args.ranks,
                          drop_at, join_at)
    churn = finish_churn(churn_dir, churn_models, *a, args.timeout, problems)
    churn_s = time.time() - t0
    if args.sequential and churn["resume_round"] is not None:
        drop_at = churn["resume_round"]
        join_at = churn["grow_round"] or JOIN_AT
        b = start_planned(conf, planned_dir, planned_models, args.ranks,
                          drop_at, join_at)
    elif (churn["resume_round"], churn["grow_round"]) != (drop_at, join_at):
        problems.append(
            f"churn: resumed at round {churn['resume_round']} and grew at "
            f"{churn['grow_round']}; the planned run shrank at {drop_at} and "
            f"grew at {join_at}")
    planned = {"rebuild_wall_s": 0.0}
    crc_equal = False
    churn_crcs: dict = {}
    if b is not None:
        planned = finish_planned(planned_dir, *b, args.timeout, problems)
        churn_crcs = read_crcs(churn_models)
        planned_crcs = read_crcs(planned_models)
        if len(churn_crcs) != NUM_ROUND + 1:
            problems.append(f"churn run wrote rounds {sorted(churn_crcs)}, "
                            f"expected {NUM_ROUND + 1} checkpoints")
        crc_equal = bool(churn_crcs) and churn_crcs == planned_crcs
        if not crc_equal:
            problems.append(
                "BITWISE PARITY FAILED: killed-and-recovered CRCs "
                f"{ {k: hex(v) for k, v in sorted(churn_crcs.items())} } != "
                "planned-resize CRCs "
                f"{ {k: hex(v) for k, v in sorted(planned_crcs.items())} }")
    doc = {
        "bench": "elastic", "ts": time.time(), "rounds": NUM_ROUND,
        "ranks": args.ranks, "dev": args.dev, "global_batch": GLOBAL_BATCH,
        "resume_round": churn["resume_round"],
        "grow_round": churn["grow_round"],
        "planned_drop_at": drop_at, "planned_join_at": join_at,
        "crc_equal": crc_equal,
        "crcs": {str(k): f"{v:#010x}" for k, v in sorted(churn_crcs.items())},
        "churn": {"wall_sec": round(churn_s, 3),
                  "rebuild_wall_s": churn["rebuild_wall_s"],
                  "kill_to_rebuild_start_s": churn["kill_to_rebuild_start_s"],
                  "recovered_samples_per_sec":
                      round(churn["recovered_samples_per_sec"], 2)},
        "planned": {"wall_sec": round(time.time() - t0, 3),
                    "rebuild_wall_s": planned["rebuild_wall_s"]},
    }
    return _verdict(doc, problems,
                    args.json_path or os.path.join(out, "elastic.json"))


if __name__ == "__main__":
    sys.exit(main())
