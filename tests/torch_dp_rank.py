"""One rank of a data-parallel job of the port, for the CPU tests.

Run as ``python tests/torch_dp_rank.py SPEC.json RANK``.  The spec
names the group (``coord``, ``world``) and a list of ``runs``, each run
a ``NetTrainer`` from a conf (``cfg`` pairs), started from a checkpoint
(``init``), the layers of one copied into a fresh net (``finetune``:
``copy_model_from``) or the conf's seed, then ``steps`` updates on this rank's
rows of the seeded global batches in ``batches`` (an npz of ``data``
``[K, B, ...]`` and ``label`` ``[K, B, L]``; the ranks of data index
``i`` take the ``i``-th block of ``B / n_data`` rows), over ``rounds``
rounds when given, each closed by ``async_round_end`` (the async
step's snapshot lands in ``async``), and with ``train_metric`` the
group's train metrics of the steps.  With ``decoy_model_parallel`` a
second trainer of the same conf with that ``model_parallel`` is built
after the run's own and before its steps (the run's collectives must
keep to its own layout).  A run with ``expect_error`` only
builds the model and records the refusal's message in ``error``.
Each run writes this rank's whole params (``p:``, gathered over the
model axis) and layer state, the collectives' bytes by kind (``by_op``),
``zero = 3``'s gather watermark (``zero``, ``NetTrainer.zero_snapshot``), the tensors the rank holds itself (``s:``
params, ``u:`` updater state slots), the state digests of the integrity
plane (``fp:`` keyed by leaf and slice), its losses and shard bytes to
``{out}.r{rank}.npz``, and rank 0 the checkpoint bytes to ``{out}.model``.
A run with ``weights`` also reads ``get_weight`` of those ``(layer,
tag)`` pairs (``gw:``), writes each back doubled with ``set_weight``
and reads the whole params again (``sw:``).
A run with ``save`` also saves through ``NetTrainer.save_model`` there,
then to a path rank 0 cannot write, and records each rank's error.
``patch_draw`` makes every random layer's draws a function of the
draw's shape alone (``shape_draws``), the same function the tests give
the JAX package's dropout.  Imports no JAX.
"""

import json
import os
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def shape_draws(shape) -> np.ndarray:
    """``U[0, 1)`` f32 draws seeded by ``shape`` alone."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).random_sample(
        tuple(shape)).astype(np.float32)


def patch_draws() -> None:
    import torch

    from cxxnet_tpu_torch.layers import elemwise

    elemwise.draw = lambda shape, gen, device: torch.from_numpy(
        shape_draws(shape)).to(device)


def run_one(run: dict, rank: int, world: int) -> None:
    import torch

    from cxxnet_tpu_torch.io.data import DataBatch
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.parallel import distributed as pdist

    tr = NetTrainer()
    tr.set_params([tuple(p) for p in run["cfg"]])
    if run.get("expect_error"):
        # a refusal at build time: every rank records its message
        try:
            tr.init_model()
            err = ""
        except (ValueError, NotImplementedError) as e:
            err = f"{type(e).__name__}: {e}"
        np.savez(f"{run['out']}.r{rank}.npz", error=np.asarray(err))
        return
    if run.get("finetune"):
        tr.copy_model_from(run["finetune"])
    elif run.get("init"):
        tr.load_model(run["init"])
    else:
        tr.init_model()
    if run.get("decoy_model_parallel"):
        decoy = NetTrainer()
        decoy.set_params([tuple(p) for p in run["cfg"]] + [
            ("model_parallel", str(run["decoy_model_parallel"]))])
        decoy.init_model()
    b = np.load(run["batches"])
    data, label = b["data"], b["label"]
    # the rows of this rank's data index (the model ranks of one index
    # feed the same rows)
    dix, n_data = tr.mesh_plan.data_index, tr.mesh_plan.n_data
    local = data.shape[1] // n_data
    rows = slice(dix * local, (dix + 1) * local)
    losses = []
    pdist.reset_stats()
    rounds = run.get("rounds", 0)
    for r in range(max(rounds, 1)):
        for k in range(run["steps"]):
            tr.update(DataBatch(data=data[k, rows], label=label[k, rows]))
            losses.append(float(tr.last_loss))
        if rounds:
            tr.async_round_end(r + 1)
    out = {"losses": np.asarray(losses, np.float64),
           "calls": np.asarray(pdist.STATS["calls"]),
           "by_op": np.asarray(json.dumps(pdist.STATS["by_op"]))}
    zero = tr.zero_snapshot()
    if zero is not None:
        out["zero"] = np.asarray(json.dumps(zero))
    if run.get("train_metric"):
        # the steps' train metrics over the group (collective)
        tr.train_metric.reduce_across_processes(tr.mesh_plan.data_group)
        out["train_metric"] = np.asarray(tr.train_metric.print("train"))
    snap = tr.async_snapshot()
    if snap is not None:
        out["async"] = np.asarray(json.dumps(snap))
    per_dev, total = tr.state_shard_bytes()
    out["shard_bytes"] = np.asarray(sum(per_dev.values()))
    out["total_bytes"] = np.asarray(total)
    out["sync_dev"] = np.asarray(tr.check_weight_sync())
    params = tr._full_params()
    for key, tags in params.items():
        for tag, w in tags.items():
            out[f"p:{key}/{tag}"] = w.detach().cpu().numpy().copy()
    for key, tags in tr.params.items():
        for tag, w in tags.items():
            out[f"s:{key}/{tag}"] = w.detach().cpu().numpy().copy()
            for slot, v in tr.ustates.get(key, {}).get(tag, {}).items():
                out[f"u:{key}/{tag}@{slot}"] = v.detach().cpu().numpy().copy()
    from cxxnet_tpu_torch.integrity.plane import local_fingerprints

    for d, (name, sk) in zip(*local_fingerprints(tr, rank)):
        out[f"fp:{name}|{sk!r}"] = np.asarray(d, np.int64)
    for key, tags in tr.aux.items():
        for tag, w in tags.items():
            out[f"aux:{key}/{tag}"] = w.detach().cpu().numpy().copy()
    blob = tr.checkpoint_bytes()
    if run.get("perturb_rank") is not None:
        # one rank's weight drifts: every rank's check must raise
        key = sorted(tr.params)[0]
        tag = sorted(tr.params[key])[0]
        if rank == run["perturb_rank"]:
            with torch.no_grad():
                tr.params[key][tag].view(-1)[0] += 1e-3
        try:
            tr.check_weight_sync()
            out["perturb_error"] = np.asarray("")
        except RuntimeError as e:
            out["perturb_error"] = np.asarray(str(e))
    if run.get("save"):
        # the collective save: every rank gathers, rank 0 writes; then a
        # write that fails on rank 0 alone (the path's parent is a file)
        # must raise on every rank, not strand rank 1 in the barrier
        tr.save_model(run["save"], round_=0)
        try:
            tr.save_model(os.path.join(run["save"], "x.model"), round_=1)
            out["save_error"] = np.asarray("")
        except Exception as e:  # noqa: BLE001 - the test reads it
            out["save_error"] = np.asarray(f"{type(e).__name__}: {e}")
    for layer, tag in run.get("weights", []):
        out[f"gw:{layer}/{tag}"] = tr.get_weight(layer, tag)
        tr.set_weight(2 * out[f"gw:{layer}/{tag}"], layer, tag)
    if run.get("weights"):
        for key, tags in tr._full_params().items():
            for tag, w in tags.items():
                out[f"sw:{key}/{tag}"] = w.detach().cpu().numpy().copy()
    np.savez(f"{run['out']}.r{rank}.npz", **out)
    if rank == 0:
        with open(f"{run['out']}.model", "wb") as f:
            f.write(blob)


def main() -> int:
    spec = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    world = int(spec["world"])
    if spec.get("patch_draw"):
        patch_draws()
    from cxxnet_tpu_torch.parallel import distributed as pdist

    if world > 1:
        pdist.init_distributed(spec["coord"], world, rank, dev="cpu",
                               timeout_s=float(spec.get("timeout_s", 60)))
    for run in spec["runs"]:
        run_one(run, rank, world)
    pdist.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
