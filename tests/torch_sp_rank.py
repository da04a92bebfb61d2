"""One rank of a model-axis job of the port, for the CPU tests.

Run as ``python tests/torch_sp_rank.py SPEC.json RANK``.  Beside the
trainer ``runs`` of ``tests/torch_dp_rank.py`` (run first to last after
the op checks), the spec may name ``ops``: an npz of whole ``q``, ``k``,
``v`` ``(B, T, H, Dh)`` and a cotangent ``w``, which every rank passes
through ``ring_self_attention``, ``ring_self_attention_flash`` and
``a2a_self_attention`` over a model sub-group of ``model_parallel``
ranks, causal and not, writing the output and the gradients of
``sum(o * w)`` for q, k and v to ``{ops_out}.r{rank}.npz``.  The same
file holds the two primitives on rank ``r``'s ``x = q[r]`` with
cotangent ``w[r]`` (reshaped to the output's shape): ``ppermute``
over the pairs ``PERM`` and
``all_to_all`` from the head axis to the time axis (``prim:{name}:o``
and ``prim:{name}:dx``).  The spec may also name ``pipe``: an npz of a
relu-MLP block stack ``w`` ``(L, D, D)``, ``b`` ``(L, D)``, rows ``x``
``(B, D)`` and a cotangent ``w_out``, which every rank runs through
``pipeline_apply`` over the stages of a model axis of
``pipe_model_parallel`` ranks (``pipe_microbatch`` microbatches), its
stage of the stack cut by ``MeshPlan.model_dim``, writing the output,
the gradient of ``sum(o * w_out)`` for ``x`` and for its stage of ``w``
and ``b`` to ``{pipe_out}.r{rank}.npz``.  Imports no JAX.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from torch_dp_rank import patch_draws, run_one  # noqa: E402

OPS = ("ring", "ring_flash", "a2a")
#: ppermute's pairs: rank 0 sends to rank 1, nothing comes to rank 0
PERM = [(0, 1)]


def run_ops(spec: dict) -> dict:
    import torch

    from cxxnet_tpu_torch.ops import attention as sp
    from cxxnet_tpu_torch.parallel import distributed as pdist

    group = pdist.sub_groups(int(spec["model_parallel"]))[1]
    z = np.load(spec["ops"])
    fns = {"ring": sp.ring_self_attention,
           "ring_flash": sp.ring_self_attention_flash,
           "a2a": sp.a2a_self_attention}
    out = {}
    for name in OPS:
        for causal in (False, True):
            qkv = [torch.from_numpy(z[n]).requires_grad_(True)
                   for n in ("q", "k", "v")]
            o = fns[name](*qkv, group, causal=causal)
            (o * torch.from_numpy(z["w"])).sum().backward()
            tag = f"{name}:{int(causal)}"
            out[f"{tag}:o"] = o.detach().numpy()
            for n, t in zip("qkv", qkv):
                out[f"{tag}:d{n}"] = t.grad.numpy()
    rank = pdist.process_info()[0]
    prims = {"ppermute": lambda x: pdist.ppermute(x, PERM, group),
             "all_to_all": lambda x: pdist.all_to_all(x, 1, 0, group)}
    for name, fn in prims.items():
        x = torch.from_numpy(z["q"][rank]).requires_grad_(True)
        o = fn(x)
        (o * torch.from_numpy(z["w"][rank]).reshape(o.shape)).sum().backward()
        out[f"prim:{name}:o"] = o.detach().numpy()
        out[f"prim:{name}:dx"] = x.grad.numpy()
    return out


def pipe_block(p, x):
    import torch

    return torch.relu(x @ p["w"] + p["b"])


def run_pipe(spec: dict) -> dict:
    import torch

    from cxxnet_tpu_torch.ops.pipeline import pipeline_apply
    from cxxnet_tpu_torch.parallel.mesh import plan_for

    plan = plan_for(torch.device("cpu"), int(spec["pipe_model_parallel"]))
    z = np.load(spec["pipe"])
    stage = {}
    for name in ("w", "b"):
        start, n = plan.slice_bounds(z[name].shape, 0, axis="model")
        stage[name] = torch.from_numpy(
            z[name][start:start + n].copy()).requires_grad_(True)
    x = torch.from_numpy(z["x"]).requires_grad_(True)
    o = pipeline_apply(pipe_block, stage, x, plan,
                       n_microbatch=int(spec["pipe_microbatch"]),
                       n_block=z["w"].shape[0])
    (o * torch.from_numpy(z["w_out"])).sum().backward()
    return {"o": o.detach().numpy(), "dx": x.grad.numpy(),
            "dw": stage["w"].grad.numpy(), "db": stage["b"].grad.numpy()}


def main() -> int:
    spec = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    world = int(spec["world"])
    if spec.get("patch_draw"):
        patch_draws()
    from cxxnet_tpu_torch.parallel import distributed as pdist

    pdist.init_distributed(spec["coord"], world, rank, dev="cpu",
                           timeout_s=float(spec.get("timeout_s", 60)))
    if spec.get("ops"):
        np.savez(f"{spec['ops_out']}.r{rank}.npz", **run_ops(spec))
    if spec.get("pipe"):
        np.savez(f"{spec['pipe_out']}.r{rank}.npz", **run_pipe(spec))
    for run in spec.get("runs", []):
        run_one(run, rank, world)
    pdist.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
