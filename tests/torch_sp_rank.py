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
and ``prim:{name}:dx``).  Imports no JAX.
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
    for run in spec.get("runs", []):
        run_one(run, rank, world)
    pdist.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
