"""One rank of the ZeRO tests' job (``tests/test_torch_zero_range.py``).

Run as ``python tests/torch_zero_rank.py SPEC.json RANK``.  First the
data-axis collectives on seeded tensors, written to ``{ops}.r{rank}.npz``:
``reduce_scatter`` of a packed buffer (plain and ``det``), and
``gather_slices`` (``GatherSlice``) forward and backward, plain and
``det``, where each rank's loss weighs the whole tensor by its own
factor, so the slice's gradient is this rank's slice of the factors'
sum.  Then the spec's ``runs``, as ``torch_dp_rank.run_one`` runs them.
Imports no JAX.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def run_ops(path: str, rank: int, world: int) -> None:
    import torch

    from cxxnet_tpu_torch.parallel import distributed as pdist

    out = {}
    rng = np.random.RandomState(100 + rank)
    buf = torch.from_numpy(rng.randn(12).astype(np.float32))
    out["rs_in"] = buf.numpy().copy()
    out["rs"] = pdist.reduce_scatter(buf.clone()).numpy()
    out["rs_det"] = pdist.reduce_scatter(buf.clone(), det=True).numpy()
    # two tensors cut along different dims, packed by rank
    a = torch.from_numpy(np.arange(24, dtype=np.float32).reshape(4, 6))
    b = torch.from_numpy(np.arange(10, dtype=np.float32).reshape(2, 5))
    packed = pdist.pack_by_rank([a, b], [1, 0], world)
    out["packed"] = packed.numpy()
    out["unpacked0"], out["unpacked1"] = (
        t.numpy() for t in pdist.unpack_slices(
            packed[:packed.numel() // world], [(4, 3), (1, 5)]))
    for det in (False, True):
        s1 = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
        s2 = torch.from_numpy(rng.randn(5).astype(np.float32))
        s1.requires_grad_(True)
        s2.requires_grad_(True)
        w1, w2 = pdist.gather_slices([s1, s2], [0, 0], None, det=det)
        c1 = torch.from_numpy(rng.randn(3 * world, 4).astype(np.float32))
        c2 = torch.from_numpy(rng.randn(5 * world).astype(np.float32))
        loss = (w1 * c1).sum() + (w2 * c2).sum()
        g1, g2 = torch.autograd.grad(loss, [s1, s2])
        tag = "det" if det else "plain"
        out[f"{tag}_s1"], out[f"{tag}_s2"] = s1.detach().numpy(), \
            s2.detach().numpy()
        out[f"{tag}_w1"], out[f"{tag}_w2"] = w1.detach().numpy(), \
            w2.detach().numpy()
        out[f"{tag}_c1"], out[f"{tag}_c2"] = c1.numpy(), c2.numpy()
        out[f"{tag}_g1"], out[f"{tag}_g2"] = g1.numpy(), g2.numpy()
    out["by_op"] = np.asarray(json.dumps(pdist.STATS["by_op"]))
    np.savez(f"{path}.r{rank}.npz", **out)


def main() -> int:
    spec = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    world = int(spec["world"])
    from cxxnet_tpu_torch.parallel import distributed as pdist
    from torch_dp_rank import run_one

    pdist.init_distributed(spec["coord"], world, rank, dev="cpu",
                           timeout_s=float(spec.get("timeout_s", 60)))
    if spec.get("ops"):
        pdist.reset_stats()
        run_ops(spec["ops"], rank, world)
    for run in spec["runs"]:
        run_one(run, rank, world)
    pdist.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
