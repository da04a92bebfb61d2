"""Run one CLI invocation as N rank processes, for the lane tools.

Each rank is ``python -m cxxnet_tpu_torch <conf> <overrides>`` plus
``dev=<its device>`` and the ``dist_*`` keys of a free loopback
coordinator, in its own directory ``<workdir>/p<rank>``.  ``dev`` is one
device (``cpu``, ``gpu``, ``gpu:k``), which every rank takes (ranks
sharing a card run over gloo), or a list of as many devices as ranks
(``gpu:0-3``), rank ``r`` taking the ``r``-th.  One process runs without
``dist_*`` keys.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import List, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rank_devices(dev: str, ranks: int) -> List[str]:
    """Each rank's ``dev`` value (see the module docstring)."""
    from ..parallel.mesh import parse_device

    plat, ids = parse_device(dev.strip().lower())
    if len(ids) == 1:
        return [dev.strip()] * ranks
    if len(ids) != ranks:
        raise ValueError(f"--dev {dev}: {len(ids)} devices for {ranks} "
                         "ranks (give one device, or one per rank)")
    return [f"{plat}:{i}" for i in ids]


def run_ranks(conf: str, workdir: str, overrides: Sequence[str],
              ranks: int, dev: str, timeout: float) -> float:
    """The ranks of one job, under one deadline; returns its wall
    seconds.  Raises ``RuntimeError`` with the ranks' output tails when
    one fails or the deadline passes (every rank is then killed)."""
    from ..parallel.elastic import free_port

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    port = free_port()
    procs = []
    t0 = time.time()
    for r, rdev in enumerate(rank_devices(dev, ranks)):
        d = os.path.join(workdir, f"p{r}")
        os.makedirs(d, exist_ok=True)
        over = list(overrides) + [f"dev={rdev}"]
        if ranks > 1:
            over += [f"dist_coordinator=127.0.0.1:{port}",
                     f"dist_num_proc={ranks}", f"dist_proc_id={r}"]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cxxnet_tpu_torch", conf] + over,
            env=env, cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs: List[bytes] = [b""] * ranks
    try:
        deadline = t0 + timeout
        for r, p in enumerate(procs):
            outs[r] = p.communicate(
                timeout=max(1.0, deadline - time.time()))[0] or b""
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        tails = []
        for r, p in enumerate(procs):
            try:
                o = p.communicate(timeout=5)[0] or b""
            except Exception:  # noqa: BLE001 - salvage is best-effort
                o = b""
            tails.append(f"--- rank {r} (rc={p.returncode}) ---\n"
                         + o.decode(errors="replace")[-2000:])
        raise RuntimeError(
            f"{ranks}-rank job timed out after {timeout:.0f}s "
            f"(overrides={list(overrides)}):\n" + "\n".join(tails)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"rank {r} of {ranks} failed (rc={p.returncode}, "
                f"overrides={list(overrides)}):\n"
                + o.decode(errors="replace")[-4000:])
    return time.time() - t0
