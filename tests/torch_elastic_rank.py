"""One rank of ``tests/test_torch_elastic.py``'s small gloo jobs.

``python torch_elastic_rank.py MODE RANK OUT PORT [PORT ...]``:

* ``kill``: two ranks; after one all-reduce rank 1 SIGKILLs itself and
  rank 0 writes what its next all-reduce raised (type names and text)
  to ``OUT`` as JSON: the real text ``classify_failure`` reads.
* ``reinit``: two ranks, three generations in one process: the stock
  join and a graceful teardown; an elastic (``resilient``) join and the
  teardown with no collective, after which rank 0's store port is free
  to bind again; a group left while rank 0's worker thread is still
  inside an all-reduce rank 1 never joins (``abandon=True``), then rank
  0 alone in a new group.  Rank 0 writes its readings to ``OUT``.
"""

import json
import os
import signal
import socket
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from cxxnet_tpu_torch.parallel import distributed as D  # noqa: E402


def _sum(n: float) -> float:
    t = torch.full((4,), n)
    D.all_reduce_(t)
    return float(t[0])


def kill(rank: int, out: str, port: int) -> None:
    D.init_distributed(f"127.0.0.1:{port}", 2, rank, dev="cpu",
                       timeout_s=30)
    _sum(1.0)
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    try:
        for _ in range(1000):
            _sum(1.0)
        err = None
    except BaseException as e:  # noqa: BLE001 - what the survivor sees
        err = e
    with open(out, "w") as f:
        json.dump({"types": [c.__name__ for c in type(err).__mro__],
                   "text": str(err)}, f)
    os._exit(0)


def _listening(port: int) -> bool:
    """Does a server still accept on ``port``?"""
    try:
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
        return True
    except OSError:
        return False


def reinit(rank: int, out: str, ports) -> None:
    got = {}
    # 1: the stock join, a graceful teardown
    assert D.maybe_init_distributed(
        [("dist_coordinator", f"127.0.0.1:{ports[0]}"),
         ("dist_num_proc", "2"), ("dist_proc_id", str(rank)), ("dev", "cpu")])
    got["gen1"] = _sum(1.0)
    assert D.shutdown_distributed()
    # 2: an elastic join, the teardown with no collective
    D.init_distributed(f"127.0.0.1:{ports[1]}", 2, rank, dev="cpu",
                       timeout_s=30, resilient=True)
    got["gen2"] = _sum(2.0)
    D.barrier("gen2")
    D.shutdown_distributed(graceful=False)
    got["store_port_free"] = not _listening(ports[1])
    got["initialized_after"] = D.distributed_initialized()
    # 3: rank 0's worker thread stays inside an all-reduce rank 1 never
    # joins; rank 0 abandons the group and joins one of its own
    D.init_distributed(f"127.0.0.1:{ports[2]}", 2, rank, dev="cpu",
                       timeout_s=30, resilient=True)
    if rank == 1:
        time.sleep(3.0)
        D.shutdown_distributed(graceful=False)
        os._exit(0)
    t = threading.Thread(target=lambda: _sum(3.0), daemon=True)
    t.start()
    time.sleep(0.5)
    got["thread_inside"] = t.is_alive()
    D.shutdown_distributed(graceful=False, abandon=True)
    got["abandoned"] = len(D._abandoned)
    D.init_distributed(f"127.0.0.1:{ports[3]}", 1, 0, dev="cpu",
                       timeout_s=30, resilient=True)
    got["gen4"] = _sum(4.0)
    got["resilient"] = D.resilient_client_used()
    with open(out, "w") as f:
        json.dump(got, f)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    mode, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    ports = [int(p) for p in sys.argv[4:]]
    if mode == "kill":
        kill(rank, out, ports[0])
    else:
        reinit(rank, out, ports)
