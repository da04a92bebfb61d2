"""Data parallelism over a ``torch.distributed`` group: the port's
``cxxnet_tpu/parallel``.

The JAX package builds a ``jax.sharding.Mesh`` from ``dev=tpu:0-3`` and
runs the train step as one SPMD program; the port runs one process per
device (:mod:`.distributed`), each with its share of the global batch,
and the trainer sums the gradients over the group with an all-reduce
(``nnet/trainer.py``).  :mod:`.mesh` holds the device rule, the
``(n_data, n_model)`` layout (``model_parallel``) and the placement
rule of the sharded updater state (``zero = 1``) and parameters (``zero
= 3``); :mod:`.async_ps` the async parameter-server step
(``async_overlap = 1``); :mod:`.elastic` the elastic pod's membership
and liveness (``elastic = 1``: a lost replica, a planned shrink, a
rejoin and the integrity quarantine), whose rebuild the CLI drives.
"""

from .distributed import (  # noqa: F401
    distributed_initialized,
    distributed_spec,
    init_distributed,
    maybe_init_distributed,
    process_info,
    shutdown_distributed,
)
from .mesh import MeshPlan, make_mesh, parse_device  # noqa: F401
