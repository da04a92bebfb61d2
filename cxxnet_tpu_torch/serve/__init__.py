"""Online inference: micro-batched engine, JSON and binary HTTP front
end, and the serving fleet.

Counterpart of ``cxxnet_tpu/serve/``: the engine and its server
(``engine.py``, ``server.py``), per-model routing and the fleet's front
door (``router.py``), replica supervision, rolling reload and the int8
canary (``fleet.py``), and the stdlib replica stand-in the fleet tests
drive (``stub.py``, run as a file).
"""

from .batcher import (  # noqa: F401
    ClosedError,
    DeadlineError,
    MicroBatcher,
    OverloadError,
    ServeError,
)
from .cache import ShapeBucketCache, bucket_size  # noqa: F401
from .engine import Engine, ModelLoadError  # noqa: F401
from .fleet import (  # noqa: F401
    CanaryController,
    FleetOptions,
    ReplicaSupervisor,
    ServingFleet,
)
from .metrics import ServingStats  # noqa: F401
from .router import FleetRouter, ModelRouter, UnknownModelError  # noqa: F401
from .server import make_server, serve_forever  # noqa: F401
from . import wire  # noqa: F401
from .wire import WireError, WireRequest  # noqa: F401

__all__ = [
    "Engine",
    "MicroBatcher",
    "ShapeBucketCache",
    "ServingStats",
    "ServeError",
    "OverloadError",
    "DeadlineError",
    "ClosedError",
    "ModelLoadError",
    "ModelRouter",
    "UnknownModelError",
    "bucket_size",
    "make_server",
    "serve_forever",
    "FleetOptions",
    "ReplicaSupervisor",
    "CanaryController",
    "ServingFleet",
    "FleetRouter",
    "wire",
    "WireError",
    "WireRequest",
]
