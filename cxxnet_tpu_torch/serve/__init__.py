"""Online inference: micro-batched engine + JSON and binary HTTP front-end.

Counterpart of ``cxxnet_tpu/serve/`` for the serving slice; see
``engine.py`` for what is ported and what waits.
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
from .metrics import ServingStats  # noqa: F401
from .router import ModelRouter, UnknownModelError  # noqa: F401
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
    "wire",
    "WireError",
    "WireRequest",
]
