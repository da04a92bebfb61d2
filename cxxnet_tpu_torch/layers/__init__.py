"""The layer types the port runs, as PyTorch code (predict and train).

Importing this package populates the registry; use ``create_layer(name)``.
"""

from .base import (  # noqa: F401
    Layer,
    LayerParam,
    LossLayer,
    Params,
    Shape,
    create_layer,
    register,
)
from . import (  # noqa: F401
    conv, elemwise, embed, linear, loss, sequence, structure)
