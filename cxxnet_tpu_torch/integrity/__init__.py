"""The integrity plane: silent-data-corruption detection for live state.

The port's copy of ``cxxnet_tpu/integrity/``:

* :mod:`.fingerprint` — an order-independent per-tensor digest, the
  JAX package's word for word, reduced on the tensor's device
  (:func:`digest_tensor`, the JAX ``digest_device_array``) with a numpy
  oracle (:func:`digest_array`).
* :mod:`.plane` — the replica vote over the digests at the round
  boundary (``integrity_every``), and the shadow-step audit
  (``integrity_shadow``) that runs a sampled grad step twice and holds
  the two bitwise; a failure is an :class:`IntegrityError`.
* :mod:`.canary` — the serving golden canary (``integrity_probe``).
"""

from .fingerprint import combine_digests, digest_array, digest_tensor
from .plane import IntegrityError, IntegrityPlane

__all__ = [
    "IntegrityError",
    "IntegrityPlane",
    "combine_digests",
    "digest_array",
    "digest_tensor",
]
