"""Disaggregated input-data service.

The port's copy of ``cxxnet_tpu/io/dataservice/``; its ``CXD1`` frames
are the JAX package's byte for byte, so a client of either package
reads a server of the other.

A standalone decode/augment fleet: ``task=data_service`` hosts a conf's
iterator chain behind the binary ``CXD1`` batch protocol
(:mod:`.wire`); ``iter = service`` (:class:`.client.ServiceIterator`)
is the drop-in chain base that streams from it.  The stream is
addressed by ``(dataset fingerprint, epoch, block)`` and therefore
bitwise-deterministic across cache hits, reconnects, and server
restarts — the property ``chip_smoke.py``'s phase 25c pins with
checkpoint CRCs.
"""

from .cache import ChunkCache
from .client import ServiceIterator
from .server import BatchPlant, DataServiceServer, dataset_fingerprint

__all__ = [
    "ChunkCache", "ServiceIterator", "BatchPlant", "DataServiceServer",
    "dataset_fingerprint",
]
