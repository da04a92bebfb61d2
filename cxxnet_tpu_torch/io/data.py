"""Data pipeline core: DataBatch, the iterator protocol, the chain factory.

The port's copy of ``cxxnet_tpu/io/data.py`` for this slice: batches are
NHWC (or flat ``(N, D)``) numpy float32 with ``(N, label_width)``
labels; ``num_batch_padd`` trailing rows of a batch are padding.  The
``iter = X`` chain is read in order: a base iterator at the bottom,
``threadbuffer`` wrapping the iterator below it, and the keys after an
``iter =`` line configure the current top of the chain, which forwards
them down.  The port builds ``synthetic``, ``text``, ``mnist``,
``imgbin``/``imgbinx`` and ``img`` (each as ``BatchAdapt(ParallelAugment(
Augment(source)))``), ``csv`` (``BatchAdapt(CSV)``), ``libsvm``, ``service``
(blocks streamed from a ``task=data_service`` server,
``io/dataservice/client.py``), and the wrappers ``threadbuffer``,
``membuffer`` and ``attachtxt``.

A batch may carry the CSR form of sparse rows (``sparse_row_ptr``,
``sparse_index``, ``sparse_value``; ``iter = libsvm`` fills them) and
side inputs (``extra_data``; ``iter = attachtxt`` appends one).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

ConfigEntry = Tuple[str, str]

#: Keys that take effect at the chain's next rewind, not when they are
#: set.  A stage that rewinds the chain below it on another thread
#: (``threadbuffer``) holds them and passes them down just before that
#: rewind.  What each means is its reader's: ``augment_epoch_next`` is
#: the augmenter's epoch anchor (io/augment.py).
DEFERRED_KEYS = ("augment_epoch_next",)


@dataclasses.dataclass
class DataBatch:
    """One mini-batch; ``num_batch_padd`` trailing instances are padding
    and are left out of evaluation."""

    data: np.ndarray                  # (N, H, W, C) or (N, D)
    label: np.ndarray                 # (N, label_width) float32
    inst_index: Optional[np.ndarray] = None
    num_batch_padd: int = 0
    extra_data: List[np.ndarray] = dataclasses.field(default_factory=list)
    #: CSR row pointer, shape (N+1,), int64; None for a dense batch
    sparse_row_ptr: Optional[np.ndarray] = None
    #: CSR column indices, shape (nnz,), int32
    sparse_index: Optional[np.ndarray] = None
    #: CSR values, shape (nnz,), float32
    sparse_value: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    def is_sparse(self) -> bool:
        return self.sparse_row_ptr is not None

    def get_row_sparse(self, rid: int):
        """Row ``rid`` of the CSR part as ``(indices, values)``."""
        if not self.is_sparse():
            raise ValueError("GetRowSparse on a dense batch")
        lo, hi = self.sparse_row_ptr[rid], self.sparse_row_ptr[rid + 1]
        return self.sparse_index[lo:hi], self.sparse_value[lo:hi]


def shard_rows(n_rows: int, rank: int, nworker: int, block: int = 1):
    """Equal-length row shard of a data-parallel job (the JAX package's
    ``io.data.shard_rows``).

    ``block = 1``: worker ``rank`` takes rows ``rank::nworker``
    truncated to ``n_rows // nworker``, disjoint and class-mixed even on
    unshuffled data.  Shards are always the same length: a worker with
    one batch more would issue a collective the others never join.
    ``block > 1`` (``dist_shard = block`` with the LOCAL batch size):
    rows dealt out in contiguous blocks of ``block`` round-robin, so
    worker ``rank``'s k-th batch is rows ``[k*B*nworker + rank*B, ... +
    B)`` of the whole stream and the workers' batches together are a
    single-process run's global batch, row for row.  Returns an index
    array."""
    if block <= 1:
        per = n_rows // nworker
        if per == 0:
            raise ValueError(
                f"cannot shard {n_rows} rows over {nworker} workers"
            )
        return np.arange(rank, n_rows, nworker)[:per]
    nblocks = n_rows // (block * nworker)
    if nblocks == 0:
        raise ValueError(
            f"cannot shard {n_rows} rows over {nworker} workers in "
            f"blocks of {block}"
        )
    starts = (np.arange(nblocks) * nworker + rank) * block
    return (starts[:, None] + np.arange(block)[None, :]).reshape(-1)


class DataIter:
    """Iterator protocol: ``init`` once, then ``before_first`` and
    ``next``/``value`` per epoch; ``close`` releases threads.

    ``supports_dist_shard`` is True for the source iterators that honour
    ``dist_num_worker`` / ``dist_worker_rank`` (the wrappers ask their
    base): the CLI refuses a data-parallel run whose train chain would
    feed every process the same rows."""

    def supports_dist_shard(self) -> bool:
        return False

    def set_param(self, name: str, val: str) -> None:  # noqa: D401
        pass

    def init(self) -> None:
        pass

    def before_first(self) -> None:
        raise NotImplementedError

    def next(self) -> bool:
        raise NotImplementedError

    def value(self) -> DataBatch:
        raise NotImplementedError

    def close(self) -> None:
        """Release resources; idempotent, wrappers delegate down."""


def create_iterator(cfg: Sequence[ConfigEntry]) -> DataIter:
    """Build an iterator chain from an ordered config section."""
    from .attach_txt import AttachTxtIterator
    from .augment import AugmentIterator
    from .batch import BatchAdaptIterator
    from .csv import CSVIterator
    from .img import ImageIterator
    from .imgbin import ImageBinIterator
    from .libsvm import LibSVMIterator
    from .membuffer import MemBufferIterator
    from .mnist import MNISTIterator
    from .pipeline import ParallelAugmentIterator
    from .prefetch import ThreadBufferIterator
    from .synth import SyntheticIterator
    from .text import TextIterator

    it: Optional[DataIter] = None
    for name, val in cfg:
        if name == "iter":
            if val == "synthetic":
                if it is not None:
                    raise ValueError(
                        "synthetic cannot chain over another iterator")
                it = SyntheticIterator()
            elif val == "text":
                if it is not None:
                    raise ValueError(
                        "text cannot chain over another iterator")
                it = TextIterator()
            elif val == "mnist":
                if it is not None:
                    raise ValueError(
                        "mnist cannot chain over another iterator")
                it = MNISTIterator()
            elif val in ("imgbin", "imgbinx", "img"):
                if it is not None:
                    raise ValueError(
                        f"{val} cannot chain over another iterator")
                source = (ImageIterator() if val == "img"
                          else ImageBinIterator())
                it = BatchAdaptIterator(ParallelAugmentIterator(
                    AugmentIterator(source)))
            elif val == "csv":
                if it is not None:
                    raise ValueError("csv cannot chain over another iterator")
                it = BatchAdaptIterator(CSVIterator())
            elif val == "libsvm":
                if it is not None:
                    raise ValueError(
                        "libsvm cannot chain over another iterator")
                it = LibSVMIterator()
            elif val == "threadbuffer":
                if it is None:
                    raise ValueError("must specify input of threadbuffer")
                it = ThreadBufferIterator(it)
            elif val == "membuffer":
                if it is None:
                    raise ValueError("must specify input of membuffer")
                it = MemBufferIterator(it)
            elif val == "attachtxt":
                if it is None:
                    raise ValueError("must specify input of attachtxt")
                it = AttachTxtIterator(it)
            elif val == "end":
                continue
            elif val == "service":
                if it is not None:
                    raise ValueError(
                        "service cannot chain over another iterator")
                # the network base: blocks streamed from a
                # task=data_service server (io/dataservice/)
                from .dataservice.client import ServiceIterator

                it = ServiceIterator()
            else:
                raise ValueError(f"unknown iterator type {val!r}")
            continue
        if it is not None:
            it.set_param(name, val)
    if it is None:
        raise ValueError("must specify iterator by iter=itername")
    return it
