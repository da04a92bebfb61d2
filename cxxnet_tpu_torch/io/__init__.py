"""Training data: ``DataBatch``, the iterator protocol, and the
``synthetic``, ``text`` and ``threadbuffer`` iterators
(``create_iterator``)."""

from .data import DataBatch, DataIter, create_iterator  # noqa: F401
