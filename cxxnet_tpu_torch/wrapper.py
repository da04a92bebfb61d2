"""User-facing Python API: ``DataIter`` / ``Net`` / ``train``.

Counterpart of ``cxxnet_tpu/wrapper.py``, the reference's ctypes
wrapper surface (``DataIter``, ``Net``, ``train``) as plain Python over
the in-process :class:`~cxxnet_tpu_torch.nnet.trainer.NetTrainer`:
numpy in, numpy out, PyTorch and the port's kernels underneath.

Layout note: batch arrays are **NHWC**, as everywhere in the port (the
reference was NCHW).  Flat ``(N, D)`` input is accepted anywhere a 4-D
tensor is (it is reshaped to ``(N, 1, 1, D)``).

Devices: ``Net(dev=...)`` follows the trainer's rule — ``cpu`` runs on
the CPU, only when asked; any other value (the default ``gpu``, ``tpu``,
``cuda``) means the card and raises at ``init_model`` / ``load_model``
without one.  As the JAX wrapper, :meth:`Net.init_model` and
:meth:`Net.load_model` join the data-parallel job the ``dist_*`` keys
(or the ``CXN_*`` environment) name (``parallel/distributed.py``); each
process then feeds its ``batch_size / dist_num_proc`` rows.

Raw arrays given to :meth:`Net.predict` / :meth:`Net.extract` go through
the serving path's :class:`~.serve.cache.ShapeBucketCache` (power-of-two
buckets, padding trimmed), except on nets with ``extra_data`` nodes,
which the trainer runs directly.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np

from . import config as cfgmod
from .io.data import DataBatch, create_iterator
from .nnet.trainer import NetTrainer
from .parallel import maybe_init_distributed

__all__ = ["DataIter", "Net", "train"]


class DataIter:
    """Config-driven data iterator (the reference's ``DataIter``).

    ``cfg`` is the text of one iterator section — the lines that would sit
    between ``data = train`` and ``iter = end`` in a ``.conf`` file (the
    section markers themselves are tolerated and ignored, so a pasted
    section works verbatim).
    """

    def __init__(self, cfg: str) -> None:
        entries = [
            (n, v)
            for n, v in cfgmod.parse_pairs(cfg)
            if n not in ("data", "eval", "pred")
            and not (n == "iter" and v == "end")
        ]
        self._iter = create_iterator(entries)
        self._iter.init()
        self.head = True
        self.tail = False

    def next(self) -> bool:
        ret = self._iter.next()
        self.head = False
        self.tail = not ret
        return ret

    def before_first(self) -> None:
        self._iter.before_first()
        self.head = True
        self.tail = False

    def check_valid(self) -> None:
        if self.head:
            raise RuntimeError(
                "iterator was at head state, call next to get to valid state"
            )
        if self.tail:
            raise RuntimeError("iterator reaches end")

    def value(self) -> DataBatch:
        self.check_valid()
        return self._iter.value()

    def get_data(self) -> np.ndarray:
        """Current batch data, NHWC (the reference returned NCHW)."""
        return np.asarray(self.value().data)

    def get_label(self) -> np.ndarray:
        return np.asarray(self.value().label)

    def close(self) -> None:
        """Stop the iterator's threads (``threadbuffer``, the decode
        pool, the native reader)."""
        self._iter.close()

    def __iter__(self):
        self.before_first()
        while self.next():
            yield self._iter.value()


def _as_batch(data: np.ndarray, label: Optional[np.ndarray]) -> DataBatch:
    data = np.ascontiguousarray(data, np.float32)
    if label is not None:
        label = np.asarray(label, np.float32)
        if label.ndim == 1:
            label = label.reshape(label.shape[0], 1)
        if label.ndim != 2:
            raise ValueError("label must be 1-D or 2-D")
        if label.shape[0] != data.shape[0]:
            raise ValueError("Net.update: data size mismatch")
    else:
        label = np.zeros((data.shape[0], 1), np.float32)
    return DataBatch(data=data, label=label)


ParamSpec = Union[Dict[str, object], Iterable[Tuple[str, object]]]


class Net:
    """Trainer handle (the reference's ``Net``).

    ``dev`` is the device string (``gpu``, ``cpu``; see the module
    docstring); ``cfg`` is full ``.conf`` text (netconfig section +
    globals).  Further settings can be layered on with :meth:`set_param`
    before :meth:`init_model`.
    """

    def __init__(self, dev: str = "gpu", cfg: str = "") -> None:
        self._trainer = NetTrainer()
        self._trainer.set_param("dev", dev)
        if cfg:
            self._trainer.set_params(cfgmod.parse_pairs(cfg))
        self._predict_cache = None  # lazy ShapeBucketCache (predict/extract)
        self._cache_graph = None  # the net the cache was built for

    @property
    def trainer(self) -> NetTrainer:
        """The underlying NetTrainer (no reference analog)."""
        return self._trainer

    def set_param(self, name: str, value: object) -> None:
        self._trainer.set_param(str(name), str(value))

    def init_model(self) -> None:
        # join the job the dist_* keys name, as the CLI does (a no-op
        # for one process)
        maybe_init_distributed(self._trainer.cfg)
        self._trainer.init_model()

    def load_model(self, fname: str) -> None:
        maybe_init_distributed(self._trainer.cfg)
        self._trainer.load_model(fname)

    def save_model(self, fname: str) -> None:
        self._trainer.save_model(fname)

    def start_round(self, round_counter: int) -> None:
        self._trainer.start_round(round_counter)

    def update(
        self,
        data: Union[DataIter, np.ndarray],
        label: Optional[np.ndarray] = None,
    ) -> None:
        if isinstance(data, DataIter):
            self._trainer.update(data.value())
        elif isinstance(data, np.ndarray):
            if label is None:
                raise ValueError("Net.update: need label to use update")
            self._trainer.update(_as_batch(data, label))
        else:
            raise TypeError(f"update does not support type {type(data)}")

    def update_scan(self, data: np.ndarray, label: np.ndarray,
                    n_steps: Optional[int] = None) -> np.ndarray:
        """K training steps (``NetTrainer.update_scan``): ``data`` is a
        ``[K, B, ...]`` micro-batch stack, or one ``[B, ...]`` batch
        reused ``n_steps`` times.  Returns the K losses."""
        return np.asarray(
            self._trainer.update_scan(np.asarray(data), np.asarray(label),
                                      n_steps=n_steps)
        )

    def evaluate(self, data: DataIter, name: str) -> str:
        if not isinstance(data, DataIter):
            raise TypeError(f"evaluate does not support type {type(data)}")
        ret = self._trainer.evaluate(data._iter, name)
        if len(self._trainer.metric) > 0:
            # the trainer drained the iterator; mark the wrapper exhausted
            # so a stale value()/update() raises instead of silently
            # reusing the last eval batch
            data.head, data.tail = False, True
        return ret

    def _bucket_cache(self):
        """The serving path's bucketed runner for raw arrays, rebuilt
        when the trainer rebuilds its net (init_model / load_model)."""
        from .serve.cache import ShapeBucketCache

        if (self._predict_cache is None
                or self._cache_graph is not self._trainer.graph):
            self._predict_cache = ShapeBucketCache(self._trainer)
            self._cache_graph = self._trainer.graph
        return self._predict_cache

    def _bucketed_ok(self, arr: np.ndarray) -> bool:
        """Raw arrays take the bucket cache on nets without
        ``extra_data`` side inputs."""
        return (arr.ndim >= 2 and self._trainer.graph is not None
                and not self._trainer.graph.extra_data_num)

    def predict(self, data: Union[DataIter, np.ndarray]) -> np.ndarray:
        """Prediction for the current batch (iter, its ``num_batch_padd``
        rows trimmed) or the given array (exactly ``data.shape[0]``
        rows)."""
        if isinstance(data, DataIter):
            batch = data.value()
            n = batch.batch_size - batch.num_batch_padd
            return self._trainer.predict(batch.data, batch.extra_data)[:n]
        arr = np.ascontiguousarray(np.asarray(data), np.float32)
        if self._bucketed_ok(arr):
            return self._bucket_cache().predict(arr)
        return self._trainer.predict(arr)

    def extract(self, data: Union[DataIter, np.ndarray], name: str) -> np.ndarray:
        """Feature extraction by node name or ``top[-k]`` (raw arrays:
        trimmed to the input row count, bucketed like predict)."""
        if isinstance(data, DataIter):
            batch = data.value()
            n = batch.batch_size - batch.num_batch_padd
            return self._trainer.extract_feature(batch, name)[:n]
        arr = np.ascontiguousarray(np.asarray(data), np.float32)
        if self._bucketed_ok(arr):
            return self._bucket_cache().extract(arr, name)
        return self._trainer.extract_feature(_as_batch(arr, None), name)

    def generate(self, prompt: str = "", gen_len: int = 256,
                 temp: float = 0.0, cache: bool = True,
                 seed: Optional[int] = None, topk: int = 0,
                 topp: float = 0.0) -> str:
        """Continue ``prompt`` from a trained byte-level language model
        (``nnet/generate.py``: KV-cache decoding by default, the sliding
        window otherwise)."""
        from .nnet.generate import generate

        return generate(self._trainer, prompt, gen_len, temp,
                        cache=cache, seed=seed, topk=topk, topp=topp)

    def set_weight(self, weight: np.ndarray, layer_name: str, tag: str) -> None:
        self._trainer.set_weight(np.asarray(weight, np.float32), layer_name, tag)

    def get_weight(self, layer_name: str, tag: str) -> Optional[np.ndarray]:
        w = self._trainer.get_weight(layer_name, tag)
        return None if w.size == 0 else w


def train(
    cfg: str,
    data: Union[DataIter, np.ndarray],
    num_round: int,
    param: ParamSpec,
    eval_data: Optional[DataIter] = None,
    label: Optional[np.ndarray] = None,
    dev: str = "gpu",
    print_step: int = 100,
) -> Net:
    """Config-in, trained-``Net``-out loop (the reference's ``train``)."""
    net = Net(dev=dev, cfg=cfg)
    items = param.items() if isinstance(param, dict) else param
    for k, v in items:
        net.set_param(k, v)
    net.init_model()
    if isinstance(data, DataIter):
        for r in range(num_round):
            net.start_round(r)
            data.before_first()
            scounter = 0
            while data.next():
                net.update(data)
                scounter += 1
                if print_step and scounter % print_step == 0:
                    print(f"[{r}] {scounter} batch passed")
            if eval_data is not None:
                seval = net.evaluate(eval_data, "eval")
                sys.stderr.write(seval + "\n")
        return net
    for r in range(num_round):
        net.start_round(r)
        net.update(data=data, label=label)
        if eval_data is not None:
            sys.stderr.write(net.evaluate(eval_data, "eval") + "\n")
    return net
