"""Serving engine: checkpoint-validated model + batcher + bucket runner.

Counterpart of ``cxxnet_tpu/serve/engine.py`` for this slice:

* **model loading** — from an explicit checkpoint path (``model_in``),
  the newest *valid* checkpoint in a directory (``model_dir``; manifest
  CRC32 + size + net-fingerprint validation, corrupt checkpoints are
  skipped, never served), or an initialized trainer (``trainer``);
* **bucketed predict** — a :class:`~.cache.ShapeBucketCache`;
* **dynamic micro-batching** — every request goes through the
  :class:`~.batcher.MicroBatcher`; ``submit`` is the direct Python API
  (numpy in, numpy out, thread-safe);
* **metrics** — a :class:`~.metrics.ServingStats` shared with the
  front-end's ``/statsz``;
* **quantized serving** — under ``quant = int8|bf16`` the engine loads
  the ``.quant.model`` sibling of the checkpoint it picked when one
  exists, validates and carries that scheme; past a sibling that fails
  to load it serves the round's f32 base; with no sibling the trainer
  quantizes on load, ungated.  ``/healthz`` and ``/statsz`` report the
  scheme and the weight bytes at rest against their dense-f32 cost.

* **the wire** — ``wire = binary`` (the default) lets the server
  negotiate the ``application/x-cxb`` frames of ``wire.py`` per request
  by Content-Type, beside JSON; ``wire = json`` turns the binary path
  off (such frames get 400 ``wire_disabled``).

Hot reload, the canary, the reload breaker, the fleet/router and the
tuner are later slices (ROADMAP.md).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import config as cfgmod
from ..nnet.graph import NetGraph
from ..nnet.quant import quant_artifact_path
from ..nnet.trainer import NetTrainer
from ..ops import quant as opsq
from ..utils import checkpoint as ckpt
from .batcher import ClosedError, MicroBatcher, ServeError
from .cache import ShapeBucketCache
from .metrics import ServingStats

__all__ = ["Engine", "ModelLoadError"]

ConfigEntry = Tuple[str, str]


class ModelLoadError(ServeError):
    """No usable checkpoint could be loaded."""

    http_status = 503


def _parse_cfg(cfg: Union[str, Sequence[ConfigEntry], None]):
    if cfg is None:
        return []
    if isinstance(cfg, str):
        return list(cfgmod.parse_pairs(cfg))
    return list(cfg)


class Engine:
    """One served model behind a micro-batcher.

    ``cfg`` carries the netconfig (checkpoints store structure; layer
    settings come from the conf) plus trainer globals (``dev`` etc.).
    Exactly one model source: ``model_in``, ``model_dir`` or
    ``trainer``."""

    def __init__(
        self,
        cfg: Union[str, Sequence[ConfigEntry], None] = None,
        model_in: Optional[str] = None,
        model_dir: Optional[str] = None,
        trainer: Optional[NetTrainer] = None,
        max_batch_size: int = 0,
        batch_timeout_ms: float = 2.0,
        queue_limit: int = 128,
        default_deadline_ms: float = 0.0,
        silent: bool = True,
        watchdog_timeout_s: float = 600.0,
    ) -> None:
        self._cfg = _parse_cfg(cfg)
        self.model_dir = model_dir
        self.silent = silent
        # the scheme to prefer a .quant.model sibling for; the trainer
        # validates the value
        self.quant = ""
        self.wire = "binary"
        for n, v in self._cfg:
            if n == "quant":
                self.quant = "" if v in ("", "0", "off", "none") else v
            elif n == "wire":
                if v not in ("binary", "json"):
                    raise ValueError(
                        f"wire must be binary or json, got {v!r}")
                self.wire = v
        self.default_deadline_ms = float(default_deadline_ms)
        self._model_lock = threading.RLock()
        self._round = -1
        self._model_path: Optional[str] = None
        self._model_crc: Optional[int] = None
        if trainer is not None:
            if trainer.net is None:
                raise ValueError("Engine(trainer=...): init/load it first")
            self._trainer = trainer
        elif model_in is not None:
            model_in = self._prefer_quant(model_in)
            reason = ckpt.validate_checkpoint(model_in,
                                              net_fp=self._conf_net_fp())
            if reason is not None:
                raise ModelLoadError(f"{model_in}: {reason}")
            self._trainer = self._load_trainer(model_in)
            self._set_model(model_in)
        elif model_dir is not None:
            self._load_newest(model_dir)
        else:
            raise ValueError(
                "Engine needs one of model_in / model_dir / trainer")
        if max_batch_size <= 0:
            max_batch_size = self._trainer.batch_size or 64
        self.max_batch_size = max_batch_size
        self.stats = ServingStats()
        self.stats.set_weights(*opsq.weight_bytes(self._trainer.params),
                               opsq.scheme_of(self._trainer) or "f32")
        self._cache = ShapeBucketCache(self._trainer)
        self._row_shapes = self._allowed_row_shapes(self._trainer)
        self.batcher = MicroBatcher(
            self._run_batch,
            max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_ms,
            queue_limit=queue_limit,
            stats=self.stats,
            watchdog_timeout_s=watchdog_timeout_s,
        )
        self._closed = False

    # ------------------------------------------------------------------
    # loading
    def _load_newest(self, model_dir: str) -> None:
        """Newest checkpoint that both validates (manifest CRC) and
        loads; falls back past one whose payload fails to load."""
        net_fp = self._conf_net_fp()
        before, last_err = None, None
        while True:
            found = ckpt.find_latest_valid(model_dir, net_fp=net_fp,
                                           silent=self.silent, before=before)
            if found is None:
                detail = f" (last load failure: {last_err})" if last_err else ""
                raise ModelLoadError(
                    f"no loadable checkpoint in {model_dir!r}{detail}")
            path = self._prefer_quant(found[1])
            try:
                self._trainer = self._load_trainer(path)
            except NotImplementedError:
                raise
            except Exception as e:  # noqa: BLE001 - fall back past it
                last_err = e
                if path != found[1]:
                    # the quant sibling failed: the round's f32 base may
                    # still load; try it before skipping the round
                    if not self.silent:
                        print(f"serve: quant artifact {path} failed to load "
                              f"({type(e).__name__}: {e}); trying the f32 "
                              "base", flush=True)
                    path = found[1]
                    try:
                        self._trainer = self._load_trainer(path)
                    except NotImplementedError:
                        raise
                    except Exception as e2:  # noqa: BLE001
                        last_err = e2
                        before = found[0]
                        continue
                else:
                    if not self.silent:
                        print(f"serve: checkpoint {path} failed to load "
                              f"({type(e).__name__}: {e}); falling back to "
                              "an older round", flush=True)
                    before = found[0]
                    continue
            self._set_model(path, found[0])
            return

    def _prefer_quant(self, path: str) -> str:
        """Under ``quant = <scheme>``: the checkpoint's ``.quant.model``
        sibling when it exists, validates and carries that scheme in its
        manifest; else ``path`` (whose trainer then quantizes on load)."""
        if not self.quant:
            return path
        qp = quant_artifact_path(path)
        if qp == path or not os.path.exists(qp):
            return path
        if ckpt.validate_checkpoint(qp, net_fp=self._conf_net_fp()) is not None:
            return path
        man = ckpt.read_manifest(qp) or {}
        if (man.get("quant") or {}).get("scheme") != self.quant:
            return path
        return qp

    def _conf_net_fp(self) -> Optional[str]:
        """Fingerprint of the conf's netconfig for manifest validation
        (None when the conf carries none)."""
        try:
            g = NetGraph()
            g.configure(self._cfg)
            return ckpt.net_fingerprint(g.structure_to_json())
        except Exception:  # noqa: BLE001 - no netconfig: CRC still applies
            return None

    def _load_trainer(self, path: str) -> NetTrainer:
        tr = NetTrainer()
        tr.set_params(self._cfg)
        tr.load_model(path)
        return tr

    def _set_model(self, path: str, round_: Optional[int] = None) -> None:
        self._model_path = path
        man = ckpt.read_manifest(path)
        if round_ is None:
            round_ = ckpt.checkpoint_round(path)
            if man is not None and man.get("round") is not None:
                round_ = int(man["round"])
        self._round = round_ if round_ is not None else -1
        self._model_crc = (int(man["crc32"]) if man is not None
                           and man.get("crc32") is not None else None)

    @staticmethod
    def _allowed_row_shapes(tr: NetTrainer) -> List[Tuple[int, ...]]:
        """The net's native input row, plus its flat spelling."""
        row = tuple(tr.net.input_node_shape(1)[1:])
        shapes = [row]
        flat = (int(np.prod(row)),)
        if flat != row:
            shapes.append(flat)
        return shapes

    # ------------------------------------------------------------------
    # request path
    def _validate(self, data) -> np.ndarray:
        arr = np.ascontiguousarray(data, np.float32)
        if arr.ndim == 1 and (arr.shape[0],) in self._row_shapes:
            arr = arr[None, :]  # single flat instance
        if arr.ndim < 2 or arr.shape[0] < 1:
            raise ValueError(
                f"request must be a (N, ...) batch of at least one row, "
                f"got shape {arr.shape}")
        if arr.shape[0] > self.max_batch_size:
            raise ValueError(
                f"request has {arr.shape[0]} rows, above the server's "
                f"max_batch_size={self.max_batch_size}; split it into "
                f"smaller requests")
        if tuple(arr.shape[1:]) not in self._row_shapes:
            raise ValueError(
                f"bad input row shape {tuple(arr.shape[1:])}; this model "
                f"accepts rows of shape "
                f"{' or '.join(str(s) for s in self._row_shapes)}")
        return arr

    def _run_batch(self, kind: str, node: Optional[str],
                   data: np.ndarray) -> np.ndarray:
        """Batcher callback: one coalesced batch through the model."""
        with self._model_lock:
            cache = self._cache
        self.stats.record_batch(data.shape[0], cache.bucket_for(data.shape[0]))
        if kind == "extract":
            return cache.extract(data, node)
        if kind == "scores":
            return cache.scores(data)
        return cache.predict(data)

    def submit(self, data, kind: str = "predict", node: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> np.ndarray:
        """Block until the request's rows come back through the
        micro-batcher.  ``kind``: ``predict`` (argmax/value per
        instance), ``scores`` (raw f32 out-node rows), or ``extract``
        (features of ``node``).  Raises ``OverloadError`` /
        ``DeadlineError`` / ``ValueError`` on shed, expiry, or malformed
        input."""
        if self._closed:
            raise ClosedError("engine is closed")
        if kind not in ("predict", "scores", "extract"):
            raise ValueError(f"unknown request kind {kind!r}")
        if kind == "extract" and not node:
            raise ValueError("extract requests need a node name")
        arr = self._validate(data)
        self.stats.record_request(arr.shape[0])
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        t0 = time.monotonic()
        try:
            out = self.batcher.submit(
                arr, kind=kind, node=node if kind == "extract" else None,
                deadline_ms=deadline_ms)
        except ServeError as e:
            self.stats.record_outcome(
                "shed" if e.http_status == 429
                else "expired" if e.http_status == 504 else "error")
            raise
        except BaseException:
            self.stats.record_outcome("error")
            raise
        self.stats.record_outcome("ok", time.monotonic() - t0)
        return out

    def predict(self, data, deadline_ms: Optional[float] = None):
        return self.submit(data, kind="predict", deadline_ms=deadline_ms)

    def scores(self, data, deadline_ms: Optional[float] = None):
        return self.submit(data, kind="scores", deadline_ms=deadline_ms)

    def extract(self, data, node: str, deadline_ms: Optional[float] = None):
        return self.submit(data, kind="extract", node=node,
                           deadline_ms=deadline_ms)

    # ------------------------------------------------------------------
    # introspection
    @property
    def round(self) -> int:
        return self._round

    @property
    def model_path(self) -> Optional[str]:
        return self._model_path

    @property
    def trainer(self) -> NetTrainer:
        return self._trainer

    def healthz(self) -> Dict[str, object]:
        with self._model_lock:
            return {
                "status": "closed" if self._closed else "ok",
                "round": self._round,
                "model": self._model_path,
                "model_crc32": self._model_crc,
                "net_fp": self._cache.net_fp(),
                "quant": self._cache.quant_scheme() or "f32",
                "device": str(self._trainer.device),
                "reasons": [],
            }

    def snapshot_stats(self) -> Dict[str, object]:
        out = self.stats.snapshot()
        with self._model_lock:
            out["compile_cache"] = self._cache.stats()
            wb, wb32 = opsq.weight_bytes(self._trainer.params)
            out["model"] = {"path": self._model_path, "round": self._round,
                            "crc32": self._model_crc,
                            "net_fp": self._cache.net_fp(),
                            "quant": self._cache.quant_scheme() or "f32",
                            "weight_bytes": wb, "weight_bytes_f32": wb32}
        out["batcher"] = {
            "max_batch_size": self.batcher.max_batch_size,
            "batch_timeout_ms": self.batcher.batch_timeout * 1e3,
            "queue_limit": self.batcher.queue_limit,
        }
        return out

    # ------------------------------------------------------------------
    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.batcher.close()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
