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
  off (such frames get 400 ``wire_disabled``);
* **hot reload** — :meth:`reload_if_newer` loads a newer valid
  checkpoint of ``model_dir`` (or, under ``quant``, the gated
  ``.quant.model`` sibling that appears for the round already serving)
  into a fresh trainer, warms it at every bucket the old one served,
  then swaps it in under the model lock: a batch in flight finishes on
  the old model, the next runs on the new one, and nothing keeps the
  old trainer alive.  :meth:`try_reload` puts it behind a
  :class:`~..utils.faults.CircuitBreaker`: ``reload_breaker_threshold``
  consecutive failures open it, the old model keeps serving and
  ``/healthz`` turns ``degraded`` (``reload_breaker_open``) until a
  trial after ``reload_breaker_cooldown_s`` succeeds;
* **the golden canary** — under ``integrity_probe = 1`` the engine
  scores the probe batch of the checkpoint's manifest at load
  (``integrity/canary.py``) and :meth:`check_canary` holds every later
  score of it to that CRC bit for bit; a drift degrades ``/healthz``
  (``integrity_failed``) until a clean score or a reload.

* **observability** (``obs/``) — the JAX engine's events
  (``serve.start``, ``serve.reload`` on a swap and on a failure,
  ``integrity.detect`` / ``integrity.clean`` / ``integrity.golden_rebased``),
  the ``serve.batch`` span around each coalesced forward, the served
  model's ``serve_model_round`` / ``serve_model_crc32`` gauges, the
  canary's ``integrity_checks_total{kind,verdict}`` /
  ``integrity_failures_total{kind}`` counters, and the alert rules that
  fire (``alert=``) named in ``/healthz`` (``alert:<name>`` reasons,
  status ``degraded``); beside them the port still prints a line per
  reload or canary verdict unless ``silent``.

* **the tuner's surface** — :meth:`set_max_batch_size` (the new
  limit's bucket warmed first), :meth:`set_batch_timeout_ms`, and
  :meth:`prewarm_buckets` over the request histogram by bucket and row
  shape (``request_buckets`` and ``tune_effective`` in ``/statsz``),
  which ``controller = 1`` turns (``tune/``); the ``serve.batch`` and
  ``serve.reload`` fault sites.

N engines in N processes behind one front door are the serving fleet
(``fleet.py``, ``router.py``; ``task=serve replicas = N``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import config as cfgmod
from ..integrity import canary
from ..nnet.graph import NetGraph
from ..nnet.quant import quant_artifact_path
from ..nnet.trainer import NetTrainer
from ..obs import alerts as obs_alerts
from ..obs import events as obs_events
from ..obs import trace as obs_trace
from ..obs.registry import registry as obs_registry
from ..ops import quant as opsq
from ..utils import checkpoint as ckpt
from ..utils import faults
from ..utils.faults import CircuitBreaker, RetryPolicy
from .batcher import ClosedError, MicroBatcher, ServeError
from .cache import ShapeBucketCache
from .metrics import ServingStats, serve_metrics

__all__ = ["Engine", "ModelLoadError"]

ConfigEntry = Tuple[str, str]

# keys ``prewarm_buckets`` warms a call (the tuner calls it every tick)
PREWARM_PER_CALL = 2


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
    Exactly one model source: ``model_in``, ``model_dir`` (the newest
    valid checkpoint; also the hot-reload watch directory) or
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
        reload_breaker_threshold: int = 3,
        reload_breaker_cooldown_s: float = 30.0,
        watchdog_timeout_s: float = 600.0,
    ) -> None:
        self._cfg = _parse_cfg(cfg)
        self.model_dir = model_dir
        self.silent = silent
        # the scheme to prefer a .quant.model sibling for; the trainer
        # validates the value
        self.quant = ""
        self.wire = "binary"
        # integrity_probe = 1: the golden canary (check_canary)
        self.integrity_probe = 0
        for n, v in self._cfg:
            if n == "quant":
                self.quant = "" if v in ("", "0", "off", "none") else v
            elif n == "wire":
                if v not in ("binary", "json"):
                    raise ValueError(
                        f"wire must be binary or json, got {v!r}")
                self.wire = v
            elif n == "integrity_probe":
                try:
                    self.integrity_probe = int(v)
                except ValueError:
                    pass
        self.default_deadline_ms = float(default_deadline_ms)
        # transient I/O on a checkpoint load is retried (retry_* keys)
        self._retry = RetryPolicy.from_cfg(self._cfg)
        self.reload_breaker = CircuitBreaker(
            failure_threshold=reload_breaker_threshold,
            cooldown_s=reload_breaker_cooldown_s)
        self._model_lock = threading.RLock()
        # one reload or canary check at a time: /reloadz and the poll
        # thread may both call in, and a canary must never score a model
        # against the golden of the one it replaced
        self._reload_lock = threading.RLock()
        self.last_reload_s: Optional[float] = None  # the last swap's load + warm
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
        # request histogram: (bucket, row shape) -> requests, fed by
        # submit(); the tuner's prewarm (prewarm_buckets) reads it to
        # warm a bucket before its first coalesced batch
        self._req_buckets: Dict[tuple, int] = {}
        self._req_lock = threading.Lock()
        self.batcher = MicroBatcher(
            self._run_batch,
            max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_ms,
            queue_limit=queue_limit,
            stats=self.stats,
            watchdog_timeout_s=watchdog_timeout_s,
        )
        self._closed = False
        # golden canary state: the probe batch, the CRC it must keep
        # reproducing, and the latch /healthz reports
        self.inject_canary_mismatch = 0  # tests: corrupt the next N CRCs
        self._canary_probe: Optional[np.ndarray] = None
        self._canary_golden: Optional[int] = None
        self._canary_src = ""
        self._canary_failed = False
        self._canary_runs = 0
        self._canary_setup()
        obs_events.emit("serve.start", round=self._round,
                        model=self._model_path,
                        max_batch_size=self.max_batch_size)

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
        self._retry.run(lambda: tr.load_model(path), what=f"loading {path}",
                        silent=self.silent)
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
        # the served weights' identity, scrapeable: a publish landing
        m = serve_metrics()
        m.model_round.set(self._round)
        m.model_crc.set(self._model_crc if self._model_crc is not None
                        else -1)

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
        """Batcher callback: one coalesced batch through the model (the
        ``serve.batch`` fault site first).  Kind ``warm`` is a prewarm
        (:meth:`_warm_bucket`): the forward alone, unrecorded."""
        with self._model_lock:
            cache = self._cache
        if kind == "warm":
            return cache._run("out", None, data)
        faults.fault_point("serve.batch")
        n = data.shape[0]
        self.stats.record_batch(n, cache.bucket_for(n))
        with obs_trace.span("serve.batch", kind=kind, rows=n):
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
        with self._model_lock:
            bucket = self._cache.bucket_for(arr.shape[0])
        hkey = (bucket, tuple(arr.shape[1:]))
        with self._req_lock:
            self._req_buckets[hkey] = self._req_buckets.get(hkey, 0) + 1
        self.stats.record_request(arr.shape[0], bucket=bucket)
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
    # hot reload
    def reload_if_newer(self) -> bool:
        """Swap to a newer valid checkpoint of ``model_dir``; False when
        there is none, when the engine has no watch directory, or when
        the newest round already serves from its preferred artifact.
        Under ``quant`` a gated ``.quant.model`` sibling that appears for
        the round already serving does swap in; rounds never move
        backward.  A load failure raises (``try_reload`` counts it).

        The fresh trainer is warmed at every key the old cache served
        before the swap, which is a pointer flip under the model lock.
        The ``serve.reload`` fault site is visited first."""
        if self.model_dir is None:
            return False
        faults.fault_point("serve.reload")
        with self._reload_lock:
            found = ckpt.find_latest_valid(
                self.model_dir, net_fp=self._conf_net_fp(),
                silent=self.silent)
            if found is None or found[0] < self._round:
                return False
            round_, path = found
            path = self._prefer_quant(path)
            if round_ == self._round and path == self._model_path:
                return False
            t0 = time.perf_counter()
            tr = self._load_trainer(path)
            cache = ShapeBucketCache(tr)
            self._warm(cache)
            with self._model_lock:
                old_round = self._round
                self._trainer = tr
                self._cache = cache
                self._row_shapes = self._allowed_row_shapes(tr)
                self._set_model(path, round_)
                self.stats.set_weights(*opsq.weight_bytes(tr.params),
                                       opsq.scheme_of(tr) or "f32")
            del tr, cache
            # new weights: rebase the golden (and clear its latch)
            self._canary_setup()
            self.last_reload_s = time.perf_counter() - t0
        obs_events.emit("serve.reload", ok=True, swapped=True, round=round_,
                        old_round=old_round, path=path)
        if not self.silent:
            print(f"serve: hot-reloaded round {round_} from {path} (was "
                  f"round {old_round}; load and warm "
                  f"{self.last_reload_s:.3f}s)", flush=True)
        return True

    def try_reload(self) -> bool:
        """:meth:`reload_if_newer` behind the circuit breaker: the poll
        thread's and ``POST /reloadz``'s entry point.  Never raises: a
        failure is counted (``reload_failures`` in ``/statsz``), opens
        the breaker after ``reload_breaker_threshold`` in a row, and the
        old model keeps serving; while the breaker is open the attempt
        is skipped.  True only when a model was swapped in."""
        if not self.reload_breaker.allow():
            return False
        try:
            swapped = self.reload_if_newer()
        except Exception as e:  # noqa: BLE001 - degrade, don't die
            self.reload_breaker.record_failure()
            self.stats.record_reload(ok=False)
            obs_events.emit("serve.reload", ok=False,
                            error=f"{type(e).__name__}: {e}",
                            breaker=self.reload_breaker.state,
                            serving_round=self._round)
            if not self.silent:
                print(f"serve: reload failed ({type(e).__name__}: {e}); "
                      f"breaker {self.reload_breaker.state}, serving round "
                      f"{self._round}", flush=True)
            return False
        self.reload_breaker.record_success()
        self.stats.record_reload(ok=True, swapped=swapped)
        return swapped

    def reload_degraded(self) -> bool:
        """True while the reload breaker is not closed: the model still
        serves but may be stale.  One failure under the threshold does
        not degrade health (``last_reload_ok`` in ``/statsz`` shows
        it)."""
        return self.reload_breaker.state != "closed"

    def _warm(self, cache: ShapeBucketCache) -> None:
        """Run zeros through ``cache`` at every (kind, node, bucket, row
        shape, dtype) the current cache has served: the prepared
        operands, cuDNN's algorithm picks and the kernels' first
        launches happen here, not in the first requests after the
        swap."""
        with self._model_lock:
            keys = self._cache.keys_snapshot()
        for _fp, kind, node_id, bucket, row_shape, dtype, _q in keys:
            zeros = np.zeros((bucket,) + tuple(row_shape), dtype)
            try:
                cache._run(kind, node_id, zeros)
            except Exception as e:  # noqa: BLE001 - the request pays later
                if not self.silent:
                    print(f"serve: warmup failed for bucket {bucket} shape "
                          f"{row_shape} ({type(e).__name__}: {e})",
                          flush=True)

    # ------------------------------------------------------------------
    # live knobs and the speculative prewarm (the tuner's surface)
    def set_max_batch_size(self, n: int, prewarm: bool = True) -> int:
        """Set the micro-batcher's coalescing limit, clamped to the
        engine's ``max_batch_size``.  With ``prewarm`` the new limit's
        bucket is warmed (one forward through ``ShapeBucketCache`` at the
        most requested row shape) on the calling thread BEFORE the limit
        applies, so the first larger batch finds cuDNN's algorithms
        picked and the prepared operands built."""
        n = max(1, min(int(n), self.max_batch_size))
        if prewarm:
            self._warm_bucket(self._bucket_for(n),
                              self._dominant_row_shape())
        self.batcher.set_max_batch_size(n)
        from ..tune.controller import set_effective

        set_effective("max_batch_size", n)
        return n

    def set_batch_timeout_ms(self, ms: float) -> float:
        """Set the micro-batcher's batch-open window."""
        out = self.batcher.set_batch_timeout_ms(ms)
        from ..tune.controller import set_effective

        set_effective("batch_timeout_ms", out)
        return out

    def _bucket_for(self, n: int) -> int:
        with self._model_lock:
            return self._cache.bucket_for(n)

    def _dominant_row_shape(self) -> Tuple[int, ...]:
        """The most requested row shape so far (the native shape before
        any traffic)."""
        with self._req_lock:
            if self._req_buckets:
                (_b, shape), _ = max(self._req_buckets.items(),
                                     key=lambda kv: kv[1])
                return tuple(shape)
        return tuple(self._row_shapes[0])

    def _warm_bucket(self, bucket: int,
                     row_shape: Tuple[int, ...]) -> bool:
        """Run ``bucket`` rows of zeros of ``row_shape`` through the
        cache once, on the batcher's thread: the thread that will run
        the bucket (PyTorch keeps the cuBLAS and cuDNN handles, and
        cuDNN's execution plans, per thread), as a ``warm`` request
        that never coalesces with traffic.  False when that exact key is
        already warm or the warm failed (the request pays it later)."""
        row_shape = tuple(row_shape)
        with self._model_lock:
            cache = self._cache
        if any(k[1] == "out" and k[3] == bucket
               and tuple(k[4]) == row_shape
               for k in cache.keys_snapshot()):
            return False
        zeros = np.zeros((bucket,) + row_shape, np.float32)
        try:
            self.batcher.submit(zeros, kind="warm")
        except Exception as e:  # noqa: BLE001 - a failed warm only costs
            obs_events.log_exception_once(   # the request's first forward
                "serve.prewarm", e, kind="tune.error", bucket=bucket)
            return False
        return True

    def prewarm_buckets(self) -> list:
        """Warm the most requested not-yet-warm (bucket, row shape)
        keys of the request histogram, up to the live batch limit and
        at most ``PREWARM_PER_CALL`` a call (the tuner runs it every tick);
        each warm emits ``tune.prewarm``."""
        with self._req_lock:
            hist = sorted(self._req_buckets.items(), key=lambda kv: -kv[1])
        ceiling = self._bucket_for(self.batcher.max_batch_size)
        warmed = []
        for (bucket, shape), count in hist:
            if len(warmed) >= PREWARM_PER_CALL:
                break
            if bucket > ceiling:
                continue
            if self._warm_bucket(bucket, shape):
                warmed.append(bucket)
                obs_events.emit("tune.prewarm", bucket=bucket,
                                row_shape=list(shape), requests=count)
        return warmed

    # ------------------------------------------------------------------
    # golden canary
    def _score_probe(self, probe: np.ndarray) -> int:
        with self._model_lock:
            cache = self._cache
        return canary.scores_crc(cache._run("out", None, probe))

    def _canary_setup(self) -> None:
        """(Re)base the golden at model load.  The manifest's ``probe``
        block commits the probe batch; its CRC binds only when this
        engine scores through the same pipeline class (backend,
        unquantized) and reproduces it.  Otherwise the golden is this
        engine's own load-time score (``src`` ``rebased``, or ``local``
        when the manifest has no CRC or no block)."""
        if not self.integrity_probe:
            return
        self._canary_failed = False
        backend = canary.backend_of(self._trainer.device)
        block = None
        if self._model_path is not None:
            block = (ckpt.read_manifest(self._model_path) or {}).get("probe")
        if not isinstance(block, dict):
            rows = max(1, min(8, self.max_batch_size))
            block = canary.make_probe_block(
                0xC0FFEE, rows, tuple(self._row_shapes[0]), None, backend)
        try:
            probe = canary.probe_batch(block["seed"], block["rows"],
                                       tuple(block["shape"]))
            crc_now = self._score_probe(probe)
        except Exception as e:  # noqa: BLE001 - the canary must not block serve
            obs_events.log_exception_once(
                "serve.canary_setup", e, kind="integrity.error",
                model=self._model_path)
            if not self.silent:
                print(f"serve: canary setup failed for {self._model_path} "
                      f"({type(e).__name__}: {e}); canary off", flush=True)
            self._canary_probe = None
            self._canary_golden = None
            return
        binding = canary.block_matches_pipeline(
            block, backend=backend, quant=bool(self.quant_scheme))
        if binding and int(block["crc32"]) == crc_now:
            src = "manifest"
        else:
            src = "local" if block.get("crc32") is None else "rebased"
            if src == "rebased":
                obs_events.emit(
                    "integrity.golden_rebased", round=self._round,
                    model=self._model_path,
                    manifest_crc32=block.get("crc32"), local_crc32=crc_now,
                    binding=binding, backend=backend,
                    quant=self.quant_scheme or "f32")
            if src == "rebased" and not self.silent:
                print(f"serve: canary golden rebased for round {self._round}"
                      f" (manifest {block.get('crc32'):#010x} on "
                      f"{block.get('backend')}, local {crc_now:#010x} on "
                      f"{backend}, binding {binding})", flush=True)
        self._canary_probe = probe
        self._canary_golden = crc_now
        self._canary_src = src

    def check_canary(self) -> bool:
        """Score the probe batch again and compare its CRC with the
        golden, bit for bit.  A mismatch latches ``integrity_failed`` in
        ``/healthz`` (status ``degraded``) until the next clean score or
        reload.  True when clean or off; never raises."""
        with self._reload_lock:
            if self._canary_golden is None or self._canary_probe is None:
                return True
            try:
                crc = self._score_probe(self._canary_probe)
            except Exception as e:  # noqa: BLE001 - degrade, don't die
                obs_events.log_exception_once(
                    "serve.canary", e, kind="integrity.error",
                    model=self._model_path)
                if not self.silent:
                    print(f"serve: canary run failed ({type(e).__name__}: "
                          f"{e})", flush=True)
                return True
            if self.inject_canary_mismatch > 0:
                self.inject_canary_mismatch -= 1
                crc ^= 0x1
            self._canary_runs += 1
            clean = crc == self._canary_golden
            obs_registry().counter(
                "integrity_checks_total",
                "Integrity-plane checks by kind and verdict.",
                labelnames=("kind", "verdict"),
            ).labels(kind="canary",
                     verdict="clean" if clean else "corrupt").inc()
            if clean:
                if self._canary_failed:
                    obs_events.emit("integrity.clean", kind="canary",
                                    round=self._round, crc32=crc)
                    if not self.silent:
                        print(f"serve: integrity canary clean again (round "
                              f"{self._round})", flush=True)
                self._canary_failed = False
                return True
            first = not self._canary_failed
            self._canary_failed = True
            obs_registry().counter(
                "integrity_failures_total",
                "Integrity-plane corruption verdicts.",
                labelnames=("kind",),
            ).labels(kind="canary").inc()
            obs_events.emit("integrity.detect", kind="canary",
                            round=self._round, model=self._model_path,
                            golden_crc32=self._canary_golden, crc32=crc)
            if first and not self.silent:
                print(f"serve: integrity canary FAILED (golden "
                      f"{self._canary_golden:#010x} != {crc:#010x}); "
                      "/healthz degraded integrity_failed", flush=True)
            return False

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
        """The live trainer (hot reload swaps it: hold no reference
        across requests)."""
        with self._model_lock:
            return self._trainer

    @property
    def quant_scheme(self) -> str:
        """The served weights' scheme (``""`` for plain f32)."""
        with self._model_lock:
            return self._cache.quant_scheme()

    def healthz(self) -> Dict[str, object]:
        # every degrade condition as a stable token (the fleet's probe
        # reads them): the model still serves, but may be stale or its
        # compute untrusted
        # firing alert rules degrade health as an open breaker does
        firing = obs_alerts.evaluator().firing()
        # a colocated trainer mid rebuild of its group degrades health
        # as an open breaker does
        from ..parallel import elastic as par_elastic

        rebuilding = par_elastic.rebuild_in_progress()
        reasons: List[str] = []
        if self.reload_degraded():
            reasons.append("reload_breaker_open")
        if rebuilding:
            reasons.append("mesh_rebuilding")
        if self._canary_failed:
            reasons.append("integrity_failed")
        reasons.extend(f"alert:{name}" for name in firing)
        with self._model_lock:
            out = {
                "status": ("closed" if self._closed
                           else "degraded" if reasons else "ok"),
                "round": self._round,
                "model": self._model_path,
                "model_crc32": self._model_crc,
                "net_fp": self._cache.net_fp(),
                "quant": self._cache.quant_scheme() or "f32",
                "device": str(self._trainer.device),
                "reload_breaker": self.reload_breaker.state,
                "reasons": reasons,
            }
        if rebuilding:
            out["mesh"] = "rebuilding"
        if firing:
            out["alerts"] = firing
        return out

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
        # what the tuner chose (the tune_effective{knob} gauges)
        out["tune_effective"] = {
            "max_batch_size": self.batcher.max_batch_size,
            "batch_timeout_ms": self.batcher.batch_timeout * 1e3,
        }
        agg: Dict[int, int] = {}
        with self._req_lock:
            for (b, _shape), c in self._req_buckets.items():
                agg[b] = agg.get(b, 0) + c
        out["request_buckets"] = {str(k): v for k, v in sorted(agg.items())}
        out["reload_breaker"] = self.reload_breaker.snapshot()
        if self.integrity_probe:
            out["integrity"] = {
                "probe": 1,
                "golden_crc32": self._canary_golden,
                "golden_src": self._canary_src,
                "runs": self._canary_runs,
                "failed": self._canary_failed,
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
