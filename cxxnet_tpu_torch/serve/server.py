"""HTTP front-end: a stdlib JSON and binary endpoint over :class:`Engine`.

Counterpart of ``cxxnet_tpu/serve/server.py`` for this slice.
``ThreadingHTTPServer`` gives one thread per connection; every handler
thread blocks in ``Engine.submit`` while the micro-batcher coalesces
concurrent requests into shared forwards.  The handler speaks HTTP/1.1,
so a client keeps its connection alive across requests.  Endpoints:

* ``POST /predict``  — ``{"data": [[...], ...]}`` → ``{"pred": [...]}``
  (add ``"raw": true`` for the full score rows, ``{"scores": ...}``)
* ``POST /extract``  — ``{"data": ..., "node": "fc1"}`` →
  ``{"features": [[...], ...]}``
* ``GET  /healthz``  — liveness + model identity (round, fingerprint)
* ``GET  /statsz``   — serving metrics (``metrics.py``)
* ``GET  /metricsz`` — Prometheus text (version 0.0.4) of the
  process-wide metrics registry (``obs/registry.py``): request outcomes
  and latency buckets, batches, reloads, the wire split, the served
  weights, the card's memory watermarks (``xla_device_memory_bytes``),
  events and alert transitions
* ``GET  /alertz``   — the alert evaluator's rules and their live state
  as JSON (``alert=`` rules; ``obs/alerts.py``)
* ``POST /reloadz``  — one breaker-gated hot-reload attempt →
  ``{"ok", "swapped", "round", "breaker", "rid"}`` (an empty body is
  allowed; under a router a ``{"model": ...}`` body picks the engine)
* ``POST /feedback`` — ``{"data": [[...], ...], "label": [...]}`` →
  ``{"appended", "dropped", "seq": [first, last], "rid"}``: labelled
  rows into the closed loop's feedback log (``loop/feedback_log.py``,
  armed by ``task=serve_train`` and ``task=loop_fleet``; 404 when no
  log is armed).  A failed append drops and counts the rows
  (``loop_feedback_dropped_total``) and the request still succeeds.
  ``/feedback`` stays JSON: a ``CXB1`` frame to it gets 400
  ``wire_unsupported_route``.  With ``capture_predict = 1`` every
  answered ``/predict`` (JSON or binary) also logs its rows with the
  model's own predictions as labels, after the reply is written.

A ``router`` (``router.ModelRouter``) arms per-model dispatch: the
request's ``model`` field (JSON, or the ``CXB1`` frame's model) picks
the engine and feedback log of ``/predict``, ``/extract``, ``/feedback``
and ``/reloadz``; a model-less request takes the default route, an
unknown one gets 404 with reason ``unknown_model`` and the list of
models; ``/healthz`` gains ``models`` (each one's status, round, CRC,
default flag) and ``/statsz`` the model names.

Both data routes also take the binary wire (``wire.py``): a request with
``Content-Type: application/x-cxb`` carries a ``CXB1`` frame whose
payload is decoded with ``np.frombuffer`` over the request body (no
copy) and handed to the micro-batcher, and the reply streams the raw
f32 rows back as a ``CXR1`` frame: no ``tolist()``, no ``json.dumps``.
JSON requests are unchanged.  A malformed frame gets 400 with the
frame's ``reason`` token, never a 500, and error bodies stay JSON.

Errors map to JSON bodies: 400 malformed request, 404 unknown route,
429 load shed, 503 shutting down, 504 deadline expired, 500 model
failure.

``serve_forever(reload_period_s > 0)`` runs a poll thread beside the
server: every period it calls ``Engine.try_reload`` (when the engine
watches a ``model_dir``) and ``Engine.check_canary`` (under
``integrity_probe = 1``), neither of which raises, over every routed
engine.

Shutdown drains: after ``httpd.shutdown()`` stops the accept loop,
in-flight requests get up to ``drain_timeout_s`` to finish writing their
responses before ``serve_forever`` returns.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from ..obs import alerts as obs_alerts
from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from . import wire
from .batcher import ServeError
from .engine import Engine
from .router import UnknownModelError

__all__ = ["make_server", "serve_forever"]

# A full-width JSON request (128 rows of 3x224x224 floats) is ~100-200 MB
# of text; the JAX server's 64 MiB cap would refuse it.  A binary frame
# is held to wire.MAX_PAYLOAD_BYTES (64 MiB) by its own decoder.
MAX_BODY_BYTES = 512 << 20


class _InflightGauge:
    """Counts requests between accept and response-written, and lets
    shutdown wait for the count to reach zero (the drain)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self.count = 0

    def __enter__(self) -> "_InflightGauge":
        with self._lock:
            self.count += 1
        return self

    def __exit__(self, *exc) -> None:
        with self._idle:
            self.count -= 1
            if self.count == 0:
                self._idle.notify_all()

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until no request is in flight; False on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self.count > 0:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._idle.wait(timeout=remain)
        return True


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a binary reply leaves in three writes (HTTP headers,
    # CXR1 header, payload); with Nagle's algorithm the second waits for
    # the client's delayed ACK of the first, about 40 ms a reply
    disable_nagle_algorithm = True
    engine: Engine = None  # bound by make_server via subclassing
    inflight: _InflightGauge = None
    verbose = False
    feedback = None  # FeedbackWriter when the closed loop is armed
    capture_predict = False  # log /predict rows with their predictions
    router = None  # ModelRouter: per-model dispatch when set
    rid_token = "srv"
    rid_counter = None  # itertools.count, bound by make_server

    def log_message(self, fmt, *args):  # noqa: N802 - stdlib name
        if self.verbose:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _reply(self, status: int, payload: dict) -> None:
        self._reply_text(status, json.dumps(payload), "application/json")

    def _reply_text(self, status: int, text: str, ctype: str) -> None:
        body = text.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self, rid: str) -> Optional[bytes]:
        """The request body under the size bound, or reply 400 and
        return None.  A reject that leaves bytes unread closes the
        connection, so they cannot desync a kept-alive socket."""
        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
            self._reply(400, {"error": "chunked bodies are not supported",
                              "rid": rid})
            return None
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            self._reply(400, {"error": "oversized body", "rid": rid})
            return None
        if length <= 0:
            self._reply(400, {"error": "missing body", "rid": rid})
            return None
        return self.rfile.read(length)

    def _read_json(self, rid: str) -> Optional[dict]:
        """The request body as a ``{"data": ...}`` object, or reply 400
        and return None."""
        body = self._read_body(rid)
        if body is None:
            return None
        try:
            obj = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            self._reply(400, {"error": f"bad JSON: {e}", "rid": rid})
            return None
        if not isinstance(obj, dict) or "data" not in obj:
            self._reply(400, {"error": 'body must be {"data": [...]}',
                              "rid": rid})
            return None
        return obj

    def do_GET(self) -> None:  # noqa: N802 - stdlib name
        with self.inflight:
            if self.path == "/healthz":
                h = self.engine.healthz()
                if self.router is not None:
                    h["models"] = self.router.healthz_models()
                self._reply(200, h)
            elif self.path == "/statsz":
                st = self.engine.snapshot_stats()
                if self.router is not None:
                    st["models"] = self.router.models()
                self._reply(200, st)
            elif self.path == "/metricsz":
                self._reply_text(
                    200, obs_registry().render_prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/alertz":
                self._reply(200, obs_alerts.evaluator().status())
            else:
                self._reply(404, {"error": f"unknown route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 - stdlib name
        with self.inflight:
            self._do_post()

    def _do_post(self) -> None:
        rid = f"{self.rid_token}-{next(self.rid_counter)}"
        if self.path == "/reloadz":
            self._do_reload(rid)
            return
        if self.path not in ("/predict", "/extract", "/feedback"):
            self.close_connection = True
            self._reply(404, {"error": f"unknown route {self.path}",
                              "rid": rid})
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype.strip().lower() == wire.CONTENT_TYPE:
            self._do_post_wire(rid)
            return
        obj = self._read_json(rid)
        if obj is None:
            return
        routed = self._route(obj.get("model"), rid)
        if routed is None:
            return
        engine, feedback = routed
        if self.path != "/feedback":
            engine.stats.record_wire("json")
        deadline = obj.get("deadline_ms")
        try:
            if self.path == "/feedback":
                self._do_feedback(obj, rid, feedback)
            elif self.path == "/extract":
                node = obj.get("node")
                if not node:
                    self._reply(400, {"error": "extract needs a node name",
                                      "rid": rid})
                    return
                out = engine.extract(obj["data"], node, deadline_ms=deadline)
                self._reply(200, {"features": out.tolist(), "rid": rid})
            else:
                kind = "scores" if obj.get("raw") else "predict"
                out = engine.submit(obj["data"], kind=kind,
                                    deadline_ms=deadline)
                key = "scores" if kind == "scores" else "pred"
                self._reply(200, {key: np.asarray(out).tolist(), "rid": rid})
                # capture after the reply: a page commit's fsyncs must
                # never sit inside the client's latency
                if (self.capture_predict and feedback is not None
                        and kind == "predict"):
                    self._capture(obj["data"], out, feedback)
        except ServeError as e:
            self._reply(e.http_status, {"error": str(e), "rid": rid})
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e), "rid": rid})
        except Exception as e:  # noqa: BLE001 - served as a 500
            self._reply(500, {"error": f"{type(e).__name__}: {e}",
                              "rid": rid})

    def _route(self, model, rid: str):
        """``(engine, feedback)`` for a request's ``model`` field: the
        router's route when one is armed, else this server's; None after
        replying 404 ``unknown_model``."""
        if self.router is None:
            return self.engine, self.feedback
        try:
            _name, engine, feedback = self.router.resolve(model)
        except UnknownModelError as e:
            self._reply(404, {"error": str(e), "reason": e.reason,
                              "models": e.known, "rid": rid})
            return None
        return engine, feedback

    def _do_reload(self, rid: str) -> None:
        """``POST /reloadz``: one breaker-gated reload attempt.  A body
        is optional, but whatever is sent is read first, so its bytes
        cannot desync the next request on a kept-alive connection."""
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            length = 0
        if self.headers.get("Transfer-Encoding") or length > MAX_BODY_BYTES:
            # cannot drain it: close so the unread bytes go with the socket
            self.close_connection = True
            self._reply(400, {"error": "chunked or oversized body",
                              "rid": rid})
            return
        body = self.rfile.read(length) if length > 0 else b""
        engine = self.engine
        if self.router is not None and body:
            # {"model": <name>} picks the tenant whose engine reloads
            try:
                req = json.loads(body.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                req = {}
            if isinstance(req, dict) and req.get("model"):
                routed = self._route(req["model"], rid)
                if routed is None:
                    return
                engine = routed[0]
        swapped = engine.try_reload()
        self._reply(200, {
            "ok": engine.stats.last_reload_ok is not False,
            "swapped": bool(swapped),
            "round": engine.round,
            "breaker": engine.reload_breaker.state,
            "rid": rid,
        })

    def _do_post_wire(self, rid: str) -> None:
        """The ``application/x-cxb`` data plane: decode the frame with
        ``np.frombuffer`` over the request body (the batcher's staging
        copy is the first copy), stream the raw f32 rows back."""
        # drain the body before any reject: unread bytes would desync
        # the next request on this kept-alive socket
        body = self._read_body(rid)
        if body is None:
            return
        self.engine.stats.record_wire("binary", len(body))
        if self.path == "/feedback":
            self._reply(400, {
                "error": "binary wire covers /predict and /extract; "
                         "/feedback stays JSON",
                "reason": "wire_unsupported_route", "rid": rid})
            return
        try:
            req = wire.decode_request(body)
        except wire.WireError as e:
            self._reply(400, {"error": str(e), "reason": e.reason,
                              "rid": rid})
            return
        routed = self._route(req.model or None, rid)
        if routed is None:
            return
        engine, feedback = routed
        if engine.wire != "binary":
            self._reply(400, {
                "error": "binary wire is disabled (wire = json)",
                "reason": "wire_disabled", "rid": rid})
            return
        try:
            if self.path == "/extract":
                if req.kind != "extract" or not req.node:
                    self._reply(400, {
                        "error": "extract frames need kind=extract and "
                                 "a node name", "reason": "bad_kind",
                        "rid": rid})
                    return
                kind = "extract"
                out = engine.extract(req.data, req.node,
                                     deadline_ms=req.deadline_ms)
            else:
                if req.kind not in ("predict", "scores"):
                    self._reply(400, {
                        "error": f"/predict frames carry kind predict "
                                 f"or scores, not {req.kind}",
                        "reason": "bad_kind", "rid": rid})
                    return
                kind = req.kind
                out = engine.submit(req.data, kind=kind,
                                    deadline_ms=req.deadline_ms)
            head, payload = wire.encode_response_header(
                np.asarray(out), kind, rid)
            self.send_response(200)
            self.send_header("Content-Type", wire.CONTENT_TYPE)
            self.send_header("Content-Length",
                             str(len(head) + payload.nbytes))
            self.end_headers()
            # the header, then the array's own buffer: the rows leave
            # the process without a tolist() or a joined-body copy
            self.wfile.write(head)
            self.wfile.write(memoryview(payload).cast("B"))
            engine.stats.record_wire_out(len(head) + payload.nbytes)
            if (self.capture_predict and feedback is not None
                    and kind == "predict"):
                self._capture(req.data, out, feedback)
        except ServeError as e:
            self._reply(e.http_status, {"error": str(e), "rid": rid})
        except (ValueError, TypeError) as e:
            self._reply(400, {"error": str(e), "rid": rid})
        except Exception as e:  # noqa: BLE001 - served as a 500
            self._reply(500, {"error": f"{type(e).__name__}: {e}",
                              "rid": rid})


    @staticmethod
    def _feedback_arrays(obj: dict):
        """A feedback body as ``(data (N, ...), label (N, L))``."""
        data = np.ascontiguousarray(obj["data"], np.float32)
        if data.ndim == 1:
            data = data[None, :]
        if "label" not in obj:
            raise ValueError('feedback needs {"data": ..., "label": ...}')
        label = np.atleast_1d(np.ascontiguousarray(obj["label"], np.float32))
        if label.ndim == 1:
            label = label[:, None]
        if label.shape[0] != data.shape[0]:
            raise ValueError(f"feedback: {data.shape[0]} data rows vs "
                             f"{label.shape[0]} labels")
        return data, label

    def _do_feedback(self, obj: dict, rid: str, feedback) -> None:
        if feedback is None:
            self._reply(404, {
                "error": "no feedback log armed (run task=serve_train "
                         "or task=loop_fleet)",
                "rid": rid})
            return
        data, label = self._feedback_arrays(obj)
        n, first, last = feedback.append_batch_ids(data, label)
        self._reply(200, {"appended": n, "dropped": data.shape[0] - n,
                          "seq": [first, last] if first is not None else None,
                          "rid": rid})

    @staticmethod
    def _capture(data, preds, feedback) -> None:
        """``capture_predict``: a request's rows with the model's
        predictions as labels, into the feedback log.  Never fails the
        request; the log's drop-and-count rule applies."""
        try:
            arr = np.ascontiguousarray(data, np.float32)
            if arr.ndim == 1:
                arr = arr[None, :]
            feedback.append_batch(
                arr, np.asarray(preds, np.float32).reshape(arr.shape[0], -1))
        except Exception as e:  # noqa: BLE001 - capture is best-effort
            obs_events.log_exception_once("serve.capture", e,
                                          kind="loop.append_error",
                                          capture=True)


class _ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128  # the stdlib backlog of 5 refuses bursts


def make_server(engine: Engine, host: str = "127.0.0.1", port: int = 0,
                verbose: bool = False, feedback=None,
                capture_predict: bool = False,
                router=None) -> ThreadingHTTPServer:
    """Bind (but do not run) the HTTP server; ``port=0`` picks an
    ephemeral port — read it back from ``server.server_port``.  The
    in-flight gauge hangs off the server as ``httpd.inflight``.
    ``feedback`` (a ``loop.FeedbackWriter``) arms ``/feedback``;
    ``capture_predict`` also logs every answered ``/predict``;
    ``router`` (a :class:`~.router.ModelRouter`) arms per-model
    dispatch, with ``engine`` the identity and default route."""
    gauge = _InflightGauge()
    handler = type("BoundHandler", (_Handler,), {
        "engine": engine, "verbose": verbose, "inflight": gauge,
        "feedback": feedback, "capture_predict": capture_predict,
        "router": router,
        "rid_token": os.urandom(3).hex(),
        "rid_counter": itertools.count(1),
    })
    httpd = _ServeHTTPServer((host, port), handler)
    httpd.inflight = gauge
    return httpd


def serve_forever(engine: Engine, host: str = "127.0.0.1", port: int = 0,
                  reload_period_s: float = 0.0, drain_timeout_s: float = 5.0,
                  verbose: bool = False, ready_fn=None, feedback=None,
                  capture_predict: bool = False, router=None
                  ) -> Tuple[ThreadingHTTPServer, Optional[threading.Thread]]:
    """Run the server until ``httpd.shutdown()`` (blocking), then drain.

    ``reload_period_s > 0`` starts a poll thread that calls
    ``engine.try_reload()`` (hot reload behind the breaker, when the
    engine watches a ``model_dir``) and ``engine.check_canary()`` (when
    ``integrity_probe`` is on) once a period; it stops with the server.
    ``ready_fn(httpd)`` is called once the socket is bound.  The poll
    covers every routed engine under a ``router``.  ``feedback``,
    ``capture_predict`` and ``router`` go to :func:`make_server`.
    Returns ``(httpd, reloader)``, the poll thread or None."""
    httpd = make_server(engine, host, port, verbose=verbose,
                        feedback=feedback, capture_predict=capture_predict,
                        router=router)
    stop = threading.Event()
    reloader = None
    engines = router.engines() if router is not None else [engine]
    polled = [e for e in engines if e.model_dir is not None]
    probed = [e for e in engines if e.integrity_probe]
    if reload_period_s > 0 and (polled or probed):
        def _poll():
            while not stop.wait(reload_period_s):
                for e in polled:
                    e.try_reload()  # breaker-gated; never raises
                for e in probed:
                    e.check_canary()  # latches /healthz; never raises

        reloader = threading.Thread(target=_poll, name="cxxnet-serve-reload",
                                    daemon=True)
        reloader.start()
    if ready_fn is not None:
        ready_fn(httpd)
    try:
        httpd.serve_forever(poll_interval=0.2)
    finally:
        stop.set()
        if reloader is not None:
            # a reload in progress finishes before the engine closes
            reloader.join()
        if drain_timeout_s > 0 and not httpd.inflight.wait_idle(
                drain_timeout_s):
            print(f"serve: drain timed out after {drain_timeout_s:g}s with "
                  f"{httpd.inflight.count} request(s) still in flight",
                  flush=True)
        httpd.server_close()
    return httpd, reloader
