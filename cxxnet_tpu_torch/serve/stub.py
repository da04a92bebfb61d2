#!/usr/bin/env python
"""Lightweight replica stand-in for serving-fleet tests.

The port's copy of ``cxxnet_tpu/serve/stub.py``: the same routes, the
same switches and, for the same request, the same answer bytes.  A
real fleet replica is a full ``task=serve`` CLI process (a PyTorch
import, the kernels' load, a checkpoint load and a warm-up forward); the
supervision, routing and canary logic in ``serve/fleet.py`` and
``serve/router.py`` does not care what is behind the replica's HTTP
surface, so the fast tests drive it against this stub: a
**stdlib-only** script (no package import, no numpy, no torch) that
answers the endpoints the fleet speaks to a real replica, starts in
~100 ms, and can be told to misbehave in the ways the supervisor must
survive:

* ``--delay-ms`` — every ``/predict`` takes this long (saturation and
  deadline tests); a request whose forwarded ``deadline_ms`` budget is
  smaller than the delay gets the honest 504.
* ``--disagree`` — predictions are offset by this value (a degraded
  canary for the rollback path; 0 = agrees with every other stub on the
  same input).
* ``POST /wedge`` (or ``--wedge``) — every later request blocks
  forever: the wedged replica the supervisor must eject within the
  probe deadline.
* ``--round-file`` — ``POST /reloadz`` re-reads the round from this
  file (the rolling-reload rendezvous without a real checkpoint).
* ``--quant`` — the precision scheme ``/healthz`` reports.
* ``POST /integrity`` — ``{"failed": true|false}`` toggles the golden-
  canary failure latch: ``/healthz`` degrades with the
  ``integrity_failed`` reason token (the supervisor quarantines the
  replica — ejected, not killed — and readmits it once cleared).

Predictions are a pure function of the input row (sum of the row,
scaled, mod 7, plus the disagree offset) so two healthy stubs always
agree and a ``--disagree`` stub never does.

``/predict`` also speaks the binary wire (``Content-Type:
application/x-cxb``) through a stdlib mirror of ``serve/wire.py``
(``struct`` + ``array``, still no numpy), so the router's relay,
failover and canary paths see binary frames without a real replica.

Run directly (NOT ``-m``): ``python cxxnet_tpu_torch/serve/stub.py --port N``.
"""

import argparse
import json
import struct
import sys
import threading
import time
from array import array
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# CXB1 / CXR1 header layouts (keep in lock-step with serve/wire.py)
_REQ = struct.Struct("<4sBBBBIHH")
_RESP = struct.Struct("<4sBBBBHH")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--round", type=int, default=1)
    ap.add_argument("--round-file", default="",
                    help="/reloadz re-reads the served round from here")
    ap.add_argument("--model", default="stub.model",
                    help="model path reported by /healthz")
    ap.add_argument("--quant", default="f32",
                    help="precision scheme reported by /healthz")
    ap.add_argument("--delay-ms", type=float, default=0.0)
    ap.add_argument("--disagree", type=int, default=0,
                    help="prediction offset (0 = agree with other stubs)")
    ap.add_argument("--wedge", action="store_true",
                    help="start wedged (every request blocks forever)")
    args = ap.parse_args()

    lock = threading.Lock()
    state = {
        "round": args.round,
        "wedged": bool(args.wedge),
        "integrity_failed": False,
        "requests": 0,
        "predicts": 0,
        "reloads": 0,
    }

    def read_round_file():
        if args.round_file:
            try:
                with open(args.round_file, "r", encoding="utf-8") as f:
                    return int(f.read().strip())
            except (OSError, ValueError):
                pass
        return None

    init = read_round_file()
    if init is not None:
        state["round"] = init

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # noqa: N802 - stdlib name
            pass

        def _reply(self, status, obj):
            body = json.dumps(obj).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _enter(self):
            with lock:
                state["requests"] += 1
                wedged = state["wedged"]
            if wedged:
                time.sleep(3600.0)

        def do_GET(self):  # noqa: N802 - stdlib name
            self._enter()
            if self.path == "/healthz":
                with lock:
                    reasons = (["integrity_failed"]
                               if state["integrity_failed"] else [])
                    self._reply(200, {
                        "status": "degraded" if reasons else "ok",
                        "round": state["round"],
                        "model": args.model,
                        "model_crc32": 0,
                        "net_fp": "stub",
                        "quant": args.quant,
                        "reload_breaker": "closed",
                        "reasons": reasons,
                    })
            elif self.path == "/statsz":
                with lock:
                    self._reply(200, dict(state))
            else:
                self._reply(404, {"error": f"unknown route {self.path}"})

        def _predict_wire(self, raw):
            """Binary /predict: parse a CXB1 frame, answer a CXR1
            frame with the same sum-mod-7 prediction as JSON."""
            if len(raw) < _REQ.size:
                self._reply(400, {"error": "short frame",
                                  "reason": "truncated_frame"})
                return
            magic, kind, dtype, ndim, _prio, deadline, mlen, nlen = \
                _REQ.unpack_from(raw, 0)
            if magic != b"CXB1":
                self._reply(400, {"error": "bad frame magic",
                                  "reason": "bad_magic"})
                return
            if dtype != 1 or not 1 <= ndim <= 8:
                self._reply(400, {"error": "unsupported frame encoding",
                                  "reason": "bad_dtype"})
                return
            dims = struct.unpack_from("<%dI" % ndim, raw, _REQ.size)
            ofs = _REQ.size + 4 * ndim + mlen + nlen
            count = 1
            for d in dims:
                count *= d
            if len(raw) != ofs + 4 * count:
                self._reply(400, {"error": "payload length mismatch",
                                  "reason": "truncated_body"})
                return
            deadline_ms = float(deadline) if deadline else None
            if args.delay_ms > 0:
                time.sleep(args.delay_ms / 1e3)
            if (deadline_ms is not None
                    and args.delay_ms >= deadline_ms):
                self._reply(504, {"error": "deadline expired"})
                return
            vals = array("f")
            vals.frombytes(raw[ofs:])
            if sys.byteorder == "big":
                vals.byteswap()
            rows = dims[0]
            per = count // rows if rows else 0
            pred = array("f", (
                float((int(round(sum(vals[i * per:(i + 1) * per])
                                 * 1e3)) % 7) + args.disagree)
                for i in range(rows)))
            if sys.byteorder == "big":
                pred.byteswap()
            with lock:
                state["predicts"] += 1
            rid = b"stub"
            head = _RESP.pack(b"CXR1", kind, 1, 1, 0, len(rid), 0)
            head += struct.pack("<I", rows) + rid
            body = head + pred.tobytes()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-cxb")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 - stdlib name
            self._enter()
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = 0
            raw = self.rfile.read(n) if n > 0 else b""
            ctype = (self.headers.get("Content-Type") or "") \
                .split(";")[0].strip().lower()
            if ctype == "application/x-cxb":
                if self.path != "/predict":
                    self._reply(400, {
                        "error": "binary frames only on /predict",
                        "reason": "wire_unsupported_route"})
                    return
                self._predict_wire(raw)
                return
            try:
                obj = json.loads(raw or b"{}")
            except ValueError:
                obj = {}
            if self.path == "/wedge":
                with lock:
                    state["wedged"] = True
                self._reply(200, {"ok": True})
            elif self.path == "/integrity":
                # fleet tests: toggle the golden-canary failure latch —
                # /healthz then degrades (or clears) integrity_failed,
                # the eject-without-kill + readmit path
                with lock:
                    state["integrity_failed"] = bool(
                        obj.get("failed", True))
                self._reply(200, {"ok": True,
                                  "failed": state["integrity_failed"]})
            elif self.path == "/reloadz":
                new = read_round_file()
                with lock:
                    old = state["round"]
                    if new is not None:
                        state["round"] = new
                    state["reloads"] += 1
                    cur = state["round"]
                self._reply(200, {"ok": True, "swapped": cur != old,
                                  "round": cur, "breaker": "closed"})
            elif self.path == "/predict":
                deadline = obj.get("deadline_ms")
                if args.delay_ms > 0:
                    time.sleep(args.delay_ms / 1e3)
                if (deadline is not None
                        and args.delay_ms >= float(deadline)):
                    self._reply(504, {"error": "deadline expired"})
                    return
                data = obj.get("data") or []
                if data and not isinstance(data[0], list):
                    data = [data]
                pred = [
                    (int(round(sum(float(v) for v in row) * 1e3)) % 7)
                    + args.disagree
                    for row in data
                ]
                with lock:
                    state["predicts"] += 1
                    rnd = state["round"]
                self._reply(200, {"pred": pred, "rid": "stub",
                                  "deadline_ms": deadline, "round": rnd})
            else:
                self._reply(404, {"error": f"unknown route {self.path}"})

    class _StubHTTPServer(ThreadingHTTPServer):
        daemon_threads = True
        request_queue_size = 128

    httpd = _StubHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"STUB READY {httpd.server_port}", flush=True)
    try:
        httpd.serve_forever(poll_interval=0.5)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
