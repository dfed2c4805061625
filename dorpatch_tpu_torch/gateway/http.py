"""The gateway's own stdlib HTTP surface (mirrors `serve/http.py`).

Endpoints:

- `POST /predict` — the fleet ingress. The body is relayed verbatim to
  the chosen backend; the response comes back with the backend's own
  status mapping plus a `gateway` attribution block (which backend
  answered, how many re-dispatches). The request's trace id (caller's
  `X-Trace-Id` header, `trace_id` body field, or minted here) is
  forwarded to the backend in `X-Trace-Id`, so one id correlates the
  client's log line, the gateway's admit/terminal events, and the
  backend's serve telemetry — `observe.report --fleet` joins on it.
- `GET /healthz` — gateway liveness + fleet routability.
- `GET /stats`   — fleet roster snapshot (per-backend membership state,
  load signals, weights) + the gateway's own counters.
- `GET /metrics` — Prometheus text exposition of the gateway registry.

One handler thread per connection (`ThreadingHTTPServer`), all funneling
into `Gateway.handle_predict` — admission control is the router's typed
`FleetOverloaded`, not socket backlog.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dorpatch_tpu_torch import observe


class _Handler(BaseHTTPRequestHandler):
    # set per-server via the factory in GatewayFrontend
    gateway = None

    def _send_json(self, code: int, payload: dict, headers=()) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        if self.path == "/healthz":
            h = self.gateway.healthz()
            self._send_json(200 if h["status"] == "ok" else 503, h)
        elif self.path == "/stats":
            self._send_json(200, self.gateway.stats())
        elif self.path == "/metrics":
            self._send_text(200, self.gateway.metrics.render_text())
        else:
            self._send_json(404, {"status": "error",
                                  "reason": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        if self.path != "/predict":
            self._send_json(404, {"status": "error",
                                  "reason": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length) or b"{}"
            payload = json.loads(raw)
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, TypeError) as e:
            self._send_json(400, {"status": "error",
                                  "reason": f"bad request body: {e!r}"})
            return
        # same trace-id precedence as the serve front-end: header wins
        # over body field; minted here only when the caller sent neither
        trace_id = str(self.headers.get("X-Trace-Id", "")
                       or payload.get("trace_id", "")
                       or observe.new_trace_id())
        result = self.gateway.handle_predict(raw, trace_id)
        body = dict(result.payload)
        body["trace_id"] = trace_id
        self._send_json(result.code, body,
                        headers=(("X-Trace-Id", trace_id),))

    def log_message(self, fmt: str, *args) -> None:
        # route through observe (rule DP101: no bare prints); request-level
        # telemetry already lands in the gateway's events.jsonl
        pass


class GatewayFrontend:
    """Owns the listening socket + serve_forever thread; `port` reports
    the bound port (pass 0 to bind an ephemeral one for tests)."""

    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"gateway": gateway})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "GatewayFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="gateway-http", daemon=True)
        self._thread.start()
        observe.log(f"gateway: http front-end on {self.host}:{self.port} "
                    f"(/predict /healthz /stats /metrics)")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "GatewayFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
