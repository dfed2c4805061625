"""Thin HTTP front-end on stdlib `http.server` (JSON in/out).

Port of `dorpatch_tpu.serve.http`, the same routes, status codes and JSON.

Endpoints:

- `POST /predict` — body `{"image": [[[...]]], "deadline_ms": 250}` (HWC
  float nested lists in [0, 1]; `deadline_ms` optional). Answers the typed
  response as JSON with the status-code mapping in `types.HTTP_STATUS`
  (200 ok / 503 overloaded / 504 deadline_exceeded / 400 error). A caller
  may pin the request's correlation id via the `X-Trace-Id` header (or a
  `trace_id` body field); otherwise one is minted here at ingress. Either
  way the id comes back in the JSON payload and the `X-Trace-Id` response
  header, and every telemetry record the request touches carries it.
- `GET /healthz` — liveness + warmup state.
- `GET /stats`   — the service's live counters, latency percentiles,
  queue depth, and per-program trace counts.
- `GET /metrics` — Prometheus text exposition of the service's metric
  registry (the same registry `/stats` summarizes — one source of truth).
- `GET /robustness` — the recert verdict snapshot loaded at boot
  (`service.robustness()`): 200 only when its status is "ok", 503 on a
  failing, stale, absent or unconfigured verdict.
- `POST /profile` — on-demand bounded `torch.profiler` capture into
  `<result_dir>/profile` (body `{"duration_ms": 500}` optional); 200 with
  the trace dir on success, 409 while another capture is in flight, 400
  when the service has no results dir to write into. Serving keeps
  answering throughout.

One handler thread per connection (`ThreadingHTTPServer`); every thread
funnels into the same `service.predict`, so the micro-batcher — not the
socket layer — decides batching and backpressure. Tests and the load
generator can skip sockets entirely and call `service.predict` directly.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.serve.types import HTTP_STATUS


class _Handler(BaseHTTPRequestHandler):
    # set per-server via the factory in HttpFrontend
    service = None

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

    def _stopping(self) -> bool:
        """True during the service's stop() drain window: snapshot paths
        race replica teardown there (the pool reference can go away mid-
        handler), so observability endpoints answer a typed 503 instead of
        a 500 — or a connection left hanging on a torn snapshot."""
        stopping = getattr(self.service, "stopping", None)
        return bool(stopping()) if callable(stopping) else False

    @staticmethod
    def _stopping_body() -> dict:
        return {"status": "stopping",
                "reason": "service is draining (stop() in progress)"}

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        if self.path == "/healthz":
            if self._stopping():
                # the drain window answers a typed 503 here too: a fleet
                # gateway's health probe must see a clean "stopping" signal
                # (and start draining the backend) instead of racing the
                # pool teardown into a torn snapshot
                self._send_json(503, self._stopping_body())
            else:
                h = self.service.healthz()
                self._send_json(200 if h["status"] == "ok" else 503, h)
        elif self.path == "/stats":
            if self._stopping():
                self._send_json(503, self._stopping_body())
            else:
                self._send_json(200, self.service.stats())
        elif self.path == "/metrics":
            if self._stopping():
                # typed refusal for the scrape too: Prometheus records the
                # 503 as a failed scrape instead of a half-torn exposition
                self._send_text(503, "# service stopping (drain window)\n")
            else:
                self._send_text(200, self.service.metrics.render_text())
        elif self.path == "/robustness":
            r = self.service.robustness()
            # canary-probe contract: 200 only on a clean verdict, 503 on
            # failing/stale/absent/unconfigured — a deploy gate can treat
            # this exactly like /healthz
            self._send_json(200 if r.get("status") == "ok" else 503, r)
        else:
            self._send_json(404, {"status": "error",
                                  "reason": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        if self.path == "/profile":
            self._do_profile()
            return
        if self.path != "/predict":
            self._send_json(404, {"status": "error",
                                  "reason": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            image = payload["image"]
            deadline_ms = payload.get("deadline_ms")
            if deadline_ms is not None \
                    and not isinstance(deadline_ms, (int, float)):
                raise ValueError("deadline_ms must be a number")
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"status": "error",
                                  "reason": f"bad request body: {e!r}"})
            return
        # correlation id: caller-pinned (header wins over body field) or
        # minted HERE — ingress is where a trace id is born, so a socket
        # client can join its own logs against the server's telemetry
        trace_id = str(self.headers.get("X-Trace-Id", "")
                       or payload.get("trace_id", "")
                       or observe.new_trace_id())
        resp = self.service.predict(image, deadline_ms=deadline_ms,
                                    trace_id=trace_id)
        body = resp.to_dict()
        body["trace_id"] = trace_id
        self._send_json(HTTP_STATUS.get(resp.status, 500), body,
                        headers=(("X-Trace-Id", trace_id),))

    def _do_profile(self) -> None:
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            duration_ms = float(payload.get("duration_ms", 500.0)) \
                if isinstance(payload, dict) else 500.0
        except (ValueError, TypeError) as e:
            self._send_json(400, {"status": "error",
                                  "reason": f"bad request body: {e!r}"})
            return
        if not getattr(self.service, "result_dir", None):
            self._send_json(400, {
                "status": "error",
                "reason": "service has no results dir to capture into"})
            return
        trace_dir = self.service.capture_profile(duration_ms=duration_ms)
        if trace_dir is None:
            # the profiler is a process-global toggle: one at a time
            self._send_json(409, {"status": "busy",
                                  "reason": "a capture is already running"})
            return
        self._send_json(200, {"status": "ok", "dir": trace_dir,
                              "duration_ms": duration_ms})

    def log_message(self, fmt: str, *args) -> None:
        # request-level telemetry already lands in events.jsonl, so keep
        # the per-request access log quiet
        pass


class HttpFrontend:
    """Owns the listening socket + serve_forever thread; `port` reports the
    bound port (pass 0 to bind an ephemeral one for tests)."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"service": service})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HttpFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        observe.log(f"serve: http front-end on {self.host}:{self.port} "
                    f"(/predict /profile /healthz /stats /metrics "
                    f"/robustness)")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "HttpFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
