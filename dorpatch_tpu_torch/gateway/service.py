"""The gateway itself: membership + router + telemetry in one object.

`Gateway` owns the fleet roster (`BackendRegistry` + prober thread), the
power-of-two router, its OWN metric registry and event log (a gateway is
a separate process with its own books — the fleet report joins them with
each backend's), and the signal-only autoscaler. It is deliberately
torch-free: routing certified-inference traffic needs sockets and JSON,
not the card, so the gateway process never pays a torch import or a
CUDA initialization.

Exactly-once accounting contract (what `observe.report --fleet` checks):

- every admitted request writes `gateway.admit` (opens_trace) at ingress
  and exactly one terminal `gateway.request` event — the terminal event
  closes the trace even when the answering backend was SIGKILLed before
  writing its own terminal record;
- `gateway_requests_total{status}` must equal the client's view exactly,
  and `gateway_backend_responses_total{backend, status}` must equal the
  sum of the backends' own `serve_requests_total` books (the killed
  backend's in-flight batch is counted NOWHERE — chaos `kill_backend`
  flushes committed counters before the SIGKILL and the router retries
  the unresolved requests on a survivor).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Optional

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.gateway.autoscale import Autoscaler
from dorpatch_tpu_torch.gateway.membership import (ROUTABLE_STATES, STATES,
                                             Backend, BackendRegistry)
from dorpatch_tpu_torch.gateway.router import Router


class Gateway:
    def __init__(self, cfg, result_dir: str = "", run_id: str = ""):
        self.cfg = cfg
        self.result_dir = result_dir
        self.run_id = run_id
        self.chaos = None
        if getattr(cfg, "chaos", ""):
            from dorpatch_tpu_torch.chaos import Chaos, parse_faults
            state_dir = result_dir or tempfile.mkdtemp(
                prefix="dorpatch_gateway_chaos_")
            self.chaos = Chaos(parse_faults(cfg.chaos), job_id="gateway",
                               state_dir=state_dir, crash_mode="raise")
        self.metrics = observe.MetricRegistry()
        self._requests = self.metrics.counter(
            "gateway_requests_total",
            help="gateway-answered requests by terminal status")
        self._backend_responses = self.metrics.counter(
            "gateway_backend_responses_total",
            help="backend-resolved responses by backend and status — must "
                 "reconcile with each backend's serve_requests_total")
        self._retries = self.metrics.counter(
            "gateway_retries_total",
            help="connection-failure re-dispatches onto a next backend")
        self._rollbacks = self.metrics.counter(
            "gateway_rollbacks_total",
            help="rolling deploys rolled back by the canary gate")
        self._transitions = self.metrics.counter(
            "gateway_membership_transitions_total",
            help="membership state changes by backend/prev/state")
        self._latency = self.metrics.histogram(
            "gateway_request_latency_seconds",
            help="gateway-side request latency (ingress to relay)")
        self._backends_gauge = self.metrics.gauge(
            "gateway_backends", help="fleet size by membership state")
        # the gateway's own sink, NOT observe's process-global active log:
        # a smoke (or test) may run an in-process serve service whose
        # telemetry must not interleave with the gateway's books
        self._elog = observe.EventLog(
            os.path.join(result_dir, "events.jsonl") if result_dir else None,
            run_id=run_id)
        backends = [Backend(url) for url in cfg.backends]
        self.registry = BackendRegistry(
            backends, cfg, chaos=self.chaos,
            on_transition=self._on_transition, on_cycle=self._on_cycle)
        self.router = Router(self.registry, cfg)
        self.autoscaler = Autoscaler(cfg, self.metrics, self._elog.event)
        self._started_mono: Optional[float] = None

    # ---------------- lifecycle ----------------

    def start(self) -> "Gateway":
        if self.result_dir:
            observe.write_run_manifest(
                self.result_dir, cfg=None, run_id=self.run_id,
                extra={"kind": "gateway",
                       "backends": [b.snapshot()["url"]
                                    for b in self.registry.backends()]})
        self._started_mono = time.monotonic()
        self._elog.event(
            "gateway.started",
            backends=[b.name for b in self.registry.backends()],
            probe_interval_s=float(self.cfg.probe_interval_s),
            fail_threshold=int(self.cfg.fail_threshold),
            ok_threshold=int(self.cfg.ok_threshold),
            inflight_cap=int(self.cfg.inflight_cap))
        self.registry.start()
        return self

    def stop(self) -> None:
        self.registry.stop()
        self._elog.event("gateway.stopped", **self._fleet_counts())
        if self.result_dir:
            self.metrics.dump(os.path.join(self.result_dir, "metrics.json"))
        self._elog.close()

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------- roster administration (deploy API) ----------------

    def add_backend(self, url: str, weight: float = 0.0) -> Backend:
        """Register a canary backend. Default weight 0: it joins, warms,
        and becomes healthy WITHOUT taking traffic — the rolling deploy
        owns the traffic split."""
        return self.registry.add(Backend(url, weight=weight))

    def record_rollback(self, reason: str, canaries: List[str],
                        step: float, findings: List[str]) -> None:
        """The deploy's one typed rollback record (event + counter)."""
        self._rollbacks.inc()
        self._elog.event("gateway.rollback", reason=reason,
                         canaries=list(canaries), step=float(step),
                         findings=list(findings))

    def emit(self, name: str, **attrs) -> None:
        self._elog.event(name, **attrs)

    # ---------------- request path ----------------

    def handle_predict(self, body: bytes, trace_id: str):
        """Route one POST /predict body; returns the RouteResult whose
        payload already carries the gateway attribution block."""
        t0 = time.monotonic()
        self._elog.event("gateway.admit", trace=trace_id, opens_trace=True)
        result = self.router.route(body, trace_id)
        latency_s = time.monotonic() - t0
        status = str(result.payload.get("status", "internal_error"))
        self._requests.inc(status=status)
        if result.backend:
            self._backend_responses.inc(backend=result.backend,
                                        status=status)
        if result.retries:
            self._retries.inc(result.retries)
        self._latency.observe(latency_s)
        # terminal event CLOSES the trace — even when the backend died
        # mid-request and never wrote its own terminal record
        self._elog.event("gateway.request", trace=trace_id, status=status,
                         backend=result.backend, retries=result.retries,
                         latency_s=round(latency_s, 6))
        result.payload.setdefault("gateway", {})
        result.payload["gateway"].update(
            {"backend": result.backend, "retries": result.retries,
             "attempted": list(result.attempted)})
        return result

    # ---------------- membership/autoscale hooks ----------------

    def _on_transition(self, name: str, prev: str, new: str,
                       reason: str) -> None:
        self._transitions.inc(backend=name, prev=prev or "none", state=new)
        self._elog.event("gateway.membership", backend=name,
                         prev=prev or "none", state=new, reason=reason)

    def _on_cycle(self, snapshots: List[dict]) -> None:
        counts = {s: 0 for s in STATES}
        for snap in snapshots:
            counts[snap["state"]] = counts.get(snap["state"], 0) + 1
        for state, n in counts.items():
            self._backends_gauge.set(float(n), state=state)
        routable = [s for s in snapshots
                    if s["state"] in ROUTABLE_STATES and s["weight"] > 0.0]
        if routable:
            occ = sum(s["occupancy"] for s in routable) / len(routable)
            rej = sum(s["reject_rate"] for s in routable) / len(routable)
        else:
            occ, rej = 1.0, 1.0  # an empty fleet is a saturated fleet
        self.autoscaler.observe(occ, rej, len(routable))

    # ---------------- observability surfaces ----------------

    def _fleet_counts(self) -> dict:
        counts = {s: 0 for s in STATES}
        for b in self.registry.backends():
            counts[b.snapshot()["state"]] += 1
        return counts

    def healthz(self) -> dict:
        counts = self._fleet_counts()
        routable = counts["healthy"] + counts["degraded"]
        return {"status": "ok" if routable > 0 else "unhealthy",
                "role": "gateway", "routable": routable, "fleet": counts}

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        uptime = (time.monotonic() - self._started_mono
                  if self._started_mono is not None else 0.0)
        return {
            "role": "gateway",
            "uptime_s": round(uptime, 3),
            "backends": [b.snapshot() for b in self.registry.backends()],
            "requests": {
                k: int(v) for k, v in observe.labeled_values(
                    snap, "gateway_requests_total", "status").items()},
            "retries": int(self.metrics.value("gateway_retries_total")),
            "rollbacks": int(self.metrics.value("gateway_rollbacks_total")),
            "autoscale_recommendation": self.metrics.value(
                "gateway_autoscale_recommendation"),
        }

    def describe(self) -> str:
        return json.dumps(self.stats(), indent=2, sort_keys=True)
