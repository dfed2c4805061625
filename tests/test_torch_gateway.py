"""The port's fleet gateway (`dorpatch_tpu_torch.gateway`): the contracts
of the JAX package's `tests/test_gateway.py` over stub HTTP backends
(membership hysteresis, exactly-once routing, the typed fleet 503, canary
deploys and rollbacks, chaos, autoscale signals, the HTTP surface), and
held against the JAX gateway: the same router picks and prober jitter
under the same seeds on the same roster and load, the same membership
transitions on the same scripted probes, the same autoscale signals and
chaos ordinals. `python -m dorpatch_tpu_torch.gateway` boots in a
subprocess and loads no torch."""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import dorpatch_tpu.gateway as jax_gateway
from dorpatch_tpu import chaos as jax_chaos
from dorpatch_tpu import config as jax_config
from dorpatch_tpu import observe as jax_observe
from dorpatch_tpu.gateway import autoscale as jax_autoscale
from dorpatch_tpu_torch import chaos as port_chaos
from dorpatch_tpu_torch import config as port_config
from dorpatch_tpu_torch import gateway as port_gateway
from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.config import ExperimentConfig, GatewayConfig
from dorpatch_tpu_torch.gateway import (Backend, BackendRegistry, Gateway,
                                        GatewayFrontend, RollingDeploy,
                                        Router)
from dorpatch_tpu_torch.gateway import autoscale as port_autoscale
from dorpatch_tpu_torch.gateway.membership import (DEGRADED, DRAINING,
                                                   EJECTED, HEALTHY, JOINING)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OK_VERDICT = {"status": "ok", "generation": 1, "worst_margin": 0.2,
              "findings_by_rule": {}, "cells": {}}
DP400_VERDICT = {"status": "failed", "generation": 2, "worst_margin": -0.5,
                 "findings_by_rule": {"DP400": ["planted regression"]},
                 "cells": {}}

PACKAGES = {"torch": (port_gateway, port_config, port_autoscale,
                      port_chaos, observe),
            "jax": (jax_gateway, jax_config, jax_autoscale, jax_chaos,
                    jax_observe)}


def _knobs(**kw):
    """Test-speed gateway knobs: the prober interval is long, so started
    gateways probe once at boot and tests step membership themselves."""
    base = dict(probe_interval_s=60.0, probe_timeout_s=2.0,
                fail_threshold=3, ok_threshold=2, inflight_cap=4,
                dispatch_retries=1, dispatch_timeout_s=5.0,
                canary_steps=(1.0,), canary_hold_s=0.0,
                autoscale_cooldown_s=1e9)
    base.update(kw)
    return base


def _cfg(pkg="torch", **kw):
    return PACKAGES[pkg][1].GatewayConfig(**_knobs(**kw))


class _StubServe:
    """A scriptable stand-in for one `python -m dorpatch_tpu_torch.serve`:
    /healthz /stats /robustness /predict with mutable behavior and exact
    served counters."""

    def __init__(self):
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    code = stub.healthz_code
                    self._json(code, {"status": "ok" if code == 200
                                      else "unhealthy"})
                elif self.path == "/stats":
                    self._json(200, dict(stub.stats))
                elif self.path == "/robustness":
                    if stub.robustness_mode == "die":
                        self.connection.close()
                        return
                    code, verdict = stub.robustness
                    self._json(code, verdict)
                else:
                    self._json(404, {"status": "error"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                self.rfile.read(n)
                with stub.lock:
                    stub.predicts += 1
                    stub.trace_ids.append(self.headers.get("X-Trace-Id", ""))
                if stub.predict_mode == "die":
                    # hang up before any status line: a connection-level
                    # failure, safe to re-dispatch
                    self.connection.close()
                    return
                if stub.predict_delay:
                    time.sleep(stub.predict_delay)
                with stub.lock:
                    stub.answers += 1
                self._json(200, {"status": "ok", "label": 1,
                                 "certified": True})

            def log_message(self, fmt, *args):
                pass

        self.lock = threading.Lock()
        self.predicts = 0
        self.answers = 0
        self.trace_ids = []
        self.healthz_code = 200
        self.stats = {"occupancy": 0.1, "reject_rate": 0.0,
                      "queue_depth": 0, "warm": True}
        self.robustness = (200, OK_VERDICT)
        self.robustness_mode = "ok"
        self.predict_mode = "ok"
        self.predict_delay = 0.0
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.name = f"127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)


@pytest.fixture
def stub():
    s = _StubServe()
    yield s
    s.close()


@pytest.fixture
def stub2():
    s = _StubServe()
    yield s
    s.close()


def _gateway(backends, tmp_path=None, **kw) -> Gateway:
    cfg = _cfg(backends=tuple(b.url for b in backends), **kw)
    return Gateway(cfg, result_dir=str(tmp_path) if tmp_path else "")


def _events(path):
    return [json.loads(line) for line in
            open(os.path.join(path, "events.jsonl"))]


# ---------------- held against the JAX gateway ----------------


def _roster(pkg, n=5):
    """`n` routable backends (no sockets) with distinct weights and loads,
    in the package's classes."""
    mod = PACKAGES[pkg][0]
    backends = [mod.Backend(f"http://127.0.0.1:{9000 + i}",
                            weight=1.0 + (i % 3)) for i in range(n)]
    for i, b in enumerate(backends):
        with b.lock:
            b.state = "healthy"
            b.occupancy = (i * 37 % 11) / 11.0
            b.reject_rate = (i % 2) * 0.05
    return backends


def test_router_picks_equal_to_jax():
    """Power-of-two choices under the router's seeded generator: the same
    pairs, in the same score order, and the same reservations (the
    inflight cap reached in the same order) as the JAX router."""
    picks = {}
    for pkg in PACKAGES:
        mod = PACKAGES[pkg][0]
        backends = _roster(pkg)
        cfg = _cfg(pkg, inflight_cap=3)
        reg = mod.BackendRegistry(backends, cfg)
        router = mod.Router(reg, cfg)
        seq = [[b.name for b in router._pick(backends)] for _ in range(200)]
        seq += [[b.name for b in router._pick(backends[:2])],
                [b.name for b in router._pick(backends[:1])]]
        reserved = []
        while True:
            b = router._reserve([])
            if b is None:
                break
            reserved.append(b.name)
        with backends[1].lock:
            backends[1].weight = 0.0
        seq.append([b.name for b in router._pick(backends)])
        picks[pkg] = (seq, reserved)
    assert picks["torch"] == picks["jax"]
    assert len(picks["torch"][1]) == 5 * 3


def test_prober_jitter_draws_equal_to_jax():
    draws = {}
    for pkg in PACKAGES:
        mod = PACKAGES[pkg][0]
        reg = mod.BackendRegistry([], _cfg(pkg))
        draws[pkg] = [reg._rng.random() for _ in range(50)]
    assert draws["torch"] == draws["jax"]


OK = (True, {"occupancy": 0.5, "reject_rate": 0.0,
             "queue_depth": 1, "warm": True}, True, "")
FAIL = (False, None, True, "ConnectionRefusedError: x")
OK_NOT_ROBUST = (True, None, False, "")


def _scripted(pkg, cfg, results):
    """A registry over one backend whose probes return `results` in turn:
    (backend, registry, transitions)."""
    mod = PACKAGES[pkg][0]
    b = mod.Backend("http://127.0.0.1:1")
    transitions = []
    reg = mod.BackendRegistry([b], cfg,
                              on_transition=lambda *a: transitions.append(a))
    script = iter(results)
    reg._collect = lambda backend: next(script)
    return b, reg, transitions


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_membership_transitions_equal_to_jax(seed):
    """On the same seeded script of ok / failed / non-robust probes, with
    an administrative drain in the middle, both registries make the same
    transitions and end in the same snapshot."""
    rng = random.Random(seed)
    script = [rng.choice([OK, OK, FAIL, OK_NOT_ROBUST]) for _ in range(80)]
    out = {}
    for pkg in PACKAGES:
        cfg = _cfg(pkg, fail_threshold=2 + seed % 2, ok_threshold=1 + seed)
        b, reg, transitions = _scripted(pkg, cfg, script)
        states = []
        for i in range(len(script)):
            if i == 60:
                reg.set_state(b.name, "draining", reason="test")
            if i == 70:
                reg.set_state(b.name, "joining", reason="test")
            reg.probe_cycle()
            states.append(b.snapshot()["state"])
        out[pkg] = (transitions, states, b.snapshot())
    assert out["torch"] == out["jax"]
    assert len(set(out["torch"][1])) >= 3 and out["torch"][0]


def test_autoscale_signals_equal_to_jax(monkeypatch):
    """The same fleet means on the same clock: the same recommendations,
    events and gauges."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    feed = [(0.95, 0.0, 2), (0.9, 0.0, 2), (0.5, 0.3, 2), (0.1, 0.0, 3),
            (0.05, 0.0, 3), (0.5, 0.0, 3), (0.0, 0.0, 1), (1.0, 1.0, 0)]
    out = {}
    for pkg in PACKAGES:
        _, cfg_mod, auto, _, obs = PACKAGES[pkg]
        now[0] = 1000.0
        metrics, events = obs.MetricRegistry(), []
        scaler = auto.Autoscaler(
            cfg_mod.GatewayConfig(**_knobs(autoscale_window_s=3.0,
                                           autoscale_cooldown_s=2.0)),
            metrics, lambda name, **a: events.append((name, a)))
        got = []
        for occ, rej, routable in feed:
            got.append(scaler.observe(occ, rej, routable))
            got.append((metrics.value("gateway_autoscale_recommendation"),
                        metrics.value("gateway_fleet_occupancy_mean"),
                        metrics.value("gateway_fleet_reject_rate_mean")))
            now[0] += 1.0
        out[pkg] = (got, events, metrics.render_text())
    assert out["torch"] == out["jax"]
    assert "up" in out["torch"][0] and "down" in out["torch"][0]


def test_gateway_chaos_equal_to_jax(tmp_path):
    for job_id in ("gateway", "g2", "serve"):
        port = port_chaos.Chaos(("wedge_probe", "poison_canary"), job_id,
                                str(tmp_path / "p" / job_id))
        jax = jax_chaos.Chaos(("wedge_probe", "poison_canary"), job_id,
                              str(tmp_path / "j" / job_id))
        assert port.wedge_probe_failures() == jax.wedge_probe_failures()
        seq = [(port.on_gateway_probe(i % 2, "b"),
                jax.on_gateway_probe(i % 2, "b")) for i in range(12)]
        assert all(a == b for a, b in seq)
        assert sum(a for a, _ in seq) == port.wedge_probe_failures()
        assert port.poison_canary(OK_VERDICT) == jax.poison_canary(OK_VERDICT)
        assert port.poison_canary(OK_VERDICT) == OK_VERDICT


# ---------------- membership ----------------


def test_membership_joining_to_healthy_needs_ok_threshold():
    b, reg, transitions = _scripted("torch", _cfg(ok_threshold=2), [OK, OK])
    reg.probe_cycle()
    assert b.snapshot()["state"] == JOINING
    reg.probe_cycle()
    snap = b.snapshot()
    assert snap["state"] == HEALTHY and snap["occupancy"] == 0.5
    assert (b.name, JOINING, HEALTHY, "probe_ok") in transitions


def test_membership_ejects_after_consecutive_failures_only():
    b, reg, _ = _scripted("torch", _cfg(fail_threshold=3, ok_threshold=2),
                          [FAIL, FAIL, OK, FAIL, FAIL, FAIL])
    for _ in range(5):
        reg.probe_cycle()
    assert b.snapshot()["state"] == JOINING
    reg.probe_cycle()
    assert b.snapshot()["state"] == EJECTED
    assert b.snapshot()["last_error"].startswith("ConnectionRefusedError")


def test_membership_readmission_hysteresis_defeats_flapping():
    b, reg, _ = _scripted("torch", _cfg(fail_threshold=2, ok_threshold=2),
                          [FAIL, FAIL, OK, FAIL, OK, FAIL, OK, OK])
    reg.probe_cycle()
    reg.probe_cycle()
    assert b.snapshot()["state"] == EJECTED
    for _ in range(4):
        reg.probe_cycle()
        assert b.snapshot()["state"] in (JOINING, EJECTED)
    reg.probe_cycle()
    reg.probe_cycle()
    assert b.snapshot()["state"] == HEALTHY


def test_membership_robustness_degrades_and_draining_is_kept():
    b, reg, transitions = _scripted("torch", _cfg(ok_threshold=1),
                                    [OK, OK_NOT_ROBUST, OK, OK])
    reg.probe_cycle()
    reg.probe_cycle()
    assert b.snapshot()["state"] == DEGRADED
    reg.probe_cycle()
    assert b.snapshot()["state"] == HEALTHY
    assert (b.name, HEALTHY, DEGRADED, "robustness") in transitions
    reg.set_state(b.name, DRAINING, reason="test drain")
    reg.probe_cycle()
    assert b.snapshot()["state"] == DRAINING and reg.routable() == []


def test_live_probe_cycle_against_stub(stub):
    cfg = _cfg(backends=(stub.url,), ok_threshold=1)
    reg = BackendRegistry([Backend(stub.url)], cfg)
    reg.probe_cycle()
    snap = reg.backends()[0].snapshot()
    assert snap["state"] == HEALTHY and snap["warm"]
    stub.robustness = (503, DP400_VERDICT)
    reg.probe_cycle()
    assert reg.backends()[0].snapshot()["state"] == DEGRADED
    stub.healthz_code = 503
    for _ in range(cfg.fail_threshold):
        reg.probe_cycle()
    assert reg.backends()[0].snapshot()["state"] == EJECTED


def test_wedge_probe_chaos_ejects_then_readmits(stub, tmp_path):
    gw = _gateway([stub], tmp_path=tmp_path, chaos="wedge_probe",
                  ok_threshold=2)
    wedged = gw.chaos.wedge_probe_failures()
    assert wedged >= gw.cfg.fail_threshold
    for _ in range(gw.cfg.fail_threshold):
        gw.registry.probe_cycle()
    assert gw.registry.backends()[0].snapshot()["state"] == EJECTED
    assert (tmp_path / "chaos_wedge_probe.fired").exists()
    for _ in range(wedged - gw.cfg.fail_threshold):
        gw.registry.probe_cycle()
    states = []
    for _ in range(gw.cfg.ok_threshold + 1):
        gw.registry.probe_cycle()
        states.append(gw.registry.backends()[0].snapshot()["state"])
    assert JOINING in states and states[-1] == HEALTHY


# ---------------- routing ----------------


def test_route_retries_on_survivor_exactly_once(stub, stub2):
    stub.predict_mode = "die"
    gw = _gateway([stub, stub2])
    for s in (stub, stub2):
        gw.registry.set_state(s.name, HEALTHY, reason="test")
    results = [gw.handle_predict(b"{}", trace_id=f"t{i}") for i in range(8)]
    assert all(r.payload["status"] == "ok" for r in results)
    assert (stub.answers, stub2.answers) == (0, 8)
    retried = [r for r in results if r.retries]
    assert retried
    for r in retried:
        assert r.backend == stub2.name and len(set(r.attempted)) == 2
    assert gw.metrics.value("gateway_requests_total", status="ok") == 8
    assert gw.metrics.value("gateway_backend_responses_total",
                            backend=stub2.name, status="ok") == 8
    assert gw.metrics.value("gateway_retries_total") == len(retried)


def test_route_all_ejected_is_typed_fleet_overloaded(stub):
    gw = _gateway([stub])
    gw.registry.set_state(stub.name, EJECTED, reason="test")
    r = gw.handle_predict(b"{}", trace_id="t-eject")
    assert r.code == 503
    assert r.payload == {"status": "overloaded", "scope": "fleet",
                         "routable": 0, "backends": 1, "inflight_cap": 4,
                         "gateway": {"backend": "", "retries": 0,
                                     "attempted": []}}
    assert stub.predicts == 0
    assert gw.metrics.value("gateway_requests_total",
                            status="overloaded") == 1


def test_route_inflight_cap_admission(stub):
    gw = _gateway([stub], inflight_cap=1)
    gw.registry.set_state(stub.name, HEALTHY, reason="test")
    b = gw.registry.get(stub.name)
    assert b.begin_dispatch(1)
    r = gw.handle_predict(b"{}", trace_id="t-cap")
    assert r.code == 503 and r.payload["status"] == "overloaded"
    b.end_dispatch()
    assert gw.handle_predict(b"{}", trace_id="t2").payload["status"] == "ok"


def test_route_timeout_is_never_retried(stub, stub2):
    stub.predict_delay = 1.0
    gw = _gateway([stub, stub2], dispatch_timeout_s=0.2, dispatch_retries=3)
    gw.registry.set_state(stub.name, HEALTHY, reason="test")
    r = gw.handle_predict(b"{}", trace_id="t-slow")
    assert r.code == 504 and r.payload["status"] == "deadline_exceeded"
    assert r.retries == 0 and len(r.attempted) == 1
    assert stub2.predicts == 0


def test_route_connection_failures_exhausted_is_internal_error():
    cfg = _cfg(backends=("http://127.0.0.1:9",), dispatch_retries=2)
    reg = BackendRegistry([Backend("http://127.0.0.1:9")], cfg)
    reg.set_state("127.0.0.1:9", HEALTHY, reason="test")
    r = Router(reg, cfg).route(b"{}", "t-conn")
    assert r.code == 500 and r.payload["status"] == "internal_error"
    assert "127.0.0.1:9" in r.payload["reason"]


def test_router_prefers_healthy_over_degraded(stub, stub2):
    gw = _gateway([stub, stub2])
    gw.registry.set_state(stub.name, DEGRADED, reason="test")
    gw.registry.set_state(stub2.name, HEALTHY, reason="test")
    for i in range(6):
        assert gw.handle_predict(b"{}", f"t{i}").backend == stub2.name
    assert stub.predicts == 0
    gw.registry.set_state(stub2.name, EJECTED, reason="test")
    assert gw.handle_predict(b"{}", "t-last").backend == stub.name


# ---------------- rolling deploys ----------------


def _deploy(stable, canary, tmp_path, **kw):
    gw = _gateway([stable], tmp_path=tmp_path, **kw)
    gw.start()
    gw.registry.set_state(stable.name, HEALTHY, reason="test")
    gw.add_backend(canary.url)
    gw.registry.set_state(canary.name, HEALTHY, reason="test")
    return gw


def test_deploy_promotes_clean_canary(stub, stub2, tmp_path):
    gw = _deploy(stub, stub2, tmp_path, canary_steps=(0.5, 1.0))
    out = RollingDeploy(gw, [stub2.name], hold_s=0.0).run(warm_timeout_s=5)
    gw.stop()
    assert out["outcome"] == "promoted"
    snaps = {b.name: b.snapshot() for b in gw.registry.backends()}
    assert snaps[stub2.name]["weight"] == 1.0
    assert (snaps[stub.name]["state"], snaps[stub.name]["weight"]) == (
        DRAINING, 0.0)
    names = [e["name"] for e in _events(tmp_path)]
    assert names.count("gateway.deploy.step") == 2
    assert "gateway.deploy.complete" in names
    assert "gateway.rollback" not in names


@pytest.mark.parametrize("fault", ["dp400", "poison_canary",
                                   "robustness_unreachable"])
def test_deploy_rolls_back(stub, stub2, tmp_path, fault):
    """A DP400 finding in the canary's verdict, the `poison_canary` fault,
    or a canary whose `/robustness` hangs up: the fleet rolls back at the
    first step (canary drained at weight 0, stable weight restored, the
    typed `gateway.rollback` event and counter, both in metrics.json)."""
    kw = dict(canary_steps=(0.1, 1.0))
    if fault == "dp400":
        stub2.robustness = (503, DP400_VERDICT)
    elif fault == "poison_canary":
        kw["chaos"] = "poison_canary"
    else:
        stub2.robustness_mode = "die"
    gw = _deploy(stub, stub2, tmp_path, **kw)
    out = RollingDeploy(gw, [stub2.name], hold_s=0.0).run(warm_timeout_s=5)
    gw.stop()
    assert out["outcome"] == "rolled_back" and out["step"] == 0.1
    if fault == "robustness_unreachable":
        assert "/robustness unreachable" in out["reason"]
    else:
        assert "DP400" in out["reason"]
        assert any(f.startswith("DP400:") for f in out["findings"])
    snaps = {b.name: b.snapshot() for b in gw.registry.backends()}
    assert (snaps[stub2.name]["state"], snaps[stub2.name]["weight"]) == (
        DRAINING, 0.0)
    assert snaps[stub.name]["weight"] == 1.0
    assert gw.metrics.value("gateway_rollbacks_total") == 1
    rb = [e for e in _events(tmp_path) if e["name"] == "gateway.rollback"]
    assert len(rb) == 1 and rb[0]["reason"] == out["reason"]
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert "gateway_rollbacks_total" in metrics["metrics"]


def test_deploy_blocks_on_a_finding_source(stub, stub2, tmp_path):
    """DP305 (AOT drift) stays a blocking rule: a finding source reporting
    it rolls the deploy back though the canary's verdict is ok."""
    gw = _deploy(stub, stub2, tmp_path)
    out = RollingDeploy(gw, [stub2.name], hold_s=0.0,
                        finding_source=lambda: ["DP305: drift", "DP999: x"]
                        ).run(warm_timeout_s=5)
    gw.stop()
    assert port_gateway.deploy.BLOCKING_RULES == ("DP305", "DP400")
    assert out["outcome"] == "rolled_back" and "DP305" in out["reason"]
    assert out["findings"] == ["DP305: drift", "DP305: DP305 reported"]


def test_deploy_rolls_back_on_a_canary_never_healthy(stub, tmp_path):
    gw = _gateway([stub], tmp_path=tmp_path)
    with gw:
        gw.registry.set_state(stub.name, HEALTHY, reason="test")
        gw.add_backend("http://127.0.0.1:9")
        out = RollingDeploy(gw, ["127.0.0.1:9"],
                            hold_s=0.0).run(warm_timeout_s=0.3)
    assert out["outcome"] == "rolled_back"
    assert "never became healthy" in out["reason"]


def test_autoscale_signals_and_cooldown():
    from dorpatch_tpu_torch.gateway.autoscale import Autoscaler

    events, metrics = [], observe.MetricRegistry()
    scaler = Autoscaler(_cfg(autoscale_window_s=60.0), metrics,
                        lambda name, **a: events.append((name, a)))
    assert scaler.observe(0.95, 0.0, routable=2) == "up"
    assert scaler.observe(0.95, 0.0, routable=2) is None
    assert metrics.value("gateway_autoscale_events_total",
                         direction="up") == 1
    assert events[0][0] == "gateway.autoscale"
    m3 = observe.MetricRegistry()
    s3 = Autoscaler(_cfg(autoscale_cooldown_s=0.0), m3, lambda n, **a: None)
    assert s3.observe(0.05, 0.0, routable=3) == "down"
    assert s3.observe(0.5, 0.0, routable=3) is None
    assert m3.value("gateway_fleet_occupancy_mean") == pytest.approx(0.275)


# ---------------- the HTTP surface ----------------


def test_gateway_http_surface_and_trace_forwarding(stub, tmp_path):
    gw = _gateway([stub], tmp_path=tmp_path)
    with gw, GatewayFrontend(gw, port=0) as fe:
        base = f"http://127.0.0.1:{fe.port}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ei.value.code == 503
        gw.registry.set_state(stub.name, HEALTHY, reason="test")
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["routable"] == 1
        req = urllib.request.Request(
            base + "/predict", data=b'{"deadline_ms": 1000}',
            headers={"Content-Type": "application/json",
                     "X-Trace-Id": "trace-abc"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.headers["X-Trace-Id"] == "trace-abc"
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["trace_id"] == "trace-abc"
        assert body["gateway"] == {"backend": stub.name, "retries": 0,
                                   "attempted": [stub.name]}
        assert stub.trace_ids == ["trace-abc"]
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["role"] == "gateway" and stats["requests"] == {"ok": 1}
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert 'gateway_requests_total{status="ok"} 1' in \
                r.read().decode()
        bad = urllib.request.Request(base + "/predict", data=b"[1, 2]")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=10)
        assert ei.value.code == 400
    events = _events(tmp_path)
    admits = [e for e in events if e["name"] == "gateway.admit"]
    terminals = [e for e in events if e["name"] == "gateway.request"]
    assert len(admits) == len(terminals) == 1
    assert admits[0]["trace"] == terminals[0]["trace"] == "trace-abc"
    assert admits[0]["opens_trace"] is True
    assert json.loads((tmp_path / "run.json").read_text())["kind"] == \
        "gateway"


# ---------------- config, CLI, process ----------------


def test_gateway_and_recert_config_cli_and_dict_roundtrip_equal_to_jax():
    from dorpatch_tpu.cli import build_parser as jax_parser
    from dorpatch_tpu.cli import config_from_args as jax_from_args
    from dorpatch_tpu_torch.cli import build_parser, config_from_args

    argv = ["--gateway-backends", "http://a:1,http://b:2",
            "--gateway-port", "9100", "--gateway-probe-interval", "0.5",
            "--gateway-fail-threshold", "5", "--gateway-ok-threshold", "3",
            "--gateway-inflight-cap", "8", "--gateway-canary-steps",
            "0.25,1.0", "--gateway-canary-hold", "0.5", "--recert-dir",
            "/r", "--recert-baseline", "/b.json", "--require-recert",
            "strict", "--farm-lease-ttl", "7", "--farm-max-attempts", "4",
            "--farm-backoff-base", "0.5", "--chaos",
            "wedge_probe,poison_canary"]
    cfg = config_from_args(build_parser().parse_args(argv))
    jcfg = jax_from_args(jax_parser().parse_args(argv))
    for name in ("gateway", "recert", "farm"):
        assert port_config.config_to_dict(cfg)[name] == \
            jax_config.config_to_dict(jcfg)[name]
    assert cfg.gateway.backends == ("http://a:1", "http://b:2")
    assert cfg.gateway.canary_steps == (0.25, 1.0)
    assert cfg.recert.require == "strict" and cfg.farm.lease_ttl == 7.0
    defaults = port_config.config_to_dict(ExperimentConfig())
    jdefaults = jax_config.config_to_dict(jax_config.ExperimentConfig())
    for name in ("gateway", "recert"):
        assert defaults[name] == jdefaults[name]
    wire = json.loads(json.dumps(port_config.config_to_dict(cfg)))
    assert port_config.config_from_dict(wire) == cfg
    assert jax_config.config_from_dict(wire).gateway == jcfg.gateway
    with pytest.raises(ValueError):
        wire["gateway"]["not_a_knob"] = 1
        port_config.config_from_dict(wire)
    assert GatewayConfig() == port_config.GatewayConfig()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_python_m_gateway_boots_routes_and_loads_no_torch(stub, tmp_path):
    """`python -m dorpatch_tpu_torch.gateway` in a subprocess: it probes
    the stub healthy, routes a request to it, stops cleanly on SIGINT
    (metrics.json written), and its import log names no torch module."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "dorpatch_tpu_torch.gateway", "--gateway-backends", stub.url,
         "--gateway-port", str(port), "--gateway-probe-interval", "0.1",
         "--gateway-ok-threshold", "1", "--results-root", str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        t0 = time.time()
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=5) as r:
                    if json.loads(r.read())["routable"] == 1:
                        break
            except (urllib.error.URLError, OSError):
                pass
            assert time.time() - t0 < 60 and proc.poll() is None
            time.sleep(0.1)
        req = urllib.request.Request(url + "/predict", data=b"{}",
                                     headers={"X-Trace-Id": "sub-1"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        assert stub.trace_ids == ["sub-1"]
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    imported = [line.rsplit("|", 1)[-1].strip() for line in err.splitlines()
                if line.startswith("import time:")]
    assert "dorpatch_tpu_torch.gateway.service" in imported
    assert not [m for m in imported if m.split(".")[0] in ("torch", "jax")
                or m == "dorpatch_tpu" or m.startswith("dorpatch_tpu.")]
    gw_dir = tmp_path / "gateway"
    metrics = json.loads((gw_dir / "metrics.json").read_text())
    assert "gateway_requests_total" in metrics["metrics"]
