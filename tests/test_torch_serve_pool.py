"""The port's HTTP front-end and replica pool on the CPU, over the stub
victim of `tests/test_torch_serve.py`: the routes, `X-Trace-Id` echo and
typed errors; the JAX package's own tools run unchanged against the port
(`tools/loadgen.py --url ... --expect-metrics` and `observe.report` on its
serve directory); the failover drills of `tests/test_serve.py`
(`wedge_dispatch`, `raise_in_worker`, `wedge_heartbeat`, exhausted
restarts) with their event records; and the chaos fault list. Every join
and wait is bounded; staleness windows leave room for a loaded machine."""

import json
import os
import pathlib
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from dorpatch_tpu.observe import report
from dorpatch_tpu_torch.serve import HttpFrontend, PredictResult

from test_torch_serve import (  # noqa: F401  (the fixture is autouse)
    IMG,
    _events,
    _fire,
    _two_torch_threads,
    make_images,
    make_service,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------- HTTP front-end, loadgen and the report ----------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_http_front_end_loadgen_and_report(tmp_path, capsys):
    svc = make_service(tmp_path, replicas=2)
    with svc, HttpFrontend(svc, port=0) as fe:
        base = f"http://127.0.0.1:{fe.port}"
        code, body, _ = _get(f"{base}/healthz")
        assert code == 200 and json.loads(body)["warm"] is True
        img = json.dumps({"image": make_images(1)[0].tolist()}).encode()
        code, body, hdr = _post(f"{base}/predict", img,
                                {"X-Trace-Id": "trace-abc"})
        p = json.loads(body)
        assert code == 200 and p["status"] == "ok"
        assert p["trace_id"] == "trace-abc" and hdr["X-Trace-Id"] == \
            "trace-abc"
        assert p["verdicts"][0]["ratio"] == 0.1
        code, body, _ = _post(f"{base}/predict", b"not json")
        assert code == 400 and json.loads(body)["status"] == "error"
        assert _get(f"{base}/nowhere")[0] == 404
        code, body, _ = _get(f"{base}/robustness")
        assert code == 503 and json.loads(body)["status"] == "unconfigured"
        code, body, _ = _get(f"{base}/stats")
        assert code == 200 and json.loads(body)["completed"] == 1
        code, body, _ = _post(f"{base}/profile",
                              json.dumps({"duration_ms": 50}).encode())
        assert code == 200, body
        assert os.path.isdir(json.loads(body)["dir"])
        # the JAX package's load generator, unchanged, against the port
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "loadgen.py"), "--url",
             base, "--requests", "16", "--concurrency", "4", "--img-size",
             str(IMG), "--deadline-ms", "30000", "--expect-metrics",
             "--results-dir", str(tmp_path / "client")],
            cwd=str(ROOT), capture_output=True, text=True, timeout=240,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stdout + out.stderr
        rep = json.loads(out.stdout.strip().splitlines()[-1])
        assert rep["metrics_check"]["ok"] and rep["by_status"] == {"ok": 16}
        code, body, _ = _get(f"{base}/metrics")
        text = body.decode()
        assert code == 200 and 'serve_requests_total{status="ok"} 17' in text
    # the stop dumped metrics.json; the JAX package's report renders it
    rd = str(tmp_path / "serve")
    snap = json.load(open(os.path.join(rd, "metrics.json")))
    assert snap["metrics"]["serve_batch_images_total"]["series"][0][
        "value"] == 17
    capsys.readouterr()
    assert report.main([rd]) == 0
    out = capsys.readouterr().out
    assert "-- serve --" in out and "p50" in out
    assert "run span never closed" not in out
    assert report.main([rd, "--json"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["serve"]["requests"] == 17
    assert s["serve"]["by_status"] == {"ok": 17}


# ---------- failover drills ----------

def test_wedged_replica_fails_over_restarts_and_reports(tmp_path, capsys):
    svc = make_service(tmp_path, max_batch=2, bucket_sizes=(1, 2),
                       replicas=2, max_restarts=2,
                       restart_backoff_base=0.2, restart_backoff_cap=1.0,
                       replica_stale_s=3.0, chaos="wedge_dispatch")
    images = make_images(6, seed=9)
    with svc:
        results = _fire(svc, images, concurrency=6)
        assert all(isinstance(r, PredictResult) for r in results), \
            [getattr(r, "status", r) for r in results]
        assert svc.stats()["failover"]["redispatched"] >= 1
        deadline = time.time() + 90.0
        while time.time() < deadline:
            snap = {r["replica"]: r for r in svc.stats()["replicas"]}
            if snap[0]["state"] == "healthy" and snap[0]["generation"] == 1:
                break
            time.sleep(0.2)
        snap = {r["replica"]: r for r in svc.stats()["replicas"]}
        assert snap[0]["state"] == "healthy" and snap[0]["restarts"] == 1
        assert snap[1]["state"] == "healthy" and snap[1]["completed"] == 6
        assert svc.healthz()["replicas"]["healthy"] == 2
        assert isinstance(svc.predict(images[0]), PredictResult)
    assert svc.stats()["completed"] == 7
    events = _events(tmp_path)
    names = [e.get("name") for e in events]
    sick = [e for e in events if e.get("name") == "serve.replica.sick"]
    assert sick and sick[0]["cause"] == "wedged" and sick[0]["replica"] == 0
    assert "serve.replica.quarantine" in names
    assert "serve.replica.restart" in names
    rd = str(tmp_path / "serve")
    capsys.readouterr()
    assert report.main([rd]) == 0
    out = capsys.readouterr().out
    assert "-- replicas --" in out and "1 restart(s)" in out


def test_raised_worker_restarts_and_redispatches(tmp_path):
    svc = make_service(tmp_path, max_batch=1, bucket_sizes=(1,),
                       replicas=1, max_restarts=2,
                       restart_backoff_base=0.2, restart_backoff_cap=1.0,
                       replica_stale_s=3.0, chaos="raise_in_worker")
    with svc:
        r = svc.predict(make_images(1)[0])
        assert isinstance(r, PredictResult), getattr(r, "reason", r)
        st = svc.stats()
        assert st["failover"]["redispatched"] == 1
        assert st["replicas"][0]["generation"] == 1
        assert st["replicas"][0]["restarts"] == 1
    sick = [e for e in _events(tmp_path)
            if e.get("name") == "serve.replica.sick"]
    assert sick[0]["cause"] == "raised" and sick[0]["inflight"] == 1


def test_restart_comes_back_through_the_aot_warm_boot(tmp_path):
    """A replica restarted after `raise_in_worker` rebuilds its bank
    through the AOT warm boot: its restart record carries the boot's hits
    (every program, written by the first boot) and no miss."""
    from dorpatch_tpu_torch.config import (AotConfig, DefenseConfig,
                                           ServeConfig)
    from dorpatch_tpu_torch.serve import CertifiedInferenceService
    from test_torch_serve import N_CLASSES, _serve_kw, torch_stub

    svc = CertifiedInferenceService(
        torch_stub, N_CLASSES, IMG,
        serve_cfg=ServeConfig(**_serve_kw(
            max_batch=1, bucket_sizes=(1,), replicas=1, max_restarts=2,
            restart_backoff_base=0.2, restart_backoff_cap=1.0,
            replica_stale_s=3.0, chaos="raise_in_worker")),
        defense_cfg=DefenseConfig(ratios=(0.1,), chunk_size=64),
        result_dir=str(tmp_path / "serve"), device="cpu",
        aot_cfg=AotConfig(cache_dir=str(tmp_path / "store"), mode="auto"))
    with svc:
        r = svc.predict(make_images(1)[0])
        assert isinstance(r, PredictResult), getattr(r, "reason", r)
        st = svc.stats()
        assert st["replicas"][0]["generation"] == 1
        n = st["aot"]["builds"]
        assert n and svc._pool.replicas[0].aot_stats["hits"] == n
    ev = _events(tmp_path)
    [start] = [e for e in ev if e.get("name") == "serve.replica.start"]
    assert start["aot"] is True
    [restart] = [e for e in ev if e.get("name") == "serve.replica.restart"]
    assert (restart["aot_hits"], restart["aot_misses"]) == (n, 0)


def test_wedge_heartbeat_detected_while_thread_lives(tmp_path):
    svc = make_service(tmp_path, max_batch=1, bucket_sizes=(1,),
                       replicas=1, max_restarts=2,
                       restart_backoff_base=0.2, restart_backoff_cap=1.0,
                       replica_stale_s=3.0, chaos="wedge_heartbeat")
    with svc:
        assert isinstance(svc.predict(make_images(1)[0]), PredictResult)
        deadline = time.time() + 90.0
        while time.time() < deadline:
            snap = svc.stats()["replicas"][0]
            if snap["state"] == "healthy" and snap["generation"] == 1:
                break
            time.sleep(0.2)
        snap = svc.stats()["replicas"][0]
        assert snap["generation"] == 1 and snap["restarts"] == 1
        assert isinstance(svc.predict(make_images(1)[0]), PredictResult)
    sick = [e for e in _events(tmp_path)
            if e.get("name") == "serve.replica.sick"]
    assert sick[0]["cause"] == "wedged"


def test_exhausted_restarts_retire_degrade_not_hang(tmp_path):
    svc = make_service(tmp_path, max_batch=1, bucket_sizes=(1,),
                       replicas=1, max_restarts=0, replica_stale_s=3.0,
                       chaos="raise_in_worker")
    with svc, HttpFrontend(svc, port=0) as fe:
        base = f"http://127.0.0.1:{fe.port}"
        body = json.dumps({"image": make_images(1)[0].tolist(),
                           "deadline_ms": 30000.0}).encode()
        t0 = time.time()
        code, out, _ = _post(f"{base}/predict", body)
        assert code == 500 and json.loads(out)["status"] == "internal_error"
        assert time.time() - t0 < 25.0
        deadline = time.time() + 60.0
        while time.time() < deadline:
            snap = svc.stats()["replicas"][0]
            if snap["state"] == "retired" and not snap["thread_alive"]:
                break
            time.sleep(0.1)
        code, out, _ = _get(f"{base}/healthz")
        h = json.loads(out)
        assert code == 503 and h["status"] == "unhealthy"
        assert h["replicas"] == {"total": 1, "healthy": 0, "retired": 1}
        code, out, _ = _post(f"{base}/predict", body)
        assert code == 503 and json.loads(out)["status"] == "overloaded"
    retire = [e for e in _events(tmp_path)
              if e.get("name") == "serve.replica.retire"]
    assert retire and retire[0]["max_queue_depth"] == 0


def test_chaos_refuses_faults_not_yet_ported():
    """Every fault of the JAX package is ported: the recert and gateway
    faults parse as the JAX package parses them, and an unknown name is
    still refused."""
    from dorpatch_tpu import chaos as jax_chaos
    from dorpatch_tpu_torch import chaos

    assert chaos.parse_faults("wedge_dispatch, kill_backend") == (
        "wedge_dispatch", "kill_backend")
    assert chaos.FAULTS == jax_chaos.FAULTS
    for fault in ("recert_kill_cycle", "wedge_probe"):
        assert chaos.parse_faults(fault) == jax_chaos.parse_faults(fault)
    with pytest.raises(ValueError, match="unknown"):
        chaos.parse_faults("nope")
