"""The port's telemetry core (`dorpatch_tpu_torch.observe`, `backoff`)
against the JAX package's: the same sequence of spans, events and metric
operations gives equal `events.jsonl` records, byte-equal Prometheus
expositions and snapshots, equal heartbeat files and manifests; plus the
port's own shape budget (the eager form of the zero-recompile contract),
held to the JAX recompile watchdog's event records, and the
`torch.profiler` capture."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import backoff as jbackoff
from dorpatch_tpu import observe as jobs
from dorpatch_tpu.analysis import sanitize as jsanitize
from dorpatch_tpu_torch import backoff as tbackoff
from dorpatch_tpu_torch import observe as tobs


class FakeClock:
    """A deterministic clock: each read advances by `step` seconds."""

    def __init__(self, t0=1000.0, step=0.25):
        self.t = t0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _drive_events(obs, path):
    """One fixed sequence of spans, events, blocks and compiles."""
    wall, perf = FakeClock(1.7e9, 0.5), FakeClock(10.0, 0.125)
    with obs.EventLog(path, run_id="run0", clock=wall, perf=perf) as el:
        with obs.span("run", service="serve") as outer:
            obs.record_event("serve.started", buckets=[1, 8],
                             ratios=[0.015, 0.12], deadline_ms=2000.0)
            with obs.span("serve.batch", bucket=8, images=3,
                          traces=["a", "b", "c"]) as sp:
                obs.record_event("serve.request", status="ok",
                                 latency_s=0.5, bucket=8, trace="a",
                                 forwards=666, forward_equivalents=12.5)
                obs.record_compile("serve.clean_predict", 1.25)
                sp["ok"] = 3
            el.block_boundary(0, 20, {"stopped": False})
            outer["note"] = "done"
        assert el.current_path() == "idle"
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _without_mem(recs):
    """`block` records carry the backend's memory sample, which the two
    packages read from different runtimes (none on this CPU)."""
    return [{k: v for k, v in r.items() if k != "mem"} for r in recs]


def test_event_log_records_equal_jax(tmp_path):
    want = _drive_events(jobs, str(tmp_path / "jax" / "events.jsonl"))
    got = _drive_events(tobs, str(tmp_path / "torch" / "events.jsonl"))
    assert _without_mem(got) == _without_mem(want)
    assert [r["kind"] for r in got] == [
        "begin", "event", "begin", "event", "compile", "span", "block",
        "span"]
    assert tobs.events_filename(0) == jobs.events_filename(0)
    assert tobs.events_filename(3) == jobs.events_filename(3)
    assert tobs.active_event_log() is None


def test_event_log_degrades_when_unwritable(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    el = tobs.EventLog(str(blocker / "events.jsonl"))
    with el:
        with tobs.span("run"):
            assert el.current_path() == "run"
            tobs.record_event("still.tracked")
    assert el.seconds_since_activity() >= 0.0


def _drive_metrics(obs):
    m = obs.MetricRegistry()
    req = m.counter("serve_requests_total", "terminal request outcomes")
    req.inc(status="ok")
    req.inc(3, status="ok")
    req.inc(status="overloaded")
    req.inc(0.5, status='we"ird\\label\n')
    m.counter("serve_batches_total", "dispatched micro-batches").inc(2)
    g = m.gauge("serve_queue_depth", "live batcher queue depth")
    g.set_function(lambda: 7.0)
    m.gauge("plain_gauge").set(2.5, replica="0")
    m.gauge("plain_gauge").add(-1.0, replica="0")
    h = m.histogram("serve_latency_ms", "latency (ms)")
    for v in (0.5, 3.0, 3.0, 42.0, 2e4):
        h.observe(v)
    h.observe(7.0, replica="1")
    m.histogram("custom_buckets", buckets=(1.0, 10.0)).observe(5.0)
    with pytest.raises(ValueError):
        req.inc(-1)
    with pytest.raises(TypeError):
        m.gauge("serve_requests_total")
    return m


def test_metric_registry_exposition_and_snapshot_equal_jax(tmp_path):
    jm, tm = _drive_metrics(jobs), _drive_metrics(tobs)
    text = tm.render_text()
    assert text.encode() == jm.render_text().encode()
    assert tm.snapshot() == jm.snapshot()
    assert tobs.parse_exposition(text) == jobs.parse_exposition(text)
    snap = tm.snapshot()
    assert (tobs.labeled_values(snap, "serve_requests_total", "status")
            == jobs.labeled_values(snap, "serve_requests_total", "status"))
    for q in (0.5, 0.95, 0.99):
        assert tm.percentile("serve_latency_ms", q) == \
            jm.percentile("serve_latency_ms", q)
    assert tm.value("serve_latency_ms") == jm.value("serve_latency_ms") == 5
    jp, tp = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert jm.dump(jp) and tm.dump(tp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    # an unwritable target never raises and leaves nothing behind
    assert tm.dump(str(tmp_path / "missing" / "m.json")) is False


def test_metric_registry_concurrent_increments_exact():
    m = tobs.MetricRegistry()
    c = m.counter("hits")
    h = m.histogram("lat")
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait(timeout=30)
        for _ in range(2000):
            c.inc(worker=str(i % 2))
            h.observe(1.0)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.total() == 16000 and h.count() == 16000


def test_nearest_rank_percentile_equals_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100):
        vals = sorted(rng.uniform(0, 100, n).tolist())
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert tobs.nearest_rank_percentile(vals, q) == \
                jobs.nearest_rank_percentile(vals, q)


def test_step_timer_summary_equals_jax():
    jt, tt = jobs.StepTimer(clock=FakeClock()), tobs.StepTimer(
        clock=FakeClock())
    for t in (jt, tt):
        for _ in range(3):
            t.start()
            t.stop()
    assert tt.summary(20, 4, 1e9, 67e12) == jt.summary(20, 4, 1e9, 67e12)


def _drive_heartbeat(obs, path):
    clock = FakeClock(5e8, 1.0)
    hb = obs.Heartbeat(path, interval=3600.0, process_index=2,
                       run_id="rid", clock=clock,
                       extra=lambda: {"jobs_done": 4, "phase": "ignored"})
    hb.start()
    hb.beat("batch")
    hb.beat()
    hb.close()
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_heartbeat_files_equal_jax(tmp_path):
    want = _drive_heartbeat(jobs, str(tmp_path / "j" / "heartbeat_2.jsonl"))
    got = _drive_heartbeat(tobs, str(tmp_path / "t" / "heartbeat_2.jsonl"))
    assert got == want and got[-1]["phase"] == "exit"
    assert tobs.heartbeat_filename(2) == jobs.heartbeat_filename(2)
    tdir = str(tmp_path / "t")
    assert tobs.last_beat(os.path.join(tdir, "heartbeat_2.jsonl")) == \
        jobs.last_beat(os.path.join(tdir, "heartbeat_2.jsonl"))
    assert tobs.summarize_heartbeats(tdir) == jobs.summarize_heartbeats(tdir)
    assert tobs.read_heartbeats(tdir) == jobs.read_heartbeats(tdir)


def test_watchdog_fires_with_last_phases(tmp_path):
    _drive_heartbeat(tobs, str(tmp_path / "heartbeat_2.jsonl"))
    lines, fired = [], []

    class Idle:
        def seconds_since_activity(self):
            return 99.0

    wd = tobs.Watchdog(str(tmp_path), Idle(), timeout_s=1.0,
                       on_abort=lambda: fired.append(1),
                       echo=lambda msg, file=None: lines.append(msg))
    assert wd.check() is True and fired == [1]
    assert any("heartbeat_2.jsonl: phase='exit'" in ln for ln in lines)


def test_manifest_equals_jax_and_chains_attempts(tmp_path):
    rd = str(tmp_path)
    tobs.write_run_manifest(rd, {"a": 1}, run_id="first")
    tobs.write_run_manifest(rd, {"a": 1}, run_id="second",
                            extra={**tobs.torch_environment(),
                                   "service": "serve"})
    m = json.load(open(os.path.join(rd, "run.json")))
    assert m["run_id"] == "second" and m["previous_run_ids"] == ["first"]
    assert m["backend_impl"] == "torch" and m["service"] == "serve"
    assert m["device_kind"] and "device_count" in m
    want = jobs.run_manifest({"a": 1}, run_id="x")
    got = tobs.run_manifest({"a": 1}, run_id="x")
    assert set(got) == set(want)
    assert len(tobs.new_run_id()) == len(jobs.new_run_id()) == 12
    assert len(tobs.new_trace_id()) == len(jobs.new_trace_id()) == 16


def test_retry_delay_equals_jax():
    for job in ("serve-r0", "serve-r1", "x"):
        for attempt in range(0, 12):
            for base, cap in ((0.5, 30.0), (2.0, 300.0)):
                assert tbackoff.retry_delay(job, attempt, base, cap) == \
                    jbackoff.retry_delay(job, attempt, base, cap)


def _budget_run(obs, watchdog, program, shapes, path, make):
    """Run `program` once per shape under an armed watchdog with budget 2;
    the third shape must trip it. Returns the event records."""
    wrapped = obs.timed_first_call(program, "prog", clock=FakeClock(),
                                   recompile_budget=2)
    prev = obs.recompile_guard()
    obs.set_recompile_guard(watchdog)
    try:
        with obs.EventLog(path, run_id="r", clock=FakeClock(),
                          perf=FakeClock()):
            for s in shapes[:2] + shapes[:2]:
                wrapped(make(s))
            assert wrapped._cache_size() == 2
            with pytest.raises(Exception) as ei:
                wrapped(make(shapes[2]))
    finally:
        obs.set_recompile_guard(prev)
    assert type(ei.value).__name__ == "RecompileBudgetExceeded"
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_shape_budget_events_equal_jax_recompile_watchdog(tmp_path):
    """The eager shape budget counts what a jit's cache counts (one entry
    per distinct input shape/dtype) and writes the JAX watchdog's events:
    one `compile`, a `sanitize.retrace` per new shape past the first, and
    `sanitize.recompile_budget_exceeded` before it raises."""
    shapes = [(1, 4), (8, 4), (3, 4)]
    want = _budget_run(jobs, jsanitize.RecompileWatchdog(),
                       jax.jit(lambda x: x * 2.0), shapes,
                       str(tmp_path / "j.jsonl"),
                       lambda s: jnp.zeros(s, jnp.float32))
    got = _budget_run(tobs, tobs.RecompileWatchdog(),
                      lambda x: x * 2.0, shapes, str(tmp_path / "t.jsonl"),
                      lambda s: torch.zeros(s))
    strip = [{k: v for k, v in r.items() if k not in ("ts", "dur_s")}
             for r in got]
    assert strip == [{k: v for k, v in r.items() if k not in ("ts", "dur_s")}
                     for r in want]
    assert [r.get("name") for r in got] == [
        "prog", "sanitize.retrace", "sanitize.retrace",
        "sanitize.recompile_budget_exceeded"]


def test_shape_budget_signature_keys():
    """Dtype, device and non-tensor arguments are part of a signature."""
    w = tobs.timed_first_call(lambda *a, **k: None, "p")
    w(torch.zeros(2, 3), 5)
    w(torch.zeros(2, 3), 5)
    assert w._cache_size() == 1
    w(torch.zeros(2, 3, dtype=torch.bfloat16), 5)
    w(torch.zeros(2, 3), 6)
    w(torch.zeros(2, 3), 5, with_margins=True)
    w((torch.zeros(1), torch.zeros(2)), 5)
    assert w._cache_size() == 5
    # no guard installed: budgets are inert
    assert tobs.timed_first_call(lambda: 1, "q", recompile_budget=0)() == 1


def test_capture_profile_writes_a_torch_trace(tmp_path):
    with tobs.EventLog(str(tmp_path / "events.jsonl"), run_id="r"):
        held = threading.Event()
        release = threading.Event()
        out = {}

        def capture():
            out["dir"] = tobs.capture_profile(
                str(tmp_path), duration_s=0.05,
                sleep=lambda s: (held.set(), release.wait(30)))

        t = threading.Thread(target=capture)
        t.start()
        assert held.wait(30)
        # one capture at a time: a second is refused, never queued
        assert tobs.capture_profile(str(tmp_path), 0.05) is None
        torch.ones(8) @ torch.ones(8)
        release.set()
        t.join(timeout=60)
    assert out["dir"] == str(tmp_path / "profile")
    assert os.path.getsize(tmp_path / "profile" / tobs.timing.TRACE_FILE) > 0
    recs = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    assert [r["name"] for r in recs] == ["profile.captured"]
    assert tobs.capture_profile("", 0.05) is None


def test_init_profiler_sets_up_once_on_the_calling_thread(monkeypatch):
    entered = []
    real = torch.profiler.profile

    def spy(*args, **kw):
        entered.append(threading.get_ident())
        return real(*args, **kw)

    monkeypatch.setattr(tobs.timing, "_profiler_ready", False)
    monkeypatch.setattr(torch.profiler, "profile", spy)
    tobs.init_profiler()
    tobs.init_profiler()
    assert entered == [threading.get_ident()]
