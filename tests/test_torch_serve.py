"""The port's certified-inference service (`dorpatch_tpu_torch.serve`)
against the JAX package's, over the weightless stub victim of
`tests/test_serve.py` (32 px, one radius, chunk 64; the JAX stub in jnp,
the port's in torch), on the CPU:

- typed responses (`to_dict` bytes), the key sets of `/stats` and
  `/healthz`, and the verdicts, forwards and forward equivalents of 52
  mixed-size requests under prune off, exact and consensus, each with the
  shape budget unchanged by the traffic;
- the micro-batcher's flushes, backpressure, requeue and exactly-once
  claim; the launch counters under 8 threads;
- one real model: `from_config` on `cifar_resnet18` at 32 px on the CPU.

The HTTP front-end, the JAX package's tools against it and the failover
drills are in `tests/test_torch_serve_pool.py`.

Every join and wait is bounded, and the timing drills' deadlines leave
room for a loaded machine."""

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import serve as jserve
from dorpatch_tpu.config import DefenseConfig as JDefenseConfig
from dorpatch_tpu.config import ServeConfig as JServeConfig
from dorpatch_tpu_torch import defense as tdefense
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch import serve as tserve
from dorpatch_tpu_torch.config import DefenseConfig, ServeConfig
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.serve import (
    CertifiedInferenceService,
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
    PendingRequest,
    PredictResult,
    ServeError,
)

IMG = 32
N_CLASSES = 5
JOIN_S = 120.0


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs files in parallel processes,
    and the replicas' threads share each one's pool; more threads only
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def jax_stub(params, x):
    """`tests/test_serve.py`'s stub: class = brightness bucket."""
    s = x.mean(axis=(1, 2, 3))
    return jax.nn.one_hot((s * 7).astype(jnp.int32) % N_CLASSES, N_CLASSES)


def torch_stub(x):
    """The same classifier in torch."""
    s = x.mean(dim=(1, 2, 3))
    return torch.nn.functional.one_hot(
        (s * 7).to(torch.int32).long() % N_CLASSES, N_CLASSES).float()


def make_images(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (n, 4, 4, 3)).astype(np.float32)
    return np.kron(base, np.ones((1, IMG // 4, IMG // 4, 1), np.float32))


def _serve_kw(**serve_kw):
    """A partial batch flushes at 0.01 of its 20 s budget: the stub's
    batches take milliseconds, and a loaded machine has 19 s to spare."""
    kw = dict(max_batch=4, bucket_sizes=(1, 2, 4), deadline_ms=20000.0,
              max_queue_depth=64, flush_fraction=0.01)
    kw.update(serve_kw)
    return kw


def make_service(tmp_path=None, prune="exact", **serve_kw):
    return CertifiedInferenceService(
        torch_stub, N_CLASSES, IMG, serve_cfg=ServeConfig(**_serve_kw(
            **serve_kw)),
        defense_cfg=DefenseConfig(ratios=(0.1,), chunk_size=64, prune=prune),
        result_dir=str(tmp_path / "serve") if tmp_path is not None else None,
        device="cpu")


def make_jax_service(prune="exact", **serve_kw):
    return jserve.CertifiedInferenceService(
        jax_stub, None, num_classes=N_CLASSES, img_size=IMG,
        serve_cfg=JServeConfig(**_serve_kw(**serve_kw)),
        defense_cfg=JDefenseConfig(ratios=(0.1,), chunk_size=64,
                                   prune=prune))


def _fire(svc, images, concurrency):
    """Closed-loop burst: `concurrency` in-flight callers over `images`."""
    results = [None] * len(images)
    nxt = {"i": 0}
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = nxt["i"]
                if i >= len(images):
                    return
                nxt["i"] = i + 1
            results[i] = svc.predict(images[i])

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return results


def _mixed_traffic(svc, images):
    """Lone requests (bucket 1), small bursts, saturating bursts."""
    return (_fire(svc, images[:2], 1) + _fire(svc, images[2:12], 3)
            + _fire(svc, images[12:], 8))


def _req(budget_s=10.0, image=None):
    now = time.perf_counter()
    return PendingRequest(image if image is not None else make_images(1)[0],
                          enqueued=now, deadline=now + budget_s)


def _events(tmp_path):
    with open(tmp_path / "serve" / "events.jsonl") as fh:
        return [json.loads(line) for line in fh]


# ---------- typed responses ----------

def test_typed_responses_to_dict_equal_jax():
    for mod in (tserve, jserve):
        assert mod.HTTP_STATUS == jserve.HTTP_STATUS
    args = [
        ("PredictResult", dict(
            prediction=3, certified=True, clean_prediction=2,
            verdicts=("V",), latency_ms=12.34567, bucket=8, batch_images=3,
            certify_forwards=700, certify_forward_equivalents=123.456)),
        ("PredictResult", dict(
            prediction=0, certified=False, clean_prediction=0,
            verdicts=(), latency_ms=1.0, bucket=1, batch_images=1)),
        ("Overloaded", dict(queue_depth=64, limit=64)),
        ("DeadlineExceeded", dict(latency_ms=2000.12345, deadline_ms=2000.0)),
        ("ServeError", dict(reason="bad", latency_ms=3.14159,
                            status="internal_error")),
        ("ServeError", dict(reason="image shape")),
    ]
    for name, kw in args:
        out = []
        for mod in (tserve, jserve):
            kw2 = dict(kw)
            if kw2.get("verdicts"):
                kw2["verdicts"] = (mod.RadiusVerdict(0.03, 3, True),
                                   mod.RadiusVerdict(0.12, 3, False))
            resp = getattr(mod, name)(**kw2)
            out.append((resp.status, json.dumps(resp.to_dict())))
        assert out[0] == out[1], name


# ---------- micro-batcher ----------

def test_size_triggered_flush():
    b = MicroBatcher((1, 2, 4), max_queue_depth=16)
    for _ in range(5):
        assert b.submit(_req(budget_s=60.0))
    t0 = time.perf_counter()
    batch = b.next_batch()
    assert time.perf_counter() - t0 < 20.0
    assert len(batch) == 4 and b.qsize() == 1


def test_deadline_triggered_flush():
    b = MicroBatcher((1, 2, 4), max_queue_depth=16)
    assert b.submit(_req(budget_s=2.0))
    t0 = time.perf_counter()
    batch = b.next_batch()
    elapsed = time.perf_counter() - t0
    # a lone request flushes once HALF its budget is spent
    assert len(batch) == 1
    assert 0.5 <= elapsed < 1.9, elapsed


def test_deadline_flush_not_head_of_line_blocked():
    b = MicroBatcher((1, 2, 8), max_queue_depth=16)
    assert b.submit(_req(budget_s=600.0))   # head alone flushes at +300 s
    assert b.submit(_req(budget_s=1.0))     # tail forces a flush at +0.5 s
    t0 = time.perf_counter()
    batch = b.next_batch()
    assert len(batch) == 2 and time.perf_counter() - t0 < 60.0


def test_backpressure_reject_and_close_drain():
    b = MicroBatcher((1, 2), max_queue_depth=2)
    assert b.submit(_req()) and b.submit(_req())
    assert not b.submit(_req())          # typed reject, nothing queued
    assert b.qsize() == 2
    b.close()
    assert not b.submit(_req())          # closed: no admission
    assert len(b.next_batch()) == 2      # drain flushes immediately
    assert b.next_batch() is None        # drained + closed -> worker exits
    with pytest.raises(ValueError):
        MicroBatcher((), 4)


def test_batcher_requeue_front_and_idle_tick():
    b = MicroBatcher((1, 2, 4), max_queue_depth=2)
    t0 = time.perf_counter()
    assert b.next_batch(timeout=0.1) == []
    assert 0.05 < time.perf_counter() - t0 < 30.0
    old = [_req(budget_s=60.0), _req(budget_s=60.0)]
    new = [_req(budget_s=60.0), _req(budget_s=60.0)]
    for r in new:
        assert b.submit(r)
    # failover requeue: jumps the FIFO, in order, exempt from the bound
    assert b.requeue(old)
    assert b.qsize() == 4
    assert b.next_batch() == old + new
    b.set_max_queue_depth(0)
    assert not b.submit(_req())
    b.close()
    assert not b.requeue(old)


def test_pending_request_claim_exactly_once():
    req = _req(budget_s=10.0)
    wins = []
    barrier = threading.Barrier(8)

    def racer(i):
        barrier.wait(timeout=30)
        if req.resolve(i):
            wins.append(i)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert len(wins) == 1
    assert req.done.is_set() and req.result == wins[0]
    assert not req.claim()


def test_launch_counts_from_8_threads_lose_none():
    """The kernel wrappers count from every replica's thread: 8 threads x
    20000 launches under two names and routes, none lost (unlocked, the
    route counts' read-modify-write loses some)."""
    _backend.reset_launch_counts()
    barrier = threading.Barrier(8)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as it can

    def worker(i):
        barrier.wait(timeout=30)
        for _ in range(20000):
            _backend.count_launch("masked_fill_fwd")
            _backend.count_launch("gn_relu_fwd", "one_pass" if i % 2
                                  else "split")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    counts, routes = _backend.launch_counts(), _backend.route_counts()
    _backend.reset_launch_counts()
    assert counts["masked_fill_fwd"] == counts["gn_relu_fwd"] == 160000
    assert routes == {"gn_relu_fwd/one_pass": 80000,
                      "gn_relu_fwd/split": 80000}


# ---------- the service against the JAX package's ----------

@pytest.mark.parametrize("prune", ["off", "exact", "consensus"])
def test_service_verdicts_equal_jax_service(prune, tmp_path):
    """52 mixed-size requests through both services: equal verdicts,
    forwards and forward equivalents request by request, all ok, and the
    port's shape budget (armed) unchanged by the traffic."""
    images = make_images(52, seed=7)
    images[5] = 0.5                     # a unanimous frame in the mix
    svc = make_service(tmp_path, prune=prune)
    with svc:
        assert svc.prune == prune
        warm = svc.trace_counts()
        got = _mixed_traffic(svc, images)
        after = svc.trace_counts()
        stats = svc.stats()
    jsvc = make_jax_service(prune=prune)
    with jsvc:
        jwarm = jsvc.trace_counts()
        want = _mixed_traffic(jsvc, images)
        jstats = jsvc.stats()
    assert after == warm and warm == jwarm
    assert all(isinstance(r, PredictResult) for r in got)
    for i, (g, w) in enumerate(zip(got, want)):
        gd, wd = g.to_dict(), w.to_dict()
        for k in ("latency_ms", "bucket", "batch_images"):
            gd.pop(k), wd.pop(k)
        assert gd == wd, f"request {i}"
    assert stats["completed"] == jstats["completed"] == 52
    assert stats["certify_forwards"] == jstats["certify_forwards"]
    assert set(stats) == set(jstats)
    # and equal to the port's own robust_predict on the same images
    pc = tdefense.PatchCleanser(torch_stub, tmasks.geometry(IMG, 0.1),
                                DefenseConfig(ratios=(0.1,), prune=prune),
                                device="cpu")
    recs = pc.robust_predict(torch.as_tensor(images), N_CLASSES)
    assert [(r.prediction, r.certified, r.certify_forwards) for r in got] \
        == [(int(r.prediction), bool(r.certification), int(r.forwards))
            for r in recs]


def test_stats_and_healthz_keys_equal_jax(tmp_path):
    svc = make_service(tmp_path, replicas=2)
    jsvc = make_jax_service(replicas=2)
    img = make_images(1)[0]
    with svc, jsvc:
        assert isinstance(svc.predict(img), PredictResult)
        assert isinstance(jsvc.predict(img), jserve.PredictResult)
        s, js = svc.stats(), jsvc.stats()
        h, jh = svc.healthz(), jsvc.healthz()
        assert svc.robustness() == jsvc.robustness()
    assert set(s) == set(js)
    assert set(s["replicas"][0]) == set(js["replicas"][0])
    assert set(s["certify_forwards"]) == set(js["certify_forwards"])
    assert h == jh
    assert svc.metrics.names() == jsvc.metrics.names()


def test_service_rejects_bad_input_overload_and_deadline(tmp_path):
    svc = make_service(max_batch=4, bucket_sizes=(4,), max_queue_depth=3,
                       flush_fraction=1.0)
    with svc:
        bad = svc.predict(np.zeros((8, 8, 3), np.float32))
        assert isinstance(bad, ServeError) and "shape" in bad.reason
        ragged = svc.predict([[1.0, [2.0]]])
        assert isinstance(ragged, ServeError) and ragged.status == "error"
        for v in (float("inf"), float("nan"), -5.0, 0.0):
            r = svc.predict(make_images(1)[0], deadline_ms=v)
            assert isinstance(r, ServeError) and "deadline_ms" in r.reason
        for _ in range(3):
            assert svc.batcher.submit(_req(budget_s=60.0))
        resp = svc.predict(make_images(1)[0])
        assert isinstance(resp, Overloaded)
        assert resp.limit == 3 and resp.queue_depth == 3
    s = svc.stats()
    assert s["rejected"] == 1 and s["errors"] == 6
    late = make_service(deadline_ms=0.001)
    with late:
        resp = late.predict(make_images(1)[0])
    assert isinstance(resp, DeadlineExceeded)
    assert late.stats()["deadline_exceeded"] == 1


def test_restart_after_stop_and_failed_start_unwinds(tmp_path, monkeypatch):
    svc = make_service()
    for _ in range(2):
        with svc:
            assert isinstance(svc.predict(make_images(1)[0]), PredictResult)
    assert svc.stats()["completed"] == 2

    from dorpatch_tpu_torch import observe

    def boom(self):
        raise RuntimeError("warmup boom")

    monkeypatch.setattr(CertifiedInferenceService, "warmup", boom)
    failing = make_service(tmp_path)
    with pytest.raises(RuntimeError, match="warmup boom"):
        failing.start()
    assert observe.active_event_log() is None
    assert observe.recompile_guard() is None
    failing.stop()


def test_start_sets_the_profiler_up_on_the_booting_thread(tmp_path,
                                                         monkeypatch):
    """`POST /profile` captures on an HTTP thread, so the profiler's first
    use is the booting thread's, before any replica thread runs; a service
    without a results dir captures nothing and skips it."""
    from dorpatch_tpu_torch import observe

    calls = []
    svc = make_service(tmp_path)
    monkeypatch.setattr(observe, "init_profiler", lambda: calls.append(
        (threading.get_ident(), svc._pool)))
    with svc:
        pass
    assert calls == [(threading.get_ident(), None)]
    with make_service():
        pass
    assert len(calls) == 1


def test_serve_raises_without_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CertifiedInferenceService(torch_stub, N_CLASSES, IMG)


# ---------- one real model ----------

def test_from_config_real_cifar_victim_matches_robust_predict(tmp_path):
    """`from_config` on the CIFAR ResNet-18 at 32 px on the CPU, buckets
    of 1, 2 requests: its verdicts equal the port's `robust_predict` on the
    same images (which tests/test_torch_defense.py holds to the JAX
    package). One radius on a 3x3 mask grid and chunk 8 keep the
    warmup's full-depth forwards within the CPU test's time."""
    from dorpatch_tpu_torch.cli import build_parser, config_from_args

    args = build_parser().parse_args([
        "--device", "cpu", "--synthetic", "--dataset", "cifar10",
        "--base_arch", "resnet18", "--img-size", "32",
        "--serve-max-batch", "1", "--serve-deadline-ms", "120000",
        "--results-root", str(tmp_path)])
    cfg = config_from_args(args)
    dcfg = DefenseConfig(ratios=(0.12,), num_mask_per_axis=3, chunk_size=8)
    cfg = dataclasses.replace(cfg, defense=dcfg)
    svc = CertifiedInferenceService.from_config(cfg)
    assert svc.bucket_sizes == (1,) and svc.incremental == "stem"
    images = make_images(2, seed=11)
    with svc:
        warm = svc.trace_counts()
        got = [svc.predict(im) for im in images]
        assert svc.trace_counts() == warm
    assert all(isinstance(r, PredictResult) for r in got)
    recs = svc.defenses[0].robust_predict(torch.as_tensor(images),
                                          svc.num_classes)
    for r, rec in zip(got, recs):
        assert (r.prediction, r.certified, r.certify_forwards) == \
            (int(rec.prediction), bool(rec.certification), int(rec.forwards))
    assert os.path.exists(tmp_path / "serve" / "metrics.json")
    manifest = json.load(open(tmp_path / "serve" / "run.json"))
    assert manifest["backend_impl"] == "torch"
    assert manifest["config"]["serve"]["max_batch"] == 1


def test_aot_auto_then_strict_answers_as_off(tmp_path):
    """The CIFAR ResNet-18 service of the test above with 2 replicas,
    booted `--aot off`, then `--aot auto` on an empty store (replica 0
    writes every program, replica 1 hits them all), then `--aot strict` on
    that store (0 misses): the same answers each time, and a strict boot
    on an empty store refuses before warmup."""
    from dorpatch_tpu_torch.aot import AotBootError
    from dorpatch_tpu_torch.cli import build_parser, config_from_args

    store = str(tmp_path / "store")
    images = make_images(2, seed=11)
    answers, stats = {}, {}
    for mode in ("off", "auto", "strict"):
        args = build_parser().parse_args([
            "--device", "cpu", "--synthetic", "--dataset", "cifar10",
            "--base_arch", "resnet18", "--img-size", "32",
            "--serve-max-batch", "1", "--serve-deadline-ms", "120000",
            "--serve-replicas", "2", "--aot", mode, "--aot-cache", store,
            "--results-root", str(tmp_path / mode)])
        cfg = dataclasses.replace(
            config_from_args(args),
            defense=DefenseConfig(ratios=(0.12,), num_mask_per_axis=3,
                                  chunk_size=8))
        svc = CertifiedInferenceService.from_config(cfg)
        with svc:
            got = [svc.predict(im) for im in images]
            stats[mode] = svc.stats()
            stats[mode]["boots"] = [r.aot_stats for r in svc._pool.replicas]
        answers[mode] = [(r.prediction, r.certified, r.certify_forwards)
                         for r in got]
    assert answers["auto"] == answers["strict"] == answers["off"]
    assert "aot" not in stats["off"]
    auto, strict = stats["auto"]["aot"], stats["strict"]["aot"]
    n = auto["builds"]
    assert n and auto["hits"] == 0 and auto["miss_reasons"] == {"absent": n}
    assert stats["auto"]["boots"][0] is auto
    assert stats["auto"]["boots"][1]["hits"] == n
    assert stats["auto"]["boots"][1]["misses"] == 0
    assert strict["hits"] == n and strict["misses"] == 0
    assert strict["methods"] == {"eager": n}       # the CPU captures nothing
    svc = CertifiedInferenceService.from_config(dataclasses.replace(
        cfg, aot=dataclasses.replace(cfg.aot, cache_dir=str(
            tmp_path / "empty"))))
    with pytest.raises(AotBootError):
        svc.start()
    assert not svc._warm


# ---------- the re-certification boot gate ----------

def _verdict_dir(tmp_path, status):
    rdir = tmp_path / f"recert_{status}"
    rdir.mkdir()
    if status != "absent":
        (rdir / "recert_verdict.json").write_text(json.dumps({
            "status": status, "generation": 3, "worst_margin": -4.0,
            "findings_by_rule": {"DP400": 1} if status == "failing" else {},
            "cells": {"cellA": {"status": "regressed" if status == "failing"
                                else "ok", "margin": -4.0}}}))
    return str(rdir)


@pytest.mark.parametrize("status", ["failing", "stale", "absent"])
def test_strict_recert_gate_refuses_before_any_model_is_built(
        tmp_path, monkeypatch, status):
    """`--require-recert strict` on a failing, stale or absent verdict
    raises `RecertGateError` in `from_config` before the model factory
    (`registry.get_model`) or the device is touched, and in the
    constructor before the defense bank is built; the message is the JAX
    gate's."""
    from dorpatch_tpu.recert.gate import RecertGateError as JaxGateError
    from dorpatch_tpu.recert.gate import boot_gate as jax_boot_gate
    from dorpatch_tpu_torch import utils
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.config import RecertConfig
    from dorpatch_tpu_torch.models import registry
    from dorpatch_tpu_torch.recert.gate import RecertGateError
    from dorpatch_tpu_torch.serve import service as service_mod

    rdir = _verdict_dir(tmp_path, status)
    calls = []
    monkeypatch.setattr(registry, "get_model",
                        lambda *a, **k: calls.append("get_model"))
    monkeypatch.setattr(utils, "resolve_device",
                        lambda *a, **k: calls.append("resolve_device"))
    monkeypatch.setattr(service_mod, "build_defenses",
                        lambda *a, **k: calls.append("build_defenses"))
    cfg = config_from_args(build_parser().parse_args([
        "--device", "cpu", "--dataset", "cifar10", "--base_arch",
        "resnet18", "--img-size", "32", "--results-root", str(tmp_path),
        "--recert-dir", rdir, "--require-recert", "strict"]))
    with pytest.raises(RecertGateError) as ei:
        CertifiedInferenceService.from_config(cfg)
    with pytest.raises(JaxGateError) as jei:
        jax_boot_gate(rdir, "strict")
    assert str(ei.value) == str(jei.value)
    with pytest.raises(RecertGateError):
        CertifiedInferenceService(
            torch_stub, N_CLASSES, IMG, serve_cfg=ServeConfig(
                **_serve_kw()), device="cpu",
            recert_cfg=RecertConfig(dir=rdir, require="strict"))
    assert calls == []


def test_warn_gate_serves_and_robustness_answers_200_only_on_ok(tmp_path):
    """`warn` on a failing verdict serves, carries the snapshot in
    `robustness()` and `stats()`, records `serve.recert_gate`, and `GET
    /robustness` answers 503 with the cells; `strict` on an ok verdict
    serves and answers 200. The snapshots equal the JAX service's."""
    import urllib.error
    import urllib.request

    from dorpatch_tpu.config import RecertConfig as JRecertConfig
    from dorpatch_tpu_torch.config import RecertConfig
    from dorpatch_tpu_torch.serve import HttpFrontend

    codes = {}
    for status, require in (("failing", "warn"), ("ok", "strict")):
        rdir = _verdict_dir(tmp_path, status)
        root = tmp_path / status
        svc = CertifiedInferenceService(
            torch_stub, N_CLASSES, IMG, serve_cfg=ServeConfig(**_serve_kw()),
            defense_cfg=DefenseConfig(ratios=(0.1,), chunk_size=64),
            result_dir=str(root), device="cpu",
            recert_cfg=RecertConfig(dir=rdir, require=require))
        jsvc = jserve.CertifiedInferenceService(
            jax_stub, None, num_classes=N_CLASSES, img_size=IMG,
            serve_cfg=JServeConfig(**_serve_kw()),
            defense_cfg=JDefenseConfig(ratios=(0.1,), chunk_size=64),
            recert_cfg=JRecertConfig(dir=rdir, require=require))
        with svc, jsvc, HttpFrontend(svc, "127.0.0.1", 0) as fe:
            assert isinstance(svc.predict(make_images(1)[0]), PredictResult)
            snap = svc.robustness()
            assert snap == jsvc.robustness()
            assert svc.stats()["robustness"] == jsvc.stats()["robustness"]
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{fe.port}/robustness",
                        timeout=30) as r:
                    codes[status] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as e:
                codes[status] = (e.code, json.loads(e.read()))
        assert snap["status"] == status and snap["require"] == require
        assert codes[status][1] == snap
        gate = [e for e in (json.loads(line) for line in
                            open(root / "events.jsonl"))
                if e.get("name") == "serve.recert_gate"]
        assert len(gate) == 1 and gate[0]["status"] == status
    assert codes["failing"][0] == 503 and codes["ok"][0] == 200
    assert codes["failing"][1]["cells"]["cellA"]["status"] == "regressed"
    plain = make_service()
    assert plain.robustness() == {"require": "off", "status": "unconfigured"}
