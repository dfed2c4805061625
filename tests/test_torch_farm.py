"""The port's attack-sweep farm (`dorpatch_tpu_torch.farm`): the contracts
of the JAX package's `tests/test_farm.py` (queue and lease protocol,
failure taxonomy, chaos, fleet report) with stub runners and injected
clocks, its JSON records byte-equal to the JAX package's, and one
SIGKILL crash-resume of the real sweep in worker subprocesses whose
resumed patch is bit-identical to an uninterrupted run."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from dorpatch_tpu_torch.config import (AttackConfig, ExperimentConfig,
                                       config_from_dict, config_to_dict)
from dorpatch_tpu_torch.farm.chaos import (Chaos, SimulatedPreemption,
                                           fault_seed, parse_faults)
from dorpatch_tpu_torch.farm.queue import (JobQueue, expand_grid, job_slug,
                                           retry_delay)
from dorpatch_tpu_torch.farm.report import (format_fleet_report,
                                            summarize_fleet)
from dorpatch_tpu_torch.farm.worker import (FarmWorker, apply_overrides,
                                            classify_failure, job_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPEC = {
    "base": {"dataset": "cifar10", "base_arch": "resnet18", "img_size": 32,
             "batch_size": 2, "synthetic_data": True},
    "axes": {"attack.patch_budget": [0.06, 0.12], "attack.dropout": [1, 2]},
    "max_attempts": 3,
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tests' small ops run in parallel test
    processes, whose threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _worker(farm_dir, runner, **kw):
    kw.setdefault("lease_ttl", 5.0)
    kw.setdefault("poll_interval", 0.02)
    kw.setdefault("heartbeat_interval", 0.2)
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_cap", 0.2)
    kw.setdefault("device", "cpu")
    return FarmWorker(str(farm_dir), runner=runner, **kw)


# ---------------- grid expansion / slugs / backoff ----------------


def test_expand_grid_deterministic_sorted_order():
    from dorpatch_tpu.farm.queue import expand_grid as jax_expand

    axes = {"b": [1, 2], "a": [0.1, 0.2]}
    grid = expand_grid(axes)
    assert grid == [
        {"a": 0.1, "b": 1}, {"a": 0.1, "b": 2},
        {"a": 0.2, "b": 1}, {"a": 0.2, "b": 2},
    ]
    assert expand_grid({}) == [{}]
    assert expand_grid(dict(reversed(list(axes.items())))) == grid
    assert grid == jax_expand(axes)


def test_job_slug_filesystem_safe():
    from dorpatch_tpu.farm.queue import job_slug as jax_slug

    params = {"attack.patch_budget": 0.06, "base_arch": "res/net 18"}
    slug = job_slug(params)
    assert "/" not in slug and " " not in slug
    assert "patch_budget=0.06" in slug
    assert len(job_slug({"k": "x" * 500})) <= 80
    assert slug == jax_slug(params)


def test_retry_delay_deterministic_exponential_capped():
    from dorpatch_tpu.farm.queue import retry_delay as jax_delay

    assert retry_delay("j", 1) == retry_delay("j", 1) == jax_delay("j", 1)
    assert retry_delay("j", 1) != retry_delay("other", 1)
    assert retry_delay("j", 1, base=2.0, cap=300.0, jitter=0.0) == 2.0
    assert retry_delay("j", 3, base=2.0, cap=300.0, jitter=0.0) == 8.0
    assert retry_delay("j", 50, base=2.0, cap=300.0, jitter=0.0) == 300.0
    assert 2.0 <= retry_delay("j", 1, base=2.0, jitter=0.25) <= 2.5


# ---------------- submit / job state ----------------


def test_submit_expands_grid_and_is_idempotent(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    ids = jq.submit_spec(SPEC)
    assert len(ids) == 4 and ids == sorted(ids)
    job = jq.read_job(ids[0])
    assert job["state"] == "pending" and job["attempts"] == 0
    assert job["params"] == {"attack.dropout": 1,
                             "attack.patch_budget": 0.06}
    jq.mark_running(dict(job), "w1")
    assert jq.submit_spec(SPEC) == ids
    assert jq.read_job(ids[0])["state"] == "running"
    assert jq.read_job(ids[0])["attempts"] == 1


def test_submit_records_byte_equal_to_jax(tmp_path):
    """`submit_spec` of one spec under one fixed clock writes `farm.json`
    and every `job.json` byte for byte as the JAX package's queue does;
    so do the state transitions and a lease."""
    from dorpatch_tpu.farm.queue import JobQueue as JaxQueue

    spec = dict(SPEC, sweep={"densities": [0.0], "defense_ratio": 0.06})
    farms = {}
    for name, cls in (("port", JobQueue), ("jax", JaxQueue)):
        clock = FakeClock(1234.5)
        q = cls(str(tmp_path / name), clock=clock)
        ids = q.submit_spec(spec)
        job = q.read_job(ids[1])
        job = q.mark_running(job, "w1")
        clock.now += 1.25
        q.mark_failed(job, {"kind": "io", "error": "x"}, next_retry_ts=7.0)
        q.mark_done(q.read_job(ids[2]), {"rows": 1})
        q.mark_quarantined(q.read_job(ids[3]), {"kind": "trace"})
        farms[name] = q
    files = ["farm.json"] + [
        os.path.join("jobs", j, "job.json")
        for j in farms["port"].job_ids()]
    assert farms["port"].job_ids() == farms["jax"].job_ids()
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    assert farms["port"].counts() == farms["jax"].counts()


def test_counts_and_drained(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    ids = jq.submit_spec(SPEC)
    c = jq.counts()
    assert c["total"] == 4 and c["pending"] == 4
    assert not jq.drained(c)
    for job_id in ids:
        job = jq.read_job(job_id)
        jq.mark_running(job, "w")
        jq.mark_done(job, {"rows": 1})
    c = jq.counts()
    assert c["done"] == 4 and jq.drained(c)


def test_job_config_applies_base_and_axes(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    ids = jq.submit_spec(SPEC)
    cfg = job_config(jq.read_job(ids[-1]))
    assert cfg.dataset == "cifar10" and cfg.synthetic_data
    assert cfg.attack.patch_budget == 0.12 and cfg.attack.dropout == 2


def test_apply_overrides_dotted_and_unknown():
    cfg = ExperimentConfig()
    out = apply_overrides(cfg, {"attack.patch_budget": 0.3, "batch_size": 7,
                                "attack.dropout_sizes": [0.05, 0.1]})
    assert out.attack.patch_budget == 0.3 and out.batch_size == 7
    assert out.attack.dropout_sizes == (0.05, 0.1)
    with pytest.raises(TypeError):
        apply_overrides(cfg, {"attack.no_such_field": 1})
    with pytest.raises(ValueError):
        apply_overrides(cfg, {"attack.lr.inner": 1})


@pytest.mark.parametrize("key", [
    {"backend": "torch"}, {"gn_impl": "auto"}, {"mesh_data": 2},
    {"mesh_mask": 1}, {"sanitize": True}, {"aot": {}}, {"recert": {}},
    {"gateway": {}}, {"attack": {"use_pallas": "auto"}},
    {"attack": {"remat": "on"}}, {"attack": {"remat_threshold": 512}},
    {"attack": {"remat_policy": "full"}}, {"defense": {"use_pallas": "on"}}])
def test_config_from_dict_refuses_not_ported_keys_by_name(key):
    """The JAX package's keys of the subsystems the port lacks are refused
    by name; `recert`, `gateway`, `sanitize` and the attack's `remat`,
    `remat_threshold` and `remat_policy`, ported, are accepted and read
    back as the JAX package reads them."""
    ported_attack = {"remat", "remat_threshold", "remat_policy"}
    if set(key) & {"recert", "gateway", "sanitize"} or \
            set(key.get("attack", {})) & ported_attack:
        from dorpatch_tpu.config import config_from_dict as jax_from_dict
        from dorpatch_tpu.config import config_to_dict as jax_to_dict

        (name,) = key
        got = config_to_dict(config_from_dict(key))[name]
        want = jax_to_dict(jax_from_dict(key))[name]
        if name == "attack":
            got = {k: got[k] for k in key[name]}
            want = {k: want[k] for k in key[name]}
        assert got == want
        return
    with pytest.raises(ValueError, match="not ported"):
        config_from_dict(key)


def test_config_from_dict_roundtrip_and_unknown_keys():
    cfg = ExperimentConfig(
        batch_size=3, stream_depth=0, carry_checkpoints=True,
        attack=AttackConfig(dropout_sizes=(0.06,), report_interval=5))
    back = config_from_dict(json.loads(json.dumps(config_to_dict(cfg))))
    assert back == cfg
    with pytest.raises(ValueError, match="unknown ExperimentConfig keys"):
        config_from_dict({"no_such_key": 1})
    with pytest.raises(ValueError, match="unknown AttackConfig keys"):
        config_from_dict({"attack": {"lr_typo": 1}})
    # the farm's spec dicts read the same in both packages
    from dorpatch_tpu.config import config_from_dict as jax_from_dict

    spec_base = dict(SPEC["base"], attack={"sampling_size": 4,
                                           "dropout_sizes": [0.06]},
                     farm={"lease_ttl": 9.0})
    port, jax = config_from_dict(spec_base), jax_from_dict(spec_base)
    assert port.attack.dropout_sizes == jax.attack.dropout_sizes == (0.06,)
    assert port.farm == ExperimentConfig().farm.__class__(lease_ttl=9.0)
    assert port.stream_depth == jax.stream_depth == 2
    for f in ("lease_ttl", "heartbeat_interval", "max_attempts",
              "backoff_base", "backoff_cap", "backoff_jitter",
              "poll_interval", "chaos"):
        assert getattr(port.farm, f) == getattr(jax.farm, f), f
    for f in ("trace_dir", "heartbeat_interval", "hang_timeout",
              "carry_checkpoints", "metrics_log"):
        assert getattr(ExperimentConfig(), f) == \
            getattr(type(jax)(), f), f
    assert AttackConfig().report_interval == jax.attack.report_interval


# ---------------- lease protocol ----------------


def test_lease_claim_is_exclusive_and_releasable(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 1})
    assert jq.try_claim_lease(job_id, "wA", ttl=60.0)
    assert not jq.try_claim_lease(job_id, "wB", ttl=60.0)
    assert jq.owns_lease(job_id, "wA") and not jq.owns_lease(job_id, "wB")
    assert jq.renew_lease(job_id, "wA", 60.0)
    assert not jq.renew_lease(job_id, "wB", 60.0)
    jq.release_lease(job_id, "wB")  # not the owner: must be a no-op
    assert jq.owns_lease(job_id, "wA")
    jq.release_lease(job_id, "wA")
    assert jq.read_lease(job_id) is None


def _beat(hb, ts, seq):
    with open(hb, "a") as fh:
        fh.write(json.dumps({"ts": ts, "seq": seq, "phase": "x"}) + "\n")


def test_stale_lease_reclaimed_via_heartbeat(tmp_path):
    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    hb = str(tmp_path / "hb.jsonl")
    _beat(hb, 1000.0, 0)
    job = jq.claim("wA", ttl=10.0, heartbeat_path=hb)
    assert job is not None and job["state"] == "leased"
    jq.mark_running(job, "wA")
    clock.now = 1005.0
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1012.0
    _beat(hb, 1011.0, 1)
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1030.0
    reclaimed = jq.claim("wB", ttl=10.0)
    assert reclaimed is not None and reclaimed["id"] == job_id
    assert reclaimed["worker"] == "wB" and reclaimed["reclaims"] == 1


def test_stale_lease_without_heartbeat_uses_expires_ts(tmp_path):
    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    jq.submit_spec({"axes": {}, "max_attempts": 3})
    assert jq.claim("wA", ttl=10.0) is not None
    clock.now = 1009.0
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1011.0
    reclaimed = jq.claim("wB", ttl=10.0)
    assert reclaimed is not None and reclaimed["worker"] == "wB"


def test_lease_skew_stale_heartbeat_beats_future_expires_ts(tmp_path):
    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    hb = str(tmp_path / "hb.jsonl")
    _beat(hb, 1000.0, 0)
    assert jq.claim("wA", ttl=10.0, heartbeat_path=hb) is not None
    assert jq.renew_lease(job_id, "wA", 10_000.0)
    clock.now = 1020.0
    reclaimed = jq.claim("wB", ttl=10.0)
    assert reclaimed is not None and reclaimed["worker"] == "wB"


def test_lease_skew_future_heartbeat_beats_lapsed_expires_ts(tmp_path):
    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    hb = str(tmp_path / "hb.jsonl")
    _beat(hb, 1000.0, 0)
    assert jq.claim("wA", ttl=10.0, heartbeat_path=hb) is not None
    clock.now = 1015.0
    _beat(hb, 1018.0, 1)
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1040.0
    reclaimed = jq.claim("wB", ttl=10.0)
    assert reclaimed is not None and reclaimed["id"] == job_id


def test_lease_seq_advance_keeps_behind_skewed_worker_alive(tmp_path):
    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    hb = str(tmp_path / "hb.jsonl")
    _beat(hb, 995.0, 0)
    assert jq.claim("wA", ttl=10.0, heartbeat_path=hb) is not None
    clock.now = 1005.0
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1012.0
    _beat(hb, 1000.0, 1)
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1020.0
    _beat(hb, 1005.0, 2)
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1035.0
    reclaimed = jq.claim("wB", ttl=10.0)
    assert reclaimed is not None and reclaimed["worker"] == "wB"


def test_lease_frozen_seq_with_future_ts_goes_stale(tmp_path):
    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    hb = str(tmp_path / "hb.jsonl")
    _beat(hb, 1000.0, 0)
    assert jq.claim("wA", ttl=10.0, heartbeat_path=hb) is not None
    clock.now = 1005.0
    assert jq.claim("wB", ttl=10.0) is None
    _beat(hb, 1020.0, 1)
    clock.now = 1010.0
    assert jq.claim("wB", ttl=10.0) is None
    clock.now = 1025.0
    reclaimed = jq.claim("wB", ttl=10.0)
    assert reclaimed is not None and reclaimed["worker"] == "wB"


def test_corrupt_lease_is_reclaimable(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 1})
    with open(jq.lease_path(job_id), "w") as fh:
        fh.write('{"worker": "wA", "expi')
    assert jq.try_claim_lease(job_id, "wB", ttl=60.0)
    assert jq.owns_lease(job_id, "wB")


def test_concurrent_claims_are_disjoint(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    ids = jq.submit_spec(SPEC)
    claimed, lock = [], threading.Lock()
    barrier = threading.Barrier(4)

    def contend(worker_id):
        q = JobQueue(str(tmp_path / "farm"))
        barrier.wait()
        while True:
            job = q.claim(worker_id, ttl=60.0)
            if job is None:
                return
            with lock:
                claimed.append((worker_id, job["id"]))

    threads = [threading.Thread(target=contend, args=(f"w{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(j for _, j in claimed) == ids


def test_claim_after_a_stale_read_of_a_finished_job_is_refused(
        tmp_path, monkeypatch):
    """The race behind the JAX package's flaky two-worker drain, made
    deterministic: worker B reads job.json while A still runs the job; A
    commits `done` and releases its lease; B then wins the (now free)
    lease. B must re-read under the lease and let the job be, instead of
    running it a second time."""
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    job = jq.claim("wA", ttl=60.0)
    running = jq.mark_running(job, "wA")
    stale = dict(running)
    jq.mark_done(running, {"rows": 1})
    jq.release_lease(job_id, "wA")
    qb = JobQueue(str(tmp_path / "farm"))
    reads = []
    real = qb.read_job

    def read_job(jid):
        reads.append(jid)
        return dict(stale) if len(reads) == 1 else real(jid)

    monkeypatch.setattr(qb, "read_job", read_job)
    assert qb.claim("wB", ttl=60.0) is None
    assert jq.read_job(job_id)["state"] == "done"
    assert jq.read_lease(job_id) is None


def test_a_lease_being_written_is_never_taken_over(tmp_path, monkeypatch):
    """A contender that looks while the winner writes its lease must not
    read a half-written lease as corrupt and take it over: exactly one of
    the two claims wins, and the lease names it."""
    from dorpatch_tpu_torch.farm import queue as farm_queue

    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 1})
    qb = JobQueue(str(tmp_path / "farm"))
    real, won = json.dump, {}

    def dump(obj, fh, *args, **kw):
        if isinstance(obj, dict) and obj.get("worker") == "wA" \
                and "wB" not in won:
            won["wB"] = None  # B looks once, while A writes
            won["wB"] = qb.try_claim_lease(job_id, "wB", ttl=60.0)
        return real(obj, fh, *args, **kw)

    monkeypatch.setattr(farm_queue.json, "dump", dump)
    won["wA"] = jq.try_claim_lease(job_id, "wA", ttl=60.0)
    assert sorted(won.values()) == [False, True]
    winner = [w for w, ok in won.items() if ok][0]
    assert jq.read_lease(job_id)["worker"] == winner


def test_stale_lease_taken_over_by_one_of_two_contenders(tmp_path,
                                                         monkeypatch):
    """Two contenders judge one lease stale; B takes it over between A's
    read and A's rename. A must put B's fresh lease back and lose."""
    from dorpatch_tpu_torch.farm import queue as farm_queue

    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    assert jq.try_claim_lease(job_id, "w0", ttl=10.0)
    clock.now = 1020.0
    qa = JobQueue(str(tmp_path / "farm"), clock=clock)
    qb = JobQueue(str(tmp_path / "farm"), clock=clock)
    real, won = farm_queue.load_json, {}

    def load_json(path, default=None):
        out = real(path, default)
        if path == qa.lease_path(job_id) and "wB" not in won:
            won["wB"] = None  # B takes over once, after A's read
            won["wB"] = qb.try_claim_lease(job_id, "wB", ttl=10.0)
        return out

    monkeypatch.setattr(farm_queue, "load_json", load_json)
    won["wA"] = qa.try_claim_lease(job_id, "wA", ttl=10.0)
    assert won == {"wB": True, "wA": False}
    assert jq.read_lease(job_id)["worker"] == "wB"


# ---------------- retry / quarantine state machine ----------------


def test_failed_respects_backoff_then_exhausts(tmp_path):
    clock = FakeClock(1000.0)
    jq = JobQueue(str(tmp_path / "farm"), clock=clock)
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 2})
    job = jq.mark_running(jq.claim("wA", ttl=60.0), "wA")
    jq.mark_failed(job, {"kind": "io"}, next_retry_ts=1050.0)
    jq.release_lease(job_id, "wA")
    assert jq.counts()["failed_retryable"] == 1
    assert jq.claim("wB", ttl=60.0) is None
    clock.now = 1051.0
    job = jq.claim("wB", ttl=60.0)
    assert job is not None
    job = jq.mark_running(job, "wB")
    assert job["attempts"] == 2
    jq.mark_failed(job, {"kind": "io"}, next_retry_ts=1100.0)
    jq.release_lease(job_id, "wB")
    c = jq.counts()
    assert c["failed_exhausted"] == 1 and jq.drained(c)
    clock.now = 2000.0
    assert jq.claim("wC", ttl=60.0) is None


def test_classify_failure_taxonomy():
    from dorpatch_tpu_torch.observe import RecompileBudgetExceeded

    assert classify_failure(SimulatedPreemption("x")) == ("preemption", True)
    assert classify_failure(MemoryError()) == ("oom", True)
    assert classify_failure(torch.cuda.OutOfMemoryError("CUDA out of "
                                                        "memory")) == \
        ("oom", True)
    assert classify_failure(OSError(28, "no space")) == ("io", True)
    assert classify_failure(FloatingPointError("nan")) == ("nan", False)
    for exc in (TypeError("t"), ValueError("v"), KeyError("k"),
                AttributeError("a"), IndexError("i")):
        assert classify_failure(exc) == ("trace", False)
    assert classify_failure(RuntimeError("???")) == ("unknown", True)
    assert classify_failure(RecompileBudgetExceeded("x")) == \
        ("recompile", False)


def test_worker_quarantines_deterministic_failure(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})

    def bad_runner(job, ctx):
        raise ValueError("shape mismatch in trace")

    summary = _worker(tmp_path / "farm", bad_runner).run()
    assert summary["quarantined"] == 1 and summary["done"] == 0
    job = jq.read_job(job_id)
    assert job["state"] == "quarantined" and job["attempts"] == 1
    failure = job["failures"][-1]
    assert failure["kind"] == "trace" and not failure["transient"]
    assert "ValueError" in failure["error"]
    assert "bad_runner" in failure["traceback"]
    assert jq.read_lease(job_id) is None


def test_job_naming_a_not_ported_key_is_quarantined(tmp_path):
    """A spec whose base names a JAX-only key fails its job as a
    deterministic configuration error, recorded by name, before any
    model is built; it is never silently dropped."""
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"base": dict(SPEC["base"], gn_impl="auto"),
                                "axes": {}, "max_attempts": 3})
    summary = _worker(tmp_path / "farm", None).run()
    assert summary["quarantined"] == 1
    failure = jq.read_job(job_id)["failures"][-1]
    assert failure["kind"] == "trace" and "not ported" in failure["error"]
    assert "gn_impl" in failure["error"]


def test_sigusr2_sets_the_profiler_up_on_the_main_thread(tmp_path,
                                                        monkeypatch):
    """SIGUSR2 captures on a thread of its own, so its handler, which runs
    on the main thread, is the profiler's first use; the capture thread
    records into the running job's event log."""
    from dorpatch_tpu_torch import observe

    calls, done = [], threading.Event()
    monkeypatch.setattr(observe, "init_profiler", lambda: calls.append(
        ("init", threading.get_ident())))

    def capture(out_dir, duration_s):
        calls.append(("capture", threading.get_ident(),
                      observe.active_event_log()))
        done.set()

    monkeypatch.setattr(observe, "capture_profile", capture)
    JobQueue(str(tmp_path / "farm"))
    worker = _worker(tmp_path / "farm", None)
    prev = worker._install_profile_signal()
    elog = observe.EventLog(str(tmp_path / "events.jsonl"), run_id="r")
    try:
        with observe.active_in_thread(elog):
            os.kill(os.getpid(), signal.SIGUSR2)
            assert done.wait(30)
    finally:
        signal.signal(signal.SIGUSR2, prev)
        elog.close()
    main = threading.main_thread().ident
    assert calls[0] == ("init", main)
    assert calls[1][0] == "capture" and calls[1][1] != main
    assert calls[1][2] is elog


def test_worker_retries_transient_until_exhausted(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 2})

    def flaky_runner(job, ctx):
        raise OSError(28, "disk full")

    summary = _worker(tmp_path / "farm", flaky_runner).run()
    assert summary["failed"] == 2
    job = jq.read_job(job_id)
    assert job["state"] == "failed" and job["exhausted"]
    assert job["attempts"] == 2 and len(job["failures"]) == 2


def test_worker_two_workers_drain_disjointly(tmp_path):
    """Two workers on threads drain the farm, each job run exactly once.
    Holds whatever the interleaving: a claimer re-reads the job under
    its lease (the stale-read test above pins that race)."""
    jq = JobQueue(str(tmp_path / "farm"))
    ids = jq.submit_spec(SPEC)
    ran, lock = [], threading.Lock()

    def runner(job, ctx):
        with lock:
            ran.append(job["id"])
        return {"rows": 1}

    workers = [_worker(tmp_path / "farm", runner, worker_id=w)
               for w in ("wA", "wB")]
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(ran) == ids
    c = jq.counts()
    assert c["done"] == 4 and jq.drained(c)


def test_many_workers_drain_each_job_exactly_once():
    """Stress: more worker threads than cores on instant jobs, with a
    shortened switch interval; every job runs exactly once, and every
    worker ends within its join timeout."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        jq = JobQueue(os.path.join(d, "farm"))
        ids = jq.submit_spec({"axes": {"seed": list(range(24))},
                              "max_attempts": 1})
        ran, lock = [], threading.Lock()

        def runner(job, ctx):
            with lock:
                ran.append(job["id"])
            return {"rows": 1}

        workers = [_worker(os.path.join(d, "farm"), runner,
                           worker_id=f"w{i}", poll_interval=0.005)
                   for i in range(2 * (os.cpu_count() or 4))]
        threads = [threading.Thread(target=w.run) for w in workers]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert sorted(ran) == ids
        assert jq.counts()["done"] == len(ids)


def test_cuda_worker_without_a_gpu_refuses_before_claiming(tmp_path,
                                                           monkeypatch):
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 1})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _worker(tmp_path / "farm", lambda job, ctx: {}, device="cuda").run()
    assert jq.read_job(job_id)["state"] == "pending"


# ---------------- chaos harness ----------------


def test_fault_seed_deterministic_and_equal_to_jax():
    from dorpatch_tpu.chaos import fault_seed as jax_seed

    assert fault_seed("0001-x", "crash_block") == \
        jax_seed("0001-x", "crash_block")
    assert fault_seed("0001-x", "crash_block") != \
        fault_seed("0002-y", "crash_block")
    assert fault_seed("0001-x", "crash_block") != \
        fault_seed("0001-x", "ckpt_raise")


def test_parse_faults_farm_and_rejects_unknown():
    assert parse_faults("crash_block, ckpt_raise") == ("crash_block",
                                                       "ckpt_raise")
    assert parse_faults("wedge_heartbeat,enospc_events") == (
        "wedge_heartbeat", "enospc_events")
    with pytest.raises(ValueError, match="unknown chaos fault"):
        parse_faults("crash_block,typo_fault")
    from dorpatch_tpu.chaos import parse_faults as jax_parse_faults

    for fault in ("recert_kill_cycle", "recert_torn_state", "wedge_probe",
                  "poison_canary"):
        assert parse_faults(fault) == jax_parse_faults(fault) == (fault,)


def test_chaos_ordinals_equal_jax(tmp_path):
    from dorpatch_tpu.chaos import Chaos as JaxChaos

    for job_id in ("0000", "0001-patch_budget=0.06", "0003-x"):
        c = Chaos(("crash_block",), job_id, str(tmp_path))
        j = JaxChaos(("crash_block",), job_id, str(tmp_path))
        for name in ("crash_block_ordinal", "events_write_budget",
                     "ckpt_raise_ordinal"):
            assert getattr(c, name)() == getattr(j, name)(), name


def test_chaos_fires_exactly_once_across_instances(tmp_path):
    d = str(tmp_path / "job")
    c1 = Chaos(("ckpt_raise",), "0000", d)
    assert c1.fire_once("ckpt_raise")
    assert not c1.fire_once("ckpt_raise")
    c2 = Chaos(("ckpt_raise",), "0000", d)
    assert c2.fired("ckpt_raise")
    assert not c2.fire_once("ckpt_raise")
    assert not c1.fire_once("enospc_events")


def test_chaos_crash_raise_at_seeded_block(tmp_path):
    c = Chaos(("crash_block",), "0000", str(tmp_path / "job"),
              crash_mode="raise")
    ordinal = c.crash_block_ordinal()
    for n in range(ordinal):
        c.on_block(0, n)
    with pytest.raises(SimulatedPreemption):
        c.on_block(0, ordinal)
    c2 = Chaos(("crash_block",), "0000", str(tmp_path / "job"),
               crash_mode="raise")
    for n in range(5):
        c2.on_block(0, n)


def test_chaos_ckpt_proxy_raises_enospc_once(tmp_path):
    class FakeCk:
        def __init__(self):
            self.saves = []

        def save(self, *a):
            self.saves.append(a)

        def latest_step_info(self):
            return None

    c = Chaos(("ckpt_raise",), "0000", str(tmp_path / "job"))
    inner = FakeCk()
    proxy = c.wrap_checkpointer(inner)
    errors = 0
    for i in range(4):
        try:
            proxy.save(0, i, "state")
        except OSError as e:
            assert e.errno == 28
            errors += 1
    assert errors == 1 and len(inner.saves) == 3
    assert proxy.latest_step_info() is None
    assert c.wrap_checkpointer(inner) is inner


def test_worker_chaos_crash_raise_then_retry_to_done(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})

    def runner(job, ctx):
        for i in range(4):
            ctx.on_block_end(0, i, {})
        return {"rows": 1}

    summary = _worker(tmp_path / "farm", runner, chaos="crash_block",
                      crash_mode="raise").run()
    assert summary["failed"] == 1 and summary["done"] == 1
    job = jq.read_job(job_id)
    assert job["state"] == "done" and job["attempts"] == 2
    assert job["failures"][0]["kind"] == "preemption"
    assert os.path.exists(os.path.join(jq.job_dir(job_id),
                                       "chaos_crash_block.fired"))


def test_worker_chaos_enospc_events_never_fatal(tmp_path):
    jq = JobQueue(str(tmp_path / "farm"))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 2})

    def runner(job, ctx):
        from dorpatch_tpu_torch import observe

        for i in range(12):
            with observe.span("farm.step", i=i):
                pass
        return {"rows": 1}

    summary = _worker(tmp_path / "farm", runner,
                      chaos="enospc_events").run()
    assert summary["done"] == 1
    assert jq.read_job(job_id)["state"] == "done"


def test_worker_wedge_heartbeat_job_reclaimed_by_healthy_worker(tmp_path):
    """A live-zombie worker (heartbeat wedged, process alive) loses its
    lease to a contender and abandons the job without committing state;
    a healthy worker then drains it. The queues' clocks are injected: the
    thief claims at a time past the zombie's lease, and the healthy worker
    past the thief's."""
    farm = tmp_path / "farm"
    clock = FakeClock(1000.0)
    jq = JobQueue(str(farm))
    (job_id,) = jq.submit_spec({"axes": {}, "max_attempts": 3})
    contender = JobQueue(str(farm), clock=clock)

    def runner(job, ctx):
        ctx.on_block_end(0, 0, {})  # wedge fires: beats freeze here
        clock.now = 1000.0 + 3600.0
        # the thief has seen the frozen beat once; an hour later it is
        # still frozen
        contender.lease_fresh(contender.read_lease(job["id"]))
        clock.now += 3600.0
        stolen = contender.claim("wThief", ttl=0.2)
        assert stolen is not None and stolen["worker"] == "wThief"
        ctx.on_block_end(0, 1, {})  # renewal sees the thief -> LeaseLost
        raise AssertionError("unreachable: lease loss must abort the job")

    wedged = _worker(farm, runner, worker_id="wZ", chaos="wedge_heartbeat",
                     lease_ttl=0.3, heartbeat_interval=0.05)
    summary_z = wedged.run()
    assert summary_z["abandoned"] == 1 and summary_z.get("wedged") is True
    assert jq.read_job(job_id)["worker"] == "wThief"

    later = FakeClock(clock.now + 3600.0)   # the thief's lease has expired
    healthy = _worker(farm, lambda job, ctx: {"rows": 1}, worker_id="wH",
                      lease_ttl=5.0, clock=later)
    healthy.run()
    job = jq.read_job(job_id)
    assert job["state"] == "done" and job["worker"] == "wH"
    assert job["reclaims"] >= 1


# ---------------- fleet report ----------------


def _run_fleet(tmp_path):
    farm = str(tmp_path / "farm")
    jq = JobQueue(farm)
    jq.submit_spec(SPEC)

    def runner(job, ctx):
        for i in range(3):
            ctx.on_block_end(0, i, {"stopped": False})
        if job["params"]["attack.dropout"] == 2 \
                and job["params"]["attack.patch_budget"] == 0.12:
            raise ValueError("bad grid point")
        from dorpatch_tpu_torch.sweep import append_row

        append_row(ctx.result_dir, {
            "patch_budget": job["params"]["attack.patch_budget"],
            "density": 0.0, "structured": 1e-3,
            "robust_accuracy": 50.0, "certified_asr_pc": 25.0,
            "asr": 50.0, "point": 0,
        })
        return {"rows": 1}

    _worker(tmp_path / "farm", runner, chaos="crash_block",
            crash_mode="raise").run()
    return farm, jq


def test_summarize_fleet_accounting(tmp_path):
    farm, jq = _run_fleet(tmp_path)
    fleet = summarize_fleet(farm)
    assert fleet["counts"]["done"] == 3
    assert fleet["counts"]["quarantined"] == 1
    assert fleet["retries"] >= 1
    assert fleet["failures_by_kind"].get("trace") == 1
    assert fleet["failures_by_kind"].get("preemption", 0) >= 1
    assert len(fleet["quarantined"]) == 1
    assert "ValueError" in fleet["quarantined"][0]["error"]
    assert len(fleet["points"]) == 3
    done = [j for j in fleet["jobs"] if j["state"] == "done"]
    assert all(j["run_ids"] for j in done)
    crashed = [j for j in fleet["jobs"] if j["attempts"] > 1]
    assert crashed and len(crashed[0]["run_ids"]) == crashed[0]["attempts"]
    # the port's workers record a block event per attack block: the
    # crashed job's second attempt re-ran its first blocks
    assert fleet["step_time"]["reexecuted_blocks"] >= 1
    assert summarize_fleet(str(tmp_path)) is None


def test_jax_fleet_report_reads_the_port_farm(tmp_path):
    """`dorpatch_tpu.farm.report.summarize_fleet` on the port's farm
    directory equals the port's summary, and renders the same text."""
    from dorpatch_tpu.farm.report import format_fleet_report as jax_format
    from dorpatch_tpu.farm.report import summarize_fleet as jax_summarize

    farm, _ = _run_fleet(tmp_path)
    ours = summarize_fleet(farm)
    assert jax_summarize(farm) == ours
    assert jax_format(ours) == format_fleet_report(ours)


def test_format_fleet_report_sections(tmp_path):
    farm, _ = _run_fleet(tmp_path)
    text = format_fleet_report(summarize_fleet(farm))
    assert "= DorPatch attack-sweep farm report =" in text
    assert "-- farm --" in text and "-- jobs --" in text
    assert "-- robust accuracy --" in text
    assert "quarantined" in text and "robust acc 50.0%" in text


def test_fleet_report_torn_rows_render_as_holes(tmp_path):
    farm, jq = _run_fleet(tmp_path)
    done = [j for j in jq.job_ids() if jq.read_job(j)["state"] == "done"]
    with open(os.path.join(jq.job_dir(done[0]), "results", "rows.jsonl"),
              "a") as fh:
        fh.write('{"patch_budget": 0.06, "robust_acc')
    os.remove(os.path.join(jq.job_dir(done[1]), "results", "rows.jsonl"))
    fleet = summarize_fleet(farm)
    by_id = {j["id"]: j for j in fleet["jobs"]}
    assert by_id[done[0]]["torn_rows"] == 1
    assert by_id[done[1]]["rows"] == 0
    text = format_fleet_report(fleet)
    assert "1 torn" in text
    assert "HOLE" in text and done[1] in text


def test_farm_cli_submit_status_report(tmp_path, capsys):
    from dorpatch_tpu_torch.farm.__main__ import main as farm_main

    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(SPEC))
    farm = str(tmp_path / "farm")
    assert farm_main(["submit", farm, "--spec", str(spec_path)]) == 0
    assert farm_main(["status", farm]) == 0
    out = capsys.readouterr().out
    assert '"jobs": 4' in out and '"pending": 4' in out
    assert farm_main(["report", farm]) == 0
    assert "-- farm --" in capsys.readouterr().out
    assert farm_main(["report", farm, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["counts"]["pending"] == 4
    assert farm_main(["report", str(tmp_path)]) == 1


# ---------------- SIGKILL crash-resume, end to end ----------------

#: the worker subprocess: the farm CLI on a shallow (one block a stage)
#: full-width CIFAR ResNet-18, one torch thread
_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from dorpatch_tpu_torch.models import registry
    from dorpatch_tpu_torch.models.small import CifarResNet18
    _, init = registry._FAMILIES["cifar_resnet18"]
    registry._FAMILIES["cifar_resnet18"] = (
        lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
        init)
    from dorpatch_tpu_torch.farm.__main__ import main
    sys.exit(main(sys.argv[1:]))
""")
ATTACK = {"sampling_size": 4, "max_iterations": 4, "sweep_interval": 2,
          "switch_iteration": 2, "dropout": 1, "dropout_sizes": [0.06],
          "basic_unit": 4}
BASE = {"dataset": "cifar10", "base_arch": "resnet18", "img_size": 32,
        "batch_size": 2, "synthetic_data": True, "attack": ATTACK,
        "model_dir": "/nonexistent"}
SWEEP = {"densities": [0.0], "structureds": [1e-3], "defense_ratio": 0.06}
SUBPROCESS_TIMEOUT = 240


def _work(farm, worker_id, *extra):
    return [sys.executable, "-c", _WORKER, "work", farm, "--device", "cpu",
            "--worker-id", worker_id, "--lease-ttl", "5",
            "--heartbeat-interval", "0.25", "--poll-interval", "0.25",
            "--backoff-base", "0.5", "--backoff-cap", "2.0", *extra]


def test_sigkill_crash_resume_is_bit_identical(tmp_path, monkeypatch):
    """The JAX package's `tools/farm_smoke.py`, ported: a chaos worker
    SIGKILLs itself at its seeded block (after that block's snapshot);
    two healthy workers drain the farm, one reclaiming the dead worker's
    job and resuming it from the snapshot; its patch equals an
    uninterrupted `run_sweep` of the same point in this process, bit for
    bit, and the fleet report carries the retry."""
    from dorpatch_tpu_torch.models import registry
    from dorpatch_tpu_torch.models.small import CifarResNet18
    from dorpatch_tpu_torch.sweep import run_sweep

    farm = str(tmp_path / "farm")
    jq = JobQueue(farm)
    ids = jq.submit_spec({"base": BASE,
                          "axes": {"attack.patch_budget": [0.08, 0.12]},
                          "sweep": SWEEP, "max_attempts": 3})
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    killer = subprocess.run(
        _work(farm, "wKill", "--chaos", "crash_block", "--crash-mode",
              "kill", "--max-jobs", "1"),
        env=env, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert killer.returncode == -signal.SIGKILL, killer.stderr[-2000:]
    killed = jq.read_job(ids[0])
    assert (killed["state"], killed["attempts"]) == ("running", 1)
    ck_root = os.path.join(jq.job_dir(ids[0]), "checkpoints", "carry_0")
    assert os.listdir(ck_root)

    drainers = [subprocess.Popen(_work(farm, w), env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for w in ("wA", "wB")]
    try:
        for proc in drainers:
            out, _ = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
            assert proc.returncode == 0, out[-2000:]
    finally:
        for proc in drainers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert jq.counts()["done"] == len(ids)
    killed = jq.read_job(ids[0])
    assert (killed["attempts"], killed["reclaims"]) == (2, 1)
    assert killed["result"]["resumed_points"] == 1
    rows = [json.loads(line) for line in open(os.path.join(
        jq.job_dir(ids[0]), "results", "rows.jsonl"))]
    assert rows[0]["resumed_from_iteration"] > 0

    _, init = registry._FAMILIES["cifar_resnet18"]
    monkeypatch.setitem(
        registry._FAMILIES, "cifar_resnet18",
        (lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
         init))
    control = str(tmp_path / "control")
    cfg = job_config(jq.read_job(ids[0]))
    run_sweep(dataclasses.replace(cfg, device="cpu"),
              patch_budgets=(0.08,), densities=(0.0,), structureds=(1e-3,),
              defense_ratio=0.06, verbose=False, result_dir=control)
    result_dir = os.path.join(jq.job_dir(ids[0]), "results")
    for name in ("point_000_mask.npy", "point_000_pattern.npy"):
        np.testing.assert_array_equal(
            np.load(os.path.join(result_dir, name)),
            np.load(os.path.join(control, name)))

    fleet = summarize_fleet(farm)
    assert fleet["retries"] >= 1 and fleet["reclaims"] >= 1
    text = format_fleet_report(fleet)
    assert "resumed" in text and "-- robust accuracy --" in text

