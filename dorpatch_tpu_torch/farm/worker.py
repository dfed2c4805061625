"""Farm worker: claim -> run -> commit, with typed failure handling.

Port of `dorpatch_tpu.farm.worker`. A worker is a plain process over the
shared farm directory, running its jobs on one device (`device`: "cuda"
unless the caller asks for "cpu"; a CUDA worker without a GPU raises before
it claims anything). Per claimed job it wires the observability and
recovery stack the pipeline uses (the `run.json` manifest with the attempt
chain in `previous_run_ids`, the job's `events.jsonl` with a `block` record
per attack block, carry checkpoints at block boundaries), then runs the
job's grid slice through `sweep.run_sweep`.

Failure taxonomy (`classify_failure`):

- *transient* (CUDA and host out-of-memory, IO/ENOSPC, preemption,
  unclassified runtime errors, a kernel that failed to build or launch):
  the job returns to `failed` with exponential backoff + deterministic
  jitter and is retried until `max_attempts`; its checkpoints survive, so a
  retry resumes rather than restarts.
- *deterministic* (shape or configuration errors, a config key that is not
  ported, NaN, shape-budget violations): retrying would fail identically,
  so the job is quarantined at once with the traceback in `job.json`.

No fallback hides a fault: a kernel that fails fails the job, and the
failure is classified and recorded; nothing reruns on a plain version.

AOT: with `aot_store` (and `aot_mode` "auto") the worker installs the
store's read-only `aot.FirstCallAotResolver` before its first claim: each
program's first call of a new signature is looked up by fingerprint, a hit
replays a captured graph from the next call on, a miss runs as it would
without a store; the store is never written. `workers/<id>/aot.json`
holds the resolver's hits and misses for the fleet report.

Lease discipline: the lease is renewed at every attack-block boundary, and
every commit re-checks ownership: a worker that lost its lease (wedged
heartbeat, reclaimed job) abandons silently; the reclaimer owns the state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

from dorpatch_tpu_torch import checkpoint, observe
from dorpatch_tpu_torch.config import ExperimentConfig, config_from_dict
from dorpatch_tpu_torch.farm import queue as farm_queue
from dorpatch_tpu_torch.farm.chaos import (Chaos, SimulatedPreemption,
                                           parse_faults)


class LeaseLost(RuntimeError):
    """This worker's lease was reclaimed mid-run; the job is no longer ours
    to execute or to commit state for."""


def classify_failure(exc: BaseException) -> Tuple[str, bool]:
    """(kind, transient). Unclassified errors count as transient: wrongly
    retrying a deterministic bug costs `max_attempts - 1` wasted runs before
    the job parks as exhausted, while wrongly quarantining a transient blip
    silently loses a finishable job; the cheaper mistake wins."""
    import torch

    if isinstance(exc, SimulatedPreemption):
        return "preemption", True
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom", True
    if isinstance(exc, OSError):
        return "io", True
    if type(exc).__name__ == "RecompileBudgetExceeded":
        return "recompile", False
    if isinstance(exc, FloatingPointError):
        return "nan", False
    if isinstance(exc, (TypeError, ValueError, KeyError, AttributeError,
                        IndexError)):
        return "trace", False  # shape/config programming errors
    return "unknown", True


def apply_overrides(cfg: ExperimentConfig, params: Dict) -> ExperimentConfig:
    """Dotted job-axis overrides onto a config: ``"attack.patch_budget"``
    reaches into the nested dataclass, bare keys hit `ExperimentConfig`
    itself. Unknown fields raise (dataclasses.replace) -> deterministic
    quarantine, which is right for a typo'd spec axis."""
    for key in sorted(params):
        value = params[key]
        if isinstance(value, list):
            value = tuple(value)
        if "." in key:
            head, field = key.split(".", 1)
            if "." in field:
                raise ValueError(f"axis {key!r}: at most one dot")
            sub = dataclasses.replace(getattr(cfg, head), **{field: value})
            cfg = dataclasses.replace(cfg, **{head: sub})
        else:
            cfg = dataclasses.replace(cfg, **{key: value})
    return cfg


def job_config(job: Dict) -> ExperimentConfig:
    """The job's resolved config: partial base dict (defaults fill the
    rest) + this job's grid-point overrides."""
    return apply_overrides(config_from_dict(dict(job.get("base", {}))),
                           job.get("params", {}))


@dataclasses.dataclass
class JobContext:
    """Everything a runner needs beyond the job dict, explicit so tests can
    substitute a stub runner with no model cost."""

    result_dir: str
    checkpoint_root: str
    chaos: Optional[Chaos]
    on_block_end: Optional[Callable[[int, int, dict], None]]
    checkpointer_factory: Optional[Callable[[int, Dict], object]]
    device: str = "cuda"


def default_runner(job: Dict, ctx: JobContext) -> Dict:
    """Run the job's grid slice via `sweep.run_sweep` on the worker's
    device, with the crash-resume wiring attached (incremental rows,
    per-point carry checkpoints, the lease/chaos block hook)."""
    from dorpatch_tpu_torch.sweep import run_sweep  # lazy: the model stack

    cfg = dataclasses.replace(job_config(job), device=ctx.device)
    sweep_kw = dict(job.get("sweep", {}))
    rows = run_sweep(
        cfg,
        patch_budgets=tuple(sweep_kw.get("patch_budgets",
                                         (cfg.attack.patch_budget,))),
        densities=tuple(sweep_kw.get("densities", (cfg.attack.density,))),
        structureds=tuple(sweep_kw.get("structureds",
                                       (cfg.attack.structured,))),
        defense_ratio=float(sweep_kw.get("defense_ratio", 0.06)),
        verbose=False,
        result_dir=ctx.result_dir,
        checkpointer_factory=ctx.checkpointer_factory,
        on_block_end=ctx.on_block_end,
    )
    return {
        "rows": len(rows),
        "resumed_points": sum(
            1 for r in rows if "resumed_from_iteration" in r),
    }


class FarmWorker:
    """One worker process's claim-and-run loop over a farm directory."""

    def __init__(self, farm_dir: str, worker_id: Optional[str] = None,
                 lease_ttl: float = 60.0,
                 backoff_base: float = 2.0, backoff_cap: float = 300.0,
                 backoff_jitter: float = 0.25, poll_interval: float = 1.0,
                 heartbeat_interval: float = 1.0, chaos: str = "",
                 crash_mode: str = "kill",
                 runner: Optional[Callable[[Dict, JobContext], Dict]] = None,
                 clock=time.time, sleep=time.sleep, device: str = "cuda",
                 aot_store: str = "", aot_mode: str = "auto"):
        # one registry per worker process: the queue's claim/reclaim
        # tallies, the drain loop's outcome counters, and the heartbeat's
        # live `jobs_*` fields all read/write the same series
        self.metrics = observe.MetricRegistry()
        self.queue = farm_queue.JobQueue(farm_dir, clock=clock,
                                         metrics=self.metrics)
        self.worker_id = worker_id or f"w{os.getpid()}"
        self.lease_ttl = float(lease_ttl)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.backoff_jitter = float(backoff_jitter)
        self.poll_interval = float(poll_interval)
        self.heartbeat_interval = float(heartbeat_interval)
        self.chaos_faults = parse_faults(chaos) if chaos else ()
        self.crash_mode = crash_mode
        self.runner = runner if runner is not None else default_runner
        self.device = device
        self.aot_store = aot_store
        self.aot_mode = aot_mode
        self._clock = clock
        self._sleep = sleep
        self.worker_dir = os.path.join(self.queue.farm_dir, "workers",
                                       self.worker_id)
        self.heartbeat_path = os.path.join(self.worker_dir,
                                           observe.heartbeat_filename(0))
        self._phase = "idle"
        self._heartbeat: Optional[observe.Heartbeat] = None
        self._m_jobs = self.metrics.counter(
            "farm_jobs_total", help="handled jobs by terminal outcome")
        self._m_retries = self.metrics.counter(
            "farm_job_retries_total",
            help="claims of a job that had already been attempted")

    # ---------------- the drain loop ----------------

    def _beat_extra(self) -> Dict:
        """Live job counters folded into every heartbeat beat, so `farm
        report` shows fleet throughput while workers are still running."""
        m = self.metrics
        return {
            "jobs_done": int(m.value("farm_jobs_total", outcome="done")),
            "jobs_failed": int(m.value("farm_jobs_total", outcome="failed")),
            "jobs_quarantined": int(
                m.value("farm_jobs_total", outcome="quarantined")),
            "jobs_abandoned": int(
                m.value("farm_jobs_total", outcome="abandoned")),
            "jobs_claimed": int(m.value("farm_jobs_claimed_total")),
            "jobs_reclaimed": int(m.value("farm_jobs_reclaimed_total")),
        }

    def _install_profile_signal(self):
        """SIGUSR2 -> bounded on-demand `torch.profiler` capture into the
        worker dir, without interrupting the job (the capture runs on its
        own thread). Returns the previous handler, or None when not
        installable (a worker driven from a non-main thread)."""
        def _handler(signum, frame):
            # the handler runs on the main thread, where the profiler's
            # first use must be (a no-op after the first signal)
            observe.init_profiler()
            elog = observe.active_event_log()  # the running job's log

            def capture():
                with observe.active_in_thread(elog):
                    observe.capture_profile(self.worker_dir, duration_s=1.0)

            threading.Thread(target=capture, name="farm-profile",
                             daemon=True).start()

        try:
            return signal.signal(signal.SIGUSR2, _handler)
        except ValueError:
            return None

    def run(self, max_jobs: Optional[int] = None) -> Dict:
        """Claim and run jobs until the queue is drained (or `max_jobs`
        handled). Polls while other workers hold live leases: their jobs
        become claimable here the moment their heartbeats go stale."""
        from dorpatch_tpu_torch import utils

        utils.resolve_device(self.device)  # no GPU: raise before claiming
        os.makedirs(self.worker_dir, exist_ok=True)
        summary = {"worker": self.worker_id, "done": 0, "failed": 0,
                   "quarantined": 0, "abandoned": 0}
        resolver = prev_resolver = None
        if self.aot_store and self.aot_mode != "off":
            # installed BEFORE the first claim: the first program call of
            # the first job is already warm-boot eligible
            try:
                from dorpatch_tpu_torch.aot.boot import FirstCallAotResolver
                from dorpatch_tpu_torch.aot.store import open_readonly

                store = open_readonly(self.aot_store, device=self.device)
                if store is not None:
                    resolver = FirstCallAotResolver(store)
            except Exception:
                resolver = None  # warm boot is an optimization, never a gate
            if resolver is not None:
                prev_resolver = observe.aot_resolver()
                observe.set_aot_resolver(resolver)
        prev_sig = self._install_profile_signal()
        heartbeat = observe.Heartbeat(
            self.heartbeat_path, get_phase=lambda: self._phase,
            interval=self.heartbeat_interval, clock=self._clock,
            extra=self._beat_extra)
        with heartbeat:
            self._heartbeat = heartbeat
            try:
                while True:
                    if max_jobs is not None and sum(
                            summary[k] for k in
                            ("done", "failed", "quarantined", "abandoned")
                    ) >= max_jobs:
                        break
                    job = self.queue.claim(self.worker_id, self.lease_ttl,
                                           self.heartbeat_path)
                    if job is None:
                        counts = self.queue.counts()
                        if self.queue.drained(counts):
                            break
                        self._sleep(self.poll_interval)
                        continue
                    if int(job.get("attempts", 0)) > 0:
                        self._m_retries.inc()
                    outcome = self.run_one(job)
                    summary[outcome] += 1
                    self._m_jobs.inc(outcome=outcome)
                    if (outcome == "abandoned" and self.chaos_faults
                            and "wedge_heartbeat" in self.chaos_faults):
                        # our beats stopped: every lease we'd take is born
                        # stale; stop claiming instead of thrashing jobs
                        # back and forth with the healthy workers
                        summary["wedged"] = True
                        break
            finally:
                self._heartbeat = None
                if prev_sig is not None:
                    try:
                        signal.signal(signal.SIGUSR2, prev_sig)
                    except ValueError:
                        pass
                if resolver is not None:
                    observe.set_aot_resolver(prev_resolver)
                    summary["aot"] = dict(resolver.stats)
                    # per-worker hit counts for the fleet report
                    checkpoint.atomic_write_json(
                        os.path.join(self.worker_dir, "aot.json"),
                        {"worker": self.worker_id, **resolver.stats})
                self._count_launches()
                self.metrics.dump(
                    os.path.join(self.worker_dir, "metrics.json"))
        summary["counts"] = self.queue.counts()
        return summary

    def _count_launches(self) -> None:
        """This process's kernel launches (`ops.launch_counts`) as the
        `kernel_launches_total{kernel=...}` counter of the worker's
        `metrics.json`: how a reader outside the process sees which
        kernels the worker's jobs ran."""
        from dorpatch_tpu_torch import ops

        c = self.metrics.counter(
            "kernel_launches_total",
            help="CUDA kernel launches of this worker process, by kernel")
        for name, n in sorted(ops.launch_counts().items()):
            if n:
                c.inc(n, kernel=name)

    # ---------------- one job ----------------

    def run_one(self, job: Dict) -> str:
        """Execute one claimed job to a single outcome: ``done``,
        ``failed`` (transient, retryable), ``quarantined`` (deterministic),
        or ``abandoned`` (lease lost: the reclaimer owns the state)."""
        jq = self.queue
        job_id = job["id"]
        job_dir = jq.job_dir(job_id)
        result_dir = os.path.join(job_dir, "results")
        checkpoint_root = os.path.join(job_dir, "checkpoints")
        chaos = None
        if self.chaos_faults:
            chaos = Chaos(self.chaos_faults, job_id, job_dir,
                          crash_mode=self.crash_mode).bind(self._heartbeat)
        jq.mark_running(job, self.worker_id)
        self._phase = f"job/{job_id}"
        run_id = observe.new_run_id()
        # the job's cross-process correlation id, minted at the claim:
        # every record of this attempt carries it
        trace_id = observe.new_trace_id()
        try:
            os.makedirs(result_dir, exist_ok=True)
            cfg = dataclasses.replace(job_config(job), device=self.device)
            observe.write_run_manifest(
                result_dir, cfg, run_id=run_id,
                extra={"farm": {"job": job_id, "worker": self.worker_id,
                                "attempt": job["attempts"],
                                "trace": trace_id}})

            def on_block(stage: int, iteration: int,
                         info: Optional[dict] = None) -> None:
                # the block's `block` record first (its carry snapshot is
                # saved): the fleet report's useful-vs-re-executed seconds
                elog = observe.active_event_log()
                if elog is not None:
                    elog.block_boundary(stage, iteration, info)
                if chaos is not None:
                    chaos.on_block(stage, iteration, info)
                if not jq.renew_lease(job_id, self.worker_id,
                                      self.lease_ttl):
                    raise LeaseLost(f"lease on {job_id} reclaimed mid-run")

            def checkpointer_factory(point: int, point_params: Dict):
                from dorpatch_tpu_torch.checkpoint import CarryCheckpointer

                # the fingerprint is attempt-independent: a retry must
                # restore the previous attempt's snapshots
                ck = CarryCheckpointer(
                    os.path.join(checkpoint_root, f"carry_{point}"),
                    fingerprint={"job": job_id, "point": int(point),
                                 **{k: float(v)
                                    for k, v in point_params.items()}})
                return (chaos.wrap_checkpointer(ck) if chaos is not None
                        else ck)

            ctx = JobContext(result_dir=result_dir,
                             checkpoint_root=checkpoint_root, chaos=chaos,
                             on_block_end=on_block,
                             checkpointer_factory=checkpointer_factory,
                             device=self.device)
            event_log = observe.EventLog(
                os.path.join(result_dir, observe.events_filename(0)),
                run_id=run_id)
            if chaos is not None:
                chaos.wrap_event_log(event_log)
            # this thread's sink, not the process's: workers on threads
            # of one process must not install or restore each other's
            with contextlib.closing(event_log), \
                    observe.active_in_thread(event_log):
                observe.record_event("farm.job.claim", job=job_id,
                                     worker=self.worker_id,
                                     attempt=job["attempts"],
                                     trace=trace_id, opens_trace=True)
                with observe.span("farm.job", job=job_id,
                                  attempt=job["attempts"], trace=trace_id):
                    result = self.runner(job, ctx)
        except LeaseLost:
            observe.log(f"worker {self.worker_id}: abandoned {job_id} "
                        "(lease reclaimed)")
            return "abandoned"
        except Exception as exc:
            return self._commit_failure(job, exc)
        finally:
            self._phase = "idle"
        if not jq.owns_lease(job_id, self.worker_id):
            observe.log(f"worker {self.worker_id}: finished {job_id} but "
                        "the lease moved on; abandoning the commit")
            return "abandoned"
        jq.mark_done(job, result if isinstance(result, dict) else {})
        jq.release_lease(job_id, self.worker_id)
        observe.log(f"worker {self.worker_id}: {job_id} done "
                    f"(attempt {job['attempts']})")
        return "done"

    def _commit_failure(self, job: Dict, exc: Exception) -> str:
        jq = self.queue
        job_id = job["id"]
        kind, transient = classify_failure(exc)
        if not jq.owns_lease(job_id, self.worker_id):
            return "abandoned"
        failure = {
            "attempt": int(job["attempts"]),
            "kind": kind,
            "transient": transient,
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc(),
            "worker": self.worker_id,
            "ts": round(self._clock(), 3),
        }
        if not transient:
            jq.mark_quarantined(job, failure)
            outcome = "quarantined"
        else:
            delay = farm_queue.retry_delay(
                job_id, int(job["attempts"]), base=self.backoff_base,
                cap=self.backoff_cap, jitter=self.backoff_jitter)
            jq.mark_failed(job, failure,
                           next_retry_ts=self._clock() + delay)
            outcome = "failed"
        jq.release_lease(job_id, self.worker_id)
        observe.log(f"worker {self.worker_id}: {job_id} {outcome} "
                    f"({kind}: {exc})")
        return outcome
