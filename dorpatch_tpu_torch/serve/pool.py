"""Supervised replica pool: N worker threads, health, failover, restarts.

Port of `dorpatch_tpu.serve.pool`. The replicas share ONE micro-batcher
queue and one card:

- **Replica** — one worker thread plus everything it exclusively owns: its
  own defense bank (`build_defenses`, so the engines' lazily filled plans
  and the programs' shape budgets stay per replica), its own CUDA stream
  (`torch.cuda.Stream`, entered for the whole worker loop; the kernel
  wrappers launch on the current stream), a manual-beat heartbeat (what
  proves liveness is the *beat*, not the thread object), and the in-flight
  batch it is currently answering. The replicas share the victim's weights
  read-only, under `torch.no_grad()`.
- **Supervisor** — a thread that classifies sick replicas by TYPE:
  `wedged` (thread alive, beats stale — a stuck device call),
  `raised` (thread died on an escaped exception, a kernel that failed to
  build or launch included), `recompile_budget` (a program ran a shape
  outside its warmed buckets). A sick replica's in-flight requests are
  re-dispatched to the healthy replicas at most once each, inside their
  original deadlines — `PendingRequest.claim()` makes a late answer from
  the sick replica a shed duplicate, never a double answer.
- **Restarts** — quarantined replicas are rebuilt, AOT-booted (with a
  store: the entries the first boot wrote, so a restart replays graphs)
  and warmed through `service._build_bank` after the shared
  `backoff.retry_delay` wait; the restart record carries the boot's hits
  and misses; a
  replica that exhausts `max_restarts` retires and the pool degrades
  gracefully: admission (`max_queue_depth`) shrinks with the healthy
  fraction so clients see `Overloaded` sooner, and the LAST retirement
  drains the queue with typed errors — the service never hangs, it only
  shrinks.

Replica state machine: healthy -> sick -> quarantined -> (restarting ->
healthy)* -> retired. Telemetry: `serve.replica.{start,sick,quarantine,
restart,retire}` events (the JAX package's records), per-replica
occupancy/latency/trace counts in `/stats`.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, List, Optional

import torch

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.backoff import retry_delay
from dorpatch_tpu_torch.serve.types import DeadlineExceeded, ServeError

# replica lifecycle states (see module docstring)
STATES = ("healthy", "sick", "quarantined", "restarting", "retired")


class ReplicaHeartbeat(observe.Heartbeat):
    """Manual-beat heartbeat for one replica worker thread.

    No daemon thread: the worker loop itself beats at batch boundaries and
    idle wakeups, so a wedged dispatch stops the beats — the missed-beat
    staleness signal the supervisor reads.
    Keeps the last beat on the service's monotonic clock for the
    supervisor's cheap in-process staleness reads; the optional JSONL file
    (`heartbeat_r<slot>.jsonl` under the results dir) is the post-mortem
    artifact, the format of every other heartbeat."""

    def __init__(self, path: Optional[str], slot: int, clock):
        super().__init__(path, interval=3600.0, process_index=slot)
        self._mono = clock
        self.last = clock()
        self.last_phase = "init"

    def mark(self, phase: str) -> None:
        if self._wedged:  # a wedged heartbeat freezes; the thread may live
            return
        self.last = self._mono()
        self.last_phase = phase
        self.beat(phase)

    def stale_s(self, now: float) -> float:
        return now - self.last


class Replica:
    """One worker loop's exclusive state. The lifecycle fields below carry
    `# guarded-by: self.lock` contracts: every mutation — worker batch
    bookkeeping AND the supervisor's state transitions — holds `lock`, so
    a `/stats` snapshot mid-transition reads a consistent (state,
    generation, restarts) triple instead of a torn one. `stream` is the
    replica's CUDA stream (None on the CPU)."""

    def __init__(self, slot: int, clean, defenses, heartbeat: ReplicaHeartbeat,
                 stream=None, aot_stats: Optional[dict] = None):
        self.slot = int(slot)
        self.generation = 0  # guarded-by: self.lock
        self.state = "healthy"  # guarded-by: self.lock
        self.restarts = 0  # guarded-by: self.lock
        self.clean = clean
        self.defenses = defenses
        self.hb = heartbeat
        self.stream = stream
        #: this generation's AOT warm boot (None without a store)
        self.aot_stats = aot_stats
        self.thread: Optional[threading.Thread] = None
        self.lock = threading.Lock()
        self.inflight: List[Any] = []  # guarded-by: self.lock
        self.fail_kind: Optional[str] = None
        self.fail_error: Optional[str] = None
        self.restart_at: Optional[float] = None
        # per-replica accounting lives in the service's metric registry
        # (`serve_replica_*_total{replica=...}` series), not here: one
        # registry feeds /stats, /metrics, and the report CLI identically

    def begin_batch(self, reqs: List[Any]) -> None:
        with self.lock:
            self.inflight = list(reqs)

    def end_batch(self) -> None:
        with self.lock:
            self.inflight = []

    def take_inflight(self) -> List[Any]:
        with self.lock:
            reqs, self.inflight = self.inflight, []
            return reqs

    def thread_alive(self) -> bool:
        t = self.thread
        return t is not None and t.is_alive()


class ReplicaPool:
    """Owns the replicas, their worker threads, and the supervisor; the
    `CertifiedInferenceService` delegates dispatch/health/stats here and
    keeps the client API, program building, and telemetry contract."""

    def __init__(self, service, chaos=None):
        self.svc = service
        self.cfg = service.serve_cfg
        self.batcher = service.batcher
        self._clock = service._clock
        self._chaos = chaos
        self.replicas: List[Replica] = []  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        self._base_depth = service.batcher.max_queue_depth
        # staleness threshold: a healthy batch must finish well inside the
        # request deadline (the batcher flushes at flush_fraction of it),
        # so a replica silent for a full deadline is stuck, not slow
        stale = float(getattr(self.cfg, "replica_stale_s", 0.0) or 0.0)
        self.stale_after_s = (stale if stale > 0.0
                              else max(self.cfg.deadline_ms / 1e3, 0.5))
        self.poll_s = max(0.05, self.stale_after_s / 4.0)

    # failover totals live in the service registry (single source of truth
    # for /stats, /metrics, and the report CLI); these properties keep the
    # pool's historical read surface
    @property
    def redispatched(self) -> int:
        return int(self.svc.metrics.value("serve_failover_redispatched_total"))

    @property
    def duplicates_shed(self) -> int:
        return int(self.svc.metrics.value("serve_duplicates_shed_total"))

    def _replica_event(self, event: str, r: Replica) -> None:
        """Lifecycle tally: `serve_replica_events_total{event,replica}` —
        the counted twin of the `serve.replica.*` event-log records."""
        self.svc.metrics.counter(
            "serve_replica_events_total",
            help="replica lifecycle transitions by kind",
        ).inc(event=event, replica=str(r.slot))

    # ---------------- lifecycle ----------------

    def _hb_path(self, slot: int) -> Optional[str]:
        if not self.svc.result_dir:
            return None
        return os.path.join(self.svc.result_dir, f"heartbeat_r{slot}.jsonl")

    def start(self) -> "ReplicaPool":
        n = max(1, int(getattr(self.cfg, "replicas", 1)))
        # replica 0 adopts the service's own bank and stream — the ones
        # `start()` already warmed
        r0 = Replica(0, self.svc._clean, self.svc.defenses,
                     ReplicaHeartbeat(self._hb_path(0), 0, self._clock),
                     stream=self.svc._stream, aot_stats=self.svc._aot_stats)
        # build the full roster locally, publish once under the lock: the
        # supervisor and /stats iterate a complete, never-mutated list
        replicas = [r0]
        for slot in range(1, n):
            clean, defenses, stream, aot_stats = self.svc._build_bank(slot)
            replicas.append(
                Replica(slot, clean, defenses,
                        ReplicaHeartbeat(self._hb_path(slot), slot,
                                         self._clock),
                        stream=stream, aot_stats=aot_stats))
        with self._lock:
            self.replicas = replicas
        for r in self.replicas:
            self._launch(r)
            self._replica_event("start", r)
            observe.record_event("serve.replica.start", replica=r.slot,
                                 generation=r.generation,
                                 aot=bool(r.aot_stats))
        self._supervisor = threading.Thread(target=self._supervise,
                                            name="serve-supervisor",
                                            daemon=True)
        self._supervisor.start()
        return self

    def _launch(self, replica: Replica) -> None:
        replica.thread = threading.Thread(
            target=self._worker_main, args=(replica,),
            name=f"serve-worker-r{replica.slot}g{replica.generation}",
            daemon=True)
        replica.thread.start()

    def begin_stop(self) -> None:
        """Stop supervising BEFORE the batcher closes: draining workers
        exit their loops naturally and must not be classified as failures."""
        self._stop_evt.set()

    def stopping(self) -> bool:
        """True from `begin_stop()` on — the drain window where the HTTP
        frontend answers `/stats` and `/metrics` with a typed 503 instead
        of racing a half-stopped service."""
        return self._stop_evt.is_set()

    def join(self, timeout_s: float) -> bool:
        """Join the current-generation worker threads (abandoned wedged
        generations died to the supervisor long ago and are daemon
        threads); True when every live worker drained in time."""
        sup = self._supervisor
        if sup is not None:
            sup.join(timeout=5.0)
        deadline = self._clock() + max(timeout_s, 0.0)
        for r in self.replicas:
            t = r.thread
            if t is None or not t.is_alive():
                continue
            t.join(timeout=max(deadline - self._clock(), 0.0))
        return not any(r.thread_alive() for r in self.replicas)

    def still_draining(self) -> List[int]:
        return [r.slot for r in self.replicas if r.thread_alive()]

    # ---------------- health ----------------

    def worker_alive(self) -> bool:
        return any(r.thread_alive() for r in self.replicas)

    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas
                   if r.state == "healthy" and r.thread_alive())

    def serving_possible(self) -> bool:
        """False only when NO replica could ever answer again: everything
        alive is gone and no restart is pending — the client's wait loop
        fails fast instead of sleeping out its deadline."""
        if self._stop_evt.is_set():
            return self.worker_alive()
        for r in self.replicas:
            if r.state == "healthy" and r.thread_alive():
                return True
            if r.state in ("sick", "restarting"):
                return True
            if r.state == "quarantined":
                return True
        return False

    # ---------------- worker ----------------

    def _worker_main(self, replica: Replica) -> None:
        gen = replica.generation
        # grad mode is per thread: the worker computes no gradient; its
        # kernels launch on the replica's own stream
        stream = (torch.cuda.stream(replica.stream)
                  if replica.stream is not None else contextlib.nullcontext())
        try:
            with torch.no_grad(), stream:
                self._worker_loop(replica, gen)
        except BaseException as e:  # thread is dying: record WHY for triage
            if replica.generation == gen:  # zombies don't smear the fresh one
                replica.fail_error = repr(e)
                replica.fail_kind = (
                    "recompile_budget"
                    if type(e).__name__ == "RecompileBudgetExceeded"
                    else "raised")

    def _worker_loop(self, replica: Replica, gen: int) -> None:
        while True:
            if replica.generation == gen:
                replica.hb.mark("idle")
            batch = self.batcher.next_batch(timeout=self.poll_s)
            if batch is None:
                return  # closed and drained
            if not batch:
                continue  # idle tick: beat and re-wait
            if replica.generation != gen or replica.state != "healthy":
                # a stale generation waking up, or a replica the supervisor
                # already declared sick, must not keep taking work — hand
                # the batch straight back to the healthy pool
                if not self.batcher.requeue(batch):
                    self._reject_all(batch, "replica quarantined")
                return
            replica.begin_batch(batch)
            replica.hb.mark("batch")
            if self._chaos is not None:
                # chaos sits OUTSIDE the per-batch guard: `raise_in_worker`
                # must escape and kill the thread, `wedge_dispatch` freezes
                # right here with the batch in-flight and unresolved
                self._chaos.on_serve_batch(replica.slot, replica.hb)
            try:
                self.svc._run_batch(batch, replica)
            except Exception as e:
                self.svc._fail_batch(batch, e, replica)
                if type(e).__name__ == "RecompileBudgetExceeded":
                    # a budget trip is structural (a shape leak) — the
                    # replica dies for the supervisor to classify and
                    # restart rather than looping on it
                    raise
            finally:
                replica.end_batch()
            replica.hb.mark("idle")

    def _reject_all(self, reqs: List[Any], reason: str) -> None:
        now = self._clock()
        won = [r for r in reqs if r.claim()]
        for r in won:
            observe.record_event("serve.request", status="internal_error",
                                 latency_s=round(now - r.enqueued, 6),
                                 trace=r.trace_id)
        self.svc._m_requests.inc(len(won), status="internal_error")
        for r in won:
            r.deliver(ServeError(reason=reason,
                                 latency_ms=(now - r.enqueued) * 1e3,
                                 status="internal_error"))

    # ---------------- supervisor ----------------

    def _supervise(self) -> None:
        interval = max(0.05, self.stale_after_s / 5.0)
        while not self._stop_evt.wait(interval):
            now = self._clock()
            for r in self.replicas:
                try:
                    if r.state == "healthy":
                        self._check_replica(r, now)
                    elif (r.state == "quarantined"
                            and r.restart_at is not None
                            and now >= r.restart_at):
                        with r.lock:
                            r.state = "restarting"
                        threading.Thread(
                            target=self._restart, args=(r,),
                            name=f"serve-restart-r{r.slot}",
                            daemon=True).start()
                except Exception as e:
                    # the supervisor must never die to one replica's
                    # bookkeeping; telemetry the failure and keep watching
                    observe.record_event("serve.supervisor_error",
                                         replica=r.slot, error=repr(e))

    def _check_replica(self, r: Replica, now: float) -> None:
        if not r.thread_alive():
            kind = r.fail_kind or "raised"
            self._mark_sick(r, kind, now, error=r.fail_error)
        elif r.hb.stale_s(now) > self.stale_after_s:
            self._mark_sick(r, "wedged", now,
                            stale_s=round(r.hb.stale_s(now), 3))

    def _mark_sick(self, r: Replica, cause: str, now: float, **info) -> None:
        # the state transition and failover run to completion BEFORE any
        # telemetry: a throwing event sink must never strand a replica in
        # "sick" (a state this method owns) or lose its in-flight requests.
        # Each transition holds r.lock (the contract on Replica state) in a
        # short, non-nested scope — take_inflight() acquires
        # the same non-reentrant lock, so it must never run inside one
        with r.lock:
            r.state = "sick"
        self._replica_event("sick", r)
        inflight = r.take_inflight()
        self._failover(inflight, now)
        with r.lock:
            r.restarts += 1  # control state, not a metric  # noqa: DP108 — control state, not a metric
        retire = r.restarts > int(getattr(self.cfg, "max_restarts", 0))
        delay = 0.0
        if not retire:
            delay = retry_delay(
                f"serve-r{r.slot}", r.restarts,
                base=float(getattr(self.cfg, "restart_backoff_base", 0.5)),
                cap=float(getattr(self.cfg, "restart_backoff_cap", 30.0)))
            with r.lock:
                r.restart_at = now + delay
                r.state = "quarantined"
        observe.record_event("serve.replica.sick", replica=r.slot,
                             generation=r.generation, cause=cause,
                             inflight=len(inflight), **info)
        if retire:
            self._retire(r)
            return
        self._replica_event("quarantine", r)
        observe.record_event("serve.replica.quarantine", replica=r.slot,
                             generation=r.generation, cause=cause,
                             restarts=r.restarts,
                             retry_in_s=round(delay, 3))

    def _failover(self, inflight: List[Any], now: float) -> None:
        """Re-dispatch a failed replica's unanswered in-flight requests to
        the healthy replicas: at most ONE re-enqueue per request, original
        deadline preserved (already-expired ones are shed typed right
        here). A request whose second replica also fails resolves as an
        internal error — never a third try, never a hang."""
        requeue: List[Any] = []
        for req in inflight:
            if req.done.is_set():
                continue
            if req.redispatched:
                if req.claim():
                    self.svc._m_requests.inc(status="internal_error")
                    observe.record_event(
                        "serve.request", status="internal_error",
                        latency_s=round(now - req.enqueued, 6),
                        redispatched=True, trace=req.trace_id)
                    req.deliver(ServeError(
                        reason="replica failed twice",
                        latency_ms=(now - req.enqueued) * 1e3,
                        status="internal_error"))
                continue
            if now > req.deadline:
                if req.claim():
                    self.svc._m_requests.inc(status="deadline_exceeded")
                    observe.record_event(
                        "serve.request", status="deadline_exceeded",
                        latency_s=round(now - req.enqueued, 6), shed=True,
                        trace=req.trace_id)
                    req.deliver(DeadlineExceeded(
                        latency_ms=(now - req.enqueued) * 1e3,
                        deadline_ms=req.budget_s() * 1e3))
                continue
            req.redispatched = True
            requeue.append(req)
        if requeue:
            self.svc.metrics.counter(
                "serve_failover_redispatched_total",
                help="in-flight requests re-enqueued after replica failure",
            ).inc(len(requeue))
            if not self.batcher.requeue(requeue):
                self._reject_all(requeue, "service stopping")

    def _retire(self, r: Replica) -> None:
        with r.lock:
            r.state = "retired"
            r.restart_at = None
        healthy = max(self.healthy_count(), 0)
        total = len(self.replicas)
        retired = sum(1 for x in self.replicas if x.state == "retired")
        live = total - retired
        new_depth = (max(1, self._base_depth * live // total)
                     if live else 0)
        self.batcher.set_max_queue_depth(new_depth)
        self._replica_event("retire", r)
        observe.record_event("serve.replica.retire", replica=r.slot,
                             generation=r.generation, restarts=r.restarts,
                             healthy_left=healthy,
                             max_queue_depth=new_depth)
        if live == 0:
            # terminal degradation: nothing will ever serve again — answer
            # every queued waiter with a typed error instead of hanging
            self._reject_all(self.batcher.drain(), "no healthy replicas")

    def _restart(self, r: Replica) -> None:
        t0 = self._clock()
        try:
            clean, defenses, stream, aot_stats = self.svc._build_bank(r.slot)
        except Exception as e:
            observe.record_event("serve.replica.quarantine", replica=r.slot,
                                 generation=r.generation,
                                 cause="restart_failed", error=repr(e),
                                 restarts=r.restarts)
            self._replica_event("quarantine", r)
            with r.lock:
                r.restarts += 1  # control state, not a metric  # noqa: DP108 — control state, not a metric
            if r.restarts > int(getattr(self.cfg, "max_restarts", 0)):
                self._retire(r)
            else:
                delay = retry_delay(
                    f"serve-r{r.slot}", r.restarts,
                    base=float(getattr(self.cfg, "restart_backoff_base",
                                       0.5)),
                    cap=float(getattr(self.cfg, "restart_backoff_cap",
                                      30.0)))
                restart_at = self._clock() + delay
                with r.lock:
                    r.restart_at = restart_at
                    r.state = "quarantined"
            return
        # the fresh heartbeat opens its JSONL file: build it BEFORE taking
        # the lock so the hold stays a handful of pure assignments
        hb = ReplicaHeartbeat(self._hb_path(r.slot), r.slot, self._clock)
        with r.lock:
            r.generation += 1  # control state, not a metric  # noqa: DP108 — control state, not a metric
            r.clean, r.defenses = clean, defenses
            r.stream = stream
            r.aot_stats = aot_stats
            r.hb = hb
            r.fail_kind = r.fail_error = None
            r.state = "healthy"
        if r.slot == 0:
            # replica 0's bank IS the service's bank: trace_counts and the
            # defenses attribute must reflect the programs actually serving
            self.svc._clean, self.svc.defenses = clean, defenses
            self.svc._stream = stream
        self._launch(r)
        self._replica_event("restart", r)
        observe.record_event(
            "serve.replica.restart", replica=r.slot,
            generation=r.generation, restarts=r.restarts,
            dur_s=round(self._clock() - t0, 6),
            aot_hits=(aot_stats or {}).get("hits"),
            aot_misses=(aot_stats or {}).get("misses"),
            trace_counts=sum(
                self.svc._bank_trace_counts(clean, defenses).values()))

    # ---------------- stats ----------------

    def snapshot(self) -> List[dict]:
        now = self._clock()
        m = self.svc.metrics
        out = []
        for r in self.replicas:
            rl = str(r.slot)

            def pct(q, rl=rl):
                v = m.percentile("serve_replica_latency_ms", q, replica=rl)
                return None if v is None else round(v, 3)

            images = m.value("serve_replica_batch_images_total", replica=rl)
            slots = m.value("serve_replica_batch_slots_total", replica=rl)
            # read the guarded lifecycle triple (and the hb reference)
            # under the replica lock: a supervisor transition mid-snapshot
            # must not produce a torn (state, generation, restarts) row
            with r.lock:
                state, generation = r.state, r.generation
                restarts, hb = r.restarts, r.hb
            out.append({
                "replica": r.slot,
                "state": state,
                "generation": generation,
                "restarts": restarts,
                "thread_alive": r.thread_alive(),
                "last_phase": hb.last_phase,
                "stale_s": round(hb.stale_s(now), 3),
                "batches": int(m.value("serve_replica_batches_total",
                                       replica=rl)),
                "completed": int(m.value("serve_replica_completed_total",
                                         replica=rl)),
                "duplicates_shed": int(m.value(
                    "serve_replica_duplicates_shed_total", replica=rl)),
                "occupancy": (round(images / slots, 4) if slots else 0.0),
                "latency_ms": {"p50": pct(0.50), "p95": pct(0.95)},
                "trace_counts": sum(self.svc._bank_trace_counts(
                    r.clean, r.defenses).values()),
            })
        return out
