"""In-process certified-inference service: micro-batched PatchCleanser
serving over shape buckets, with every live shape warmed at start.

Port of `dorpatch_tpu.serve.service`. Request lifecycle:

1. `predict()` (the Python client API; the HTTP front-end calls the same
   method) validates the image, stamps its deadline, and submits it to the
   `MicroBatcher`'s bounded queue — or returns a typed `Overloaded` reject
   when the queue is at depth (backpressure, never unbounded queueing).
2. A replica worker thread (one of `serve_cfg.replicas`, all sharing the
   one queue — see `serve/pool.py` for the supervisor, health, and
   failover story) pops a batch on a size-or-deadline trigger, pads it up
   to the nearest shape bucket in pinned host memory, copies it to the card
   once (`non_blocking`, on the replica's stream), and drives ITS OWN
   programs: one undefended forward plus the full PatchCleanser defense
   bank. Every program ran every bucket's shapes at warmup and counts its
   input signatures against a budget of those shapes
   (`observe.timed_first_call(..., recompile_budget=...)`, armed by
   `observe.RecompileWatchdog`): live traffic runs only warmed shapes, so
   cuDNN's algorithm choice and the allocator's blocks are the warmed ones,
   and a shape leak raises `RecompileBudgetExceeded`.
3. `marshal_response` — the one designated device-to-host sync point of
   this package — materializes the verdicts, checks each request's
   deadline, and resolves the waiters.

Observability: when built with a `result_dir`, the service writes the
JAX package's telemetry contract (`run.json`, `events.jsonl`,
`metrics.json`, `heartbeat_r<slot>.jsonl`) — a `serve.batch` span per
flush (bucket, occupancy), a `serve.request` event per answered or
rejected request (status, latency) — which
`python -m dorpatch_tpu_torch.observe.report` renders as its "serve" section.

Re-certification boot gate: with a `RecertConfig` (`recert_cfg`) the
service reads the recert scheduler's published verdict
(`recert.gate.boot_gate`) before anything else: before it resolves its
device, builds its victim (`from_config`) or its defense bank, or warms
a program. Under `--require-recert strict` a failing, stale or absent
verdict raises `RecertGateError` there, so a refusal costs neither a CUDA
context nor a kernel build; `warn` serves and carries the status. The
gate runs again at every `start()` (a restarted service reads the newest
verdict) and records `serve.recert_gate`; `robustness()` (`GET
/robustness`, 200 only on "ok") answers the snapshot.

AOT warm boot: with an `AotConfig` (`--aot auto|strict --aot-cache DIR`)
every bank's programs are installed from the executable store (`aot/`)
after the shape budget is armed and before warmup, each captured as a
CUDA graph per call signature (`trace_entrypoints`); "strict" refuses to
boot on any miss. `stats()["aot"]` carries replica 0's boot.

The service runs on "cuda" unless `device="cpu"` is asked for; a CUDA
request without a GPU raises.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dorpatch_tpu_torch import data as data_lib
from dorpatch_tpu_torch import defense as defense_lib
from dorpatch_tpu_torch import observe, ops, utils
from dorpatch_tpu_torch.config import (AotConfig, DefenseConfig,
                                       ExperimentConfig, RecertConfig,
                                       ServeConfig)
from dorpatch_tpu_torch.defense import build_defenses
from dorpatch_tpu_torch.serve.batcher import MicroBatcher, PendingRequest
from dorpatch_tpu_torch.serve.pool import ReplicaPool
from dorpatch_tpu_torch.serve.types import (
    DeadlineExceeded,
    Overloaded,
    PredictResult,
    RadiusVerdict,
    ServeError,
)


def resolved_bucket_sizes(cfg: ServeConfig) -> Sequence[int]:
    """cfg.bucket_sizes, or the shared `data.batch_buckets` ladder."""
    if cfg.bucket_sizes:
        return tuple(sorted(int(b) for b in cfg.bucket_sizes))
    return data_lib.batch_buckets(cfg.max_batch)


def marshal_response(reqs: List[PendingRequest], clean_logits,
                     per_defense: List[Any], ratios: Sequence[float],
                     bucket: int, clock=time.perf_counter) -> List[Any]:
    """THE designated response-marshalling function: the only place in
    `serve/` that synchronizes device results to the host. By the time
    this runs, every program in the batch has been launched (`per_defense`
    holds either `PatchCleanser.predict_tables` tuples or scheduled pruned
    pendings), so the reads here — including the pruned finalize inside
    `defense.materialize_verdicts` — are the batch's only blocking points.
    Slices the real rows out of the padded-bucket results, enforces each
    request's deadline, and builds the typed responses."""
    clean = clean_logits.argmax(dim=-1).cpu().numpy()
    tables = [defense_lib.materialize_verdicts(entry)
              for entry in per_defense]
    now = clock()
    out: List[Any] = []
    for i, r in enumerate(reqs):
        latency_ms = (now - r.enqueued) * 1e3
        if now > r.deadline:
            out.append(DeadlineExceeded(latency_ms=latency_ms,
                                        deadline_ms=r.budget_s() * 1e3))
            continue
        verdicts = tuple(
            RadiusVerdict(ratio=float(ratio), prediction=int(pred[i]),
                          certified=bool(cert[i]))
            for ratio, (pred, cert, _fwd, _fe) in zip(ratios, tables)
        )
        out.append(PredictResult(
            prediction=verdicts[0].prediction,
            certified=all(v.certified for v in verdicts),
            clean_prediction=int(clean[i]),
            verdicts=verdicts,
            latency_ms=latency_ms,
            bucket=int(bucket),
            batch_images=len(reqs),
            certify_forwards=sum(int(fwd[i])
                                 for _p, _c, fwd, _fe in tables),
            certify_forward_equivalents=float(
                sum(fe[i] for _p, _c, _fwd, fe in tables)),
        ))
    return out


def recert_gate(recert_cfg: Optional[RecertConfig]
                ) -> Optional[Dict[str, Any]]:
    """The robustness snapshot of `recert_cfg`: None when neither a recert
    dir nor a gate mode is configured; raises `RecertGateError` under
    "strict" unless the verdict is "ok"."""
    if recert_cfg is None or (recert_cfg.require == "off"
                              and not recert_cfg.dir):
        return None
    from dorpatch_tpu_torch.recert.gate import boot_gate

    return boot_gate(recert_cfg.dir, recert_cfg.require)


class CertifiedInferenceService:
    """Micro-batching front door over a victim + PatchCleanser defense bank.

    Construct directly with an `apply_fn` (images NHWC in [0, 1] on
    `device` -> logits; tests, stub victims) or via `from_config` (real
    models through `models.registry.get_model`). `start()` warms every
    bucket's programs and launches the workers; `predict()` is the client
    API; `stop()` drains and restores global state. Usable as a context
    manager."""

    def __init__(
        self,
        apply_fn: Callable[[torch.Tensor], torch.Tensor],
        num_classes: int,
        img_size: int,
        serve_cfg: ServeConfig = ServeConfig(),
        defense_cfg: DefenseConfig = DefenseConfig(),
        result_dir: Optional[str] = None,
        run_cfg: Optional[ExperimentConfig] = None,
        enforce_budgets: bool = True,
        clock=time.perf_counter,
        incremental_engine: Any = None,
        device: Any = "cuda",
        recert_cfg: Optional[RecertConfig] = None,
        aot_cfg: Optional[AotConfig] = None,
    ):
        # the robustness boot gate comes first: a strict refusal must cost
        # no device, no bank and no warmup
        self.recert_cfg = recert_cfg
        self._robustness: Optional[Dict[str, Any]] = recert_gate(recert_cfg)
        self.apply_fn = apply_fn
        self.num_classes = int(num_classes)
        self.img_size = int(img_size)
        self.serve_cfg = serve_cfg
        self.defense_cfg = defense_cfg
        self.result_dir = result_dir
        self.run_cfg = run_cfg
        self.enforce_budgets = enforce_budgets
        self._clock = clock
        self.device = utils.resolve_device(device)
        self.aot_cfg = aot_cfg
        self._aot_stats: Optional[Dict[str, Any]] = None
        # the AOT keys of the service's programs, recorded by the first
        # boot: every replica runs the same programs (`aot.warm_boot`)
        self._aot_keys: Dict[str, tuple] = {}

        self.bucket_sizes = tuple(resolved_bucket_sizes(serve_cfg))
        self.batcher = MicroBatcher(self.bucket_sizes,
                                    serve_cfg.max_queue_depth,
                                    serve_cfg.flush_fraction, clock=clock)
        self._incremental_engine = incremental_engine
        # replica 0's bank: one clean-forward program + one certifier per
        # radius, each allowed one input signature per shape bucket —
        # warmup runs them all, so live traffic stays at n_buckets forever
        self._clean, self.defenses, self._stream = self._new_bank()
        self.ratios = tuple(defense_cfg.ratios)
        # effective double-masking schedule ("off" | "exact" | "consensus",
        # resolved once — n_patch!=1 families force "off"): pruned modes
        # schedule only the second-round work each verdict actually reads
        self.prune = (self.defenses[0].resolved_prune()
                      if self.defenses else "off")
        # effective incremental mode (off | token | token-exact | mixer
        # | mixer-exact | stem); the per-request certify cost lands in
        # `certify_forward_equivalents` as fractional full forwards
        self.incremental = (self.defenses[0].resolved_incremental()
                            if self.defenses else "off")

        # ONE typed registry for every piece of serving accounting: the
        # `/stats` block, `GET /metrics`, `metrics.json` and the loadgen
        # reconciliation all render from these series
        self.metrics = observe.MetricRegistry()
        m = self.metrics
        self._m_requests = m.counter(
            "serve_requests_total",
            "terminal request outcomes by status")
        self._m_received = m.counter(
            "serve_received_total", "requests admitted to the queue")
        self._m_batches = m.counter(
            "serve_batches_total", "dispatched micro-batches")
        self._m_batch_images = m.counter(
            "serve_batch_images_total", "images across dispatched batches")
        self._m_batch_slots = m.counter(
            "serve_batch_slots_total",
            "padded bucket slots across dispatched batches")
        self._m_certify_fwd = m.counter(
            "serve_certify_forwards_total",
            "model forwards spent on certification")
        self._m_certify_exh = m.counter(
            "serve_certify_forwards_exhaustive_total",
            "forwards an exhaustive double-masking pass would have spent")
        self._m_certify_fe = m.counter(
            "serve_certify_forward_equivalents_total",
            "fractional full-forward equivalents (incremental engines)")
        self._m_latency = m.histogram(
            "serve_latency_ms", "end-to-end latency of ok requests (ms)")
        self._m_replica_latency = m.histogram(
            "serve_replica_latency_ms",
            "per-replica batch-completion latency of ok requests (ms)")
        self._m_replica_events = m.counter(
            "serve_replica_events_total",
            "replica lifecycle transitions by event")
        # computed gauge: reads the batcher at exposition time, so the
        # admit path pays zero extra bookkeeping
        m.gauge("serve_queue_depth", "live batcher queue depth"
                ).set_function(lambda: float(self.batcher.qsize()))
        self._pool: Optional[ReplicaPool] = None
        self._stack: Optional[contextlib.ExitStack] = None
        self._elog: Optional[observe.EventLog] = None
        self._warm = False
        self._started_at: Optional[float] = None
        # kernel launches when every bank was warm, and those already
        # written to metrics.json (`_dump_metrics`)
        self._launches_from: Dict[str, int] = {}
        self._launches_dumped: Dict[str, int] = {}

    @classmethod
    def from_config(cls, cfg: ExperimentConfig,
                    result_dir: Optional[str] = None
                    ) -> "CertifiedInferenceService":
        """Real-model service: the victim `models.registry.get_model`
        resolves for `cfg` on `cfg.device`, the defense bank from
        `cfg.defense`, serving knobs from `cfg.serve`. `result_dir`
        defaults to `<results_root>/serve`."""
        from dorpatch_tpu_torch.models.registry import get_model

        # strict refusal before the victim is built or the card touched
        recert_gate(cfg.recert)
        dev = utils.resolve_device(cfg.device)
        utils.configure_numerics()
        victim = get_model(cfg.dataset, cfg.base_arch, cfg.model_dir,
                           cfg.img_size, device=dev)
        if result_dir is None:
            result_dir = os.path.join(cfg.results_root, "serve")
        return cls(victim.apply, victim.num_classes, cfg.img_size,
                   serve_cfg=cfg.serve, defense_cfg=cfg.defense,
                   result_dir=result_dir if cfg.metrics_log else None,
                   run_cfg=cfg, incremental_engine=victim.incremental,
                   device=dev, recert_cfg=cfg.recert, aot_cfg=cfg.aot)

    # ---------------- lifecycle ----------------

    def start(self) -> "CertifiedInferenceService":
        if self._pool is not None:
            raise RuntimeError("service already started")
        self._stack = contextlib.ExitStack()
        try:
            self._start_inner()
        except BaseException:
            # a failed start (warmup OOM, a kernel that does not build,
            # budget trip) must unwind every global it installed: active
            # EventLog, run span, recompile guard
            if self._pool is not None:
                self._pool.begin_stop()
                self.batcher.close()
                self._pool = None
            self._stack.close()
            self._stack = None
            self._elog = None
            raise
        return self

    def _start_inner(self) -> None:
        if self.batcher.closed:
            # a stopped service restarts cleanly: the old batcher was
            # closed (and drained) by stop(), so admit through a fresh one
            self.batcher = MicroBatcher(
                self.bucket_sizes, self.serve_cfg.max_queue_depth,
                self.serve_cfg.flush_fraction, clock=self._clock)
        if self.result_dir:
            # `POST /profile` captures on an HTTP thread: the profiler's
            # first use must be here, on the thread that boots
            observe.init_profiler()
            run_id = observe.new_run_id()
            observe.write_run_manifest(
                self.result_dir, self.run_cfg, run_id=run_id,
                extra={**observe.torch_environment(), "service": "serve"})
            self._elog = observe.EventLog(
                os.path.join(self.result_dir, observe.events_filename(0)),
                run_id=run_id)
            self._stack.enter_context(self._elog)
            self._stack.enter_context(observe.active(self._elog))
            # the service's lifetime IS the run: the report's wall-clock,
            # phase, and open-span accounting all hang off this span (a
            # crashed service leaves it open — the hang signature)
            self._stack.enter_context(observe.span("run", service="serve"))
        # robustness boot gate, before any warmup: the verdict as of this
        # boot (strict raises RecertGateError here); `warn` records the
        # degraded status and serves, `GET /robustness` renders it
        self._robustness = recert_gate(self.recert_cfg)
        if self._robustness is not None:
            observe.record_event(
                "serve.recert_gate",
                require=self._robustness["require"],
                status=self._robustness["status"],
                generation=self._robustness.get("generation"),
                worst_margin=self._robustness.get("worst_margin"))
        if self.enforce_budgets:
            # arm the shape budget for the serving process: any program
            # running a shape past its per-bucket budget fails the batch
            # loudly instead of serving unwarmed shapes
            prev = observe.recompile_guard()
            observe.set_recompile_guard(observe.RecompileWatchdog())
            self._stack.callback(observe.set_recompile_guard, prev)
        if self._aot_on():
            # AOT warm boot, AFTER the shape budget is armed and BEFORE
            # warmup: every program's executable is installed behind its
            # timer, so warmup and traffic replay graphs. Misses capture
            # and rewrite the store ("auto") or fail boot ("strict"); a
            # stale record is never served either way
            self._aot_stats = self._warm_boot(self._clean, self.defenses,
                                              self._stream)
        if self.serve_cfg.warmup:
            if self._booted_all(self._aot_stats):
                # the boot ran every program at every shape: its warmup
                # (a warmup after it replays them all once more, which
                # takes about as long on the card as an eager warmup)
                self._warm_bank(self._clean, self.defenses, booted=True)
                self._warm = True
            else:
                self.warmup()
        self._started_at = self._clock()
        observe.record_event(
            "serve.started", buckets=list(self.bucket_sizes),
            ratios=[float(r) for r in self.ratios],
            max_queue_depth=self.batcher.max_queue_depth,
            deadline_ms=float(self.serve_cfg.deadline_ms),
            replicas=max(1, int(getattr(self.serve_cfg, "replicas", 1))))
        chaos = None
        if getattr(self.serve_cfg, "chaos", ""):
            # serve-side fault injection: the state dir holds the O_EXCL
            # fired-markers, so each fault fires exactly once per run
            import tempfile

            from dorpatch_tpu_torch.chaos import Chaos, parse_faults

            state_dir = self.result_dir or tempfile.mkdtemp(
                prefix="dorpatch_serve_chaos_")
            chaos = Chaos(parse_faults(self.serve_cfg.chaos),
                          job_id="serve", state_dir=state_dir,
                          crash_mode="raise")
            if self.result_dir:
                # kill_backend's flush-before-SIGKILL contract
                chaos.bind(metrics_flush=self._dump_metrics)
        # the pool builds replicas 1..N-1 (fresh banks and streams, warmed
        # through _build_bank), adopts replica 0's bank from this service,
        # launches every worker thread, and starts the supervisor
        self._pool = ReplicaPool(self, chaos=chaos)
        self._pool.start()
        # every bank is warm: the kernel launches from here on are the
        # traffic's (`_dump_metrics`)
        self._launches_from = ops.launch_counts()
        self._launches_dumped = {}

    def _drain_timeout_s(self) -> float:
        """How long stop() waits for in-flight work: twice the request
        deadline, floored so sub-second test deadlines still tolerate a
        slow first-call straggler."""
        return max(2.0 * float(self.serve_cfg.deadline_ms) / 1e3, 5.0)

    def stopping(self) -> bool:
        """True inside stop()'s drain window (begin_stop() fired, pool not
        yet released): the HTTP frontend answers /stats and /metrics with
        a typed 503 for its duration instead of racing the teardown."""
        pool = self._pool
        return pool is not None and pool.stopping()

    def stop(self) -> None:
        if self._pool is None:
            return
        self._pool.begin_stop()
        self.batcher.close()
        drain_s = self._drain_timeout_s()
        if not self._pool.join(drain_s):
            # a wedged device call: keep the pool reference (so waiting
            # clients don't misreport a dead worker) and leave the
            # EventLog open for its late writes; the daemon threads die
            # with the process. A later stop() retries the join.
            observe.record_event("serve.drain_timeout",
                                 timeout_s=round(drain_s, 3),
                                 replicas=self._pool.still_draining())
            observe.log(f"WARNING: serve workers still draining after "
                        f"{drain_s:.1f}s; telemetry stays open",
                        file=sys.stderr)
            if self.result_dir:
                self._dump_metrics()
            return
        self._pool = None
        observe.record_event("serve.stopped", **self._snapshot())
        if self.result_dir:
            # final atomic snapshot next to events.jsonl: the offline
            # report and the fleet cross-check read this file
            self._dump_metrics()
        if self._stack is not None:
            self._stack.close()
            self._stack = None
            self._elog = None

    def _dump_metrics(self) -> None:
        """The registry's atomic snapshot, `<result_dir>/metrics.json`, with
        the process's kernel launches since the service warmed as
        `kernel_launches_total{kernel=...}` (the farm worker's counter): how
        a reader outside a serve process sees which kernels its traffic
        ran. The launch counts are the process's, so the counter means
        this service's launches only in a serve process of its own."""
        now = ops.launch_counts()
        base, dumped = self._launches_from, self._launches_dumped
        for name, n in sorted(now.items()):
            new = max(0, n - base.get(name, 0)) - dumped.get(name, 0)
            if new > 0:
                self.metrics.counter(
                    "kernel_launches_total",
                    "CUDA kernel launches of this serve process since "
                    "warmup, by kernel").inc(new, kernel=name)
                dumped[name] = dumped.get(name, 0) + new
        self.metrics.dump(os.path.join(self.result_dir, "metrics.json"))

    def capture_profile(self, duration_ms: float = 500.0) -> Optional[str]:
        """On-demand bounded `torch.profiler` capture into the run dir (the
        `POST /profile` hook). None when no result_dir is configured or a
        capture is already running."""
        return observe.capture_profile(self.result_dir,
                                       duration_s=float(duration_ms) / 1e3)

    def __enter__(self) -> "CertifiedInferenceService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------- banks / warmup / shape accounting ----------------

    def _new_bank(self):
        """One replica's programs: the timed clean forward, its own defense
        bank (`build_defenses`: the engines' lazily filled plans are per
        certifier, so per replica) and its CUDA stream (None on the
        CPU)."""
        n_buckets = len(self.bucket_sizes)
        # a wrapper of its own per bank: the signatures it counts are its
        # replica's
        clean = observe.timed_first_call(
            self.apply_fn, "serve.clean_predict", recompile_budget=n_buckets)
        defenses = build_defenses(self.apply_fn, self.img_size,
                                  self.defense_cfg,
                                  incremental=self._incremental_engine,
                                  device=self.device,
                                  recompile_budget=n_buckets)
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        if stream is not None:
            # the bank's tables were made on this thread's stream; the
            # replica's stream must not read them before they exist
            torch.cuda.synchronize(self.device)  # noqa: DP107 — bank build, before traffic
        return clean, defenses, stream

    def warmup(self) -> Dict[str, int]:
        """Run every program at every shape bucket (the first-call cost of
        serving happens HERE, before traffic). Returns the per-program
        signature counts — the baseline the zero-recompile contract is
        checked against. Under a pruned schedule the bucket loop warms the
        clean forward only and `PatchCleanser.warm_pruned` runs the certify
        programs once per shape — phase 1 + pair audit per image bucket,
        the row program per row bucket (and the escalation's exhaustive
        program per image bucket where the path escalates)."""
        self._warm_bank(self._clean, self.defenses, replica=0,
                        stream=self._stream)
        self._warm = True
        return self.trace_counts()

    def _to_device(self, host: np.ndarray, bucket: int) -> torch.Tensor:
        """The batch padded to `bucket` rows (repeating the first) in one
        pinned host buffer, then ONE non-blocking copy to the card on the
        current (the replica's) stream."""
        n = int(host.shape[0])
        pin = self.device.type == "cuda"
        buf = torch.empty((bucket,) + tuple(host.shape[1:]),
                          dtype=torch.float32, pin_memory=pin)
        buf[:n] = torch.from_numpy(host)
        if bucket > n:
            buf[n:] = buf[0]
        return buf.to(self.device, non_blocking=pin)

    def _warm_bank(self, clean, defenses, replica: int = 0,
                   stream=None, booted: bool = False) -> None:
        """Warm ONE replica's bank (see `warmup`) on its own stream, with
        inputs made the way live batches are; replica 0's bank is the
        service's own, the pool warms the others through here. A bank
        whose AOT boot installed every program (`booted`) ran each at
        every shape in that boot: its warmup is that boot's."""
        if booted:
            observe.record_event("serve.warmup_aot", replica=int(replica),
                                 buckets=list(self.bucket_sizes))
            return
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            for b in self.bucket_sizes:
                t0 = self._clock()
                placed = self._to_device(
                    np.full((b, self.img_size, self.img_size, 3), 0.5,
                            np.float32), b)
                if self.prune == "off":
                    logits, per_defense = self._dispatch(
                        placed, b, clean=clean, defenses=defenses)
                else:
                    logits, per_defense = clean(placed), []
                # marshalling doubles as the completion sync for the warmup
                marshal_response([], logits, per_defense, self.ratios, b,
                                 clock=self._clock)
                observe.record_event("serve.warmup", bucket=int(b),
                                     replica=int(replica),
                                     dur_s=round(self._clock() - t0, 6))
            if self.prune != "off":
                t0 = self._clock()
                for d in defenses:
                    d.warm_pruned(self.bucket_sizes,
                                  num_classes=self.num_classes)
                observe.record_event("serve.warmup_pruned",
                                     incremental=self.incremental,
                                     replica=int(replica),
                                     row_buckets=[int(w) for w in
                                                  defenses[0].row_bucket_sizes],
                                     dur_s=round(self._clock() - t0, 6))
            if stream is not None:
                stream.synchronize()  # noqa: DP107 — warmup, before traffic

    def _build_bank(self, slot: int):
        """Build, AOT-boot (when configured: the store is keyed by program
        name, fingerprint and interface, so every replica hits the entries
        the first boot wrote) and warm one replica's bank (`_new_bank`,
        `_warm_boot`, `_warm_bank`). Returns `(clean, defenses, stream,
        aot_stats)`."""
        clean, defenses, stream = self._new_bank()
        aot_stats = (self._warm_boot(clean, defenses, stream)
                     if self._aot_on() else None)
        if self.serve_cfg.warmup:
            self._warm_bank(clean, defenses, replica=slot, stream=stream,
                            booted=self._booted_all(aot_stats))
        return clean, defenses, stream, aot_stats

    def _booted_all(self, aot_stats) -> bool:
        """True when an AOT boot installed every program of the bank's
        boot set (each ran at its shape in the boot, through its timer)."""
        return bool(aot_stats) and aot_stats["installed"] == len(
            aot_stats["programs"]) - ("<kernels>" in aot_stats["programs"])

    def _aot_on(self) -> bool:
        cfg = self.aot_cfg
        return (cfg is not None and getattr(cfg, "mode", "off") != "off"
                and bool(getattr(cfg, "cache_dir", "")))

    def _warm_boot(self, clean, defenses, stream) -> Dict[str, Any]:
        """`aot.warm_boot` of one bank's serving programs, on its stream."""
        from dorpatch_tpu_torch.aot.boot import warm_boot

        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            return warm_boot(self._bank_entrypoints(clean, defenses,
                                                    boot=True),
                             self.aot_cfg, clock=self._clock,
                             keys=self._aot_keys)

    def trace_entrypoints(self) -> List[tuple]:
        """`(name, program, example args)` for every serving program at
        every shape bucket — the program auditor's enumeration hook
        (`analysis/entrypoints.py`). Bucket-suffixed names (e.g.
        `serve.clean_predict[b8]`) keep one registry entry per shape
        bucket; nothing is executed. Always replica 0's bank — every
        replica runs the same programs with the same names, so the
        registry, the baseline and the AOT store see ONE program set. The
        rows program stands at its smallest row bucket here (the audit's
        record); a boot installs it at every row bucket."""
        return self._bank_entrypoints(self._clean, self.defenses)

    def _bank_entrypoints(self, clean, defenses,
                          boot: bool = False) -> List[tuple]:
        """The bank's programs with example inputs made as live ones are
        (dtype, device, index types: their call signatures are live
        traffic's). `boot`: the set a warm boot installs — the rows
        program at every row bucket, and the exhaustive program only
        where the path runs it (no pruning, or an escalating path)."""
        dev = self.device

        def imgs_of(b):
            return torch.full((int(b), self.img_size, self.img_size, 3), 0.5,
                              dtype=torch.float32, device=dev)

        out: List[tuple] = []
        for b in self.bucket_sizes:
            imgs = imgs_of(b)
            out.append((f"serve.clean_predict[b{b}]", clean, (imgs,)))
            for d in defenses:
                r = d.spec.patch_ratio
                if not boot or self.prune == "off" or \
                        d.resolved_incremental().endswith("-exact") or \
                        d._bf16:
                    out.append((f"defense.predict.r{r}[b{b}]", d._predict,
                                (imgs, self.num_classes)))
                if self.prune != "off":
                    # the programs the resolved pruned(+incremental) path
                    # dispatches — engine-backed twins included
                    for name, fn, kind in d.pruned_programs():
                        if kind == "imgs":
                            out.append((f"{name}[b{b}]", fn, (imgs,)))
        if self.prune != "off":
            for d in defenses:
                rungs = d.row_bucket_sizes if boot else d.row_bucket_sizes[:1]
                for name, fn, kind in d.pruned_programs():
                    if kind not in ("rows", "rows_sets"):
                        continue
                    for w in rungs:
                        idx = (torch.zeros((int(w),), dtype=torch.long,
                                           device=dev) if kind == "rows"
                               else torch.as_tensor(
                                   d._np_grid_full[[0] * int(w)],
                                   device=dev))
                        out.append((f"{name}[w{w}]", fn,
                                    (imgs_of(w), idx)))
        return out

    def trace_counts(self) -> Dict[str, int]:
        """Input signatures run so far per program (the JAX package's
        compiled-trace counts, under the same names). After warmup the
        clean forward (and, pruned: phase 1 + pair audit) sit at
        `len(bucket_sizes)` and the row program at `len(row_bucket_sizes)`;
        the serve e2e asserts this dict is IDENTICAL before and after
        traffic. Reads replica 0's live bank; per-replica totals are in
        `stats()["replicas"]`."""
        return self._bank_trace_counts(self._clean, self.defenses)

    def _bank_trace_counts(self, clean, defenses) -> Dict[str, int]:
        out = {"serve.clean_predict": int(clean._cache_size())}
        for d in defenses:
            name = f"defense.predict.r{d.spec.patch_ratio}"
            out[name] = int(d._predict._cache_size())
            if self.prune != "off":
                out.update(d.pruned_trace_counts())
        return out

    # ---------------- client API ----------------

    def predict(self, image, deadline_ms: Optional[float] = None,
                trace_id: str = ""):
        """Certified prediction for ONE image (HWC float in [0, 1]).
        Returns a typed response: `PredictResult`, `Overloaded`,
        `DeadlineExceeded`, or `ServeError`. Thread-safe; this is the same
        path the HTTP front-end drives. `trace_id` correlates this request
        across processes (minted here when the ingress didn't)."""
        tid = str(trace_id) if trace_id else observe.new_trace_id()
        try:
            arr = np.asarray(image, dtype=np.float32)  # noqa: DP107 — host data parsing
        except (ValueError, TypeError) as e:  # ragged / non-numeric input
            self._m_requests.inc(status="error")
            observe.record_event("serve.request", status="error",
                                 reason="bad_image", trace=tid)
            return ServeError(reason=f"image does not parse: {e}")
        want = (self.img_size, self.img_size, 3)
        if arr.shape != want:
            self._m_requests.inc(status="error")
            observe.record_event("serve.request", status="error",
                                 reason="bad_shape", trace=tid)
            return ServeError(reason=f"image shape {arr.shape} != {want}")
        if deadline_ms is not None and not (
                isinstance(deadline_ms, (int, float))
                and math.isfinite(deadline_ms) and deadline_ms > 0):
            # Infinity/NaN parse as legal JSON floats but would poison the
            # batcher's flush-instant arithmetic (inf wait / NaN min) —
            # one bad request must never wedge the worker
            self._m_requests.inc(status="error")
            observe.record_event("serve.request", status="error",
                                 reason="bad_deadline", trace=tid)
            return ServeError(
                reason=f"deadline_ms must be a finite positive number, "
                       f"got {deadline_ms!r}")
        now = self._clock()
        budget_s = (deadline_ms if deadline_ms is not None
                    else self.serve_cfg.deadline_ms) / 1e3
        req = PendingRequest(arr, enqueued=now, deadline=now + budget_s,
                             trace_id=tid)
        if not self.batcher.submit(req):
            depth = self.batcher.qsize()
            self._m_requests.inc(status="overloaded")
            observe.record_event("serve.request", status="overloaded",
                                 queue_depth=depth, trace=tid)
            return Overloaded(queue_depth=depth,
                              limit=self.batcher.max_queue_depth)
        self._m_received.inc()
        # `opens_trace`: the fleet report joins on these — an admitted
        # trace with no later terminal record is an orphaned request
        observe.record_event("serve.admit", trace=tid, opens_trace=True,
                             queue_depth=self.batcher.qsize())
        # every admitted request IS resolved (the worker sheds expired ones
        # with DeadlineExceeded, the supervisor re-dispatches a failed
        # replica's in-flight work), so wait for the answer and poll only
        # for the one failure the pool cannot recover from: no replica left
        # that could ever serve again. The deadline+grace backstop exists
        # for the failure NOBODY resolves: abandon typed rather than hang.
        while not req.done.wait(timeout=1.0):
            pool = self._pool
            if pool is None or not pool.serving_possible():
                if req.claim():
                    self._m_requests.inc(status="internal_error")
                    observe.record_event(
                        "serve.request", status="internal_error",
                        reason="worker thread died", trace=tid)
                    req.deliver(ServeError(reason="worker thread died",
                                           status="internal_error"))
                    return req.result
            elif self._clock() > req.deadline + max(
                    2.0 * pool.stale_after_s, 5.0):
                if req.claim():
                    now2 = self._clock()
                    self._m_requests.inc(status="deadline_exceeded")
                    observe.record_event(
                        "serve.request", status="deadline_exceeded",
                        latency_s=round(now2 - req.enqueued, 6),
                        abandoned=True, trace=tid)
                    req.deliver(DeadlineExceeded(
                        latency_ms=(now2 - req.enqueued) * 1e3,
                        deadline_ms=req.budget_s() * 1e3))
                    return req.result
        return req.result

    def healthz(self) -> dict:
        """Liveness the load balancer can act on: "ok" only while at least
        one healthy replica thread is actually serving."""
        pool = self._pool
        alive = pool is not None and pool.worker_alive()
        healthy = pool.healthy_count() if pool is not None else 0
        out = {"status": "ok" if healthy > 0 else "unhealthy",
               "worker_alive": alive, "warm": self._warm,
               "queue_depth": self.batcher.qsize()}
        if pool is not None:
            out["replicas"] = {
                "total": len(pool.replicas), "healthy": healthy,
                "retired": sum(1 for r in pool.replicas
                               if r.state == "retired")}
        return out

    def robustness(self) -> dict:
        """The recert verdict snapshot loaded at boot (`GET /robustness`):
        gate mode, verdict status, generation, worst margin, per-cell
        grid. It reflects the verdict as of boot: a fresh generation's
        verdict takes effect at the next start."""
        if self._robustness is None:
            return {"require": "off", "status": "unconfigured"}
        return dict(self._robustness)

    def stats(self) -> dict:
        s = self._snapshot()
        s["queue_depth"] = self.batcher.qsize()
        s["buckets"] = list(self.bucket_sizes)
        s["trace_counts"] = self.trace_counts()
        s["warm"] = self._warm
        if self._robustness is not None:
            s["robustness"] = {
                k: self._robustness.get(k)
                for k in ("require", "status", "generation", "worst_margin")}
        if self._started_at is not None:
            s["uptime_s"] = round(self._clock() - self._started_at, 3)
        if self._aot_stats is not None:
            s["aot"] = self._aot_stats
        pool = self._pool
        if pool is not None:
            s["replicas"] = pool.snapshot()
            s["failover"] = {"redispatched": pool.redispatched,
                             "duplicates_shed": pool.duplicates_shed}
        return s

    def _snapshot(self) -> dict:
        # every number here is a registry read — /stats is a VIEW over the
        # same series `GET /metrics` exposes, never a second ledger
        v = self.metrics.value
        completed = int(v("serve_requests_total", status="ok"))
        s = {
            "received": int(v("serve_received_total")),
            "completed": completed,
            "rejected": int(v("serve_requests_total", status="overloaded")),
            "deadline_exceeded": int(
                v("serve_requests_total", status="deadline_exceeded")),
            "errors": int(v("serve_requests_total", status="error")
                          + v("serve_requests_total",
                              status="internal_error")),
            "batches": int(v("serve_batches_total")),
            "batch_images": int(v("serve_batch_images_total")),
            "batch_slots": int(v("serve_batch_slots_total")),
        }
        s["occupancy"] = (round(s["batch_images"] / s["batch_slots"], 4)
                          if s["batch_slots"] else 0.0)
        s["prune"] = self.prune
        s["incremental"] = self.incremental
        s["compute_dtype"] = self.defense_cfg.compute_dtype
        fwd = int(v("serve_certify_forwards_total"))
        exh = int(v("serve_certify_forwards_exhaustive_total"))
        fe = float(v("serve_certify_forward_equivalents_total"))
        s["certify_forwards"] = {
            "total": fwd,
            "per_request": round(fwd / completed, 1)
            if completed else None,
            "forward_equivalents": round(fe, 2),
            "forward_equivalents_per_request": round(fe / completed, 2)
            if completed else None,
            "prune_rate": round(1.0 - fwd / exh, 4) if exh else None,
            "speedup_equivalent": round(exh / fe, 2) if fe else None,
        }
        # denominator = every terminal outcome, matching the report CLI's
        # all-serve.request-events accounting
        total = (s["completed"] + s["rejected"] + s["deadline_exceeded"]
                 + s["errors"])
        s["reject_rate"] = round(s["rejected"] / total, 4) if total else 0.0

        def pct(q):
            p = self._m_latency.percentile(q)
            return None if p is None else round(p, 3)

        s["latency_ms"] = {"count": self._m_latency.count(),
                           "p50": pct(0.50), "p95": pct(0.95),
                           "p99": pct(0.99)}
        return s

    # ---------------- worker ----------------

    def _dispatch(self, x, n_real: int, clean=None, defenses=None):
        """Launch the clean forward and EVERY certifier before reading any
        result back. Exhaustive mode is launch-only (the reads all happen
        later, in `marshal_response`); a pruned schedule launches phase 1
        for every radius first, then lets each certifier's `schedule()`
        read its tiny `[B, 36]` first-round table (the pruned path's one
        designed sync, inside defense.py) and launch only the phase-2 work
        the batch's verdicts need. `clean`/`defenses` select a replica's
        bank; default is replica 0's (the service's own)."""
        clean = self._clean if clean is None else clean
        defenses = self.defenses if defenses is None else defenses
        logits = clean(x)
        if self.prune == "off":
            per_defense = [d.predict_tables(x, self.num_classes)
                           for d in defenses]
            return logits, per_defense
        pendings = [d.begin_pruned(x, self.num_classes, n=n_real,
                                   bucket_sizes=self.bucket_sizes)
                    for d in defenses]
        for p in pendings:
            p.schedule()
        return logits, pendings

    def _note_duplicate(self, replica=None) -> None:
        """A resolver lost the claim race: the request was already answered
        elsewhere. The late answer is shed, counted, and never delivered."""
        self.metrics.counter("serve_duplicates_shed_total").inc()
        if replica is not None:
            self.metrics.counter("serve_replica_duplicates_shed_total").inc(
                replica=str(replica.slot))

    def _fail_batch(self, batch: List[PendingRequest], e: Exception,
                    replica=None) -> None:
        """A failed batch must resolve its unanswered waiters (the worker
        stays serving for ordinary errors — the pool escalates only the
        structural ones); events and counts land before the waiters wake,
        as on the success path. Requests already answered are skipped via
        the claim arbiter, never re-resolved or re-counted."""
        now = self._clock()
        pending = [r for r in batch if r.claim()]
        for r in pending:
            observe.record_event(
                "serve.request", status="internal_error",
                latency_s=round(now - r.enqueued, 6), trace=r.trace_id)
        self._m_requests.inc(len(pending), status="internal_error")
        observe.record_event(
            "serve.batch_error", error=repr(e), images=len(pending),
            replica=replica.slot if replica is not None else 0)
        for r in pending:
            r.deliver(ServeError(reason=repr(e),
                                 latency_ms=(now - r.enqueued) * 1e3,
                                 status="internal_error"))

    def _run_batch(self, reqs: List[PendingRequest], replica=None) -> None:
        clean = self._clean if replica is None else replica.clean
        defenses = self.defenses if replica is None else replica.defenses
        slot = 0 if replica is None else replica.slot
        # shed already-expired requests BEFORE dispatch: their answers
        # would be withheld anyway, so a certify sweep on them is waste
        now = self._clock()
        live = [r for r in reqs if now <= r.deadline]
        expired = [r for r in reqs if now > r.deadline]
        if expired:
            won = [r for r in expired if r.claim()]
            self._note_duplicates(len(expired) - len(won), replica)
            for r in won:
                observe.record_event("serve.request",
                                     status="deadline_exceeded",
                                     latency_s=round(now - r.enqueued, 6),
                                     shed=True, trace=r.trace_id)
            self._m_requests.inc(len(won), status="deadline_exceeded")
            for r in won:
                r.deliver(DeadlineExceeded(
                    latency_ms=(now - r.enqueued) * 1e3,
                    deadline_ms=r.budget_s() * 1e3))
        if not live:
            return
        reqs = live
        n = len(reqs)
        bucket = data_lib.bucket_batch(n, self.bucket_sizes)
        with observe.span("serve.batch", bucket=int(bucket), images=n,
                          replica=slot,
                          queue_depth=self.batcher.qsize(),
                          compute_dtype=(
                              "bf16"
                              if self.defense_cfg.compute_dtype == "bfloat16"
                              else "f32"),
                          traces=[r.trace_id for r in reqs]) as sp:
            # pad on the host so exactly ONE host->device copy happens per
            # batch, always bucket-shaped
            x = self._to_device(np.stack([r.image for r in reqs]), bucket)
            logits, per_defense = self._dispatch(x, n, clean=clean,
                                                 defenses=defenses)
            responses = marshal_response(reqs, logits, per_defense,
                                         self.ratios, bucket,
                                         clock=self._clock)
            # stats and telemetry land BEFORE the waiters wake: a client
            # that returns from predict() must observe its own completion
            # in stats(). claim() first: a request the failover path
            # already answered is a shed duplicate, not a second answer.
            ok = 0
            deliver: List[tuple] = []
            exhaustive = sum(d.num_forwards_exhaustive
                             for d in defenses)
            for r, resp in zip(reqs, responses):
                if not r.claim():
                    self._note_duplicate(replica)
                    continue
                deliver.append((r, resp))
                status = resp.status
                lat = getattr(resp, "latency_ms", None)
                fwd = getattr(resp, "certify_forwards", None)
                fe = getattr(resp, "certify_forward_equivalents", None)
                extra = {}
                if status == "ok" and fwd is not None:
                    # per-request certify cost, for the report CLI's serve
                    # prune-rate column
                    extra = {"forwards": int(fwd),
                             "forwards_exhaustive": exhaustive}
                    if fe is not None:
                        extra["forward_equivalents"] = round(float(fe), 2)
                observe.record_event("serve.request", status=status,
                                     latency_s=round((lat or 0.0) / 1e3, 6),
                                     bucket=int(bucket), trace=r.trace_id,
                                     **extra)
                if status == "ok":
                    ok += 1
                    self._m_requests.inc(status="ok")
                    if fwd is not None:
                        self._m_certify_fwd.inc(int(fwd))
                        self._m_certify_exh.inc(exhaustive)
                    if fe is not None:
                        self._m_certify_fe.inc(float(fe))
                    self._m_latency.observe(lat)
                else:
                    self._m_requests.inc(status=status)
            self._m_batches.inc()
            self._m_batch_images.inc(n)
            self._m_batch_slots.inc(bucket)
            if replica is not None:
                rl = str(replica.slot)
                self.metrics.counter("serve_replica_batches_total").inc(
                    replica=rl)
                self.metrics.counter("serve_replica_batch_images_total").inc(
                    n, replica=rl)
                self.metrics.counter("serve_replica_batch_slots_total").inc(
                    bucket, replica=rl)
                self.metrics.counter("serve_replica_completed_total").inc(
                    ok, replica=rl)
                for _r, resp in deliver:
                    if resp.status == "ok":
                        self._m_replica_latency.observe(resp.latency_ms,
                                                        replica=rl)
            sp["ok"] = ok
            for r, resp in deliver:
                r.deliver(resp)

    def _note_duplicates(self, count: int, replica=None) -> None:
        for _ in range(count):
            self._note_duplicate(replica)
