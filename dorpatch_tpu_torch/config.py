"""Configuration of the attack-and-certify pipeline.

The fields of `dorpatch_tpu.config` that this package reads, with the same
defaults, so a results directory, a flag and a default mean the same thing in
both packages. `ExperimentConfig.device` is new: entry points run on "cuda"
unless the caller asks for "cpu". `ServeConfig` configures the
certified-inference service (`serve/`), `FarmConfig` the attack-sweep farm
(`farm/`), `RecertConfig` the service's re-certification boot gate
(`recert/`) and `GatewayConfig` the fleet gateway (`gateway/`).
`config_from_dict` reads a config dict back, and refuses by name the JAX
package's keys whose subsystems this package does not have (`NOT_PORTED`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Dropout/defense ratio schedule and the R-covering axis count.
DEFAULT_RATIOS: Tuple[float, ...] = (0.015, 0.03, 0.06, 0.12)
NUM_MASKS_PER_AXIS: int = 6

NUM_CLASSES = {"imagenet": 1000, "cifar10": 10, "cifar100": 100}


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """DorPatch optimizer hyper-parameters."""

    patch_budget: float = 0.12
    targeted: bool = False
    lr: float = 1e-2
    confidence: float = 1e-1
    clip_min: float = 0.0
    clip_max: float = 1.0
    max_iterations: int = 5000
    basic_unit: int = 7
    dropout: int = 2               # 0: occlusion EOT off, 1: single, 2: double masks
    sampling_size: int = 128       # EOT samples (occlusion masks) per step
    density: float = 1e-3          # density regularization coefficient
    structured: float = 1e-3       # structured (TV) loss coefficient
    eps: float = 4.0               # L2 budget for the patch delta
    mask_fill: float = 0.5         # occlusion gray fill
    dual: bool = False             # second independent occlusion layer per sample
    num_patch: int = -1            # bookkeeping only (results path)

    patience: int = 200                        # lr-decay patience
    coeff_group_lasso: float = 1e-5
    scale_up: float = 1.2
    dropout_sizes: Tuple[float, ...] = DEFAULT_RATIOS
    success_threshold: float = 1e-1            # attack_success = loss_adv < 0.1
    switch_iteration: int = 500                # untargeted -> targeted switch
    sweep_interval: int = 100                  # failure-sweep cadence
    failure_sampling_start: int = 1000         # failure-biased sampling start
    lr_floor: float = 0.1 / 256.0
    lr_stop: float = 1e-3                      # all-lr early-stop threshold
    lr_decay: float = 0.1
    loss_decay_margin: float = 1e-3
    report_interval: int = 20                  # metrics echo cadence (iterations)
    adapt_start: int = 200                     # stage-0 coefficient adaptation start
    # EOT forward+backward precision, float32|bfloat16 (the patch, the
    # losses and the carry stay float32)
    compute_dtype: str = "float32"
    # rematerialize the EOT forward in the backward: auto|on|off. "auto"
    # remats only when the masked batch (images x sampling_size) exceeds
    # remat_threshold. The port checkpoints each residual block
    # (models/remat.py); the JAX package wraps the whole forward.
    remat: str = "auto"
    # masked images above which "auto" remats. The JAX package's 512 was
    # measured on a v5e; on an 80 GB H100 it would remat the default CIFAR
    # path (8 images x 128 samples, 2.27 GiB). 1024 is the largest masked
    # batch of every path the port ran before remat existed (CIFAR, the
    # farm and the parity run at batch 8), so "auto" changes none of them.
    remat_threshold: int = 1024
    # what an active remat saves inside a block: "full" nothing, "conv" the
    # ResNetV2 std-conv outputs, "dots" the matmul outputs (ViT, ResMLP)
    remat_policy: str = "full"

    @property
    def scale_down(self) -> float:
        return float(self.scale_up ** 1.5)


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """PatchCleanser double-masking defense.

    prune: "exact" (two-phase pruned schedule, verdicts identical to the
    exhaustive sweep), "consensus" ("exact", but a first-round-unanimous
    image stops after the first round with the weaker round-1
    certificate) or "off" (the exhaustive 666-mask sweep). n_patch=2
    families always run the exhaustive sweep.
    incremental: "auto" (the victim family's engine: "stem" for conv
    victims, "token-exact" for ViT victims, "mixer-exact" for ResMLP
    victims), "stem", "token" (token-pruned forwards over a clean KV cache,
    verdicts up to the engine's logit drift), "token-exact" ("token", plus
    re-certifying every image whose read entries have a top-2 logit margin
    below `incremental_margin` through the exhaustive sweep), "mixer" and
    "mixer-exact" (the same pair for the ResMLP dirty-row engine) or "off"
    (full masked forwards for every entry).
    compute_dtype: "bfloat16" runs the pruned path's programs (phase 1,
    pair audits, rows and the engines) on a once-cast bf16 copy of the
    victim, reads every margin in f32, and re-certifies every image whose
    evaluated margins come within `incremental_margin` of the argmax
    boundary through the f32 exhaustive sweep, so verdicts never weaken.
    """

    ratios: Tuple[float, ...] = DEFAULT_RATIOS
    n_patch: int = 1
    num_mask_per_axis: int = NUM_MASKS_PER_AXIS
    mask_fill: float = 0.5
    chunk_size: int = 64            # certification sweep chunking
    prune: str = "exact"
    incremental: str = "auto"
    incremental_margin: float = 0.5  # "token-exact" escalation threshold
    compute_dtype: str = "float32"   # certify precision: float32|bfloat16


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Online certified-inference service (`dorpatch_tpu_torch/serve/`).

    The micro-batcher admits requests into a bounded queue and flushes a
    batch when a full bucket's worth is pending (size trigger) or when the
    oldest request has spent `flush_fraction` of its latency budget
    (deadline trigger). Batches pad up to fixed bucket sizes
    (`data.batch_buckets(max_batch)`, e.g. 1/8) so every program runs only
    the shapes warmup ran, the shape budget of `observe.timed_first_call`
    enforcing it."""

    max_batch: int = 8              # largest micro-batch (top bucket size)
    bucket_sizes: Tuple[int, ...] = ()  # () = derive data.batch_buckets(max_batch)
    max_queue_depth: int = 64       # backpressure bound: submissions past
                                    # this many queued requests get a typed
                                    # Overloaded reject, never unbounded queueing
    deadline_ms: float = 2000.0     # default per-request latency budget
    flush_fraction: float = 0.5     # flush when this fraction of the oldest
                                    # queued request's budget is spent
    host: str = "127.0.0.1"
    port: int = 8700                # HTTP front-end bind port (0 = ephemeral)
    warmup: bool = True             # run every bucket's programs at start
    # -- replica pool / failover (serve/pool.py) --
    replicas: int = 1               # worker threads sharing the queue, each
                                    # with its own defense bank and stream
    max_restarts: int = 2           # quarantined-replica restarts before it
                                    # retires (0 = a failed replica is gone)
    restart_backoff_base: float = 0.5   # shared backoff.retry_delay knobs
    restart_backoff_cap: float = 30.0   # for replica restarts (seconds)
    replica_stale_s: float = 0.0    # missed-beat staleness threshold for
                                    # the supervisor; 0 = deadline_ms/1e3
    chaos: str = ""                 # serve-side fault injection (comma list
                                    # of chaos.SERVE_FAULTS)


@dataclasses.dataclass(frozen=True)
class FarmConfig:
    """Attack-sweep farm knobs (`dorpatch_tpu_torch/farm/`): how workers
    lease, retry, and (in chaos mode) sabotage jobs over a shared farm
    directory.

    `lease_ttl` is the reclaim latency after a worker dies: a lease is
    fresh while the owner's heartbeat file advanced within the TTL, so it
    must comfortably exceed `heartbeat_interval` AND the longest gap
    between block boundaries (lease renewal points), a kernel build inside
    the first block included."""

    lease_ttl: float = 60.0         # heartbeat staleness after which a
                                    # worker's jobs are reclaimable
    heartbeat_interval: float = 1.0  # worker liveness beat cadence
    max_attempts: int = 3           # per-job cap across transient retries
                                    # and crash reclaims
    backoff_base: float = 2.0       # transient retry delay: base * 2^(n-1)
    backoff_cap: float = 300.0      # ... clipped here ...
    backoff_jitter: float = 0.25    # ... times (1 + jitter * u), u drawn
                                    # deterministically from the job id
    poll_interval: float = 1.0      # idle worker re-scan cadence
    chaos: str = ""                 # comma-joined farm fault injections
                                    # ("" = off): crash_block, ckpt_raise,
                                    # wedge_heartbeat, enospc_events


@dataclasses.dataclass(frozen=True)
class RecertConfig:
    """Continuous re-certification (`dorpatch_tpu_torch/recert/`): the
    serve-boot robustness gate against the scheduler's published verdict.

    `require` semantics (the JAX package's AotConfig.mode has the same):
      "off"    — (default) no gate; the snapshot is still loaded for
                 `GET /robustness` when `dir` is set.
      "warn"   — boot proceeds on any verdict (failing/stale/absent) and
                 carries the degraded status in `/robustness` + the boot
                 log — canary mode.
      "strict" — the deploy mode: the pool refuses serving-ready
                 (`RecertGateError`) unless the verdict exists and is
                 `ok` — never serve silently-uncertified."""

    dir: str = ""                   # recert dir holding recert_verdict.json
                                    # ("" = no robustness surface)
    baseline_file: str = ""         # baseline override ("" = the package's
                                    # recert/robustness_baseline.json)
    require: str = "off"            # off|warn|strict


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Horizontal serve fleet front-end (`dorpatch_tpu_torch/gateway/`): a
    stdlib-only HTTP gateway routing `POST /predict` across N serve
    *processes* (each a `python -m dorpatch_tpu_torch.serve`).

    Membership is probe-driven (`/healthz` + `/stats` + `/robustness` on a
    jittered interval): `fail_threshold` CONSECUTIVE probe failures eject a
    backend, `ok_threshold` consecutive successes re-admit it — the
    hysteresis that keeps a flapping backend out. Routing is
    power-of-two-choices over each backend's scraped occupancy/reject rate,
    retrying connection-level failures on the next backend (never
    re-dispatching a request the backend already answered). When every
    routable backend is saturated the gateway answers a typed `Overloaded`
    (503) instead of queueing."""

    backends: Tuple[str, ...] = ()  # backend base URLs (http://host:port)
    host: str = "127.0.0.1"
    port: int = 8800                # gateway bind port (0 = ephemeral)
    probe_interval_s: float = 1.0   # health-probe cadence per backend
    probe_jitter: float = 0.2       # multiplicative interval jitter (anti
                                    # thundering-herd across gateways)
    probe_timeout_s: float = 5.0    # per-probe socket timeout
    fail_threshold: int = 3         # consecutive probe failures -> ejected
    ok_threshold: int = 2           # consecutive probe successes -> healthy
                                    # (re-admission hysteresis)
    check_robustness: bool = True   # poll GET /robustness: a failing
                                    # verdict degrades (not ejects) the
                                    # backend — routable only when no
                                    # healthy backend remains
    inflight_cap: int = 32          # per-backend concurrent dispatches the
                                    # gateway allows before calling the
                                    # fleet saturated
    dispatch_retries: int = 1       # connection-failure retries, each on a
                                    # backend the request has not touched
    dispatch_timeout_s: float = 75.0  # per-dispatch socket timeout (never
                                    # retried: the backend may still answer)
    canary_steps: Tuple[float, ...] = (0.1, 0.5, 1.0)
                                    # rolling-deploy traffic fractions the
                                    # canary group is stepped through
    canary_hold_s: float = 2.0      # soak time per step before evaluating
                                    # the canary's robustness
    autoscale_window_s: float = 30.0   # sliding window for the signal-only
                                    # scale recommendations
    autoscale_high_occupancy: float = 0.8  # scale-up above this mean occupancy
    autoscale_low_occupancy: float = 0.2   # scale-down below (and no rejects)
    autoscale_high_reject: float = 0.01    # scale-up above this reject rate
    autoscale_cooldown_s: float = 60.0     # min gap between recommendations
    chaos: str = ""                 # gateway-side fault injection (comma
                                    # list of dorpatch_tpu_torch.chaos
                                    # GATEWAY_FAULTS: wedge_probe,
                                    # poison_canary)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One end-to-end experiment."""

    dataset: str = "imagenet"
    data_dir: str = "/home/data/data"
    model_dir: str = "pretrained_models/"
    base_arch: str = "resnetv2"
    attack_name: str = "DorPatch"
    batch_size: int = 1
    num_batches: int = 10
    seed: int = 1234
    device: str = "cuda"            # "cuda" (default) or "cpu" on request
    results_root: str = "results"
    synthetic_data: bool = False
    data_source: str = "auto"       # auto|disk|synthetic|procedural
    img_size: int = 224
    stream_depth: int = 2           # input streaming: a background loader
                                    # thread and a pinned-memory copy on a
                                    # side stream, this many batches ahead
                                    # (data.streaming_batches); 0 = loads in
                                    # the loop
    # telemetry: metrics_log gates metrics.jsonl, events.jsonl and the
    # heartbeats; run.json is always written
    metrics_log: bool = True
    trace_dir: str = ""             # torch.profiler trace of the run here
    heartbeat_interval: float = 5.0  # seconds between heartbeat beats
    hang_timeout: float = 0.0       # >0 arms the watchdog: abort with the
                                    # last-known phase instead of hanging;
                                    # must exceed the longest block, the
                                    # kernel build included
    # snapshots of the attack's carry at every block (checkpoint.py)
    carry_checkpoints: bool = False
    # runtime sanitizers (analysis/sanitize.py): NaN at the producing op or
    # kernel, compile-like events into events.jsonl, the programs' shape
    # budgets enforced, the lock watch armed; debugging runs only
    sanitize: bool = False

    attack: AttackConfig = dataclasses.field(default_factory=AttackConfig)
    defense: DefenseConfig = dataclasses.field(default_factory=DefenseConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    farm: FarmConfig = dataclasses.field(default_factory=FarmConfig)
    recert: RecertConfig = dataclasses.field(default_factory=RecertConfig)
    gateway: GatewayConfig = dataclasses.field(default_factory=GatewayConfig)

    @property
    def num_classes(self) -> int:
        return NUM_CLASSES[self.dataset]


def config_to_dict(cfg: ExperimentConfig) -> dict:
    """JSON-safe nested dict of the experiment config."""
    return dataclasses.asdict(cfg)


#: keys of the JAX package's config whose subsystems (mesh, Pallas tier,
#: GroupNorm implementation switch, AOT store) this package does not have;
#: `config_from_dict` refuses them by name, so a job that names one fails
#: as a configuration error instead of losing the setting. `backend` and
#: `gn_impl` at their JAX defaults are refused too: the port has one
#: backend and picks its GroupNorm kernels itself.
NOT_PORTED = {
    "ExperimentConfig": ("backend", "gn_impl", "mesh_data", "mesh_mask",
                         "aot"),
    "AttackConfig": ("selection", "use_pallas"),
    "DefenseConfig": ("use_pallas",),
}


def config_from_dict(d: dict) -> ExperimentConfig:
    """Inverse of `config_to_dict`. Unknown keys are rejected, and the JAX
    package's keys of `NOT_PORTED` are refused by name; list values
    round-trip back to the tuples the dataclasses declare."""
    def build(cls, sub: dict):
        fields = {f.name for f in dataclasses.fields(cls)}
        later = sorted(set(sub) & set(NOT_PORTED.get(cls.__name__, ())))
        if later:
            raise ValueError(
                f"{cls.__name__} keys {later} are not ported to "
                "dorpatch_tpu_torch (their subsystems are not in this "
                "package)")
        unknown = set(sub) - fields
        if unknown:
            raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in sub.items()})

    d = dict(d)
    attack = build(AttackConfig, d.pop("attack", {}))
    defense = build(DefenseConfig, d.pop("defense", {}))
    serve = build(ServeConfig, d.pop("serve", {}))
    farm = build(FarmConfig, d.pop("farm", {}))
    recert = build(RecertConfig, d.pop("recert", {}))
    gateway = build(GatewayConfig, d.pop("gateway", {}))
    cfg = build(ExperimentConfig, d)
    return dataclasses.replace(cfg, attack=attack, defense=defense,
                               serve=serve, farm=farm, recert=recert,
                               gateway=gateway)


def resolved_data_source(cfg: ExperimentConfig) -> str:
    """`cfg.data_source` with "auto" mapped through `synthetic_data`."""
    source = cfg.data_source
    if source != "auto":
        if source not in ("disk", "synthetic", "procedural"):
            raise ValueError(f"unknown data_source {source!r}")
        return source
    return "synthetic" if cfg.synthetic_data else "disk"
