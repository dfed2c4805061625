"""Command line of the port: the flags of `dorpatch_tpu.cli` (names,
aliases, defaults, choices and help), plus `--device`.
`python -m dorpatch_tpu_torch.serve` reuses this parser (the `--serve-*`
group, `--chaos` with the serve faults, `--no-metrics-log`, and the
recert boot gate's `--recert-dir`, `--recert-baseline` and
`--require-recert`), and so does `python -m dorpatch_tpu_torch.gateway`
(the `--gateway-*` group, `--chaos` with the gateway faults). The
`--farm-*` flags land in the config record (`run.json`) a farm spec's
`base` carries.

`--mesh-data D --mesh-mask M` (JAX defaults 1, 1) run the experiment on a
`(data, mask)` mesh of D * M processes, one a rank, launched by torchrun
(`parallel/`). `--aot-cache DIR --aot auto|strict` warm-boot the service
from the executable store (`aot/`). Not offered, because the port has no
such subsystem: `--backend`, `--use-pallas` and `--gn-impl` (the port
picks its CUDA kernels itself).

Run:  python -m dorpatch_tpu_torch --synthetic --dataset imagenet \\
          --base_arch resnetv2 --img-size 224 --max-iterations 20 -b 2
      python -m dorpatch_tpu_torch --synthetic --dataset cifar10 \\
          --base_arch resnet18 --img-size 32 --max-iterations 20 -b 8
      python -m dorpatch_tpu_torch --synthetic --dataset imagenet \\
          --base_arch vit --img-size 224 --max-iterations 20 -b 2
      python -m dorpatch_tpu_torch --synthetic --base_arch resnetv2 \\
          --img-size 224 -b 2 --compute-dtype bfloat16 --certify-dtype bfloat16
      python -m dorpatch_tpu_torch --synthetic --dataset imagenet \\
          --base_arch resmlp --img-size 224 --max-iterations 20 -b 2
      python -m dorpatch_tpu_torch --synthetic --dataset cifar10 \\
          --base_arch resnet18 --img-size 32 --defense-n-patch 2
      python -m dorpatch_tpu_torch --dataset cifar10 --data_dir DIR \\
          --base_arch resnet18 --img-size 32 --prune consensus
      python -m dorpatch_tpu_torch --synthetic --base_arch resnetv2 \\
          --img-size 480 -b 2 --remat on --remat-policy full
      python -m dorpatch_tpu_torch --synthetic --dataset cifar10 \\
          --base_arch resnet18 --img-size 32 --sanitize
      torchrun --nproc-per-node 4 -m dorpatch_tpu_torch --synthetic \\
          --dataset cifar10 --base_arch resnet18 --img-size 32 -b 8 \\
          --mesh-data 2 --mesh-mask 2
"""

from __future__ import annotations

import argparse

from dorpatch_tpu_torch.config import (AotConfig, AttackConfig,
                                       DefenseConfig,
                                       ExperimentConfig, FarmConfig,
                                       GatewayConfig, RecertConfig,
                                       ServeConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DorPatch on PyTorch/CUDA: distributed occlusion-robust "
        "adversarial patches vs PatchCleanser certification")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the GPU (default) or, on request, "
                        "the CPU with the kernels' plain versions")
    p.add_argument("--dataset", "-d", default="imagenet",
                   choices=["cifar10", "imagenet", "cifar100"])
    p.add_argument("--data_dir", default="/home/data/data",
                   help="dataset root of the disk source: "
                        "<dir>/cifar10/cifar-10-batches-py, "
                        "<dir>/cifar100/cifar-100-python, "
                        "<dir>/imagenet/val/<class>/<image>")
    p.add_argument("--model_dir", default="pretrained_models/")
    p.add_argument("--base_arch", "-ba", default="resnetv2",
                   choices=["resnetv2", "resnet18", "cifar_resnet18", "vit",
                            "cifar_vit", "resmlp", "cifar_resmlp"])
    p.add_argument("--targeted", "-t", action="store_true")
    p.add_argument("--patch_budget", type=float, default=0.12)
    p.add_argument("--attack", "-a", default="DorPatch", choices=["DorPatch"])
    p.add_argument("-b", "--batch-size", type=int, default=1)
    p.add_argument("-e", "--epsilon", type=float, default=4.0,
                   help="L2 bound")
    p.add_argument("--lr", "--learning-rate", type=float, default=0.01)
    p.add_argument("--num_patch", type=int, default=-1)
    p.add_argument("--dropout", type=int, default=2, choices=[0, 1, 2])
    p.add_argument("--density", type=float, default=1e-3)
    p.add_argument("--structured", type=float, default=1e-3)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (no dataset on disk needed)")
    p.add_argument("--data-source", default="auto",
                   choices=["auto", "disk", "synthetic", "procedural"],
                   help="image stream: 'disk' reads --data_dir (needs "
                        "Pillow); 'procedural' = the learnable generated "
                        "task with genuine labels; 'auto' follows "
                        "--synthetic")
    p.add_argument("--num-batches", type=int, default=10)
    p.add_argument("--max-iterations", type=int, default=5000)
    p.add_argument("--sampling-size", type=int, default=128)
    p.add_argument("--basic-unit", type=int, default=7,
                   help="patch group cell size")
    p.add_argument("--switch-iteration", type=int, default=500,
                   help="stage-0 untargeted->targeted switch iteration")
    p.add_argument("--sweep-interval", type=int, default=100,
                   help="full-universe failure-sweep cadence in iterations")
    p.add_argument("--failure-sampling-start", type=int, default=1000,
                   help="iteration from which mask sampling biases toward "
                        "the failure set")
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--results-root", default="results")
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data axis of the mesh (images); with --mesh-mask, "
                        "one process a rank under torchrun")
    p.add_argument("--mesh-mask", type=int, default=1,
                   help="mask axis of the mesh (the masked copies of an "
                        "image)")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="EOT forward+backward precision (carry stays float32)")
    p.add_argument("--remat", default="auto", choices=["auto", "on", "off"],
                   help="rematerialize the EOT forward in the backward "
                        "(activation memory for step time; auto: only when "
                        "the masked batch exceeds the remat threshold, "
                        "1024 masked images)")
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "conv", "dots"],
                   help="what an active remat keeps inside each residual "
                        "block: full = nothing; conv = the conv outputs, "
                        "replaying only the normalize chains (ResNetV2); "
                        "dots = the matmul outputs (ViT/ResMLP)")
    p.add_argument("--certify-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="certification sweep precision (the defense's "
                        "compute_dtype): 'bfloat16' runs the masked "
                        "forwards - phase-1 tables, pair audits, rows, "
                        "and the incremental engines - in bf16 with f32 "
                        "logit/margin readouts; images whose evaluated "
                        "entries come within --incremental-margin of the "
                        "argmax boundary re-certify through the f32 "
                        "exhaustive sweep, so verdicts never weaken")
    p.add_argument("--dual", action="store_true",
                   help="second independent occlusion layer per EOT sample")
    p.add_argument("--defense-n-patch", type=int, default=1, choices=[1, 2],
                   help="PatchCleanser mask-set patch count of the defense "
                        "bank: 2 = pair/triple mask sets, certified by the "
                        "exhaustive sweep (--prune resolves to 'off')")
    p.add_argument("--prune", default="exact",
                   choices=["off", "exact", "consensus"],
                   help="certification scheduling: 'exact' (default) runs "
                        "the two-phase pruned path with verdicts identical "
                        "to 'off', the exhaustive 666-forward sweep; "
                        "'consensus' also stops first-round-unanimous "
                        "images after the first round (weaker, "
                        "consensus-only certificates)")
    p.add_argument("--no-prune", dest="prune", action="store_const",
                   const="off", help="alias for --prune off")
    p.add_argument("--incremental", default="auto",
                   choices=["auto", "token", "token-exact", "mixer",
                            "mixer-exact", "stem", "off"],
                   help="incremental masked forwards on the pruned path: "
                        "'auto' picks per family, 'stem' for conv victims "
                        "(the first round folded into the conv stem, "
                        "kernel C on the card), 'token-exact' for ViT "
                        "victims (token-pruned forwards over a clean KV "
                        "cache, kernel H on the card) and 'mixer-exact' "
                        "for ResMLP victims (dirty-row tracking through a "
                        "skinny slice of the token-mixing matmul); the "
                        "'-exact' modes re-certify through the exhaustive "
                        "sweep every image whose read entries come within "
                        "--incremental-margin of the decision boundary, "
                        "plain 'token'/'mixer' skip that; 'off' runs full "
                        "masked forwards")
    p.add_argument("--incremental-margin", type=float, default=0.5,
                   help="token/mixer-exact escalation threshold: the top-2 "
                        "logit gap below which an incremental entry is "
                        "distrusted and its image re-certified "
                        "exhaustively")
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--sanitize", action="store_true",
                   help="arm the runtime sanitizers: NaN checks that name "
                        "the op or kernel that produced a NaN, compile-like "
                        "events (kernel builds, new program input "
                        "signatures) in events.jsonl, the programs' shape "
                        "budgets enforced, the lock watch; debugging runs "
                        "only, costs throughput")
    p.add_argument("--no-metrics-log", action="store_true",
                   help="disable run telemetry (metrics.jsonl, "
                        "events.jsonl, heartbeats, metrics.json) in the "
                        "results dir")
    p.add_argument("--hang-timeout", type=float, default=0.0,
                   help="seconds without telemetry progress before the "
                        "watchdog prints every process's last-known phase "
                        "and aborts (0 = disabled); must exceed the longest "
                        "single attack block including the kernels' build; "
                        "requires telemetry (no effect with --no-metrics-log)")
    p.add_argument("--heartbeat-interval", type=float, default=5.0,
                   help="seconds between heartbeat_<proc>.jsonl beats")
    p.add_argument("--carry-checkpoints", action="store_true",
                   help="checkpoint the optimizer carry every sweep block "
                        "(mid-stage crash recovery)")
    # serving (`python -m dorpatch_tpu_torch.serve` reuses this parser)
    p.add_argument("--serve-port", type=int, default=8700,
                   help="HTTP front-end port for the certified-inference "
                        "service (0 = ephemeral)")
    p.add_argument("--serve-max-batch", type=int, default=8,
                   help="largest serving micro-batch; shape buckets are "
                        "data.batch_buckets(max_batch), e.g. 8 -> 1/8")
    p.add_argument("--serve-queue-depth", type=int, default=64,
                   help="backpressure bound: requests past this queue depth "
                        "are rejected with a typed Overloaded response")
    p.add_argument("--serve-deadline-ms", type=float, default=2000.0,
                   help="default per-request latency budget; the batcher "
                        "flushes a partial batch once half of it is spent")
    p.add_argument("--serve-replicas", type=int, default=1,
                   help="replica pool size: worker threads sharing the one "
                        "micro-batcher queue, each owning its own defense "
                        "bank and CUDA stream; a supervisor quarantines "
                        "and restarts sick replicas (serve/pool.py)")
    p.add_argument("--serve-max-restarts", type=int, default=2,
                   help="restarts a quarantined replica gets (AOT warm "
                        "boot when --aot-cache is set) before it retires "
                        "and the pool degrades to reduced capacity")
    p.add_argument("--serve-restart-backoff-base", type=float, default=0.5,
                   help="replica restart backoff base seconds (shared "
                        "backoff.retry_delay: base * 2^(n-1), capped, "
                        "deterministic jitter)")
    p.add_argument("--serve-restart-backoff-cap", type=float, default=30.0,
                   help="replica restart backoff cap seconds")
    p.add_argument("--serve-replica-stale-s", type=float, default=0.0,
                   help="missed-beat staleness window before the "
                        "supervisor declares a replica wedged (0 = derive "
                        "from --serve-deadline-ms); raise it above the "
                        "slowest legitimate batch — replicas beat only at "
                        "batch boundaries, so a window shorter than one "
                        "batch false-positives a healthy replica as wedged")
    # AOT executable store (`python -m dorpatch_tpu_torch.aot build` writes
    # it; serve warm-boots from it, farm workers take --aot-store)
    p.add_argument("--aot-cache", default="",
                   help="AOT executable store directory: serve boots every "
                        "program keyed by its baseline fingerprint and "
                        "captures it as a CUDA graph, with the kernel "
                        "library from the store ('' = disabled)")
    p.add_argument("--aot", default="off",
                   choices=["off", "auto", "strict"],
                   help="warm-boot mode: 'auto' captures-and-rewrites the "
                        "store on any miss (fingerprint/topology drift, "
                        "corrupt blob — never serves stale); 'strict' is "
                        "the deploy mode, failing boot on any miss before "
                        "warmup so a fleet restart either comes up warm or "
                        "visibly refuses")
    # continuous re-certification (`python -m dorpatch_tpu_torch.recert`
    # runs the scheduler; serve consults its published verdict at boot)
    p.add_argument("--recert-dir", default="",
                   help="recert directory holding the scheduler's published "
                        "robustness verdict (recert_verdict.json); enables "
                        "GET /robustness on the serve front-end "
                        "('' = no robustness surface)")
    p.add_argument("--recert-baseline", default="",
                   help="robustness baseline file override ('' = the "
                        "package's recert/robustness_baseline.json)")
    p.add_argument("--require-recert", default="off",
                   choices=["off", "warn", "strict"],
                   help="serve-boot robustness gate against the recert "
                        "verdict: 'warn' serves on a failing/stale verdict "
                        "but reports it (canary mode); 'strict' is the "
                        "deploy mode — boot refuses serving-ready with a "
                        "typed error unless the verdict exists and is ok, "
                        "so a fleet never serves silently-uncertified "
                        "(as the JAX package's --aot strict)")
    # fleet gateway (`python -m dorpatch_tpu_torch.gateway` routes POST
    # /predict across N serve processes)
    p.add_argument("--gateway-backends", default="",
                   help="comma-joined backend base URLs "
                        "(http://host:port) the gateway fronts; each is a "
                        "`python -m dorpatch_tpu_torch.serve` process")
    p.add_argument("--gateway-port", type=int, default=8800,
                   help="gateway bind port (0 = ephemeral)")
    p.add_argument("--gateway-probe-interval", type=float, default=1.0,
                   help="per-backend health-probe cadence seconds "
                        "(/healthz + /stats + /robustness, jittered)")
    p.add_argument("--gateway-fail-threshold", type=int, default=3,
                   help="consecutive probe failures before a backend is "
                        "ejected from routing")
    p.add_argument("--gateway-ok-threshold", type=int, default=2,
                   help="consecutive probe successes before an ejected "
                        "backend is re-admitted (flap hysteresis)")
    p.add_argument("--gateway-inflight-cap", type=int, default=32,
                   help="per-backend concurrent dispatches before the "
                        "gateway answers typed Overloaded (503)")
    p.add_argument("--gateway-canary-steps", default="0.1,0.5,1.0",
                   help="rolling-deploy traffic fractions the canary group "
                        "is stepped through (comma-joined floats)")
    p.add_argument("--gateway-canary-hold", type=float, default=2.0,
                   help="soak seconds per canary step before evaluating "
                        "its robustness verdict")
    # farm (`python -m dorpatch_tpu_torch.farm` shares these defaults;
    # setting them here persists them into the config record a spec's
    # `base` carries)
    p.add_argument("--farm-lease-ttl", type=float, default=60.0,
                   help="attack-sweep farm: heartbeat staleness (seconds) "
                        "after which a worker's leased jobs are reclaimable "
                        "by survivors; must exceed both the worker "
                        "heartbeat interval and the longest gap between "
                        "attack-block boundaries (lease renewal points)")
    p.add_argument("--farm-max-attempts", type=int, default=3,
                   help="attack-sweep farm: per-job attempt cap across "
                        "transient retries and crash reclaims")
    p.add_argument("--farm-backoff-base", type=float, default=2.0,
                   help="attack-sweep farm: transient retry delay base "
                        "(base * 2^(attempt-1), capped, plus deterministic "
                        "per-job jitter)")
    p.add_argument("--chaos", default="",
                   help="deterministic fault injection (recovery testing; "
                        "dorpatch_tpu_torch.chaos): comma-joined list. "
                        "Serve faults (python -m dorpatch_tpu_torch.serve): "
                        "wedge_dispatch, raise_in_worker, wedge_heartbeat, "
                        "kill_backend. Gateway faults (python -m "
                        "dorpatch_tpu_torch.gateway): wedge_probe, "
                        "poison_canary")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        dataset=args.dataset,
        data_dir=args.data_dir,
        model_dir=args.model_dir,
        base_arch=args.base_arch,
        attack_name=args.attack,
        batch_size=args.batch_size,
        num_batches=args.num_batches,
        seed=args.seed,
        device=args.device,
        results_root=args.results_root,
        synthetic_data=args.synthetic,
        data_source=args.data_source,
        img_size=args.img_size,
        metrics_log=not args.no_metrics_log,
        trace_dir=args.trace_dir,
        hang_timeout=args.hang_timeout,
        heartbeat_interval=args.heartbeat_interval,
        carry_checkpoints=args.carry_checkpoints,
        mesh_data=args.mesh_data,
        mesh_mask=args.mesh_mask,
        sanitize=args.sanitize,
        attack=AttackConfig(patch_budget=args.patch_budget,
                            targeted=args.targeted,
                            lr=args.lr,
                            max_iterations=args.max_iterations,
                            switch_iteration=args.switch_iteration,
                            sweep_interval=args.sweep_interval,
                            failure_sampling_start=args.failure_sampling_start,
                            basic_unit=args.basic_unit,
                            dropout=args.dropout,
                            sampling_size=args.sampling_size,
                            density=args.density,
                            structured=args.structured,
                            eps=args.epsilon,
                            num_patch=args.num_patch,
                            dual=args.dual,
                            compute_dtype=args.compute_dtype,
                            remat=args.remat,
                            remat_policy=args.remat_policy),
        defense=DefenseConfig(n_patch=args.defense_n_patch,
                              prune=args.prune,
                              incremental=args.incremental,
                              incremental_margin=args.incremental_margin,
                              compute_dtype=args.certify_dtype),
        serve=ServeConfig(port=args.serve_port,
                          max_batch=args.serve_max_batch,
                          max_queue_depth=args.serve_queue_depth,
                          deadline_ms=args.serve_deadline_ms,
                          replicas=args.serve_replicas,
                          max_restarts=args.serve_max_restarts,
                          restart_backoff_base=args.serve_restart_backoff_base,
                          restart_backoff_cap=args.serve_restart_backoff_cap,
                          replica_stale_s=args.serve_replica_stale_s,
                          chaos=args.chaos),
        farm=FarmConfig(lease_ttl=args.farm_lease_ttl,
                        max_attempts=args.farm_max_attempts,
                        backoff_base=args.farm_backoff_base,
                        chaos=args.chaos),
        aot=AotConfig(cache_dir=args.aot_cache, mode=args.aot),
        recert=RecertConfig(dir=args.recert_dir,
                            baseline_file=args.recert_baseline,
                            require=args.require_recert),
        gateway=GatewayConfig(
            backends=tuple(b for b in args.gateway_backends.split(",") if b),
            port=args.gateway_port,
            probe_interval_s=args.gateway_probe_interval,
            fail_threshold=args.gateway_fail_threshold,
            ok_threshold=args.gateway_ok_threshold,
            inflight_cap=args.gateway_inflight_cap,
            canary_steps=tuple(float(s) for s in
                               args.gateway_canary_steps.split(",") if s),
            canary_hold_s=args.gateway_canary_hold,
            chaos=args.chaos),
    )


def main(argv=None):
    cfg = config_from_args(build_parser().parse_args(argv))
    from dorpatch_tpu_torch.pipeline import run_experiment

    return run_experiment(cfg)


if __name__ == "__main__":
    main()
