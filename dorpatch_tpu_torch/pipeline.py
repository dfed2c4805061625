"""End-to-end experiment driver, per batch:

  filter correctly-classified -> resume or run DorPatch.generate ->
  L2-project the patch -> certify with the 4-radius defense bank ->
  accumulate records -> report.

Port of `dorpatch_tpu.pipeline.run_experiment` for one device, without the
mesh layer. Runs on `cfg.device` ("cuda" unless the caller asks for "cpu"),
in full float32 (`utils.configure_numerics`) unless the config asks for
bf16: the attack's `compute_dtype` (`--compute-dtype`) and the certify
bank's (`--certify-dtype`) reach `DorPatch` and `build_defenses` with the
config.

Run telemetry (`observe/`), the JAX package's files and span names:
`run.json` always; with `metrics_log`, `events.jsonl` (spans `run`,
`setup`, `data`, `batch` with `images` and `cached`, `attack`, `certify`
with the forward counts and `compute_dtype`, `artifact_io` with `op`,
`finalize`, and a `block` record per attack block), `heartbeat_0.jsonl`,
`metrics.jsonl` (`observe.AttackMetricsLogger`) and, under
`hang_timeout`, the watchdog; `trace_dir` wraps the run in a
`torch.profiler` trace. `sanitize` arms the runtime sanitizers
(`analysis/sanitize.py`) once the event log is active, so their events
land in `events.jsonl`; the programs' shape budgets are declared always,
as in the JAX package (the batch size for the attack's step and sweep,
the image buckets for certification's), and enforced only then. Input
streams through `data.streaming_batches` when `stream_depth` > 0.
`carry_checkpoints` snapshots the attack's carry under
`<results>/carry_<batch>` at every block (cleared on success, kept on
failure for the next run to resume from).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from dorpatch_tpu_torch import data, losses, metrics, observe, utils
from dorpatch_tpu_torch.artifacts import (ArtifactStore, results_path,
                                          write_config_record)
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.checkpoint import CarryCheckpointer
from dorpatch_tpu_torch.config import ExperimentConfig, resolved_data_source
from dorpatch_tpu_torch.defense import build_defenses
from dorpatch_tpu_torch.models import get_model


def _random_targets(rng: np.random.Generator, y: np.ndarray,
                    n_classes: int) -> np.ndarray:
    """Random targets != label (re-sampled on a clash)."""
    t = rng.integers(0, n_classes, y.shape)
    while (t == y).any():
        clash = t == y
        t[clash] = rng.integers(0, n_classes, clash.sum())
    return t


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_experiment(cfg: ExperimentConfig, verbose: bool = True) -> Dict:
    """Run the full pipeline; returns the metrics dict with the report
    line, the attack and certify seconds and the forward counts."""
    dev = utils.resolve_device(cfg.device)
    utils.configure_numerics()
    utils.set_global_seed(cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    store = ArtifactStore(results_path(cfg))
    if verbose:
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        observe.log(f"device: {dev} ({name}); attack "
                    f"{cfg.attack.compute_dtype}, certification "
                    f"{cfg.defense.compute_dtype}")

    # run telemetry: a per-attempt run_id stamps every record, so resumed
    # runs stay groupable; run.json makes the results dir self-describing
    run_id = observe.new_run_id()
    write_config_record(cfg, store.result_dir)
    observe.write_run_manifest(store.result_dir, cfg, run_id=run_id,
                               extra=observe.torch_environment())
    elog = hb = watchdog = None
    if cfg.metrics_log:
        elog = observe.EventLog(
            os.path.join(store.result_dir, observe.events_filename(0)),
            run_id=run_id)
        hb = observe.Heartbeat(
            os.path.join(store.result_dir, observe.heartbeat_filename(0)),
            get_phase=elog.current_path, interval=cfg.heartbeat_interval,
            run_id=run_id)
        if cfg.hang_timeout > 0:
            watchdog = observe.Watchdog(store.result_dir, elog,
                                        cfg.hang_timeout)
    elif cfg.hang_timeout > 0:
        # the watchdog's progress signal is the event log
        observe.log(f"WARNING: --hang-timeout {cfg.hang_timeout:g} ignored: "
                    "telemetry is disabled (--no-metrics-log)",
                    file=sys.stderr)
    logger = observe.AttackMetricsLogger(
        path=(os.path.join(store.result_dir, "metrics.jsonl")
              if cfg.metrics_log else None),
        echo_every=cfg.attack.report_interval if verbose else 0,
        run_id=run_id)

    def _on_block(stage, step, info):
        logger.on_block_end(stage, step, info)
        if elog is not None:  # block wall time + device-memory sample
            elog.block_boundary(stage, step, info)

    with contextlib.ExitStack() as stack:
        if elog is not None:
            stack.enter_context(elog)
            stack.enter_context(hb)
            if watchdog is not None:
                stack.enter_context(watchdog)
        if cfg.sanitize:
            from dorpatch_tpu_torch.analysis.sanitize import Sanitizer

            stack.enter_context(Sanitizer())
        stack.enter_context(observe.trace(cfg.trace_dir))
        stack.enter_context(logger)
        stack.enter_context(observe.span("run", processes=1))
        stack.enter_context(torch.no_grad())
        with observe.span("setup"):
            victim = get_model(cfg.dataset, cfg.base_arch, cfg.model_dir,
                               cfg.img_size, device=dev)
            cert_buckets = data.batch_buckets(cfg.batch_size)
            defenses = build_defenses(victim.apply, cfg.img_size,
                                      cfg.defense,
                                      incremental=victim.incremental,
                                      device=dev,
                                      recompile_budget=len(cert_buckets))
            attack = DorPatch(victim.apply, victim.num_classes, cfg.attack,
                              on_block_end=_on_block,
                              recompile_budget=int(cfg.batch_size))
        return _run_batches(cfg, dev, rng, store, victim, defenses,
                            cert_buckets, attack, logger, verbose)


def _run_batches(cfg, dev, rng, store, victim, defenses, cert_buckets,
                 attack, logger, verbose) -> Dict:
    preds_list: List[np.ndarray] = []
    y_list: List[np.ndarray] = []
    preds_adv_list: List[np.ndarray] = []
    target_list: List[np.ndarray] = []
    records: List[List] = []
    attack_seconds: List[float] = []
    certify_seconds: List[float] = []
    forwards = forwards_exhaustive = 0
    forward_equivalents = 0.0
    escalated = 0
    generated_images = 0

    source = resolved_data_source(cfg)
    if cfg.stream_depth > 0:
        batches = data.streaming_batches(
            cfg.dataset, cfg.batch_size, cfg.img_size, cfg.seed,
            source=source, data_dir=cfg.data_dir, depth=cfg.stream_depth,
            device=dev)
    else:
        batches = data.dataset_batches(cfg.dataset, cfg.batch_size,
                                       cfg.img_size, cfg.seed, source=source,
                                       data_dir=cfg.data_dir)
    batch_iter = enumerate(batches)
    try:
        while True:
            # the data fetch in its own span, so the batch spans and these
            # cover the loop's wall time
            with observe.span("data"):
                nxt = next(batch_iter, None)
            if nxt is None:
                break
            i, (x_in, y_np) = nxt
            if i == cfg.num_batches:
                break
            t0 = time.time()
            logger.set_batch(i)
            with observe.span("batch", batch=i) as sp_batch:
                x = torch.as_tensor(x_in, device=dev)
                # keep only correctly-classified images
                preds = torch.argmax(victim.apply(x), -1).cpu().numpy()
                if source == "synthetic":
                    # synthetic labels are random: score against the
                    # model's own clean predictions instead
                    y_np = preds.copy()
                correct = preds == y_np
                sp_batch["images"] = int(correct.sum())
                if correct.sum() == 0:
                    continue
                x = x[torch.as_tensor(correct, device=dev)]
                y_np, preds = y_np[correct], preds[correct]

                with observe.span("artifact_io", op="load_patch"):
                    cached = store.load_patch(i)
                sp_batch["cached"] = cached is not None
                if cached is not None:
                    adv_mask, adv_pattern = (torch.as_tensor(a, device=dev)
                                             for a in cached)
                    if cfg.attack.targeted:
                        def _rederive(s0):
                            d0 = losses.l2_project(
                                torch.as_tensor(s0[0], device=dev),
                                torch.as_tensor(s0[1], device=dev), x,
                                cfg.attack.eps)
                            return torch.argmax(victim.apply(x + d0),
                                                -1).cpu().numpy()

                        with observe.span("artifact_io",
                                          op="resolve_targets"):
                            target_list.append(
                                store.resolve_targets(i, _rederive))
                else:
                    y_attack = None
                    if cfg.attack.targeted:
                        y_attack = torch.as_tensor(
                            _random_targets(rng, y_np, victim.num_classes),
                            device=dev)
                    ck = None
                    if cfg.carry_checkpoints:
                        ck = CarryCheckpointer(
                            os.path.join(store.result_dir, f"carry_{i}"),
                            fingerprint={"seed": int(cfg.seed),
                                         "batch": int(i),
                                         "n_images": int(x.shape[0]),
                                         "attack": repr(cfg.attack)})
                        attack.checkpointer = ck
                    _sync(dev)
                    ta = time.perf_counter()
                    try:
                        with observe.span("attack"):
                            result = attack.generate(
                                x, y=y_attack, targeted=cfg.attack.targeted,
                                seed=cfg.seed + i, store=store, batch_id=i)
                            _sync(dev)
                        if ck is not None:
                            ck.clear()  # success: no stale carry leaks
                    finally:
                        attack.checkpointer = None
                        if ck is not None:
                            ck.close()  # on failure the snapshots stay
                    attack_seconds.append(time.perf_counter() - ta)
                    generated_images += int(x.shape[0])
                    if cfg.attack.targeted:
                        # the target the attack optimized toward (after a
                        # resume: the snapshot's, not this run's draw)
                        target_list.append(result.y)
                        with observe.span("artifact_io", op="save_targets"):
                            store.save_targets(i, result.y)
                    adv_mask, adv_pattern = (result.adv_mask,
                                             result.adv_pattern)
                    with observe.span("artifact_io", op="save_patch"):
                        store.save_patch(i, adv_mask, adv_pattern)

                delta = losses.l2_project(adv_mask, adv_pattern, x,
                                          cfg.attack.eps)
                adv_x = x + delta

                with observe.span("artifact_io", op="load_pc_records"):
                    recs = store.load_pc_records(i)
                if recs is not None and any(len(r) != len(defenses)
                                            for r in recs):
                    recs = None
                if recs is None:
                    with observe.span(
                            "certify", batch=i, images=int(x.shape[0]),
                            compute_dtype=(
                                "bf16"
                                if cfg.defense.compute_dtype == "bfloat16"
                                else "f32")) as sp_cert:
                        _sync(dev)
                        tc = time.perf_counter()
                        per_defense = [
                            d.robust_predict(adv_x, victim.num_classes,
                                             bucket_sizes=cert_buckets)
                            for d in defenses]
                        _sync(dev)
                        certify_seconds.append(time.perf_counter() - tc)
                        n_fwd = sum(max(0, r.forwards)
                                    for recs_d in per_defense
                                    for r in recs_d)
                        # incremental entries count their fraction of a
                        # forward
                        n_eq = sum(max(0.0, r.forward_equivalents)
                                   for recs_d in per_defense
                                   for r in recs_d)
                        n_exh = int(x.shape[0]) * sum(
                            d.num_forwards_exhaustive for d in defenses)
                        sp_cert["forwards"] = int(n_fwd)
                        sp_cert["forward_equivalents"] = round(n_eq, 2)
                        sp_cert["forwards_exhaustive"] = n_exh
                    forwards += n_fwd
                    forward_equivalents += n_eq
                    forwards_exhaustive += n_exh
                    # an escalated record paid the exhaustive sweep on top
                    # of its first round, so its forwards exceed the sweep's
                    escalated += sum(r.forwards > d.num_forwards_exhaustive
                                     for d, recs_d in zip(defenses,
                                                          per_defense)
                                     for r in recs_d)
                    recs = [list(r) for r in zip(*per_defense)]
                    with observe.span("artifact_io", op="save_pc_records"):
                        store.save_pc_records(i, recs)

                preds_list.append(preds)
                y_list.append(y_np)
                preds_adv_list.append(
                    torch.argmax(victim.apply(adv_x), -1).cpu().numpy())
                records.extend(recs)
                if verbose:
                    observe.log(f"batch {i}: {len(y_np)} imgs in "
                                f"{time.time() - t0:.1f}s")
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()  # stop the loader thread of a stream cut short

    with observe.span("finalize"):
        if not preds_list:
            empty = {"clean_accuracy": 0.0, "robust_accuracy": 0.0,
                     "acc_pc": [], "certified_acc_pc": [],
                     "certified_asr_pc": [], "evaluated_images": 0,
                     "report": "no correctly-classified images evaluated"}
            if verbose:
                observe.log(empty["report"])
            return empty
        y_all = np.concatenate(y_list)
        targets = np.concatenate(target_list) if target_list else None
        for di, d in enumerate(defenses):
            d.collect([r[di] for r in records])
        m = metrics.compute_metrics(np.concatenate(preds_list), y_all,
                                    np.concatenate(preds_adv_list),
                                    [d.result for d in defenses], targets)
        m["evaluated_images"] = int(len(y_all))
        if targets is not None:
            m["targets"] = [int(t) for t in targets]
        if attack_seconds:
            m["attack_seconds"] = attack_seconds
            m["attack_images_per_sec"] = (generated_images
                                          / sum(attack_seconds))
        if certify_seconds:
            m["certify_seconds"] = certify_seconds
            m["forwards"] = int(forwards)
            m["forward_equivalents"] = round(forward_equivalents, 2)
            m["forwards_exhaustive"] = int(forwards_exhaustive)
            m["escalated"] = int(escalated)
        m["report"] = metrics.report_line(m)
        if verbose:
            observe.log(m["report"])
        try:
            with open(os.path.join(store.result_dir, "summary.json"),
                      "w") as fh:
                json.dump(m, fh, indent=1, default=float)
        except OSError:
            pass
        return m
