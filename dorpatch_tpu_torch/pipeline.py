"""End-to-end experiment driver, per batch:

  filter correctly-classified -> resume or run DorPatch.generate ->
  L2-project the patch -> certify with the 4-radius defense bank ->
  accumulate records -> report.

Port of `dorpatch_tpu.pipeline.run_experiment` for one device, without the
telemetry, mesh, streaming and carry-checkpoint layers. Runs on
`cfg.device` ("cuda" unless the caller asks for "cpu"), in full float32
(`utils.configure_numerics`) unless the config asks for bf16: the attack's
`compute_dtype` (`--compute-dtype`) and the certify bank's
(`--certify-dtype`) reach `DorPatch` and `build_defenses` with the
config.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from dorpatch_tpu_torch import data, losses, metrics, utils
from dorpatch_tpu_torch.artifacts import (ArtifactStore, results_path,
                                          write_config_record)
from dorpatch_tpu_torch.attack import DorPatch
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
    write_config_record(cfg, store.result_dir)
    if verbose:
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        print(f"device: {dev} ({name}); attack {cfg.attack.compute_dtype}, "
              f"certification {cfg.defense.compute_dtype}", flush=True)

    victim = get_model(cfg.dataset, cfg.base_arch, cfg.model_dir,
                       cfg.img_size, device=dev)
    cert_buckets = data.batch_buckets(cfg.batch_size)
    defenses = build_defenses(victim.apply, cfg.img_size, cfg.defense,
                              incremental=victim.incremental, device=dev)
    attack = DorPatch(victim.apply, victim.num_classes, cfg.attack)

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
    batches = data.dataset_batches(cfg.dataset, cfg.batch_size, cfg.img_size,
                                   cfg.seed, source=source)
    with torch.no_grad():
        for i, (x_np, y_np) in enumerate(batches):
            if i == cfg.num_batches:
                break
            t0 = time.time()
            x = torch.as_tensor(x_np, device=dev)
            # keep only correctly-classified images
            preds = torch.argmax(victim.apply(x), -1).cpu().numpy()
            if source == "synthetic":
                # synthetic labels are random: score against the model's own
                # clean predictions instead
                y_np = preds.copy()
            correct = preds == y_np
            if correct.sum() == 0:
                continue
            x = x[torch.as_tensor(correct, device=dev)]
            y_np, preds = y_np[correct], preds[correct]

            cached = store.load_patch(i)
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

                    target_list.append(store.resolve_targets(i, _rederive))
            else:
                y_attack = None
                if cfg.attack.targeted:
                    y_attack = torch.as_tensor(
                        _random_targets(rng, y_np, victim.num_classes),
                        device=dev)
                _sync(dev)
                ta = time.perf_counter()
                result = attack.generate(x, y=y_attack,
                                         targeted=cfg.attack.targeted,
                                         seed=cfg.seed + i, store=store,
                                         batch_id=i)
                _sync(dev)
                attack_seconds.append(time.perf_counter() - ta)
                generated_images += int(x.shape[0])
                if cfg.attack.targeted:
                    target_list.append(result.y)
                    store.save_targets(i, result.y)
                adv_mask, adv_pattern = result.adv_mask, result.adv_pattern
                store.save_patch(i, adv_mask, adv_pattern)

            delta = losses.l2_project(adv_mask, adv_pattern, x,
                                      cfg.attack.eps)
            adv_x = x + delta

            recs = store.load_pc_records(i)
            if recs is not None and any(len(r) != len(defenses) for r in recs):
                recs = None
            if recs is None:
                _sync(dev)
                tc = time.perf_counter()
                per_defense = [d.robust_predict(adv_x, victim.num_classes,
                                                bucket_sizes=cert_buckets)
                               for d in defenses]
                _sync(dev)
                certify_seconds.append(time.perf_counter() - tc)
                forwards += sum(max(0, r.forwards)
                                for recs_d in per_defense for r in recs_d)
                # token-pruned entries count their fraction of a forward
                forward_equivalents += sum(
                    max(0.0, r.forward_equivalents)
                    for recs_d in per_defense for r in recs_d)
                forwards_exhaustive += int(x.shape[0]) * sum(
                    d.num_forwards_exhaustive for d in defenses)
                # an escalated record paid the exhaustive sweep on top of
                # its first round, so its forwards exceed the sweep's
                escalated += sum(r.forwards > d.num_forwards_exhaustive
                                 for d, recs_d in zip(defenses, per_defense)
                                 for r in recs_d)
                recs = [list(r) for r in zip(*per_defense)]
                store.save_pc_records(i, recs)

            preds_list.append(preds)
            y_list.append(y_np)
            preds_adv_list.append(
                torch.argmax(victim.apply(adv_x), -1).cpu().numpy())
            records.extend(recs)
            if verbose:
                print(f"batch {i}: {len(y_np)} imgs in "
                      f"{time.time() - t0:.1f}s", flush=True)

    if not preds_list:
        empty = {"clean_accuracy": 0.0, "robust_accuracy": 0.0, "acc_pc": [],
                 "certified_acc_pc": [], "certified_asr_pc": [],
                 "evaluated_images": 0,
                 "report": "no correctly-classified images evaluated"}
        if verbose:
            print(empty["report"], flush=True)
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
        m["attack_images_per_sec"] = generated_images / sum(attack_seconds)
    if certify_seconds:
        m["certify_seconds"] = certify_seconds
        m["forwards"] = int(forwards)
        m["forward_equivalents"] = round(forward_equivalents, 2)
        m["forwards_exhaustive"] = int(forwards_exhaustive)
        m["escalated"] = int(escalated)
    m["report"] = metrics.report_line(m)
    if verbose:
        print(m["report"], flush=True)
    try:
        with open(os.path.join(store.result_dir, "summary.json"), "w") as fh:
            json.dump(m, fh, indent=1, default=float)
    except OSError:
        pass
    return m
