"""Hyperparameter sweep (BASELINE.md config 4: CIFAR-10 + ResNet-18,
a patch-budget x regularization grid).

Port of `dorpatch_tpu.sweep`: every grid point attacks the same fixed
evaluation batch with one victim, one mask universe and one defense, then
scores robust accuracy and certified attack success on the device. The rows
(`rows.jsonl`, the same keys in the same order) and the per-point patches
(`point_NNN_{mask,pattern}.npy`, NHWC float32) are the JAX package's.

A sweep over a results directory is crash-resumable: each finished row is
appended as it completes, and a re-run skips the recorded points; with a
`checkpointer_factory` (the farm's), the interrupted point itself resumes
from its newest carry snapshot, and its row records
`resumed_from_stage`/`resumed_from_iteration`.

The JAX package shares one set of compiled step programs across the grid
(`DorPatch.adopt_compiled`) and logs their count as `block_programs`. The
port runs eagerly: there is no compiled program to share, and its step
runs the same input shapes at every grid point, so that key is left out.

Run:  python -m dorpatch_tpu_torch.sweep --synthetic --result-dir DIR
      python -m dorpatch_tpu_torch.sweep --device cpu --synthetic \\
          --max-iterations 2 --sampling-size 4 -b 2 --result-dir DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dorpatch_tpu_torch import data, losses, metrics, observe, utils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.config import (AttackConfig, DefenseConfig,
                                       ExperimentConfig, resolved_data_source)
from dorpatch_tpu_torch.defense import build_defenses
from dorpatch_tpu_torch.models import get_model

ROWS_NAME = "rows.jsonl"
GRID_KEYS = ("patch_budget", "density", "structured")


def row_key(patch_budget: float, density: float, structured: float) -> Tuple:
    """Hashable identity of one grid point, stable across a JSON round-trip
    (recorded rows come back from `rows.jsonl` with json's float formatting,
    so the in-memory key goes through the same representation)."""
    return tuple(json.loads(json.dumps(
        [float(patch_budget), float(density), float(structured)])))


def load_recorded_rows(result_dir: str) -> Dict[Tuple, Dict]:
    """{grid-point key: row} already recorded in `result_dir`'s rows.jsonl.

    Tolerant of a truncated final line: the file is appended row by row and
    the previous sweep may have been killed mid-write; a partial row is not
    recorded, so that point re-runs."""
    out: Dict[Tuple, Dict] = {}
    try:
        with open(os.path.join(result_dir, ROWS_NAME), errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and all(k in row for k in GRID_KEYS):
                    out[row_key(*(row[k] for k in GRID_KEYS))] = row
    except OSError:
        pass
    return out


def append_row(result_dir: str, row: Dict) -> None:
    """Flush one completed grid row to `rows.jsonl` (append mode, line
    buffered): a killed sweep keeps every finished row and loses at most
    the one in flight."""
    os.makedirs(result_dir, exist_ok=True)
    with open(os.path.join(result_dir, ROWS_NAME), "a", buffering=1) as fh:
        fh.write(json.dumps(row, default=float) + "\n")


def _first_batch(cfg: ExperimentConfig, dev: torch.device):
    """The sweep's one evaluation batch: through the streaming input path
    when `stream_depth` > 0 (closed after the batch), else the
    synchronous stream."""
    source = resolved_data_source(cfg)
    if cfg.stream_depth > 0:
        it = data.streaming_batches(
            cfg.dataset, cfg.batch_size, cfg.img_size, cfg.seed,
            source=source, data_dir=cfg.data_dir, depth=cfg.stream_depth,
            device=dev)
    else:
        it = iter(data.dataset_batches(cfg.dataset, cfg.batch_size,
                                       cfg.img_size, cfg.seed, source=source,
                                       data_dir=cfg.data_dir))
    try:
        x, y_np = next(it)
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    return torch.as_tensor(x, device=dev), y_np, source


@torch.no_grad()
def run_sweep(
    cfg: ExperimentConfig,
    patch_budgets: Sequence[float] = (0.06, 0.12),
    densities: Sequence[float] = (0.0, 1e-3),
    structureds: Sequence[float] = (1e-3,),
    defense_ratio: float = 0.06,
    verbose: bool = True,
    result_dir: Optional[str] = None,
    checkpointer_factory: Optional[Callable[[int, Dict], object]] = None,
    on_block_end: Optional[Callable[[int, int, dict], None]] = None,
) -> List[Dict]:
    """Grid-attack one evaluation batch on `cfg.device`; one result row per
    grid point.

    Row: the point's hyperparameters, robust accuracy (victim still correct
    under the patch), certified ASR at `defense_ratio`, mean patch L2, the
    image count and wall seconds.

    With `result_dir`, each completed row is appended to `rows.jsonl` and
    the point's patch saved; on re-invocation over the same directory,
    recorded grid points are skipped (their recorded rows are returned in
    place). `checkpointer_factory(point_index, point_params)` (returning a
    `CarryCheckpointer` or None) snapshots the attack carry at block
    boundaries, so even the interrupted point resumes mid-stage;
    `on_block_end` is forwarded to every point's `DorPatch` (the farm's
    lease-renewal and chaos hook)."""
    dev = utils.resolve_device(cfg.device)
    utils.configure_numerics()
    victim = get_model(cfg.dataset, cfg.base_arch, cfg.model_dir,
                       cfg.img_size, device=dev)
    x, y_np, source = _first_batch(cfg, dev)
    preds = torch.argmax(victim.apply(x), -1).cpu().numpy()
    if source == "synthetic":
        y_np = preds  # random labels: score the model's own predictions
    keep = preds == y_np
    if not keep.any():
        raise RuntimeError("no correctly-classified images in the sweep batch")
    x, y_np = x[torch.as_tensor(keep, device=dev)], y_np[keep]

    defense = build_defenses(
        victim.apply, cfg.img_size,
        dataclasses.replace(cfg.defense, ratios=(defense_ratio,)),
        incremental=victim.incremental, device=dev)[0]

    rows: List[Dict] = []
    grid = list(itertools.product(patch_budgets, densities, structureds))
    recorded = load_recorded_rows(result_dir) if result_dir else {}
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)
    for gi, (budget, density, structured) in enumerate(grid):
        prior = recorded.get(row_key(budget, density, structured))
        if prior is not None:
            # completed by an earlier (killed) invocation of this sweep
            rows.append(prior)
            if verbose:
                observe.log(json.dumps({"sweep_resume_skip": gi,
                                        "patch_budget": budget,
                                        "density": density,
                                        "structured": structured}))
            continue
        acfg = dataclasses.replace(cfg.attack, patch_budget=budget,
                                   density=density, structured=structured)
        attack = DorPatch(victim.apply, victim.num_classes, acfg,
                          on_block_end=on_block_end)
        point_params = {"patch_budget": budget, "density": density,
                        "structured": structured}
        ck = (checkpointer_factory(gi, point_params)
              if checkpointer_factory is not None else None)
        resumed = ck.latest_step_info() if ck is not None else None
        attack.checkpointer = ck
        try:
            timer = observe.StepTimer()
            timer.start()
            # the same seed for every grid point (the reference protocol:
            # one process per point, same --seed), so row deltas isolate
            # the hyperparameters
            with observe.span("sweep.point", point=gi, patch_budget=budget,
                              density=density, structured=structured):
                res = attack.generate(x, seed=cfg.seed)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            seconds = timer.stop()

            delta = losses.l2_project(res.adv_mask, res.adv_pattern, x,
                                      acfg.eps)
            adv_x = x + delta
            preds_adv = torch.argmax(victim.apply(adv_x), -1).cpu().numpy()
            with observe.span("certify", point=gi, images=int(x.shape[0])):
                recs = defense.robust_predict(adv_x, victim.num_classes)
            defense.collect(recs)
            m = metrics.compute_metrics(np.asarray(y_np), y_np, preds_adv,
                                        [defense.result])
            row = {
                "point": gi,
                "patch_budget": budget,
                "density": density,
                "structured": structured,
                "robust_accuracy": m["robust_accuracy"],
                "asr": round(100.0 - m["robust_accuracy"], 4),
                "certified_asr_pc": m["certified_asr_pc"][0],
                "mean_l2": float(torch.sqrt(torch.sum(
                    delta ** 2, dim=(1, 2, 3))).mean()),
                "images": int(x.shape[0]),
                "seconds": round(seconds, 2),
            }
            if resumed is not None:
                # this attempt started from a carry snapshot, not from
                # iteration zero
                row["resumed_from_stage"] = resumed.stage
                row["resumed_from_iteration"] = resumed.iteration
            if result_dir:
                np.save(os.path.join(result_dir, f"point_{gi:03d}_mask.npy"),
                        res.adv_mask.cpu().numpy())
                np.save(os.path.join(result_dir,
                                     f"point_{gi:03d}_pattern.npy"),
                        res.adv_pattern.cpu().numpy())
                append_row(result_dir, row)
            if ck is not None:
                ck.clear()  # row recorded: a stale carry must never leak
        finally:
            if ck is not None:
                ck.close()
        rows.append(row)
        if verbose:
            observe.log(json.dumps(row))
    if verbose:
        observe.log(json.dumps({"grid_points": len(grid)}))
    return rows


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="DorPatch hyperparameter sweep")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the GPU (default) or, on request, "
                        "the CPU with the kernels' plain versions")
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "imagenet", "cifar100"])
    p.add_argument("--data_dir", default="/home/data/data")
    p.add_argument("--model_dir", default="pretrained_models/")
    p.add_argument("--base_arch", default="resnet18")
    p.add_argument("--img-size", type=int, default=32)
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--max-iterations", type=int, default=400)
    p.add_argument("--sampling-size", type=int, default=32)
    p.add_argument("--basic-unit", type=int, default=4)
    p.add_argument("--dropout", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--patch-budgets", type=float, nargs="+",
                   default=[0.06, 0.12])
    p.add_argument("--densities", type=float, nargs="+", default=[0.0, 1e-3])
    p.add_argument("--structureds", type=float, nargs="+", default=[1e-3])
    p.add_argument("--defense-ratio", type=float, default=0.06)
    p.add_argument("--result-dir", default="",
                   help="persist rows.jsonl + per-point patch artifacts here;"
                        " re-running over the same dir skips finished rows")
    args = p.parse_args(argv)

    attack = AttackConfig(
        max_iterations=args.max_iterations,
        sampling_size=args.sampling_size,
        basic_unit=args.basic_unit,
        dropout=args.dropout,
        switch_iteration=min(500, args.max_iterations // 2),
        sweep_interval=min(100, max(1, args.max_iterations // 4)),
    )
    cfg = ExperimentConfig(
        dataset=args.dataset, data_dir=args.data_dir,
        model_dir=args.model_dir, base_arch=args.base_arch,
        img_size=args.img_size, batch_size=args.batch_size, seed=args.seed,
        device=args.device, synthetic_data=args.synthetic, attack=attack,
        defense=DefenseConfig(),
    )
    t0 = time.time()
    rows = run_sweep(cfg, args.patch_budgets, args.densities,
                     args.structureds, args.defense_ratio,
                     result_dir=args.result_dir or None)
    observe.log(json.dumps({"sweep_points": len(rows),
                            "total_seconds": round(time.time() - t0, 1)}))
    return rows


if __name__ == "__main__":
    main()
