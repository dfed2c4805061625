"""Configuration of the attack-and-certify pipeline.

The fields of `dorpatch_tpu.config` that this package reads, with the same
defaults, so a results directory, a flag and a default mean the same thing in
both packages. `ExperimentConfig.device` is new: entry points run on "cuda"
unless the caller asks for "cpu".
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
    adapt_start: int = 200                     # stage-0 coefficient adaptation start
    # EOT forward+backward precision, float32|bfloat16 (the patch, the
    # losses and the carry stay float32)
    compute_dtype: str = "float32"

    @property
    def scale_down(self) -> float:
        return float(self.scale_up ** 1.5)


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """PatchCleanser double-masking defense.

    prune: "exact" (two-phase pruned schedule, verdicts identical to the
    exhaustive sweep) or "off" (the exhaustive 666-mask sweep).
    incremental: "auto" (the victim family's engine: "stem" for conv
    victims, "token-exact" for ViT victims), "stem", "token" (token-pruned
    forwards over a clean KV cache, verdicts up to the engine's logit
    drift), "token-exact" ("token", plus re-certifying every image whose
    read entries have a top-2 logit margin below `incremental_margin`
    through the exhaustive sweep) or "off" (full masked forwards for every
    entry).
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
class ExperimentConfig:
    """One end-to-end experiment."""

    dataset: str = "imagenet"
    model_dir: str = "pretrained_models/"
    base_arch: str = "resnetv2"
    attack_name: str = "DorPatch"
    batch_size: int = 1
    num_batches: int = 10
    seed: int = 1234
    device: str = "cuda"            # "cuda" (default) or "cpu" on request
    results_root: str = "results"
    synthetic_data: bool = False
    data_source: str = "auto"       # auto|synthetic|procedural
    img_size: int = 224

    attack: AttackConfig = dataclasses.field(default_factory=AttackConfig)
    defense: DefenseConfig = dataclasses.field(default_factory=DefenseConfig)

    @property
    def num_classes(self) -> int:
        return NUM_CLASSES[self.dataset]


def config_to_dict(cfg: ExperimentConfig) -> dict:
    """JSON-safe nested dict of the experiment config."""
    return dataclasses.asdict(cfg)


def resolved_data_source(cfg: ExperimentConfig) -> str:
    """`cfg.data_source` with "auto" mapped through `synthetic_data`."""
    source = cfg.data_source
    if source != "auto":
        if source not in ("disk", "synthetic", "procedural"):
            raise ValueError(f"unknown data_source {source!r}")
        return source
    return "synthetic" if cfg.synthetic_data else "disk"
