"""The port's slice end to end on the CPU: `run_experiment` on a shallow
full-width CIFAR ResNet-18 (attack, L2 projection, pruned stem-fold
certification, report), its results tree beside the JAX package's
`results_path` contract, artifact resume, and the command line."""

import os
import re

import numpy as np
import pytest
import torch

from dorpatch_tpu.artifacts import results_path as jax_results_path
from dorpatch_tpu.config import AttackConfig as JaxAttackConfig
from dorpatch_tpu.config import DefenseConfig as JaxDefenseConfig
from dorpatch_tpu.config import ExperimentConfig as JaxExperimentConfig
from dorpatch_tpu_torch import artifacts as tart
from dorpatch_tpu_torch import metrics as tmetrics
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import (AttackConfig, DefenseConfig,
                                       ExperimentConfig)
from dorpatch_tpu_torch.defense import PatchCleanserRecord
from dorpatch_tpu_torch.models import registry
from dorpatch_tpu_torch.models.small import CifarResNet18
from dorpatch_tpu_torch.pipeline import run_experiment

REPORT = re.compile(
    r"^clean accuracy: \d+\.\d\d%, robust accuracy:\d+\.\d\d%, "
    r"acc@PC:\d+\.\d\d%, certified_ACC@PC:\d+\.\d\d%, "
    r"certified_ASR@PC:\d+\.\d\d%$")


@pytest.fixture()
def shallow_victim(monkeypatch):
    """The factory builds the full-width, one-block-per-stage ResNet-18."""
    _, init_weights = registry._FAMILIES["cifar_resnet18"]
    monkeypatch.setitem(
        registry._FAMILIES, "cifar_resnet18",
        (lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
         init_weights))


def _cfg(tmp_path, **attack):
    kw = dict(sampling_size=4, max_iterations=2, sweep_interval=1,
              switch_iteration=1, dropout=1, dropout_sizes=(0.12,),
              basic_unit=4, patch_budget=0.15)
    kw.update(attack)
    return ExperimentConfig(
        dataset="cifar10", base_arch="resnet18", batch_size=2, num_batches=1,
        synthetic_data=True, img_size=16, device="cpu",
        model_dir=str(tmp_path / "models"),
        results_root=str(tmp_path / "results"),
        attack=AttackConfig(**kw),
        defense=DefenseConfig(ratios=(0.12,), chunk_size=64))


def test_slice_runs_writes_the_results_tree_and_resumes(tmp_path,
                                                        shallow_victim):
    cfg = _cfg(tmp_path)
    m = run_experiment(cfg, verbose=False)
    assert REPORT.match(m["report"]), m["report"]
    assert m["evaluated_images"] == 2
    assert len(m["acc_pc"]) == len(m["certified_asr_pc"]) == 1
    assert 0 < m["forwards"] <= m["forwards_exhaustive"] == 2 * 666
    assert len(m["attack_seconds"]) == len(m["certify_seconds"]) == 1

    jcfg = JaxExperimentConfig(
        dataset="cifar10", base_arch="resnet18",
        results_root=cfg.results_root,
        attack=JaxAttackConfig(patch_budget=0.15, dropout=1),
        defense=JaxDefenseConfig(ratios=(0.12,)))
    out = tart.results_path(cfg)
    assert out == jax_results_path(jcfg)
    files = set(os.listdir(out))
    assert {"adv_mask_0.pt", "adv_pattern_0.pt", "adv_PC_0.pt",
            "config.json", "summary.json"} <= files
    parent = set(os.listdir(os.path.dirname(out)))
    assert {"adv_mask_0.pt", "adv_pattern_0.pt"} <= parent   # stage 0
    mask = torch.load(os.path.join(out, "adv_mask_0.pt"), weights_only=True)
    assert tuple(mask.shape) == (2, 1, 16, 16)               # NCHW on disk
    recs = tart.ArtifactStore(out).load_pc_records(0)
    assert len(recs) == 2 and isinstance(recs[0][0], PatchCleanserRecord)

    again = run_experiment(cfg, verbose=False)               # all cached
    assert again["report"] == m["report"]
    assert "attack_seconds" not in again


def test_targeted_slice_records_targets(tmp_path, shallow_victim):
    cfg = _cfg(tmp_path, targeted=True, max_iterations=1)
    m = run_experiment(cfg, verbose=False)
    assert REPORT.match(m["report"])
    assert len(m["targets"]) == 2
    store = tart.ArtifactStore(tart.results_path(cfg))
    np.testing.assert_array_equal(store.load_targets(0), m["targets"])
    assert run_experiment(cfg, verbose=False)["targets"] == m["targets"]


def test_metrics_and_report_line():
    class Res:
        predictions = np.asarray([1, 2, 3, 3])
        certifications = np.asarray([True, False, True, True])

    y = np.asarray([1, 2, 0, 3])
    m = tmetrics.compute_metrics(y, y, np.asarray([1, 0, 0, 3]), [Res])
    assert m["clean_accuracy"] == 100.0 and m["robust_accuracy"] == 75.0
    assert m["acc_pc"] == [75.0] and m["certified_acc_pc"] == [50.0]
    assert m["certified_asr_pc"] == [25.0]
    t = tmetrics.compute_metrics(y, y, y, [Res], targets=np.asarray([0, 0, 3,
                                                                     0]))
    assert t["certified_asr_pc"] == [25.0]
    assert REPORT.match(tmetrics.report_line(m))


def test_cli_defaults_and_flags():
    args = build_parser().parse_args([
        "--synthetic", "--dataset", "cifar10", "--base_arch", "resnet18",
        "--img-size", "32", "-b", "8", "--sampling-size", "128",
        "--dropout", "2", "--max-iterations", "20", "--num-batches", "1",
        "--patch_budget", "0.06", "--prune", "off", "--incremental", "stem",
        "--seed", "9", "--results-root", "/x"])
    cfg = config_from_args(args)
    assert cfg.device == "cuda"
    assert (cfg.batch_size, cfg.img_size, cfg.num_batches, cfg.seed) == \
        (8, 32, 1, 9)
    assert cfg.attack.sampling_size == 128 and cfg.attack.max_iterations == 20
    assert cfg.attack.patch_budget == 0.06
    assert (cfg.defense.prune, cfg.defense.incremental) == ("off", "stem")
    assert config_from_args(build_parser().parse_args(
        ["--device", "cpu"])).device == "cpu"
    vit_cfg = config_from_args(build_parser().parse_args(
        ["--base_arch", "vit", "--incremental", "token-exact",
         "--incremental-margin", "0.3"]))
    assert (vit_cfg.base_arch, vit_cfg.defense.incremental,
            vit_cfg.defense.incremental_margin) == ("vit", "token-exact", 0.3)
    # the JAX package's default victim, ResNetV2-50x1 BiT at 224 on imagenet
    default = config_from_args(build_parser().parse_args([]))
    assert (default.base_arch, default.dataset, default.img_size) == \
        ("resnetv2", "imagenet", 224)
    assert ExperimentConfig().base_arch == "resnetv2"
    assert registry.resolve_arch(default.base_arch) == \
        "resnetv2_50x1_bit_distilled"
    assert config_from_args(build_parser().parse_args(
        ["--base_arch", "resnetv2"])).base_arch == "resnetv2"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--base_arch", "resmlp"])
