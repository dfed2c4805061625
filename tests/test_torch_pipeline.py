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
    assert config_from_args(build_parser().parse_args(
        ["--base_arch", "resmlp"])).base_arch == "resmlp"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--base_arch", "mlp_mixer"])


#: one case per main-path flag of `dorpatch_tpu.cli` the port took over,
#: its aliases, and all the results-path keys at once
NEW_FLAGS = [
    ["--data_dir", "/data/elsewhere"],
    ["--attack", "DorPatch"], ["-a", "DorPatch"],
    ["-e", "2.5"], ["--epsilon", "6"],
    ["--lr", "0.05"], ["--learning-rate", "0.002"],
    ["--num_patch", "3"],
    ["--density", "0.01"],
    ["--structured", "0.002"],
    ["--basic-unit", "5"],
    ["--switch-iteration", "10"],
    ["--sweep-interval", "7"],
    ["--failure-sampling-start", "40"],
    ["--dual"],
    ["--defense-n-patch", "2"],
    ["--prune", "consensus"],
    ["--no-prune"],
    ["--incremental", "mixer"], ["--incremental", "mixer-exact"],
    ["--data-source", "disk"],
    ["--base_arch", "resmlp"],
    ["--density", "0.004", "--structured", "0.0", "--num_patch", "2",
     "--dual", "--defense-n-patch", "2", "--patch_budget", "0.06", "-t",
     "--dropout", "1", "--dataset", "cifar100", "--base_arch", "resnet18"],
]


@pytest.mark.parametrize("argv", NEW_FLAGS, ids=lambda a: " ".join(a))
def test_cli_flag_matches_jax_and_results_path(argv):
    """Each flag lands in the same config fields as in `dorpatch_tpu.cli`,
    and the results tree is byte-equal to
    `dorpatch_tpu.artifacts.results_path`'s."""
    from dorpatch_tpu import cli as jcli

    argv = argv + ["--results-root", "/r"]
    cfg = config_from_args(build_parser().parse_args(argv))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    for name in ("dataset", "data_dir", "base_arch", "attack_name",
                 "data_source", "synthetic_data"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for name in ("patch_budget", "targeted", "lr", "max_iterations",
                 "switch_iteration", "sweep_interval",
                 "failure_sampling_start", "basic_unit", "dropout",
                 "sampling_size", "density", "structured", "eps",
                 "num_patch", "dual", "compute_dtype"):
        assert getattr(cfg.attack, name) == getattr(jcfg.attack, name), name
    for name in ("n_patch", "prune", "incremental", "incremental_margin",
                 "compute_dtype"):
        assert getattr(cfg.defense, name) == getattr(jcfg.defense, name), \
            name
    path = tart.results_path(cfg)
    assert isinstance(path, str)
    assert path.encode() == jax_results_path(jcfg).encode()


@pytest.mark.parametrize("argv", [["--attack", "PGD"],
                                  ["--defense-n-patch", "3"],
                                  ["--prune", "greedy"],
                                  ["--incremental", "mixer-approx"],
                                  ["--data-source", "hdf5"]])
def test_cli_rejects_what_the_jax_cli_rejects(argv):
    from dorpatch_tpu import cli as jcli

    for parser in (build_parser(), jcli.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)


# ------------------------------------- run telemetry and carry checkpoints


@pytest.fixture()
def one_torch_thread():
    """One intra-op thread: the runs' small ops go in parallel test
    processes, whose threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: the span names of the JAX package's main path, with their attributes
SPANS = {"run": {"processes"}, "setup": set(), "data": set(),
         "batch": {"batch", "images", "cached"}, "attack": set(),
         "certify": {"batch", "images", "forwards", "forward_equivalents",
                     "forwards_exhaustive", "compute_dtype"},
         "artifact_io": {"op"}, "finalize": set(),
         "attack.stage0": {"start_iter", "end_iter"},
         "attack.stage1": {"start_iter", "end_iter"},
         "data.prefetch": {"batch", "images", "ahead"}}


def _jsonl(path):
    import json

    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_run_telemetry_files_and_the_jax_report(tmp_path, shallow_victim,
                                                capsys, one_torch_thread):
    """A CPU run writes `run.json` (torch environment), `events.jsonl`
    with the JAX package's span names and attributes and a `block` record
    per attack block, `metrics.jsonl` with the JAX logger's keys, and
    heartbeats; `python -m dorpatch_tpu.observe.report` renders the
    directory."""
    import json

    from dorpatch_tpu.observe import AttackMetricsLogger as JaxLogger
    from dorpatch_tpu.observe import report as jax_report

    cfg = _cfg(tmp_path)
    run_experiment(cfg, verbose=False)
    out = tart.results_path(cfg)
    run = json.load(open(os.path.join(out, "run.json")))
    assert run["backend_impl"] == "torch" and run["config"]["device"] == "cpu"
    events = _jsonl(os.path.join(out, "events.jsonl"))
    assert {e["run_id"] for e in events} == {run["run_id"]}
    spans = {}
    for e in events:
        if e["kind"] == "span":
            spans.setdefault(e["name"], set()).update(e)
    for name, attrs in SPANS.items():
        assert name in spans, name
        assert attrs <= spans[name], (name, attrs - spans[name])
    ops = {e["op"] for e in events if e.get("name") == "artifact_io"
           and e["kind"] == "span"}
    assert {"load_patch", "save_patch", "load_pc_records",
            "save_pc_records"} <= ops
    blocks = [(e["stage"], e["step"]) for e in events if e["kind"] == "block"]
    assert blocks == [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert any(e.get("name") == "data.stream.wait" for e in events)
    recs = _jsonl(os.path.join(out, "metrics.jsonl"))
    assert [(r["stage"], r["step"]) for r in recs] == blocks
    jlog = JaxLogger(run_id=run["run_id"])
    jlog.on_block_end(0, 1, {"metrics": np.zeros(8), "stopped": False})
    assert list(recs[0]) == list(jlog.history[0])
    beats = _jsonl(os.path.join(out, "heartbeat_0.jsonl"))
    assert beats and beats[-1]["phase"] == "exit"
    capsys.readouterr()
    assert jax_report.main([out]) == 0
    text = capsys.readouterr().out
    assert run["run_id"] in text
    assert jax_report.main([out, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["manifest"]["run_id"] == run["run_id"]


def test_no_metrics_log_and_hang_timeout_warning(tmp_path, shallow_victim,
                                                 capsys, one_torch_thread):
    """Telemetry off: run.json only, and an armed --hang-timeout says it is
    ignored; the synchronous input path (stream_depth 0) gives the same
    report."""
    import dataclasses

    cfg = dataclasses.replace(_cfg(tmp_path), metrics_log=False,
                              hang_timeout=30.0, stream_depth=0)
    m = run_experiment(cfg, verbose=False)
    assert "ignored: telemetry is disabled" in capsys.readouterr().err
    out = tart.results_path(cfg)
    files = set(os.listdir(out))
    assert "run.json" in files
    assert not files & {"events.jsonl", "metrics.jsonl", "heartbeat_0.jsonl"}
    streamed = run_experiment(
        dataclasses.replace(_cfg(tmp_path / "s")), verbose=False)
    assert streamed["report"] == m["report"]


def test_carry_checkpoints_resume_the_main_path(tmp_path, shallow_victim,
                                                monkeypatch, one_torch_thread):
    """--carry-checkpoints: a run killed at a stage-1 block leaves its
    snapshots under carry_0; the next run over the same results dir
    resumes from them (no earlier block again) and saves the patch of an
    uninterrupted run, bit for bit; on success the snapshots are cleared.
    The watchdog (--hang-timeout) stays quiet through all of it."""
    import dataclasses

    from dorpatch_tpu_torch import observe

    kw = dict(max_iterations=4, sweep_interval=2, switch_iteration=2)
    base = dataclasses.replace(_cfg(tmp_path / "a", **kw),
                               carry_checkpoints=True, hang_timeout=600.0)
    run_experiment(base, verbose=False)
    want = tart.ArtifactStore(tart.results_path(base)).load_patch(0)
    assert os.listdir(os.path.join(tart.results_path(base), "carry_0")) == []

    cfg = dataclasses.replace(base, results_root=str(tmp_path / "b"))
    real = observe.AttackMetricsLogger.on_block_end

    def crash(self, stage, step, info):
        real(self, stage, step, info)
        if (stage, step) == (1, 2):
            raise RuntimeError("killed")

    monkeypatch.setattr(observe.AttackMetricsLogger, "on_block_end", crash)
    with pytest.raises(RuntimeError, match="killed"):
        run_experiment(cfg, verbose=False)
    out = tart.results_path(cfg)
    assert os.listdir(os.path.join(out, "carry_0"))
    monkeypatch.setattr(observe.AttackMetricsLogger, "on_block_end", real)
    run_experiment(cfg, verbose=False)
    got = tart.ArtifactStore(out).load_patch(0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert os.listdir(os.path.join(out, "carry_0")) == []
    recs = _jsonl(os.path.join(out, "metrics.jsonl"))
    runs = {}
    for r in recs:
        runs.setdefault(r["run_id"], []).append((r["stage"], r["step"]))
    assert list(runs.values()) == [[(0, 2), (0, 4), (1, 2)], [(1, 4)]]


@pytest.mark.parametrize("argv", [
    ["--trace-dir", "/t"], ["--hang-timeout", "30"],
    ["--heartbeat-interval", "0.5"], ["--carry-checkpoints"], []])
def test_telemetry_flags_match_jax(argv):
    from dorpatch_tpu import cli as jcli

    cfg = config_from_args(build_parser().parse_args(argv))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    for name in ("trace_dir", "hang_timeout", "heartbeat_interval",
                 "carry_checkpoints", "metrics_log", "stream_depth"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.attack.report_interval == jcfg.attack.report_interval
