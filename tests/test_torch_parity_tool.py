"""`tools/port_parity.py`: the port's patches, certified by the JAX
package, against the port's own certification. Staging hands the JAX
pipeline the patches but never the port's certification records, the
config carries over, and on a tiny tree (a CIFAR ResNet-18 at 16 px, 2
iterations, both packages on the CPU) all 15 rows agree."""

import importlib.util
import json
import os

import pytest
import torch

from dorpatch_tpu_torch.config import (AttackConfig, ExperimentConfig,
                                       config_to_dict)
from dorpatch_tpu_torch.models import registry
from dorpatch_tpu_torch.train import save_victim_checkpoint

_spec = importlib.util.spec_from_file_location(
    "port_parity",
    os.path.join(os.path.dirname(__file__), "..", "tools", "port_parity.py"))
port_parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(port_parity)


def test_stage_tree_copies_patches_not_records(tmp_path):
    src = tmp_path / "port" / "a" / "b"
    src.mkdir(parents=True)
    for name in ("adv_mask_0.pt", "adv_pattern_0.pt", "targets_0.pt",
                 "adv_PC_0.pt", "stage0_0.pt", "summary.json"):
        (src / name).write_bytes(b"x")
    jax_root = tmp_path / "jax"
    (jax_root / "stale").mkdir(parents=True)
    assert port_parity.stage_tree(str(tmp_path / "port"), str(jax_root)) == 3
    assert sorted(os.listdir(jax_root / "a" / "b")) == [
        "adv_mask_0.pt", "adv_pattern_0.pt", "targets_0.pt"]
    assert not (jax_root / "stale").exists()


def test_parity_rows_are_the_fifteen_metrics():
    m = {"evaluated_images": 5, "clean_accuracy": 100.0,
         "robust_accuracy": 60.0, "acc_pc": [60.0, 60.0, 40.0, 20.0],
         "certified_acc_pc": [40.0, 40.0, 20.0, 0.0],
         "certified_asr_pc": [0.0, 0.0, 20.0, 20.0]}
    other = dict(m, robust_accuracy=40.0,
                 certified_asr_pc=[0.0, 0.0, 20.0, 40.0])
    rows = port_parity.parity_rows(m, other)
    assert len(rows) == 15
    assert [r["metric"] for r in rows][:3] == [
        "evaluated_images", "clean_accuracy", "robust_accuracy"]
    nonzero = {r["metric"]: r["delta"] for r in rows if r["delta"]}
    assert nonzero == {"robust_accuracy": 20.0,
                       "certified_asr_pc@12%": -20.0}
    assert all({"metric", "port", "jax", "delta"} <= set(r) for r in rows)


def test_jax_config_carries_the_port_record(tmp_path):
    cfg = ExperimentConfig(dataset="cifar10", base_arch="resnet18",
                           img_size=32, batch_size=8, device="cpu",
                           sanitize=True,
                           attack=AttackConfig(max_iterations=1200,
                                               remat="on"))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config_to_dict(cfg)))
    jcfg = port_parity.jax_config(str(path), "/staged", "/victim")
    assert (jcfg.results_root, jcfg.model_dir) == ("/staged", "/victim")
    assert jcfg.attack.max_iterations == 1200
    assert (jcfg.batch_size, jcfg.img_size, jcfg.base_arch) == (8, 32,
                                                                "resnet18")


@pytest.fixture()
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_compare_on_a_tiny_tree(tmp_path, one_torch_thread):
    """The port attacks and certifies on the CPU; the tool certifies the
    same patches with the JAX package: every row agrees."""
    from dorpatch_tpu_torch.pipeline import run_experiment

    victim = str(tmp_path / "victim")
    save_victim_checkpoint(
        registry.build_bare_model("cifar_resnet18", 10, 16, seed=1), victim)
    cfg = ExperimentConfig(
        dataset="cifar10", base_arch="resnet18", img_size=16, batch_size=1,
        num_batches=1, synthetic_data=True, device="cpu", stream_depth=0,
        model_dir=victim, results_root=str(tmp_path / "port"),
        attack=AttackConfig(sampling_size=4, max_iterations=2,
                            sweep_interval=2, switch_iteration=2, dropout=1,
                            basic_unit=4))
    run_experiment(cfg, verbose=False)
    out = tmp_path / "parity.json"
    report = port_parity.compare(str(tmp_path / "port"), victim, str(out))
    assert report["staged_files"] == 4   # the patch and the stage-0 patch
    assert len(report["rows"]) == 15
    assert report["nonzero"] == [], report["rows"]
    assert json.loads(out.read_text())["rows"] == report["rows"]
