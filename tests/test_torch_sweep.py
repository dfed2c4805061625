"""The port's sweep (`dorpatch_tpu_torch.sweep`) against
`dorpatch_tpu.sweep` on the CPU: row persistence and its resume, and the
rows of one grid on a shallow full-width CIFAR ResNet-18 with the same
weights in both packages, each attack's `generate` patched to return one
seeded patch a grid point."""

import json
import os

import numpy as np
import pytest
import torch

from dorpatch_tpu import sweep as jsweep
from dorpatch_tpu_torch import sweep as tsweep
from dorpatch_tpu_torch.config import (AttackConfig, DefenseConfig,
                                       ExperimentConfig)

IMG = 16
BUDGETS = (0.1, 0.2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tests' small ops run in parallel test
    processes, whose threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_rows_jsonl_roundtrip_and_truncation(tmp_path):
    """Appended rows survive a round-trip with keys stable across JSON
    float formatting; a final line truncated by a kill, and rows without
    the grid keys, are dropped; the file is the JAX package's byte for
    byte."""
    d = str(tmp_path / "res")
    assert tsweep.load_recorded_rows(d) == {}
    row_a = {"patch_budget": 0.1, "density": 0.0, "structured": 1e-3,
             "robust_accuracy": 42.0, "point": 0}
    row_b = {"patch_budget": 0.2, "density": 0.0, "structured": 1e-3,
             "robust_accuracy": 17.0, "point": 1}
    for row in (row_a, row_b):
        tsweep.append_row(d, row)
        jsweep.append_row(str(tmp_path / "jax"), row)
    assert (tmp_path / "res" / tsweep.ROWS_NAME).read_bytes() == \
        (tmp_path / "jax" / jsweep.ROWS_NAME).read_bytes()
    recorded = tsweep.load_recorded_rows(d)
    assert recorded[tsweep.row_key(0.1, 0.0, 1e-3)] == row_a
    assert recorded[tsweep.row_key(0.2, 0.0, 1e-3)] == row_b
    with open(tmp_path / "res" / tsweep.ROWS_NAME, "a") as fh:
        fh.write('{"patch_budget": 0.3, "den')
    assert len(tsweep.load_recorded_rows(d)) == 2
    with open(tmp_path / "res" / tsweep.ROWS_NAME, "a") as fh:
        fh.write('\n{"unrelated": true}\n[1, 2]\n')
    assert len(tsweep.load_recorded_rows(d)) == 2
    assert tsweep.load_recorded_rows(d) == jsweep.load_recorded_rows(d)


@pytest.mark.parametrize("point", [(0.1, 1e-3, 3.3333333333333335e-05),
                                   (0.06, 0.0, 1e-3), (1, 0, 0)])
def test_row_key_stable_and_equal_to_jax(point):
    row = dict(zip(tsweep.GRID_KEYS, point))
    back = json.loads(json.dumps(row))
    key = tsweep.row_key(*(back[k] for k in tsweep.GRID_KEYS))
    assert key == tsweep.row_key(*point) == jsweep.row_key(*point)


@pytest.fixture()
def same_victims(tmp_path, monkeypatch):
    """A shallow (one block a stage) CIFAR ResNet-18 in both packages: the
    JAX factory's random init from seed 0, and the port's factory loading
    those weights from a checkpoint in the export format. Returns the
    port's model_dir."""
    import jax.numpy as jnp

    from dorpatch_tpu.models import registry as jreg
    from dorpatch_tpu.models.convert import export_cifar_resnet18
    from dorpatch_tpu.models.small import CifarResNet18 as JaxResNet18
    from dorpatch_tpu_torch.models import registry as treg
    from dorpatch_tpu_torch.models.small import CifarResNet18

    build = jreg._build_flax

    def shallow(timm_name, num_classes, gn_impl="auto"):
        if timm_name == "cifar_resnet18":
            return JaxResNet18(num_classes=num_classes,
                               stage_sizes=(1, 1, 1, 1))
        return build(timm_name, num_classes, gn_impl=gn_impl)

    monkeypatch.setattr(jreg, "_build_flax", shallow)
    _, init_weights = treg._FAMILIES["cifar_resnet18"]
    monkeypatch.setitem(
        treg._FAMILIES, "cifar_resnet18",
        (lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
         init_weights))
    jv = jreg.get_model("cifar10", "resnet18", "/nonexistent", IMG)
    params = {k: np.asarray(v) for k, v in
              export_cifar_resnet18(jv.params, (1, 1, 1, 1)).items()}
    model_dir = str(tmp_path / "models")
    path = treg.checkpoint_path(model_dir, "cifar10", "cifar_resnet18")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {k: torch.tensor(v)
                               for k, v in params.items()}}, path)
    tv = treg.get_model("cifar10", "resnet18", model_dir, IMG, device="cpu")
    assert tv.from_checkpoint
    x = np.random.default_rng(1).uniform(0, 1, (2, IMG, IMG, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            tv.apply(torch.as_tensor(x)).numpy(),
            np.asarray(jv.apply(jv.params, jnp.asarray(x))), atol=1e-4)
    return model_dir


def _patch(budget, shape):
    rng = np.random.default_rng(int(round(budget * 1000)))
    b, h, w = shape[:3]
    mask = (rng.uniform(0, 1, (b, h, w, 1)) < 0.2).astype(np.float32)
    return mask, rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def _fake_generates(monkeypatch):
    """Both packages' `DorPatch.generate` return `_patch(budget)`."""
    import jax.numpy as jnp

    from dorpatch_tpu import attack as jattack
    from dorpatch_tpu_torch import attack as tattack

    calls = []

    def jax_generate(self, x, y=None, targeted=False, key=None, **kw):
        mask, pattern = _patch(self.config.patch_budget, x.shape)
        m, p = jnp.asarray(mask), jnp.asarray(pattern)
        return jattack.AttackResult(adv_mask=m, adv_pattern=p,
                                    y=np.zeros(x.shape[0]),
                                    targeted=np.zeros(x.shape[0], bool),
                                    stage0_mask=m, stage0_pattern=p)

    def torch_generate(self, x, y=None, targeted=False, seed=0, **kw):
        calls.append(self.config.patch_budget)
        mask, pattern = _patch(self.config.patch_budget, x.shape)
        m, p = torch.as_tensor(mask), torch.as_tensor(pattern)
        return tattack.AttackResult(adv_mask=m, adv_pattern=p,
                                    y=np.zeros(x.shape[0]),
                                    targeted=np.zeros(x.shape[0], bool),
                                    stage0_mask=m, stage0_pattern=p)

    monkeypatch.setattr(jattack.DorPatch, "generate", jax_generate)
    monkeypatch.setattr(tattack.DorPatch, "generate", torch_generate)
    return calls


def _configs(model_dir):
    from dorpatch_tpu.config import AttackConfig as JAttack
    from dorpatch_tpu.config import DefenseConfig as JDefense
    from dorpatch_tpu.config import ExperimentConfig as JExperiment

    common = dict(dataset="cifar10", base_arch="resnet18", img_size=IMG,
                  batch_size=2, synthetic_data=True, seed=1234)
    attack = dict(dropout=1, basic_unit=4, eps=4.0)
    defense = dict(ratios=(0.12,))
    return (ExperimentConfig(device="cpu", model_dir=model_dir,
                             attack=AttackConfig(**attack),
                             defense=DefenseConfig(**defense), **common),
            JExperiment(model_dir="/nonexistent", attack=JAttack(**attack),
                        defense=JDefense(**defense), **common))


def test_sweep_rows_equal_jax(tmp_path, monkeypatch, same_victims):
    """The same grid through both packages: robust accuracy, ASR,
    certified ASR and the image count exact, the mean L2 within 1e-5, the
    row keys equal and in the same order; the port's `rows.jsonl` and
    patches land in its result dir, and a re-run skips every recorded
    point."""
    calls = _fake_generates(monkeypatch)
    cfg, jcfg = _configs(same_victims)
    kw = dict(patch_budgets=BUDGETS, densities=(0.0,), structureds=(1e-3,),
              defense_ratio=0.12, verbose=False)
    out = str(tmp_path / "rows")
    rows = tsweep.run_sweep(cfg, result_dir=out, **kw)
    want = jsweep.run_sweep(jcfg, **kw)
    assert len(rows) == len(want) == 2
    for got, ref in zip(rows, want):
        assert list(got) == list(ref)
        for k in ("point", "patch_budget", "density", "structured",
                  "robust_accuracy", "asr", "certified_asr_pc", "images"):
            assert got[k] == ref[k], k
        assert abs(got["mean_l2"] - ref["mean_l2"]) <= 1e-5
    assert [json.loads(line) for line in
            open(os.path.join(out, tsweep.ROWS_NAME))] == rows
    for gi, budget in enumerate(BUDGETS):
        mask, pattern = _patch(budget, (rows[gi]["images"], IMG, IMG))
        np.testing.assert_array_equal(
            np.load(os.path.join(out, f"point_{gi:03d}_mask.npy")), mask)
        np.testing.assert_array_equal(
            np.load(os.path.join(out, f"point_{gi:03d}_pattern.npy")),
            pattern)
    assert calls == list(BUDGETS)
    again = tsweep.run_sweep(cfg, result_dir=out, **kw)
    assert again == rows and calls == list(BUDGETS)   # nothing re-attacked


def test_sweep_resume_skips_recorded_points_and_marks_resumed(
        tmp_path, monkeypatch, same_victims):
    """A sweep killed after its first row re-runs only the second point;
    a point whose checkpointer holds a snapshot records where it resumed
    from."""
    calls = _fake_generates(monkeypatch)
    cfg, _ = _configs(same_victims)
    out = str(tmp_path / "rows")
    kw = dict(patch_budgets=BUDGETS, densities=(0.0,), structureds=(1e-3,),
              defense_ratio=0.12, verbose=False, result_dir=out)
    first = tsweep.run_sweep(cfg, **dict(kw, patch_budgets=BUDGETS[:1]))
    assert calls == [0.1]

    class Snapshot:
        cleared = closed = False

        def latest_step_info(self):
            from dorpatch_tpu_torch.checkpoint import CarryCheckpoint

            return CarryCheckpoint(1, 40, None, None, None)

        def clear(self):
            self.cleared = True

        def close(self):
            self.closed = True

    made = []

    def factory(point, params):
        made.append((point, params))
        made.append(Snapshot())
        return made[-1]

    rows = tsweep.run_sweep(cfg, checkpointer_factory=factory, **kw)
    assert calls == [0.1, 0.2]
    assert rows[0] == first[0]
    assert made[0] == (1, {"patch_budget": 0.2, "density": 0.0,
                           "structured": 1e-3})
    assert made[1].cleared and made[1].closed
    assert (rows[1]["resumed_from_stage"],
            rows[1]["resumed_from_iteration"]) == (1, 40)
    assert "resumed_from_iteration" not in rows[0]


def test_sweep_cli_on_the_cpu_and_device_gate(tmp_path, monkeypatch):
    """`python -m dorpatch_tpu_torch.sweep --device cpu` end to end on a
    tiny grid (the real attack, two iterations); the default device is
    the GPU, which a CPU-only machine refuses."""
    from dorpatch_tpu_torch.models import registry as treg
    from dorpatch_tpu_torch.models.small import CifarResNet18

    _, init_weights = treg._FAMILIES["cifar_resnet18"]
    monkeypatch.setitem(
        treg._FAMILIES, "cifar_resnet18",
        (lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
         init_weights))
    out = str(tmp_path / "res")
    argv = ["--synthetic", "--img-size", str(IMG), "-b", "2",
            "--max-iterations", "2", "--sampling-size", "4",
            "--patch-budgets", "0.1", "--densities", "0.0",
            "--model_dir", str(tmp_path / "none"), "--result-dir", out]
    rows = tsweep.main(argv + ["--device", "cpu"])
    assert len(rows) == 1 and rows[0]["patch_budget"] == 0.1
    assert 0.0 <= rows[0]["asr"] <= 100.0
    assert np.isfinite(rows[0]["mean_l2"])
    assert os.path.exists(os.path.join(out, "point_000_pattern.npy"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.main(argv)
