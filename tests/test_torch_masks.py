"""The PyTorch port's host layers against the JAX package: mask geometry,
rasterize/apply_masks, the data streams and bucket math, the device gate,
and the import isolation of the port (no jax, nothing of dorpatch_tpu)."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dorpatch_tpu import data as jdata
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu_torch import data as tdata
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch import utils as tutils

ROOT = pathlib.Path(__file__).resolve().parents[1]
RATIOS = (0.015, 0.03, 0.06, 0.12)


@pytest.mark.parametrize("img_size", [32, 224, 480])
@pytest.mark.parametrize("n_patch", [1, 2])
def test_geometry_and_mask_sets_equal_jax(img_size, n_patch):
    for ratio in RATIOS:
        js = jmasks.geometry(img_size, ratio, n_patch)
        ts = tmasks.geometry(img_size, ratio, n_patch)
        assert tuple(ts) == tuple(js)
        np.testing.assert_array_equal(tmasks.first_order_rects(ts),
                                      jmasks.first_order_rects(js))
        for got, want in zip(tmasks.mask_sets(ts), jmasks.mask_sets(js)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        singles, doubles = tmasks.mask_sets(ts)
        k = max(singles.shape[1], doubles.shape[1])
        np.testing.assert_array_equal(tmasks.pad_rects(singles, k),
                                      jmasks.pad_rects(singles, k))


@pytest.mark.parametrize("img_size", [32, 224, 480])
@pytest.mark.parametrize("dropout", [0, 1, 2])
def test_dropout_universe_equals_jax(img_size, dropout):
    np.testing.assert_array_equal(
        tmasks.dropout_universe(img_size, dropout, RATIOS),
        jmasks.dropout_universe(img_size, dropout, RATIOS))


def test_pair_tables_equal_jax():
    for n in (4, 36):
        np.testing.assert_array_equal(tmasks.second_round_table_indices(n),
                                      jmasks.second_round_table_indices(n))
        i, j = np.triu_indices(n, k=1)
        np.testing.assert_array_equal(tmasks.pair_index(n, i, j),
                                      jmasks.pair_index(n, i, j))
    rects = jmasks.first_order_rects(jmasks.geometry(32, 0.06))
    np.testing.assert_array_equal(tmasks.pair_rects(rects),
                                  jmasks.pair_rects(rects))


def test_rasterize_and_apply_masks_equal_jax():
    rng = np.random.default_rng(0)
    size = 24
    rects = tmasks.pad_rects(tmasks.dropout_universe(size, 2)[::37], 3)
    imgs = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    keep_t = tmasks.rasterize(torch.as_tensor(rects), size)
    keep_j = np.asarray(jmasks.rasterize(jnp.asarray(rects), size))
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_array_equal(
        tmasks.apply_masks(torch.as_tensor(imgs), keep_t, 0.5).numpy(),
        np.asarray(jmasks.apply_masks(jnp.asarray(imgs), jnp.asarray(keep_j),
                                      0.5)))


def test_synthetic_and_procedural_streams_equal_jax():
    """The PIL-free bilinear resize gives the JAX package's synthetic images
    bit for bit; the procedural task is the same arrays."""
    tb = tdata.synthetic_batches("cifar10", 3, 32, seed=5)
    jb = jdata.synthetic_batches("cifar10", 3, 32, seed=5)
    for _ in range(2):
        (tx, ty), (jx, jy) = next(tb), next(jb)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    tx, ty = next(tdata.procedural_batches("cifar10", 4, 16, seed=3,
                                           n_per_class=2))
    jx, jy = next(jdata.procedural_batches("cifar10", 4, 16, seed=3,
                                           n_per_class=2))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("n", [0, 1, 5, 8, 31, 34, 200])
def test_bucket_math_equals_jax(n):
    for max_batch in (1, 8, 32, 64, 200):
        assert tdata.batch_buckets(max_batch) == jdata.batch_buckets(max_batch)
    bs = (1, 8, 32, 128)
    assert tdata.bucket_plan(n, bs) == jdata.bucket_plan(n, bs)
    if 0 < n <= 128:
        assert tdata.bucket_batch(n, bs) == jdata.bucket_batch(n, bs)
        arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        b = tdata.bucket_batch(n, bs)
        np.testing.assert_array_equal(
            tdata.pad_to_bucket(torch.as_tensor(arr), b).numpy(),
            jdata.pad_to_bucket(arr, b))


def test_device_gate_cpu_request_and_cuda_refusal(monkeypatch):
    """A CPU request runs on the CPU; without a GPU, the default (cuda)
    request raises instead of carrying on quietly on the CPU."""
    from dorpatch_tpu_torch.models import get_model
    from dorpatch_tpu_torch.ops import _backend

    assert tutils.resolve_device("cpu") == torch.device("cpu")
    assert not _backend.on_card(torch.zeros(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tutils.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("cifar10", "resnet18", "/nonexistent", 16)
    from dorpatch_tpu_torch.config import ExperimentConfig
    from dorpatch_tpu_torch.pipeline import run_experiment

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(ExperimentConfig(dataset="cifar10", img_size=16,
                                        results_root="/nonexistent"))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Import every module of the port in a fresh interpreter: neither jax
    nor any module of `dorpatch_tpu` may load."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import dorpatch_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            dorpatch_tpu_torch.__path__, "dorpatch_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "flax" or m.startswith("flax.")
                     or m == "dorpatch_tpu" or m.startswith("dorpatch_tpu."))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 15 else 0)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "dorpatch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in ("jax", "flax", "dorpatch_tpu"), (path, name)
