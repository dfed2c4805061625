"""The port's mesh (`dorpatch_tpu_torch.parallel`) on the CPU: four ranks of
a `(2, 2)` gloo mesh (`torch_mesh_ranks.py`, spawned once for the module)
run the sharded fill, stem fold and masked-KV attention, a toy sharded
attack, a meshed pruned certification and a meshed `run_experiment`; here
their results are held against the JAX package's mesh (`tests/conftest.py`
gives JAX 8 CPU devices) and against the port's single-process runs."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import parallel as jpar
from dorpatch_tpu.config import DefenseConfig as JaxDefenseConfig
from dorpatch_tpu.ops import masked_fill as jmasked_fill
from dorpatch_tpu.ops import masked_kv_attn as jattn
from dorpatch_tpu.ops import stem_fold as jsf
from dorpatch_tpu_torch.config import ExperimentConfig
from dorpatch_tpu_torch.ops import masked_fill as tmf
from dorpatch_tpu_torch.parallel import make_mesh
from dorpatch_tpu_torch.pipeline import run_experiment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_ranks.py")
WORLD = 4
#: seconds the four ranks may take together (each collective waits 120)
RANKS_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(out / "store"),
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = []
    for r in range(WORLD):
        with open(out / f"rank_{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res, out


def _assemble(res, case, shape, key="out"):
    full = np.zeros(shape, np.float32)
    seen = np.zeros(shape[:2], np.int64)
    for r in res:
        c = r[case]
        rows, cols = slice(*c["rows"]), slice(*c.get("cols", (0, shape[1])))
        full[rows, cols] = c[key]
        seen[rows, cols] += 1
    assert (seen == 1).all()          # each entry owned by one rank
    return full


def test_sharded_fill_matches_the_jax_mesh(ranks):
    res, _ = ranks
    c = res[0]["fill"]
    jmesh = jpar.make_mesh(2, 2)
    imgs, rects = jnp.asarray(c["imgs"]), jnp.asarray(c["rects"])

    def f(x):
        return jmasked_fill(x, rects, 0.5, "interpret", mesh=jmesh)

    want, vjp = jax.vjp(f, imgs)
    (want_gx,) = vjp(jnp.asarray(c["g"]))
    got = _assemble(res, "fill", want.shape)
    np.testing.assert_array_equal(got, np.asarray(want))
    for r in res:                     # the cotangent, whole on every rank
        np.testing.assert_allclose(r["fill"]["gx"], np.asarray(want_gx),
                                   atol=1e-5, rtol=0)


def test_sharded_fill_indivisible_runs_the_plain_fill(ranks):
    res, _ = ranks
    c = res[0]["fill_indivisible"]
    x = torch.tensor(c["imgs"], requires_grad=True)
    out = tmf.masked_fill(x, torch.as_tensor(c["rects"]), 0.5)
    (gx,) = torch.autograd.grad((out * torch.as_tensor(c["g"])).sum(), x)
    for r in res:
        got = r["fill_indivisible"]
        assert got["out"].shape == (3, 5, 16, 16, 3)
        np.testing.assert_array_equal(got["out"], out.detach().numpy())
        np.testing.assert_array_equal(got["gx"], gx.numpy())
        assert r["unsharded"].get("fill", 0) >= 1


def test_sharded_stem_fold_matches_jax(ranks):
    res, _ = ranks
    c = res[0]["stem"]
    plan = jsf.plan_windows(c["singles"], 16, 3, 1, c["pads"])
    want = np.asarray(jsf.fold_masked_stem(
        jnp.asarray(c["kern"]), jnp.asarray(c["clean"]), jnp.asarray(c["u"]),
        plan, (1, 1), c["pads"]))
    got = _assemble(res, "stem", want.shape)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for r in res:                     # the meshed family: gathered tables
        one, mesh = r["stem_family"]["one"], r["stem_family"]["mesh"]
        np.testing.assert_array_equal(mesh[0], one[0])
        np.testing.assert_allclose(mesh[1], one[1], atol=1e-4, rtol=0)


def test_sharded_kv_attention_matches_jax(ranks):
    res, _ = ranks
    ops = res[0]["attn"]["ops"]
    want = np.asarray(jattn.masked_kv_attention_reference(
        *(jnp.asarray(o) for o in ops)))
    # H shards the data axis only: the two ranks of a data block agree
    first = [r for r in res if r["coords"][1] == 0]
    got = _assemble(first, "attn", want.shape)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for r in res:
        rows = slice(*r["attn"]["rows"])
        np.testing.assert_array_equal(r["attn"]["out"], got[rows])


def test_sharded_attack_matches_single_process(ranks):
    res, _ = ranks
    for r in res:
        one, mesh = r["attack"]["one"], r["attack"]["mesh"]
        np.testing.assert_allclose(mesh["mask"], one["mask"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(mesh["pattern"], one["pattern"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(mesh["y"], one["y"])
        np.testing.assert_array_equal(mesh["targeted"], one["targeted"])
    np.testing.assert_array_equal(res[1]["attack"]["mesh"]["pattern"],
                                  res[0]["attack"]["mesh"]["pattern"])


def test_sharded_attack_resumes_from_a_rank0_snapshot(ranks):
    """Cut at stage 1's first block, every rank resumes from rank 0's
    snapshot (read there, broadcast) and ends on the uninterrupted run's
    patch, bit for bit."""
    res, _ = ranks
    for r in res:
        assert r["carry"]["restored"] == [(1, 2)]
        np.testing.assert_array_equal(r["carry"]["resumed"],
                                      r["carry"]["whole"])


def _jax_trigger(params, x):
    t1 = x[:, 4:8, 4:8, :].mean(axis=(1, 2, 3)) > 0.8
    t2 = x[:, 24:28, 24:28, :].mean(axis=(1, 2, 3)) > 0.8
    t3 = x[:, 4:8, 24:28, :].mean(axis=(1, 2, 3)) < 0.2
    return jax.nn.one_hot(jnp.where(t1 | t2, 1, jnp.where(t3, 2, 0)), 3)


def test_meshed_certification_matches_the_jax_mesh(ranks):
    res, _ = ranks
    c = res[0]["certify"]
    jmesh = jpar.make_mesh(2, 2)
    jpc = jpar.make_sharded_defenses(
        _jax_trigger, 32, jmesh,
        JaxDefenseConfig(ratios=(0.1,), prune="exact"))[0]
    want = jpc.robust_predict(None, jpar.place_batch(jmesh,
                                                     jnp.asarray(c["x"])), 3)
    for r in res:
        got = r["certify"]["records"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[0] == w.prediction and g[1] == w.certification
            np.testing.assert_array_equal(g[2], w.preds_1)
            np.testing.assert_array_equal(g[3], w.preds_2)   # unevaluated too
            assert g[4] == w.forwards
    # all four verdict classes, one of them pruned below the exhaustive cost
    assert [(g[0], g[1]) for g in res[0]["certify"]["records"]] == \
        [(0, True), (0, False), (1, False), (1, False)]
    assert res[0]["certify"]["records"][1][4] < 36 + 630


def test_meshed_run_experiment_matches_single_process(ranks):
    res, out = ranks
    one = res[0]["run"]["one"]
    for r in res:
        got = r["run"]["mesh"]
        assert got["report"] == one["report"]
        for k in ("clean_accuracy", "robust_accuracy", "acc_pc",
                  "certified_acc_pc", "certified_asr_pc", "evaluated_images",
                  "forwards", "forward_equivalents", "forwards_exhaustive",
                  "escalated"):
            assert got[k] == one[k], k
    # one results directory, the report and config written once (rank 0),
    # each rank's telemetry and mesh record of its own
    dirs = [d for d, _, files in os.walk(out / "run_mesh")
            if "summary.json" in files]
    assert len(dirs) == 1
    names = set(os.listdir(dirs[0]))
    assert {f"mesh_{r}.json" for r in range(WORLD)} <= names
    assert {f"heartbeat_{r}.jsonl" for r in range(WORLD)} <= names
    assert {"events.jsonl", "events_1.jsonl", "run.json",
            "config.json"} <= names


def test_mesh_flags_parse_and_round_trip():
    """`--mesh-data` and `--mesh-mask` parse with the JAX package's
    defaults, round-trip through `config_from_dict`, and `NOT_PORTED` no
    longer names them."""
    from dorpatch_tpu.cli import build_parser as jax_parser
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.config import (NOT_PORTED, config_from_dict,
                                           config_to_dict)

    assert not {"mesh_data", "mesh_mask"} & set(
        NOT_PORTED["ExperimentConfig"])
    jdef = jax_parser().parse_args([])
    cfg = config_from_args(build_parser().parse_args([]))
    assert (cfg.mesh_data, cfg.mesh_mask) == (jdef.mesh_data,
                                              jdef.mesh_mask) == (1, 1)
    cfg = config_from_args(build_parser().parse_args(
        ["--mesh-data", "2", "--mesh-mask", "4"]))
    assert (cfg.mesh_data, cfg.mesh_mask) == (2, 4)
    assert config_from_dict(config_to_dict(cfg)) == cfg


def test_mesh_larger_than_the_world_raises_naming_torchrun():
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, 2, device="cpu")
    cfg = ExperimentConfig(device="cpu", mesh_data=2, mesh_mask=1,
                           synthetic_data=True, dataset="cifar10",
                           img_size=16, results_root="/nonexistent")
    with pytest.raises(ValueError, match="torchrun"):
        run_experiment(cfg, verbose=False)
