"""Carry snapshots of the port (`dorpatch_tpu_torch.checkpoint`): the
contracts of the JAX package's `tests/test_checkpoint.py`, and mid-stage
resumes whose patch is `torch.equal` to an uninterrupted run's, in float32
and with the bf16 EOT step."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from dorpatch_tpu_torch import utils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.checkpoint import (CarryCheckpointer,
                                           atomic_write_json, load_json)
from dorpatch_tpu_torch.config import AttackConfig


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tests' small ops run in parallel test
    processes, whose threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _apply(x):
    s = x.mean(dim=(1, 2))
    return torch.stack([s[:, 0], s[:, 1], s[:, 2], s.sum(-1) / 3.0], -1) * 10


def _tiny_attack(cfg, **kw):
    return DorPatch(_apply, 4, cfg, **kw)


def _cfg(**kw):
    base = dict(sampling_size=4, max_iterations=9, sweep_interval=3,
                switch_iteration=3, dropout=1, dropout_sizes=(0.06,),
                basic_unit=4, patch_budget=0.15, failure_sampling_start=2)
    base.update(kw)
    return AttackConfig(**base)


def _x(seed=0, scale=1.0):
    g = utils.generator(seed, torch.device("cpu"))
    return torch.rand((1, 16, 16, 3), generator=g) * scale


def _state(seed=1):
    atk = _tiny_attack(_cfg())
    x = _x()
    return atk._init_state(utils.generator(seed, torch.device("cpu")), x,
                           torch.zeros((1,), dtype=torch.long), False, 10)


def _assert_states_equal(a, b):
    for name in a.__dataclass_fields__:
        u, v = getattr(a, name), getattr(b, name)
        if isinstance(u, torch.Generator):
            assert torch.equal(u.get_state(), v.get_state())
        else:
            assert u.dtype == v.dtype and torch.equal(u, v), name


def test_carry_roundtrip(tmp_path):
    state = _state()
    with CarryCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(0, 3, state)
        got = ck.restore(state)
        assert got is not None and (got.stage, got.iteration) == (0, 3)
        assert got.stage0_mask is None
        _assert_states_equal(state, got.state)
        # the restored generator is its own object, in the saved state:
        # both draw the same numbers from here on
        assert got.state.gen is not state.gen
        assert torch.equal(torch.rand(5, generator=got.state.gen),
                           torch.rand(5, generator=state.gen))

        # stage-1 snapshot includes the stage-0 artifacts, newest wins
        ck.save(1, 3, state, state.adv_mask, state.adv_pattern)
        got1 = ck.restore(state, (state.adv_mask, state.adv_pattern))
        assert (got1.stage, got1.iteration) == (1, 3)
        assert torch.equal(got1.stage0_mask, state.adv_mask)
        assert ck.all_steps() == [3, 10_000_003]


def test_restore_empty_returns_none(tmp_path):
    with CarryCheckpointer(str(tmp_path / "empty")) as ck:
        assert ck.restore(None) is None
        assert ck.latest_step_info() is None


def test_clear_removes_snapshots(tmp_path):
    state = _state()
    with CarryCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(0, 3, state)
        ck.clear()
        assert ck.restore(state) is None


def test_max_to_keep_and_latest_step_info(tmp_path):
    state = _state()
    with CarryCheckpointer(str(tmp_path / "ck")) as ck:
        for i in (3, 6, 9):
            ck.save(0, i, state)
        assert ck.all_steps() == [6, 9]
        info = ck.latest_step_info()
        assert (info.stage, info.iteration, info.state) == (0, 9, None)
    assert not glob.glob(str(tmp_path / "ck" / ".tmp-*"))


def _run(attack, x, **kw):
    return attack.generate(x, seed=3, **kw)


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", [0, 1])
def test_mid_stage_resume_matches_uninterrupted(tmp_path, stage, dtype):
    """Raise from `on_block_end` after the first block of stage 0 or of
    stage 1 (the snapshot of that block is already saved); a fresh attack
    with a fresh checkpointer on the same inputs resumes from it, runs no
    earlier block again, and ends on the uninterrupted run's patch bit for
    bit (stage 1's init draws from the generator: a resume must not draw
    them again)."""
    cfg = _cfg(compute_dtype=dtype)
    x = _x(2, 0.3)
    blocks = {}
    full = _run(_tiny_attack(cfg, on_block_end=lambda s, i, info:
                             blocks.setdefault((s, i), info["metrics"])), x)

    def bomb(s, i, info):
        assert set(info) == {"metrics", "stopped", "n_failed"}
        assert info["metrics"].shape == (8,)
        if (s, i) == (stage, 3):
            raise Boom()

    ck_dir = str(tmp_path / "carry")
    atk = _tiny_attack(cfg, checkpointer=CarryCheckpointer(ck_dir),
                       on_block_end=bomb)
    with pytest.raises(Boom):
        _run(atk, x)

    resumed = {}
    atk2 = _tiny_attack(cfg, checkpointer=CarryCheckpointer(ck_dir),
                        on_block_end=lambda s, i, info:
                        resumed.setdefault((s, i), info["metrics"]))
    res = _run(atk2, x)
    assert list(resumed)[0] == (stage, 6)    # no block before the snapshot
    assert list(resumed)[-1] == (1, 9)
    # every later block saw the uninterrupted run's losses and failure
    # counts: the same masks were drawn
    for coord, m in resumed.items():
        np.testing.assert_array_equal(m, blocks[coord])
    assert torch.equal(res.adv_pattern, full.adv_pattern)
    assert torch.equal(res.adv_mask, full.adv_mask)
    assert torch.equal(res.stage0_mask, full.stage0_mask)
    np.testing.assert_array_equal(res.y, full.y)
    np.testing.assert_array_equal(res.targeted, full.targeted)


def test_resume_on_a_shallow_resnet18(tmp_path):
    """The same contract on a full-width (one block a stage) CIFAR
    ResNet-18 victim at 16 px, stage-1 resume."""
    from dorpatch_tpu_torch.models.small import CifarResNet18

    torch.manual_seed(0)
    net = CifarResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1)).eval()
    net.requires_grad_(False)
    cfg = _cfg(max_iterations=4, sweep_interval=2, switch_iteration=2)
    x = _x(5)
    blocks, resumed = {}, {}
    full = DorPatch(net, 10, cfg, on_block_end=lambda s, i, info:
                    blocks.setdefault((s, i), info["metrics"])
                    ).generate(x, seed=7)

    def bomb(s, i, info):
        if (s, i) == (1, 2):
            raise Boom()

    ck_dir = str(tmp_path / "carry")
    with pytest.raises(Boom):
        DorPatch(net, 10, cfg, on_block_end=bomb,
                 checkpointer=CarryCheckpointer(ck_dir)).generate(x, seed=7)
    res = DorPatch(net, 10, cfg, checkpointer=CarryCheckpointer(ck_dir),
                   on_block_end=lambda s, i, info:
                   resumed.setdefault((s, i), info["metrics"])
                   ).generate(x, seed=7)
    assert list(resumed) == [(1, 4)]
    np.testing.assert_array_equal(resumed[(1, 4)], blocks[(1, 4)])
    assert torch.equal(res.adv_pattern, full.adv_pattern)
    assert torch.equal(res.adv_mask, full.adv_mask)


def test_fingerprint_mismatch_purged(tmp_path):
    """A snapshot saved under one fingerprint never restores into a run
    with another: it is purged (with a warning) at construction; a legacy
    snapshot without a fingerprint is purged by a fingerprinted open."""
    state = _state()
    fp1 = {"seed": 1234, "batch": 0}
    with CarryCheckpointer(str(tmp_path / "ck"), fingerprint=fp1) as ck:
        ck.save(0, 3, state)
    with CarryCheckpointer(str(tmp_path / "ck"), fingerprint=fp1) as ck1:
        got = ck1.restore(state)
        assert got is not None and got.iteration == 3
    with pytest.warns(UserWarning, match="fingerprint"):
        ck2 = CarryCheckpointer(str(tmp_path / "ck"),
                                fingerprint={"seed": 99, "batch": 0})
    with ck2:
        assert ck2.restore(state) is None
    with CarryCheckpointer(str(tmp_path / "ck2")) as ck4:
        ck4.save(0, 2, state)
    with pytest.warns(UserWarning, match="fingerprint"):
        ck5 = CarryCheckpointer(str(tmp_path / "ck2"), fingerprint=fp1)
    with ck5:
        assert ck5.restore(state) is None


def test_fingerprint_purge_unblocks_new_runs_saves(tmp_path):
    """A stale run's stage-1 snapshot (step 10_000_003) is purged, so it
    shadows none of the new run's restores."""
    state = _state()
    fp_a, fp_b = {"seed": 1}, {"seed": 2}
    d = str(tmp_path / "ck")
    with CarryCheckpointer(d, fingerprint=fp_a) as ck:
        ck.save(1, 3, state, state.adv_mask, state.adv_pattern)
    with pytest.warns(UserWarning, match="deleting"):
        ck_b = CarryCheckpointer(d, fingerprint=fp_b)
    with ck_b:
        ck_b.save(0, 2, state)
        assert ck_b.all_steps() == [2]
    with CarryCheckpointer(d, fingerprint=fp_b) as ck:
        got = ck.restore(state)
        assert got is not None and (got.stage, got.iteration) == (0, 2)


def _two_snapshots(tmp_path):
    state = _state()
    d = str(tmp_path / "ck")
    with CarryCheckpointer(d) as ck:
        ck.save(0, 2, state)
        ck.save(0, 4, state)
    return d, state


def test_truncated_meta_falls_back_to_previous_snapshot(tmp_path):
    d, state = _two_snapshots(tmp_path)
    with open(os.path.join(d, "4", "meta.json"), "w") as fh:
        fh.write('{"stage": 0, "iter')  # truncated mid-write
    with CarryCheckpointer(d) as ck:
        with pytest.warns(UserWarning, match="truncated/corrupt"):
            got = ck.restore(state)
        assert got is not None and (got.stage, got.iteration) == (0, 2)
        assert 4 not in ck.all_steps()  # deleted, not just skipped


def test_corrupt_payload_falls_back_and_unblocks_saves(tmp_path):
    d, state = _two_snapshots(tmp_path)
    with open(os.path.join(d, "4", "carry.pt"), "r+b") as fh:
        fh.truncate(3)
    with CarryCheckpointer(d) as ck:
        with pytest.warns(UserWarning, match="falling back"):
            got = ck.restore(state)
        assert got is not None and (got.stage, got.iteration) == (0, 2)
        ck.save(0, 3, state)
        assert ck.all_steps() == [2, 3]
    with CarryCheckpointer(d) as ck:
        got = ck.restore(state)
        assert (got.stage, got.iteration) == (0, 3)


def test_restore_all_snapshots_corrupt_returns_none(tmp_path):
    d, state = _two_snapshots(tmp_path)
    for step in ("2", "4"):
        with open(os.path.join(d, step, "meta.json"), "w") as fh:
            fh.write("not json")
    with CarryCheckpointer(d) as ck:
        with pytest.warns(UserWarning):
            assert ck.restore(state) is None


def test_snapshot_of_another_shape_or_package_is_absent(tmp_path):
    """A snapshot of another run shape (no fingerprint to tell) fails its
    restore and is deleted; a step directory in the JAX package's orbax
    layout (`<step>/meta/`, `<step>/carry/`) reads as corrupt: both count
    as absent, with a warning."""
    d, state = _two_snapshots(tmp_path)
    other = _tiny_attack(_cfg())._init_state(
        utils.generator(1, torch.device("cpu")), torch.zeros((2, 16, 16, 3)),
        torch.zeros((2,), dtype=torch.long), False, 10)
    with CarryCheckpointer(d) as ck:
        with pytest.warns(UserWarning, match="failed to restore"):
            assert ck.restore(other) is None
        assert ck.all_steps() == []
    orbax = tmp_path / "orbax" / "7"
    (orbax / "meta").mkdir(parents=True)
    (orbax / "carry").mkdir()
    (orbax / "meta" / "metadata").write_text('{"stage": 0}')
    with CarryCheckpointer(str(tmp_path / "orbax")) as ck:
        with pytest.warns(UserWarning, match="truncated/corrupt"):
            assert ck.restore(state) is None


def test_atomic_write_json_and_tolerant_load(tmp_path):
    """The JAX package's contract, and byte-equal output."""
    from dorpatch_tpu.checkpoint import atomic_write_json as jax_write

    path = str(tmp_path / "state.json")
    atomic_write_json(path, {"a": 1})
    assert load_json(path) == {"a": 1}
    assert not glob.glob(path + ".tmp.*")
    atomic_write_json(path, {"a": 2})
    assert load_json(path) == {"a": 2}
    with open(path, "w") as fh:
        fh.write('{"a": ')  # torn write
    assert load_json(path) is None
    assert load_json(path, default={}) == {}
    assert load_json(str(tmp_path / "missing.json"), default=7) == 7
    rec = {"z": [1, 2.5, "x"], "a": {"b": None, "c": True}, "f": np.float32(3)}
    atomic_write_json(str(tmp_path / "p.json"), rec)
    jax_write(str(tmp_path / "j.json"), rec)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "p.json").read_text())["f"] == 3.0
