"""The port's runtime sanitizers (`dorpatch_tpu_torch/analysis/
sanitize.py`, `--sanitize`): the counterparts of `tests/test_sanitize.py`
(the shape budget counts buckets, a retrace within budget is an event, a
NaN raises at the op that produced it, global state restored, budgets
inert without the sanitizer, the flag plumbed, the pipeline end to end),
the kernel wrappers naming themselves, and the port's `LockWatch` against
`dorpatch_tpu.analysis.lockwatch.LockWatch` on the same acquisitions."""

import dataclasses
import json
import math
import os
import threading

import numpy as np
import pytest
import torch

from dorpatch_tpu.analysis import lockwatch as jlockwatch
from dorpatch_tpu.observe import events as jevents
from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch import utils as tutils
from dorpatch_tpu_torch.analysis import lockwatch
from dorpatch_tpu_torch.analysis.sanitize import (NanOpMode,
                                                  RecompileBudgetExceeded,
                                                  Sanitizer)
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import (AttackConfig, DefenseConfig,
                                       ExperimentConfig)
from dorpatch_tpu_torch.observe import events
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops.masked_fill import masked_fill

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _tiny_attack(cfg, apply_fn=None, **kw):
    def logits(x):
        s = x.mean(dim=(1, 2))  # [B,3]
        return torch.stack([s[:, 0], s[:, 1], s[:, 2], s.sum(-1) / 3.0],
                           dim=-1) * 10

    return DorPatch(apply_fn or logits, 4, cfg, **kw)


TINY = AttackConfig(sampling_size=4, max_iterations=4, sweep_interval=2,
                    switch_iteration=2, dropout=1, dropout_sizes=(0.25,),
                    basic_unit=4, patch_budget=0.15)


def _x():
    return torch.rand(1, 16, 16, 3, generator=tutils.generator(2, CPU)) * 0.2


# ------------------------------------------------------ shape budgets


def test_watchdog_trips_on_shape_unstable_program():
    f = observe.timed_first_call(lambda x: x * 2, "unstable",
                                 recompile_budget=1)
    with Sanitizer(debug_nans=False, log_compiles=False):
        f(torch.ones(4))
        f(torch.ones(4))
        with pytest.raises(RecompileBudgetExceeded):
            f(torch.ones(5))


def test_watchdog_counts_buckets_not_calls():
    f = observe.timed_first_call(lambda x: x + 1, "stable",
                                 recompile_budget=2)
    with Sanitizer(debug_nans=False, log_compiles=False):
        for _ in range(5):
            f(torch.ones(3))
        f(torch.ones(4))             # second bucket: exactly at budget
    assert float(f(torch.ones(3))[0]) == 2.0


def test_watchdog_quiet_on_real_attack_step():
    """The attack's programs see one signature each at a fixed batch: a
    tiny `generate` under the armed sanitizer at budget 1 does not trip,
    and its carry (with its `inf` loss sentinels) raises no NaN."""
    atk = _tiny_attack(TINY, recompile_budget=1)
    with Sanitizer():
        res = atk.generate(_x(), seed=3)
    assert res.adv_mask.shape == (1, 16, 16, 1)
    assert atk._programs[0]._cache_size() == 1
    assert atk._programs["sweep"]._cache_size() == 1


def test_retrace_within_budget_is_event_not_error(tmp_path):
    f = observe.timed_first_call(lambda x: x * 3, "bucketed",
                                 recompile_budget=4)
    with observe.EventLog(str(tmp_path / "events.jsonl")), \
            Sanitizer(debug_nans=False, log_compiles=False):
        f(torch.ones(2))
        f(torch.ones(3))
    recs = _records(tmp_path / "events.jsonl")
    retraces = [r for r in recs if r.get("name") == "sanitize.retrace"]
    assert len(retraces) == 1
    assert retraces[0]["traces"] == 2 and retraces[0]["budget"] == 4
    budgets = [r for r in recs if r.get("name") == "sanitize.budget"]
    assert [(r["entry"], r["budget"]) for r in budgets] == [("bucketed", 4)]


def test_compile_log_records_every_new_signature(tmp_path):
    """Under the sanitizer every new input signature of a program is a
    `compile` record under its name (the report's compile section), as
    `jax_log_compiles` logs every trace; the kernels' build is one too."""
    f = observe.timed_first_call(lambda x: x - 7, "prog")
    with observe.EventLog(str(tmp_path / "events.jsonl")):
        f(torch.ones(2))
        f(torch.ones(3))             # not logged: the sanitizer is off
        events.log_compile("kernels.build", 1.5)
        with Sanitizer(debug_nans=False, recompile_budgets=False):
            f(torch.ones(2))         # seen: no record
            f(torch.ones(4))
            events.log_compile("kernels.build", 2.5)
    recs = _records(tmp_path / "events.jsonl")
    compiles = [(r["name"], r["dur_s"]) for r in recs
                if r["kind"] == "compile"]
    assert [n for n, _ in compiles] == ["prog", "prog", "kernels.build"]
    assert compiles[-1][1] == 2.5
    assert any(r.get("name") == "sanitize.enabled" for r in recs)


def test_budget_declaration_is_inert_without_sanitizer():
    f = observe.timed_first_call(lambda x: x * 2, "inert",
                                 recompile_budget=1)
    f(torch.ones(4))
    f(torch.ones(5))
    assert observe.recompile_guard() is None
    assert events.nan_guard() is None


def test_sanitizer_restores_global_state():
    from dorpatch_tpu_torch.analysis.sanitize import NanGuard

    assert events.nan_guard() is None
    with Sanitizer():
        assert isinstance(events.nan_guard(), NanGuard)
        assert _backend.set_sanitize(True) is True
        assert events.set_compile_log(True) is True
        assert observe.recompile_guard() is not None
        assert lockwatch.active_watch() is not None
    assert events.nan_guard() is None
    assert _backend.set_sanitize(False) is False
    assert events.set_compile_log(False) is False
    assert observe.recompile_guard() is None
    assert lockwatch.active_watch() is None


# ------------------------------------------------------ NaN at the source


def test_nan_raises_at_producing_op():
    f = observe.timed_first_call(lambda x: torch.log(x) * 2 + 1, "logp")
    f(torch.tensor([-1.0]))          # unarmed: NaN passes through
    with Sanitizer(log_compiles=False, recompile_budgets=False):
        with pytest.raises(FloatingPointError, match=r"aten\.log\.default"):
            f(torch.tensor([-1.0]))
        f(torch.tensor([float("inf")]))   # inf is not a NaN


def test_nan_op_mode_names_the_first_op_only():
    x = torch.tensor([-1.0, 4.0])
    with pytest.raises(FloatingPointError, match="aten.sqrt.default") as ei:
        with NanOpMode("p"):
            torch.sqrt(x).mul(2).add(1)
    assert "no NaN in its inputs" in str(ei.value)
    with NanOpMode("p"):
        torch.empty(3).fill_(1.0)    # uninitialized memory is no NaN


def test_nan_replay_rewinds_generators():
    """The replay draws what the call drew: every generator among the
    program's arguments is rewound to its state before the call."""
    drawn = []

    def prog(gen, x):
        u = torch.rand(3, generator=gen)
        drawn.append(u)
        return torch.log(x - u)

    f = observe.timed_first_call(prog, "draws")
    gen = tutils.generator(7, CPU)
    with Sanitizer(log_compiles=False, recompile_budgets=False):
        with pytest.raises(FloatingPointError, match="aten.log"):
            f(gen, torch.zeros(3))
    assert len(drawn) == 2 and torch.equal(drawn[0], drawn[1])


def test_nan_in_attack_step_named_at_the_op():
    """A victim whose forward makes a NaN: the step's carry carries it out,
    and the replay of that step names the op."""
    def bad(x):
        s = x.mean(dim=(1, 2))
        return torch.log(torch.cat([s, s.sum(-1, keepdim=True)], -1) - 1.0)

    atk = _tiny_attack(TINY, apply_fn=bad)
    with Sanitizer(log_compiles=False):
        with pytest.raises(FloatingPointError,
                           match=r"aten\.log\.default.*attack\.step\.stage0"):
            atk.generate(_x(), y=torch.tensor([0]), seed=3)


@pytest.mark.parametrize("where", ["wrapper", "attack"])
def test_nan_named_at_kernel_wrapper_plain_version(where):
    """A NaN that a kernel wrapper makes (here a NaN fill of the masked
    fill, kernel A) is blamed on the wrapper, on the CPU on its plain
    version, not on an aten op inside it."""
    nan = float("nan")
    with Sanitizer(log_compiles=False):
        with pytest.raises(FloatingPointError,
                           match="plain version of kernel masked_fill_fwd"):
            if where == "wrapper":
                masked_fill(torch.rand(1, 8, 8, 3),
                            torch.tensor([[[0, 4, 0, 4]]]), nan)
            else:
                atk = _tiny_attack(dataclasses.replace(TINY, mask_fill=nan))
                atk.generate(_x(), y=torch.tensor([0]), seed=3)
    out = masked_fill(torch.rand(1, 8, 8, 3), torch.tensor([[[0, 4, 0, 4]]]),
                      nan)
    assert math.isnan(float(out[0, 0, 0, 0, 0]))   # unarmed: no check


def test_nan_reaching_a_kernel_wrapper_is_not_blamed_on_it():
    """A NaN in a wrapper's inputs passes on (its program's replay names
    where it was made); only a NaN the wrapper made raises."""
    imgs = torch.rand(1, 8, 8, 3)
    imgs[0, 6, 6, 0] = float("nan")
    with Sanitizer(log_compiles=False):
        out = masked_fill(imgs, torch.tensor([[[0, 4, 0, 4]]]), 0.5)
    assert math.isnan(float(out[0, 0, 6, 6, 0]))


# ------------------------------------------------------ the pipeline


def test_pipeline_e2e_under_sanitize(tmp_path):
    """The tiny synthetic experiment runs clean under `sanitize`: no NaN,
    every program within its declared budget, the budgets and the
    sanitizer's events in the run's events.jsonl, its state unwound."""
    from dorpatch_tpu_torch.pipeline import run_experiment

    cfg = ExperimentConfig(
        dataset="cifar10", base_arch="resnet18", batch_size=2,
        num_batches=1, synthetic_data=True, sanitize=True, img_size=16,
        device="cpu", stream_depth=0,
        results_root=str(tmp_path / "results"),
        attack=AttackConfig(sampling_size=4, max_iterations=2,
                            sweep_interval=2, switch_iteration=2, dropout=1,
                            basic_unit=4, patch_budget=0.15),
        defense=DefenseConfig(ratios=(0.12,), chunk_size=18))
    m = run_experiment(cfg, verbose=False)
    assert "report" in m
    assert observe.recompile_guard() is None and events.nan_guard() is None
    results = next(p for p, _, fs in os.walk(tmp_path)
                   if "events.jsonl" in fs)
    recs = _records(os.path.join(results, "events.jsonl"))
    names = {r.get("name") for r in recs if r["kind"] == "event"}
    assert "sanitize.enabled" in names
    assert "sanitize.recompile_budget_exceeded" not in names
    budgets = {r["entry"]: r["budget"] for r in recs
               if r.get("name") == "sanitize.budget"}
    assert budgets["attack.step.stage0"] == budgets["attack.sweep"] == 2
    assert budgets["defense.phase1.stem.r0.12"] == 2   # buckets of 2: 1, 2
    compiles = {r["name"] for r in recs if r["kind"] == "compile"}
    assert {"attack.step.stage0", "attack.step.stage1",
            "attack.sweep"} <= compiles


def test_pipeline_flag_plumbed():
    args = build_parser().parse_args(["--sanitize", "--synthetic"])
    assert config_from_args(args).sanitize is True
    args = build_parser().parse_args(["--synthetic"])
    assert config_from_args(args).sanitize is False


# ------------------------------------------------------ the lock watch


def _drive(mod, evmod, script, tmp_path, name, hold_budget_s=None):
    """Run one acquisition script against a module's LockWatch; returns
    (outcome per step, the watch's events)."""
    clock = iter(np.arange(0.0, 100.0, 0.5))
    watch = mod.LockWatch(hold_budget_s=hold_budget_s,
                          clock=lambda: float(next(clock)))
    locks = {n: watch.lock(n) for n in ("a", "b", "c")}
    locks["r"] = watch.rlock("r")
    path = str(tmp_path / f"{name}.jsonl")
    out = []
    el = evmod.EventLog(path, run_id="r")
    with el, evmod.active(el):
        for step in script:
            res, held = [], []
            for n in step:
                try:
                    locks[n].acquire()
                    held.append(n)
                except mod.LockOrderViolation as e:
                    res.append(type(e).__name__)
            for n in reversed(held):
                try:
                    locks[n].release()
                except mod.LockHoldBudgetExceeded as e:
                    res.append(type(e).__name__)
            out.append(",".join(res) or "ok")
    recs = [{k: v for k, v in r.items()
             if k not in ("ts", "seq", "thread", "proc", "run_id")}
            for r in _records(path)]
    return out, recs, watch.violations


SCRIPTS = {
    "abba": [("a", "b"), ("b", "a")],
    "transitive": [("a", "b"), ("b", "c"), ("c", "a")],
    "reentrant": [("r", "r", "a"), ("a", "b")],
    "consistent": [("a", "b"), ("a", "b"), ("b", "c"), ("a", "c")],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_lockwatch_matches_jax(script, tmp_path):
    """The same acquisitions raise the same violations and write the same
    events in both packages."""
    got = _drive(lockwatch, events, SCRIPTS[script], tmp_path, "t")
    want = _drive(jlockwatch, jevents, SCRIPTS[script], tmp_path, "j")
    assert got == want
    assert ("ok" in got[0])


def test_lockwatch_hold_budget_matches_jax(tmp_path):
    got = _drive(lockwatch, events, [("a",), ("a", "b")], tmp_path, "t",
                 hold_budget_s=0.4)
    want = _drive(jlockwatch, jevents, [("a",), ("a", "b")], tmp_path, "j",
                  hold_budget_s=0.4)
    assert got == want
    assert got[0][0] == "LockHoldBudgetExceeded"


def test_watched_lock_armed_only_under_sanitizer():
    assert not isinstance(lockwatch.watched_lock("x"), lockwatch.WatchedLock)
    with Sanitizer(debug_nans=False, log_compiles=False,
                   recompile_budgets=False):
        lk = lockwatch.watched_lock("x")
        assert isinstance(lk, lockwatch.WatchedLock)
        box = []
        t = threading.Thread(target=lambda: box.append(lk.acquire()))
        t.start()
        t.join(timeout=10)
        assert box == [True] and not t.is_alive()
        lk.release()
