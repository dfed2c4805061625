"""The port's program auditor (`analysis/program.py`, DP200-DP208) and its
entry-point registry (`analysis/entrypoints.py`): each rule on a toy torch
program traced on fake tensors, positive and negative; the allowlist and
`# noqa` suppressions; capture through the `timed_first_call` recorder;
every production entry point tracing clean, each kernel's op in the
traces; and the `--trace` CLI's exit codes.

Mirrors `tests/test_program_audit.py` case by case (DP205 and DP206 have
no torch reading: `--list-rules` says so, `test_torch_analysis.py`).
"""

import dataclasses
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dorpatch_tpu_torch import observe  # noqa: E402
from dorpatch_tpu_torch.analysis import entrypoints as ep_mod  # noqa: E402
from dorpatch_tpu_torch.analysis import program  # noqa: E402
from dorpatch_tpu_torch.analysis.cli import main as cli_main  # noqa: E402
from dorpatch_tpu_torch.analysis.entrypoints import (  # noqa: E402
    EntryPoint, capture_entrypoints, clear_entrypoints, register_entrypoint,
    registered_entrypoints, uncovered_names)
from dorpatch_tpu_torch.ops import masked_fill as mf  # noqa: E402

W = torch.zeros(16, 16)
BIG = torch.zeros(256, 256)       # 256 KiB, closed over: made once


def rule_ids(findings):
    return sorted({f.rule_id for f in findings})


def audit(fn, args, name="fx.prog"):
    return program.audit_entrypoint(
        EntryPoint(name=name, fn=fn, args=tuple(args)))


@dataclasses.dataclass
class Carry:
    a: torch.Tensor
    b: torch.Tensor


# toy programs: (positive, negative) per rule, and their example args

def _untraceable(x):
    return x * float(x.sum())          # a host read of a value


def _traceable(x):
    return x * float(x.shape[0])


def _carry_drift(c: Carry, x):
    return Carry(c.a.double(), c.b + x)


def _carry_stable(c: Carry, x):
    return Carry(c.a * 2, c.b + x)


def _f64_inside(x):
    return (x.double() * 2).sum().float()


def _f32_only(x):
    return (x * 2).sum()


def _host_const(x):
    return x + torch.as_tensor(np.ones((256, 256), np.float32))


def _closed_const(x):
    return x + BIG + torch.as_tensor(np.ones((4, 4), np.float32)).sum()


def _dead_matmul(x):
    _ = x @ W
    return x + 1


def _dead_view(x):
    _ = x.t()
    return x + 1


def _upcast(x):
    return x.float() @ W


def _upcast_reduced(x):
    return x.float().sum(dim=-1)


X = torch.zeros(128, 16)
CASES = {
    "DP200": ((_untraceable, (X,)), (_traceable, (X,))),
    "DP201": ((_carry_drift, (Carry(X, X), X)),
              (_carry_stable, (Carry(X, X), X))),
    "DP202": ((_f64_inside, (X,)), (_f32_only, (X,))),
    "DP203": ((_host_const, (torch.zeros(256, 256),)),
              (_closed_const, (torch.zeros(256, 256),))),
    "DP204": ((_dead_matmul, (X,)), (_dead_view, (X,))),
    "DP208": ((_upcast, (torch.zeros(1024, 16, dtype=torch.bfloat16),)),
              (_upcast_reduced,
               (torch.zeros(1024, 16, dtype=torch.bfloat16),))),
}


@pytest.mark.parametrize("rule_id", sorted(CASES))
def test_trace_rule_positive_fires(rule_id):
    (fn, args), _ = CASES[rule_id]
    found = audit(fn, args, name="fx.prog.bf16")
    assert rule_id in rule_ids(found), found
    assert all(f.message.startswith("[fx.prog.bf16]") for f in found)


@pytest.mark.parametrize("rule_id", sorted(CASES))
def test_trace_rule_negative_clean(rule_id):
    _, (fn, args) = CASES[rule_id]
    found = audit(fn, args, name="fx.prog.bf16")
    assert rule_id not in rule_ids(found), found


def test_dp208_only_in_declared_bf16_programs():
    (fn, args), _ = CASES["DP208"]
    assert "DP208" not in rule_ids(audit(fn, args, name="fx.prog"))


def test_dp201_single_leaf_needs_a_dtype_of_one_kind():
    """A single tensor in and out is a carry only when its dtype drifts
    within one kind (float -> float): an int index table in and float
    margins out of the same shape is a program, not a carry."""
    assert "DP201" in rule_ids(audit(lambda x: x.half(), (X,)))
    idx = torch.zeros(4, 36, dtype=torch.long)
    assert "DP201" not in rule_ids(audit(lambda i: i.float() * 2, (idx,)))


def test_dp200_names_the_data_dependent_op():
    (f,) = audit(_untraceable, (X,))
    assert f.rule_id == "DP200" and "failed to trace" in f.message


def test_trace_draws_nothing_from_a_closed_over_generator():
    """Tracing runs on fake tensors: a program's draws from a real
    generator it closes over leave the generator's state as it was (the
    attack's RNG streams stay bit-equal)."""
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state().clone()

    def draw(x):
        return x + torch.rand(x.shape, generator=gen)

    ctx, errs = program.trace_entrypoint(
        EntryPoint(name="fx.draw", fn=draw, args=(X,)))
    assert ctx is not None, errs
    assert torch.equal(gen.get_state(), before)
    assert any(program.op_packet(n) == "rand"
               for n in ctx.nodes("call_function"))


def test_allowlist_glob_suppresses():
    (fn, args), _ = CASES["DP202"]
    ep = EntryPoint(name="fx.allowed.one", fn=fn, args=args)
    assert not program.audit_entrypoint(
        ep, allow={"fx.allowed.*": {"DP202": "fixture"}})


def test_noqa_on_def_line_suppresses(tmp_path):
    mod = tmp_path / "noqa_tprog.py"
    mod.write_text(textwrap.dedent("""\
        def prog(x):  # noqa: DP202 — fixture: the f64 is the point
            return (x.double() * 2).float()
    """), encoding="utf-8")
    sys.path.insert(0, str(tmp_path))
    try:
        import noqa_tprog

        ep = EntryPoint(name="fx.noqa", fn=noqa_tprog.prog, args=(X,))
        assert "DP202" not in rule_ids(program.audit_entrypoint(ep))
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("noqa_tprog", None)


# ---------- the registry ----------

def test_capture_records_wraps_and_calls():
    clear_entrypoints()
    try:
        with capture_entrypoints():
            fn = observe.timed_first_call(lambda x: x * 2.0, "fx.captured",
                                          recompile_budget=3)
            assert uncovered_names() == ["fx.captured"]    # wrap discovered
            fn(torch.ones(3))                               # call: the args
        (ep,) = registered_entrypoints()
        assert ep.name == "fx.captured" and ep.source == "captured"
        from torch._subclasses.fake_tensor import FakeTensor

        assert isinstance(ep.args[0], FakeTensor)
        assert tuple(ep.args[0].shape) == (3,)
        assert uncovered_names() == []
        assert ep_mod.declared_budgets() == {"fx.captured": 3}
        assert not program.audit_entrypoint(ep)
    finally:
        clear_entrypoints()


def test_recorder_is_inert_outside_capture():
    assert observe.entrypoint_recorder() is None
    fn = observe.timed_first_call(lambda x: x + 1, "fx.free")
    fn(torch.ones(2))
    assert "fx.free" not in {e.name for e in registered_entrypoints()}


def test_uncovered_wrap_is_dp200():
    findings = program.audit_entrypoints([], uncovered=["fx.orphan"])
    assert rule_ids(findings) == ["DP200"]
    assert "fx.orphan" in findings[0].message


def test_register_entrypoint_uses_wrapper_name():
    clear_entrypoints()
    try:
        def body(x):
            return x + 1

        wrapped = observe.timed_first_call(body, "fx.named")
        ep = register_entrypoint(wrapped, (torch.zeros(2),))
        assert ep.name == "fx.named" and ep.fn is body
    finally:
        clear_entrypoints()


def test_kernel_ops_are_single_nodes():
    """A kernel wrapper traces to its one op: the plain version's aten ops
    stay inside it."""
    rects = torch.tensor([[[0, 4, 0, 4]], [[2, 6, 2, 6]]], dtype=torch.int32)

    def fill(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            out = mf.masked_fill(x, rects, 0.5)
            (g,) = torch.autograd.grad(out.sum(), (x,))
        return out.detach(), g

    ctx, errs = program.trace_entrypoint(
        EntryPoint(name="fx.fill", fn=fill, args=(torch.zeros(2, 8, 8, 3),)))
    assert ctx is not None, errs
    ops = [program.op_name(n) for n in ctx.nodes("call_function")
           if program.is_kernel(n)]
    assert ops == ["dorpatch_torch.masked_fill_fwd.default",
                   "dorpatch_torch.masked_fill_bwd.default"]


# ---------- the production programs ----------

@pytest.fixture(scope="module")
def production():
    """Every production entry point enumerated and traced once (the
    `--trace` gate's work), with the uncovered names."""
    eps = ep_mod.production_entrypoints()
    uncovered = ep_mod.uncovered_names()
    traced = {ep.name: program.trace_entrypoint(ep) for ep in eps}
    yield eps, uncovered, traced
    clear_entrypoints()


def test_production_registry_round_trip(production):
    eps, uncovered, _ = production
    names = {e.name for e in eps}
    expected = {"attack.step.stage0", "attack.step.stage1", "attack.sweep",
                "train.step", "train.eval_step", "serve.clean_predict[b1]",
                "serve.clean_predict[b4]", "defense.phase1.stem.r0.06",
                "defense.pairs.token.bf16.r0.06", "defense.rows.mixer.r0.06",
                "ops.gn_relu.grad", "ops.gn_relu.grad.bf16"}
    assert expected <= names, f"missing: {expected - names}"
    for kind in ("predict", "phase1", "pairs", "rows"):
        assert {f"defense.{kind}.r{r}" for r in (0.015, 0.03, 0.06, 0.12)
                } <= names, kind
    assert uncovered == []
    # eager torch has no programs for these: listed with their reasons
    assert set(ep_mod.NOT_PROGRAMS) == {"train.init", "model.init.*"}
    assert not names & {"train.init"}


def test_shipped_tree_trace_clean(production):
    eps, uncovered, traced = production
    findings = program.audit_entrypoints([], uncovered=uncovered)
    for ep in eps:
        ctx, errs = traced[ep.name]
        findings += errs
        if ctx is not None:
            for rule in program.all_trace_rules():
                findings += [f for f in rule.check(ctx)
                             if not program.allowed(ep.name, f.rule_id)]
    assert not findings, "\n".join(f.render() for f in findings)


def test_every_kernel_op_is_in_the_production_traces(production):
    """Each kernel's op shows in the programs that run it: A and B in the
    attack step, A in the defense's sweeps, C in the stem engine's phase 1,
    H in the token engine's programs, D-G in the GroupNorm probes."""
    _, _, traced = production

    def ops(name):
        ctx, _ = traced[name]
        return {program.op_packet(n) for n in ctx.nodes("call_function")
                if program.is_kernel(n)}

    assert ops("attack.step.stage0") == {"masked_fill_fwd",
                                         "masked_fill_bwd"}
    assert ops("defense.pairs.r0.06") == {"masked_fill_fwd"}
    assert ops("defense.phase1.stem.bf16.r0.06") == {"stem_fold"}
    assert ops("defense.phase1.token.r0.06") == {"masked_kv_attn"}
    assert ops("ops.gn_relu.grad.bf16") == {"gn_relu_fwd", "gn_relu_bwd"}
    seen = set().union(*(ops(n) for n in traced if traced[n][0] is not None))
    from dorpatch_tpu_torch.ops import _library

    assert seen == set(_library.OP_NAMES)


# ---------- CLI ----------

LOADERS = '''
import torch
from dorpatch_tpu_torch.analysis.entrypoints import EntryPoint

X = torch.zeros(8, 4)


def _clean(x):
    return (x * 2).sum()


def _leak(x):
    return (x.double() * 2).sum()


def clean_entrypoints():
    return [EntryPoint(name="fx.clean", fn=_clean, args=(X,))]


def bad_entrypoints():
    return [EntryPoint(name="fx.leak", fn=_leak, args=(X,))]
'''


@pytest.fixture
def loaders(tmp_path):
    (tmp_path / "tprog_loaders.py").write_text(LOADERS, encoding="utf-8")
    sys.path.insert(0, str(tmp_path))
    yield "tprog_loaders"
    sys.path.remove(str(tmp_path))
    sys.modules.pop("tprog_loaders", None)
    clear_entrypoints()


def test_cli_trace_exit_codes(loaders, capsys):
    assert cli_main(["--trace", "--entrypoints",
                     f"{loaders}:clean_entrypoints"]) == 0
    assert "1 entry point(s) clean" in capsys.readouterr().err
    assert cli_main(["--trace", "--entrypoints",
                     f"{loaders}:bad_entrypoints"]) == 1
    out = capsys.readouterr().out
    assert "DP202" in out and "[fx.leak]" in out


def test_cli_trace_select(loaders, capsys):
    assert cli_main(["--trace", "--select", "DP204", "--entrypoints",
                     f"{loaders}:bad_entrypoints"]) == 0
    assert cli_main(["--trace", "--select", "DP202", "--format", "json",
                     "--entrypoints", f"{loaders}:bad_entrypoints"]) == 1
    assert '"rule": "DP202"' in capsys.readouterr().out


def test_cli_trace_bad_entrypoints_spec():
    assert cli_main(["--trace", "--entrypoints", "no.such.module:x"]) == 2
