"""The port's program-baseline tier (`analysis/baseline.py`, DP300-DP304):
the fingerprint's stability and sensitivity, its equality on fake `cpu`
and fake `cuda` tensors, the interface apart from the body, the static
cost model, every rule on a planted drift, deterministic `--baseline
update` and its refusals, suppression, the CLI's exit contract, and the
shipped `baselines.json` checking clean in a subprocess.

Mirrors `tests/test_baseline.py` case by case. The fixture programs are
written to `tmp_path` as a module, so the CLI's `--entrypoints
module:callable` loads them.
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from dorpatch_tpu_torch.analysis import baseline  # noqa: E402
from dorpatch_tpu_torch.analysis import entrypoints as ep_mod  # noqa: E402
from dorpatch_tpu_torch.analysis.cli import main as cli_main  # noqa: E402
from dorpatch_tpu_torch.analysis.entrypoints import (  # noqa: E402
    EntryPoint, clear_entrypoints, register_bucket_ladder)

REPO = pathlib.Path(__file__).resolve().parents[1]

PROGRAMS = '''
"""Fixture programs of the baseline tier: a reference, a local-rename twin
(the same graph), a literal twin, a planted extra-matmul regression, an
elementwise carry and its channels-last twin (the same ops: interface
drift only), and an untraceable program."""
import torch

from dorpatch_tpu_torch.analysis.entrypoints import EntryPoint

X = torch.zeros(8, 16)
W = torch.zeros(16, 16)
X4 = torch.zeros(2, 4, 8, 8)
X4_CL = X4.contiguous(memory_format=torch.channels_last)


def _ref(x, w):
    y = torch.tanh(x @ w)
    return y.sum(dim=-1)


def _renamed(a, b):
    hidden = torch.tanh(a @ b)
    return hidden.sum(dim=-1)


def _literal(x, w):
    y = torch.tanh(x @ w) * 2.0
    return y.sum(dim=-1)


def _regressed(x, w):
    y = torch.tanh((x @ w) @ w)
    return y.sum(dim=-1)


def _step(x, w):
    return x + w, w


def _untraceable(x, w):
    return x * float((x @ w).sum())


def ref_entrypoint(name="fx.base.ref"):
    return EntryPoint(name=name, fn=_ref, args=(X, W))


def renamed_entrypoint(name="fx.base.ref"):
    return EntryPoint(name=name, fn=_renamed, args=(X, W))


def literal_entrypoint(name="fx.base.ref"):
    return EntryPoint(name=name, fn=_literal, args=(X, W))


def regressed_entrypoint(name="fx.base.ref"):
    return EntryPoint(name=name, fn=_regressed, args=(X, W))


def carry_entrypoint(name="fx.base.carry"):
    return EntryPoint(name=name, fn=_step, args=(X4, X4))


def carry_cl_entrypoint(name="fx.base.carry"):
    return EntryPoint(name=name, fn=_step, args=(X4_CL, X4_CL))


def clean_entrypoints():
    return [ref_entrypoint(), carry_entrypoint()]


def regressed_entrypoints():
    return [regressed_entrypoint(), carry_cl_entrypoint()]


def shrunk_entrypoints():
    return [ref_entrypoint()]


def bad_entrypoints():
    return [EntryPoint(name="fx.bad", fn=_untraceable, args=(X, W))]
'''


@pytest.fixture
def progs(tmp_path):
    """The fixture module, importable as `base_progs`."""
    (tmp_path / "base_progs.py").write_text(PROGRAMS, encoding="utf-8")
    sys.path.insert(0, str(tmp_path))
    import base_progs

    yield base_progs
    sys.path.remove(str(tmp_path))
    sys.modules.pop("base_progs", None)
    clear_entrypoints()


def rule_ids(findings):
    return sorted({f.rule_id for f in findings})


def snap(ep):
    entry, errs = baseline.snapshot_entrypoint(ep)
    assert entry is not None, errs
    return entry


def clean_baseline(progs):
    data, errs = baseline.build_baseline(progs.clean_entrypoints())
    assert not errs
    return data


# ---------- fingerprint stability / sensitivity ----------

def test_fingerprint_stable_across_reenumeration(progs):
    prints = []
    for _ in range(2):
        clear_entrypoints()
        data, errs = baseline.build_baseline(progs.clean_entrypoints())
        assert not errs
        prints.append(baseline.dump_baseline(data))
    assert prints[0] == prints[1]


def test_fingerprint_ignores_local_rename(progs):
    a = snap(progs.ref_entrypoint())
    b = snap(progs.renamed_entrypoint())
    assert a["fingerprint"] == b["fingerprint"]


def test_fingerprint_changes_on_literal(progs):
    a = snap(progs.ref_entrypoint())
    b = snap(progs.literal_entrypoint())
    assert a["fingerprint"] != b["fingerprint"]


def test_fingerprint_changes_on_op(progs):
    a = snap(progs.ref_entrypoint())
    b = snap(progs.regressed_entrypoint())
    assert a["fingerprint"] != b["fingerprint"]


def test_fingerprint_changes_on_a_constant():
    w1, w2 = torch.zeros(4, 4), torch.ones(4, 4)

    def prog(w):
        return lambda x: x @ w

    x = torch.zeros(2, 4)
    f1 = snap(EntryPoint("fx.c", prog(w1), (x,)))["fingerprint"]
    f2 = snap(EntryPoint("fx.c", prog(w2), (x,)))["fingerprint"]
    f3 = snap(EntryPoint("fx.c", prog(torch.zeros(4, 4)), (x,)))
    assert f1 != f2 and f1 == f3["fingerprint"]


def test_fingerprint_same_on_fake_cpu_and_fake_cuda():
    """A program with a kernel's op, a closed-over weight, a host-made
    table and a convolution (whose result layout the backend picks)
    traces to one fingerprint on fake `cpu` and fake `cuda` tensors (no
    gradient: autograd on a fake `cuda` tensor needs a CUDA build)."""
    import numpy as np

    from dorpatch_tpu_torch.ops.masked_fill import masked_fill

    w = torch.randn(8, 3, 3, 3, generator=torch.Generator().manual_seed(0))

    def prog(x):
        rects = torch.as_tensor(np.array([[[0, 4, 0, 4]], [[2, 6, 2, 6]]],
                                         np.int32), device=x.device)
        m = masked_fill(x, rects, 0.5).reshape(-1, 8, 8, 3)
        y = torch.nn.functional.conv2d(m.permute(0, 3, 1, 2), w)
        return y.amax(dim=(1, 2, 3))

    ep = EntryPoint("fx.dev", prog, (torch.zeros(2, 8, 8, 3),))
    (check,) = baseline.device_fingerprints([ep], ("cpu", "cuda"))
    assert check.same, check.fingerprints
    assert not any(v.startswith("untraceable")
                   for v in check.fingerprints.values())


def test_interface_split_from_body(progs):
    """A channels-last input to the same ops: the body fingerprint holds,
    the interface record moves."""
    a = snap(progs.carry_entrypoint())
    b = snap(progs.carry_cl_entrypoint())
    assert a["fingerprint"] == b["fingerprint"]
    assert a["interface"]["sha"] != b["interface"]["sha"]
    assert "channels_last" in " ".join(b["interface"]["inputs"]["head"])


def test_interface_records_inputs_written_in_place():
    def prog(x, y):
        x.add_(1)
        return y * 2

    rec = snap(EntryPoint("fx.mut", prog, (torch.zeros(3), torch.zeros(3))))
    assert rec["interface"]["mutated"] == [0]


def test_estimator_counts_matmul_flops():
    m, k, n = 8, 16, 32
    est = baseline.estimate_cost(snap_gm(lambda a, b: a @ b,
                                         torch.zeros(m, k),
                                         torch.zeros(k, n)))
    assert est["est_flops"] == 2 * m * n * k
    assert est["primitives"] == {"mm": 2 * m * n * k}
    # bytes: both operands and the result, once each
    assert est["est_bytes"] == 4 * (m * k + k * n + m * n)


def snap_gm(fn, *args):
    from dorpatch_tpu_torch.analysis import program

    gm, _ = program.trace_program(fn, args)
    return gm


def test_kernel_ops_costed_by_their_bound_formula():
    """Kernel H's op: 4 (T + S) f flops a query row, head and entry; its
    bytes each input once and the output once."""
    from dorpatch_tpu_torch.ops.masked_kv_attn import masked_kv_attention

    b, c, s, h, f, t = 2, 3, 4, 2, 32, 5
    q = torch.zeros(b, c, s, h, f)
    kc = torch.zeros(b, t, h, f)
    args = (q, q, q, kc, kc, torch.zeros(b, c, t), torch.zeros(b, c, s))
    est = baseline.estimate_cost(snap_gm(masked_kv_attention, *args))
    assert est["primitives"]["masked_kv_attn"] == 4.0 * b * c * h * s * (
        t + s) * f
    kernel_bytes = 4 * (4 * q.numel() + 2 * kc.numel() + b * c * (t + s))
    assert est["est_bytes"] >= kernel_bytes


# ---------- the rules on planted drift ----------

def test_dp301_planted_regression_names_the_op(progs):
    findings = baseline.check_entrypoints(progs.regressed_entrypoints(),
                                          clean_baseline(progs))
    dp301 = [f for f in findings if f.rule_id == "DP301"]
    assert len(dp301) == 1
    assert "[fx.base.ref]" in dp301[0].message
    assert "mm" in dp301[0].message


def test_dp304_channels_last_flip(progs):
    findings = baseline.check_entrypoints(progs.regressed_entrypoints(),
                                          clean_baseline(progs))
    dp304 = [f for f in findings if f.rule_id == "DP304"]
    assert len(dp304) == 1
    assert "[fx.base.carry]" in dp304[0].message
    assert "channels_last" in dp304[0].message


def test_dp300_fires_once_per_drifted_program(progs):
    live = [progs.literal_entrypoint(), progs.carry_entrypoint()]
    findings = baseline.check_entrypoints(live, clean_baseline(progs))
    assert [f.rule_id for f in findings if f.rule_id == "DP300"] == ["DP300"]


def test_dp302_added_and_removed(progs):
    live = [progs.ref_entrypoint(),
            progs.carry_entrypoint(name="fx.base.carry2")]
    findings = baseline.check_entrypoints(live, clean_baseline(progs))
    assert rule_ids(findings) == ["DP302"]
    assert len(findings) == 2
    assert "fx.base.carry2" in " ".join(f.message for f in findings)


def test_dp303_budget_vs_variants_and_ladder(progs):
    eps = [progs.ref_entrypoint(name="fx.rows[w4]"),
           progs.ref_entrypoint(name="fx.rows[w8]")]
    data, errs = baseline.build_baseline(eps)
    assert not errs
    bad = baseline.check_entrypoints(eps, data, budgets={"fx.rows": 3})
    assert rule_ids(bad) == ["DP303"]
    assert "implies 2 bucket(s)" in bad[0].message
    assert not baseline.check_entrypoints(eps, data,
                                          budgets={"fx.rows": 2})
    assert not baseline.check_entrypoints(
        eps, data, budgets={"fx.rows": 3}, ladders={"fx.rows": 3})
    assert not baseline.check_entrypoints(
        eps, data, budgets={"fx.rows": None, "fx.orphan": 5})


def test_bucket_ladder_registry_round_trip():
    clear_entrypoints()
    try:
        register_bucket_ladder("fx.rows", (4, 8, 16))
        assert ep_mod.bucket_ladders() == {"fx.rows": 3}
    finally:
        clear_entrypoints()


def test_on_budget_hook_captures_declared_budget():
    from dorpatch_tpu_torch import observe

    clear_entrypoints()
    try:
        with ep_mod.capture_entrypoints():
            observe.timed_first_call(lambda x: x, "fx.budgeted",
                                     recompile_budget=7)
        assert ep_mod.declared_budgets() == {"fx.budgeted": 7}
    finally:
        clear_entrypoints()


# ---------- suppression ----------

def test_allowlist_overlay_suppresses(progs):
    findings = baseline.check_entrypoints(
        progs.regressed_entrypoints(), clean_baseline(progs),
        allow={"fx.base.*": {"DP301": "fixture", "DP304": "fixture"}})
    assert "DP301" not in rule_ids(findings)
    assert "DP304" not in rule_ids(findings)


def test_noqa_on_def_line_suppresses_dp300(tmp_path):
    mod = tmp_path / "noqa_base_tprog.py"
    mod.write_text(textwrap.dedent("""\
        import torch

        def prog(x):  # noqa: DP300 — fixture: drift here is deliberate
            return torch.tanh(x) * 3.0
    """), encoding="utf-8")
    sys.path.insert(0, str(tmp_path))
    try:
        import noqa_base_tprog

        ep = EntryPoint(name="fx.noqa", fn=noqa_base_tprog.prog,
                        args=(torch.zeros(4),))
        data, _ = baseline.build_baseline([ep])
        data["entries"]["fx.noqa"]["fingerprint"] = "0" * 16
        assert "DP300" not in rule_ids(baseline.check_entrypoints([ep], data))
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("noqa_base_tprog", None)


def test_select_filters_rules(progs):
    findings = baseline.check_entrypoints(
        progs.regressed_entrypoints(), clean_baseline(progs),
        select=["DP304"])
    assert rule_ids(findings) == ["DP304"]


# ---------- update determinism / refusals ----------

def _argv(path, loader, *extra):
    return (["--baseline", "update", "--baseline-file", str(path),
             "--entrypoints", f"base_progs:{loader}"] + list(extra))


def test_update_idempotent_byte_identical(progs, tmp_path):
    path = tmp_path / "baselines.json"
    assert cli_main(_argv(path, "clean_entrypoints")) == 0
    first = path.read_bytes()
    assert cli_main(_argv(path, "clean_entrypoints")) == 0
    assert path.read_bytes() == first
    data = json.loads(first)
    assert sorted(data["entries"]) == ["fx.base.carry", "fx.base.ref"]
    assert data["version"] == 1


def test_update_refuses_silent_entry_removal(progs, tmp_path, capsys):
    path = tmp_path / "baselines.json"
    assert cli_main(_argv(path, "clean_entrypoints")) == 0
    before = path.read_bytes()
    capsys.readouterr()
    assert cli_main(_argv(path, "shrunk_entrypoints")) == 1
    err = capsys.readouterr().err
    assert "fx.base.carry" in err and "--allow-remove" in err
    assert "NOT written" in err
    assert path.read_bytes() == before
    assert cli_main(_argv(path, "shrunk_entrypoints", "--allow-remove")) == 0
    assert sorted(json.loads(path.read_bytes())["entries"]) == [
        "fx.base.ref"]


def test_update_refuses_untraceable(progs, tmp_path):
    path = tmp_path / "baselines.json"
    assert cli_main(_argv(path, "bad_entrypoints")) == 1
    assert not path.exists(), "a holed baseline must never be written"


# ---------- CLI exit contract ----------

def test_cli_check_exit_codes(progs, tmp_path, capsys):
    path = tmp_path / "baselines.json"
    assert cli_main(_argv(path, "clean_entrypoints")) == 0
    capsys.readouterr()
    check = ["--baseline", "check", "--baseline-file", str(path),
             "--entrypoints"]
    assert cli_main(check + ["base_progs:clean_entrypoints"]) == 0
    capsys.readouterr()
    assert cli_main(check + ["base_progs:regressed_entrypoints",
                             "--format", "json"]) == 1
    objs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines() if line]
    assert {o["rule"] for o in objs} == {"DP300", "DP301", "DP304"}
    assert all("message" in o and "path" in o for o in objs)


def test_cli_check_select_and_usage_errors(progs, tmp_path, capsys):
    path = tmp_path / "baselines.json"
    assert cli_main(_argv(path, "clean_entrypoints")) == 0
    capsys.readouterr()
    assert cli_main(["--baseline", "check", "--baseline-file", str(path),
                     "--select", "DP304", "--entrypoints",
                     "base_progs:regressed_entrypoints"]) == 1
    out = capsys.readouterr().out
    assert "DP304" in out and "DP301" not in out
    assert cli_main(["--baseline", "check", "--select", "DP201"]) == 2
    assert cli_main(["--trace", "--select", "DP300"]) == 2
    assert cli_main(["--baseline", "check", "--baseline-file",
                     str(tmp_path / "nope.json"), "--entrypoints",
                     "base_progs:clean_entrypoints"]) == 2
    assert cli_main(["--baseline", "check",
                     "--entrypoints", "no.such.module:x"]) == 2


def test_cli_baseline_outranks_trace_flag(progs, tmp_path):
    path = tmp_path / "baselines.json"
    assert cli_main(["--trace"] + _argv(path, "clean_entrypoints")) == 0
    assert path.exists()


def test_cli_baseline_report_written(progs, tmp_path):
    path = tmp_path / "baselines.json"
    rd = tmp_path / "results"
    assert cli_main(_argv(path, "clean_entrypoints")) == 0
    assert cli_main(["--baseline", "check", "--baseline-file", str(path),
                     "--baseline-report", str(rd), "--entrypoints",
                     "base_progs:regressed_entrypoints"]) == 1
    summary = json.loads((rd / "baseline_check.json").read_text())
    assert summary["clean"] is False
    assert summary["findings_by_rule"] == {"DP300": 1, "DP301": 1,
                                           "DP304": 1}
    assert summary["fingerprint_set"]


def test_list_rules_includes_baseline_rows(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in ("DP300", "DP301", "DP302", "DP303", "DP304"):
        assert rid in out


# ---------- the shipped baseline ----------

def test_program_set_stamp_matches_shipped_baseline():
    stamp = baseline.program_set_stamp()
    assert stamp is not None, "analysis/baselines.json missing"
    data = baseline.load_baseline()
    assert stamp["entries"] == len(data["entries"])
    assert stamp["hash"] == baseline.fingerprint_set_hash(data["entries"])
    assert stamp["file"] == "analysis/baselines.json"
    # every kernel's op is in the baselined programs
    from dorpatch_tpu_torch.ops import _library

    seen = set()
    for e in data["entries"].values():
        seen |= set(e.get("kernels", {}))
    assert seen == set(_library.OP_NAMES)


def test_cli_baseline_check_production_subprocess(tmp_path):
    """The gate end to end: `--baseline check` traces the production
    registry in a fresh process and finds it equal to the shipped
    `baselines.json` (the set, the fingerprints, the interfaces, the costs
    and the budgets) — exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "dorpatch_tpu_torch.analysis", "--baseline",
         "check"],
        cwd=REPO, capture_output=True, text=True, timeout=400,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "2", "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "baseline check" in proc.stderr
