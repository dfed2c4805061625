"""The port's continuous re-certification (`dorpatch_tpu_torch.recert`):
the contracts of the JAX package's `tests/test_recert.py` with stub farm
runners, held against the JAX package on the same rows: byte-equal
`robustness_baseline.json` and `recert_state.json`, equal DP400-DP402
findings and verdicts, the same boot-gate outcomes and the same CLI exit
codes and `--format json` lines. Findings and verdicts name the package's
own command (`python -m dorpatch_tpu_torch.recert ...`) and the test's
own baseline path; those two strings are mapped to the JAX package's
before comparing, nothing else. One real drain runs the port's sweep on
the CPU."""

import json
import os
import sys

import pytest
import torch

from dorpatch_tpu.chaos import Chaos as JaxChaos
from dorpatch_tpu.farm.worker import FarmWorker as JaxFarmWorker
from dorpatch_tpu.recert import baseline as jrb
from dorpatch_tpu.recert.__main__ import main as jax_main
from dorpatch_tpu.recert.gate import RecertGateError as JaxGateError
from dorpatch_tpu.recert.gate import boot_gate as jax_boot_gate
from dorpatch_tpu.recert.scheduler import RecertScheduler as JaxScheduler
from dorpatch_tpu.sweep import append_row as jax_append_row
from dorpatch_tpu_torch.chaos import Chaos, SimulatedPreemption
from dorpatch_tpu_torch.farm.queue import JobQueue
from dorpatch_tpu_torch.farm.worker import FarmWorker
from dorpatch_tpu_torch.recert import baseline as rb
from dorpatch_tpu_torch.recert.__main__ import main as recert_main
from dorpatch_tpu_torch.recert.gate import (REQUIRE_MODES, RecertGateError,
                                            boot_gate, snapshot)
from dorpatch_tpu_torch.recert.scheduler import (RecertError,
                                                 RecertScheduler,
                                                 is_recert_dir)
from dorpatch_tpu_torch.sweep import append_row

SPEC = {
    "base": {"dataset": "cifar10", "base_arch": "resnet18", "img_size": 32,
             "batch_size": 2, "synthetic_data": True},
    "axes": {"attack.patch_budget": [0.06, 0.12]},
    "sweep": {"densities": [0.0], "structureds": [1e-3],
              "defense_ratio": 0.06},
    "max_attempts": 2,
}

JOB = {"base": SPEC["base"], "sweep": SPEC["sweep"],
       "params": {"attack.patch_budget": 0.06}}

PACKAGES = {
    "torch": dict(sched=RecertScheduler, worker=FarmWorker, row=append_row,
                  main=recert_main, gate=boot_gate,
                  gate_error=RecertGateError, chaos=Chaos, rb=rb),
    "jax": dict(sched=JaxScheduler, worker=JaxFarmWorker,
                row=jax_append_row, main=jax_main, gate=jax_boot_gate,
                gate_error=JaxGateError, chaos=JaxChaos, rb=jrb),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fixed_traces(monkeypatch):
    """Both packages' trace ids fixed: the inflight record carries one."""
    from dorpatch_tpu import observe as jax_observe
    from dorpatch_tpu_torch import observe

    monkeypatch.setattr(observe, "new_trace_id", lambda: "t" * 16)
    monkeypatch.setattr(jax_observe, "new_trace_id", lambda: "t" * 16)


def _same(text: str, *paths) -> str:
    """The JAX package's wording of a port string: its command's package
    name, and each of `paths` (the port's file, the JAX file) as one."""
    for port_path, jax_path in paths:
        text = text.replace(port_path, jax_path)
    return text.replace("dorpatch_tpu_torch.", "dorpatch_tpu.")


def stub_runner(pkg, ra=50.0, asr=25.0, bad_budget=None):
    """A farm runner writing one plausible sweep row per job through the
    package's own `append_row`; `bad_budget`'s job fails deterministically
    (quarantine)."""
    def runner(job, ctx):
        budget = job["params"]["attack.patch_budget"]
        if budget == bad_budget:
            raise ValueError("deterministic failure -> quarantine")
        PACKAGES[pkg]["row"](ctx.result_dir, {
            "patch_budget": budget, "density": 0.0, "structured": 1e-3,
            "robust_accuracy": ra, "certified_asr_pc": asr,
            "asr": 100.0 - ra, "point": 0, "images": 2})
        return {"rows": 1}
    return runner


def _drain(pkg, farm_dir, runner):
    kw = dict(worker_id="w", lease_ttl=10.0, poll_interval=0.02,
              heartbeat_interval=0.2, backoff_base=0.05, backoff_cap=0.2,
              runner=runner)
    if pkg == "torch":
        kw["device"] = "cpu"
    PACKAGES[pkg]["worker"](str(farm_dir), **kw).run()


def _sched(pkg, tmp_path, **kw):
    return PACKAGES[pkg]["sched"](str(tmp_path / pkg / "recert"),
                                  baseline_file=str(tmp_path / pkg / "rb.json"),
                                  clock=lambda: 1000.0, **kw)


def _cycle(pkg, sched, spec=SPEC, update=False, **runner_kw):
    gen, farm_dir = sched.begin_generation(spec)
    _drain(pkg, farm_dir, stub_runner(pkg, **runner_kw))
    return gen, sched.complete_generation(gen, farm_dir,
                                          update_baseline=update)


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _norm_verdict(v: dict, tmp_path) -> dict:
    return json.loads(_same(json.dumps(v, sort_keys=True),
                            (str(tmp_path / "torch"), str(tmp_path / "jax"))))


# ---------------- cell keys / measurements ----------------


@pytest.mark.parametrize("row", [
    {"patch_budget": 0.06, "density": 0.0, "structured": 1e-3},
    {"patch_budget": 0.1 + 0.2, "density": 1e-3, "structured": 0.5},
    {"patch_budget": 1, "density": True, "structured": "x"},
    {"patch_budget": 0.12},
])
def test_cell_key_equal_to_jax_and_json_roundtrip_stable(row):
    """A spec float and the same float read back from rows.jsonl give one
    key, and the port's key is the JAX package's."""
    recorded = json.loads(json.dumps(row))
    for job in (JOB, dict(JOB, params={"attack.patch_budget": 0.06,
                                       "attack.dropout": 1})):
        key = rb.cell_key(job, row)
        assert key == rb.cell_key(job, recorded)
        assert key == jrb.cell_key(job, row) == jrb.cell_key(job, recorded)
    assert rb.cell_key(JOB, row).startswith("resnet18@cifar10/32|pc:r0.06|")


def test_cell_key_carries_non_grid_axis_params():
    a = dict(JOB, params={"attack.patch_budget": 0.06, "attack.dropout": 1})
    b = dict(JOB, params={"attack.patch_budget": 0.06, "attack.dropout": 2})
    row = {"patch_budget": 0.06, "density": 0.0, "structured": 1e-3}
    assert rb.cell_key(a, row) != rb.cell_key(b, row)


def test_job_cells_equal_to_jax_without_rows():
    for job in (JOB, {**JOB, "sweep": {**SPEC["sweep"],
                                       "patch_budgets": [0.06, 0.12],
                                       "densities": [0.0, 0.5]}},
                {"base": SPEC["base"], "params": {}}):
        cells = rb.job_cells(job)
        assert cells == jrb.job_cells(job)
        assert len(set(cells)) == len(cells)


def test_row_measurement_equal_to_jax():
    for row in ({"robust_accuracy": 12.5, "certified_asr_pc": 3,
                 "images": 8}, {}, {"images": None}):
        assert rb.row_measurement(row, "j") == jrb.row_measurement(row, "j")


def test_fold_and_dump_deterministic_and_byte_equal_to_jax():
    measured = {"k1": {"robust_accuracy": 51.5, "certified_asr_pc": 20.0,
                       "images": 4, "job": "j"},
                "k0": {"robust_accuracy": 100.0 / 3, "certified_asr_pc": 0.0,
                       "images": 3, "job": "j"}}
    d1 = rb.fold_measurements(None, measured, 3)
    d2 = rb.fold_measurements(rb.empty_baseline(), dict(measured), 3)
    assert rb.dump_baseline(d1) == rb.dump_baseline(d2)
    assert rb.dump_baseline(d1) == jrb.dump_baseline(
        jrb.fold_measurements(None, measured, 3))
    assert d1["entries"]["k1"]["generation"] == 3 and d1["generation"] == 3
    d1["entries"]["k2"] = {"robust_accuracy": 70.0, "certified_asr_pc": 5.0,
                           "tolerance": 5.0}
    d3 = rb.fold_measurements(d1, measured, 4)
    assert d3["entries"]["k2"]["robust_accuracy"] == 70.0
    assert d3["entries"]["k1"]["generation"] == 4
    assert rb.dump_baseline(d3) == jrb.dump_baseline(
        jrb.fold_measurements(d1, measured, 4))


def test_shipped_baseline_is_the_jax_file_byte_for_byte():
    assert _read(rb.baseline_path()) == _read(jrb.baseline_path())
    data = rb.load_baseline()
    assert data["entries"] == {} and data["generation"] == 0
    assert rb.DEFAULT_TOLERANCE == 2.0
    assert rb.RECERT_RULE_IDS == ("DP400", "DP401", "DP402")
    assert [r[:2] for r in rb.RECERT_RULE_ROWS] == [
        r[:2] for r in jrb.RECERT_RULE_ROWS]


def _seeded(ra=50.0, asr=25.0, tol=None):
    entry = {"robust_accuracy": ra, "certified_asr_pc": asr, "images": 2,
             "generation": 1}
    if tol is not None:
        entry["tolerance"] = tol
    return {"version": 1, "generation": 1, "tolerance_default": 2.0,
            "entries": {"cellA": entry}}


def _m(ra=50.0, asr=25.0):
    return {"robust_accuracy": ra, "certified_asr_pc": asr, "images": 2,
            "job": "j"}


CHECK_CASES = {
    "unseeded": (dict(measured={"cellA": _m()}, holes=[], data=None), {}),
    "empty-entries": (dict(measured={"cellA": _m()}, holes=[],
                           data={"entries": {}}), {}),
    "clean": (dict(measured={"cellA": _m(49.0)}, holes=[], data=_seeded()),
              {}),
    "regression": (dict(measured={"cellA": _m(40.0)}, holes=[],
                        data=_seeded()), {}),
    "asr-rise": (dict(measured={"cellA": _m(50.0, 40.0)}, holes=[],
                      data=_seeded()), {}),
    "per-cell-tolerance": (dict(measured={"cellA": _m(46.0)}, holes=[],
                                data=_seeded(tol=5.0)), {}),
    "drift-and-holes": (dict(measured={"cellB": _m()},
                             holes=["cellA", "cellC"], data=_seeded()), {}),
    "removed": (dict(measured={}, holes=[], data=_seeded()), {}),
    "allowlisted": (dict(measured={"cellA": _m(40.0)}, holes=[],
                         data=_seeded()),
                    dict(allow={"cell*": {"DP400": "known"}})),
    "selected": (dict(measured={"cellA": _m(40.0), "cellB": _m()},
                      holes=[], data=_seeded()), dict(select=["DP401"])),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_and_verdict_equal_to_jax(case):
    """DP400-DP402 findings and the verdict built from them, on the same
    measurements, holes and baseline, equal the JAX package's."""
    args, kw = CHECK_CASES[case]
    call = dict(args, generation=3, baseline_file="rb.json")
    got = rb.check_measurements(**call, **kw)
    want = jrb.check_measurements(**call, **kw)
    assert [_same(f.render()) for f in got] == [f.render() for f in want]
    verdict = rb.build_verdict(args["measured"], args["holes"],
                               args["data"], 3, got, baseline_file="rb.json")
    jverdict = jrb.build_verdict(args["measured"], args["holes"],
                                 args["data"], 3, want,
                                 baseline_file="rb.json")
    assert json.loads(_same(json.dumps(verdict))) == jverdict
    expect = {"unseeded": "failing", "empty-entries": "failing", "clean": "ok",
              "regression": "failing", "asr-rise": "failing",
              "per-cell-tolerance": "ok", "drift-and-holes": "failing",
              "removed": "failing", "allowlisted": "ok",
              "selected": "failing"}[case]
    assert verdict["status"] == expect


def test_build_verdict_margin_and_cell_statuses():
    f = rb.check_measurements({"cellA": _m(40.0), "cellB": _m()},
                              ["cellC"], _seeded(), 2)
    v = rb.build_verdict({"cellA": _m(40.0), "cellB": _m()}, ["cellC"],
                         _seeded(), 2, f)
    assert v["cells"]["cellA"]["status"] == "regressed"
    assert v["cells"]["cellA"]["margin"] == pytest.approx(-8.0)
    assert v["cells"]["cellB"]["status"] == "added"
    assert v["cells"]["cellC"]["status"] == "stale"
    assert v["worst_margin"] == pytest.approx(-8.0)
    assert v["findings_by_rule"] == {"DP400": 1, "DP401": 2}


# ---------------- scheduler generations, against the JAX package ----------


def test_scheduler_files_byte_equal_to_jax(tmp_path, fixed_traces):
    """Generation 1 seeds the baseline, generation 2 measures a regression:
    on the same rows both packages write byte-equal baseline and state
    files, and equal verdicts."""
    verdicts = {}
    for pkg in PACKAGES:
        sched = _sched(pkg, tmp_path)
        gen, farm_dir = sched.begin_generation(SPEC)
        inflight = _read(sched.state_path)
        _drain(pkg, farm_dir, stub_runner(pkg))
        v1 = sched.complete_generation(gen, farm_dir, update_baseline=True)
        base1 = _read(sched.baseline_file)
        state1 = _read(sched.state_path)
        gen2, v2 = _cycle(pkg, sched, ra=40.0)
        verdicts[pkg] = (gen, gen2, inflight, v1, base1, state1, v2,
                         _read(sched.state_path), sched.status())
    t, j = verdicts["torch"], verdicts["jax"]
    assert (t[0], t[1]) == (j[0], j[1]) == (1, 2)
    assert t[2] == j[2]          # the inflight record, spec and trace
    assert t[4] == j[4]          # robustness_baseline.json
    assert t[5] == j[5] and t[7] == j[7]   # recert_state.json
    for a, b in ((t[3], j[3]), (t[6], j[6])):
        assert _norm_verdict(a, tmp_path) == b
    assert t[3]["status"] == "ok" and t[6]["status"] == "failing"
    assert t[6]["findings_by_rule"] == {"DP400": 2}
    assert json.loads(_same(json.dumps(t[8], sort_keys=True),
                            (str(tmp_path / "torch"), str(tmp_path / "jax")))
                      ) == j[8]


def test_scheduler_full_cycle_seeds_then_stays_ok(tmp_path):
    sched = _sched("torch", tmp_path)
    gen, verdict = _cycle("torch", sched, update=True)
    assert gen == 1 and verdict["status"] == "ok"
    assert len(verdict["cells"]) == 2
    assert is_recert_dir(sched.recert_dir)
    gen, verdict = _cycle("torch", sched)
    assert gen == 2 and verdict["status"] == "ok" and verdict["clean"]
    assert verdict["worst_margin"] == pytest.approx(2.0)
    metrics = json.loads(_read(os.path.join(sched.recert_dir,
                                            "metrics.json")))
    assert "recert_generations_total" in metrics["metrics"]
    events = [json.loads(line) for line in open(os.path.join(
        sched.recert_dir, "events.jsonl"))]
    names = [e["name"] for e in events]
    assert names.count("recert.generation.begin") == 2
    assert names.count("recert.generation") == 2
    assert [e["seq"] for e in events] == list(range(len(events)))


def test_scheduler_resumes_inflight_generation_not_resubmit(tmp_path):
    sched = _sched("torch", tmp_path)
    gen, farm_dir = sched.begin_generation(SPEC)
    sched2 = _sched("torch", tmp_path)
    gen2, farm_dir2 = sched2.begin_generation()
    assert (gen2, farm_dir2) == (gen, farm_dir)
    assert JobQueue(farm_dir2).counts()["total"] == 2
    _drain("torch", farm_dir2, stub_runner("torch"))
    verdict = sched2.complete_generation(gen2, farm_dir2,
                                         update_baseline=True)
    assert verdict["generation"] == gen
    with pytest.raises(RecertError):
        sched2.begin_generation()


def test_kill_after_submit_and_torn_state_resume_the_same_generation(
        tmp_path, fixed_traces):
    """`recert_kill_cycle` (crash_mode "raise") and `recert_torn_state`
    after the submit: the state file is torn, a new scheduler recovers it
    from the generation dirs and finishes generation 1, in both packages;
    the port's baseline and state files equal the JAX package's."""
    for pkg, p in PACKAGES.items():
        root = tmp_path / pkg / "recert"
        chaos = p["chaos"](("recert_kill_cycle", "recert_torn_state"),
                           job_id="recert", state_dir=str(root),
                           crash_mode="raise")
        sched = _sched(pkg, tmp_path, chaos=chaos)
        with pytest.raises(Exception,
                           match="simulated scheduler preemption"):
            sched.begin_generation(SPEC)
        with pytest.raises(ValueError):
            json.loads(_read(sched.state_path))
        resumed = _sched(pkg, tmp_path)
        st = resumed.load_state()
        assert st["generation"] == 0 and st["inflight"]["generation"] == 1
        gen, farm_dir = resumed.begin_generation()
        assert gen == 1 and os.path.basename(farm_dir) == "gen_0001"
        _drain(pkg, farm_dir, stub_runner(pkg))
        resumed.complete_generation(gen, farm_dir, update_baseline=True)
        assert sorted(n for n in os.listdir(root)
                      if n.startswith("gen_")) == ["gen_0001"]
    for name in ("rb.json", "recert/recert_state.json"):
        assert _read(tmp_path / "torch" / name) == _read(
            tmp_path / "jax" / name)


def test_port_chaos_raise_is_simulated_preemption(tmp_path):
    chaos = Chaos(("recert_kill_cycle",), job_id="recert",
                  state_dir=str(tmp_path), crash_mode="raise")
    chaos.on_recert("begun")             # only "submitted" is a site
    with pytest.raises(SimulatedPreemption):
        chaos.on_recert("submitted")
    chaos.on_recert("submitted")         # fires once
    assert (tmp_path / "chaos_recert_kill_cycle.fired").exists()


def test_scheduler_recovers_from_torn_state_file(tmp_path):
    sched = _sched("torch", tmp_path)
    _cycle("torch", sched, update=True)
    gen, farm_dir = sched.begin_generation(SPEC)
    raw = _read(sched.state_path)
    with open(sched.state_path, "wb") as fh:
        fh.write(raw[:len(raw) // 2])
    sched3 = _sched("torch", tmp_path)
    st = sched3.load_state()
    assert st["generation"] == 1
    assert st["inflight"]["generation"] == gen
    assert sched3.begin_generation() == (gen, farm_dir)


def test_quarantined_job_becomes_hole_generation_completes(tmp_path):
    sched = _sched("torch", tmp_path)
    _cycle("torch", sched, update=True)
    gen, farm_dir = sched.begin_generation(SPEC)
    _drain("torch", farm_dir, stub_runner("torch", bad_budget=0.12))
    assert sched.drained(farm_dir)
    verdict = sched.complete_generation(gen, farm_dir)
    assert verdict["status"] == "stale"
    assert verdict["findings_by_rule"] == {"DP402": 1}
    stale = [k for k, c in verdict["cells"].items()
             if c["status"] == "stale"]
    assert len(stale) == 1 and "patch_budget=0.12" in stale[0]
    # a hole is a missing measurement, not a grid change: update keeps it
    summary = sched.update_from_latest()
    assert summary["removed"] == [] and summary["holes"] == stale
    assert len(rb.load_baseline(sched.baseline_file)["entries"]) == 2


def test_update_from_latest_refuses_shrink_without_allow_remove(tmp_path):
    sched = _sched("torch", tmp_path)
    _cycle("torch", sched, update=True)
    _cycle("torch", sched, spec=dict(SPEC, axes={
        "attack.patch_budget": [0.06]}))
    before = _read(sched.baseline_file)
    with pytest.raises(RecertError, match="--allow-remove"):
        sched.update_from_latest()
    assert _read(sched.baseline_file) == before
    summary = sched.update_from_latest(allow_remove=True)
    assert len(summary["removed"]) == 1
    assert len(rb.load_baseline(sched.baseline_file)["entries"]) == 1


# ---------------- the boot gate ----------------


def _publish(recert_dir, status):
    os.makedirs(recert_dir, exist_ok=True)
    if status == "absent":
        return
    with open(os.path.join(recert_dir, "recert_verdict.json"), "w") as fh:
        json.dump({"status": status, "generation": 4, "worst_margin": -1.5,
                   "findings_by_rule": {"DP400": 1} if status == "failing"
                   else {}, "cells": {
                       "c1": {"status": "regressed" if status == "failing"
                              else "ok"},
                       "c2": {"status": "ok"}}}, fh)


@pytest.mark.parametrize("status", ["ok", "failing", "stale", "absent"])
def test_boot_gate_outcomes_equal_to_jax(tmp_path, status):
    """off, warn and strict on the same published verdict: the same
    snapshot, or the same typed refusal with the same message."""
    rdir = str(tmp_path / "recert")
    _publish(rdir, status)
    for mode in REQUIRE_MODES:
        outcomes = []
        for pkg in ("torch", "jax"):
            p = PACKAGES[pkg]
            try:
                outcomes.append(("ok", p["gate"](rdir, mode)))
            except p["gate_error"] as e:
                outcomes.append(("refused", str(e)))
        assert outcomes[0] == outcomes[1], (mode, outcomes)
        refused = outcomes[0][0] == "refused"
        assert refused == (mode == "strict" and status != "ok")
    for pkg in PACKAGES:
        p = PACKAGES[pkg]
        assert p["gate"]("", "off") is None
        with pytest.raises(p["gate_error"], match="needs a recert dir"):
            p["gate"]("", "warn")
        with pytest.raises(ValueError):
            p["gate"](rdir, "loud")


def test_snapshot_carries_the_verdict_cells(tmp_path):
    rdir = str(tmp_path / "recert")
    _publish(rdir, "failing")
    snap = snapshot(rdir, "warn")
    assert snap["status"] == "failing" and snap["generation"] == 4
    assert snap["cells"]["c1"]["status"] == "regressed"
    assert snapshot(str(tmp_path / "none"), "off")["status"] == "absent"


# ---------------- the CLI, against the JAX package ----------------


def _cli(pkg, capsys, *argv):
    """(exit code, stdout, stderr) of the package's recert CLI; the
    console's `[p0 +1.2s] ` prefixes (elapsed seconds) are cut."""
    import re

    capsys.readouterr()
    rc = PACKAGES[pkg]["main"](list(argv))
    out = capsys.readouterr()
    strip = re.compile(r"^\[p\d+ \+[0-9.]+s\] ", re.M)
    return rc, strip.sub("", out.out), strip.sub("", out.err)


def test_cli_exit_codes_and_json_lines_equal_to_jax(tmp_path, capsys,
                                                    fixed_traces):
    """check, update, status and schedule on the same completed
    generations: the same exit codes, the same `--format json` finding
    lines, the same status record."""
    runs = {}
    for pkg in PACKAGES:
        sched = _sched(pkg, tmp_path)
        _cycle(pkg, sched, update=True)
        _cycle(pkg, sched, ra=40.0)
        rdir, rbf = sched.recert_dir, sched.baseline_file
        spec = str(tmp_path / pkg / "spec.json")
        with open(spec, "w") as fh:
            json.dump(SPEC, fh)
        steps = [
            _cli(pkg, capsys, "check", rdir, "--baseline-file", rbf,
                 "--format", "json"),
            _cli(pkg, capsys, "check", rdir, "--baseline-file", rbf),
            _cli(pkg, capsys, "check", rdir, "--baseline-file", rbf,
                 "--select", "DP401", "--format", "json"),
            _cli(pkg, capsys, "check", rdir, "--baseline-file", rbf,
                 "--select", "DP999"),
            _cli(pkg, capsys, "update", rdir, "--baseline-file", rbf),
            _cli(pkg, capsys, "check", rdir, "--baseline-file", rbf,
                 "--format", "json"),
            _cli(pkg, capsys, "check", str(tmp_path / pkg / "empty"),
                 "--baseline-file", rbf),
            _cli(pkg, capsys, "schedule", rdir, "--baseline-file", rbf,
                 "--spec", spec),
            _cli(pkg, capsys, "--list-rules"),
        ]
        runs[pkg] = steps
    paths = (str(tmp_path / "torch"), str(tmp_path / "jax"))
    for (t_rc, t_out, _), (j_rc, j_out, _) in zip(runs["torch"],
                                                  runs["jax"]):
        assert t_rc == j_rc
        assert _same(t_out, paths) == j_out
    rcs = [step[0] for step in runs["torch"]]
    assert rcs == [1, 1, 0, 2, 0, 0, 2, 0, 0]
    lines = [json.loads(line) for line in
             runs["torch"][0][1].splitlines()]
    assert {d["rule"] for d in lines} == {"DP400"} and len(lines) == 2
    assert "DP400" in runs["torch"][8][1]


def test_cli_status_and_update_refusal(tmp_path, capsys):
    sched = _sched("torch", tmp_path)
    _cycle("torch", sched, update=True)
    _cycle("torch", sched, spec=dict(SPEC, axes={
        "attack.patch_budget": [0.06]}))
    rc, out, err = _cli("torch", capsys, "update", sched.recert_dir,
                        "--baseline-file", sched.baseline_file)
    assert rc == 1 and "--allow-remove" in err
    rc, out, _ = _cli("torch", capsys, "status", sched.recert_dir,
                      "--baseline-file", sched.baseline_file)
    status = json.loads(out)
    assert rc == 0 and status["generation"] == 2
    assert status["verdict"]["status"] == "failing"


# ---------------- one real drain on the CPU ----------------


def test_recert_run_real_drain_on_cpu(tmp_path, capsys, monkeypatch):
    """`recert run --update-baseline --device cpu`: the in-process farm
    worker runs the port's real sweep (a shallow CIFAR ResNet-18 at 16
    px, batch 2, 2 iterations), the generation seeds the baseline, and a
    second run of the same spec is clean against it."""
    from dorpatch_tpu_torch.models import registry
    from dorpatch_tpu_torch.models.small import CifarResNet18

    _, init = registry._FAMILIES["cifar_resnet18"]
    monkeypatch.setitem(
        registry._FAMILIES, "cifar_resnet18",
        (lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
         init))
    spec = {"base": {"dataset": "cifar10", "base_arch": "resnet18",
                     "img_size": 16, "batch_size": 2, "synthetic_data": True,
                     "model_dir": "/nonexistent",
                     "attack": {"sampling_size": 4, "max_iterations": 2,
                                "sweep_interval": 2, "switch_iteration": 2,
                                "dropout": 1, "dropout_sizes": [0.06],
                                "basic_unit": 4}},
            "axes": {"attack.patch_budget": [0.06, 0.12]},
            "sweep": {"defense_ratio": 0.06}, "max_attempts": 1}
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    rdir, rbf = str(tmp_path / "recert"), str(tmp_path / "rb.json")
    argv = ["run", rdir, "--spec", spec_path, "--baseline-file", rbf,
            "--update-baseline", "--device", "cpu", "--poll-interval",
            "0.05", "--lease-ttl", "30"]
    rc, out, err = _cli("torch", capsys, *argv)
    assert rc == 0, out + err
    data = rb.load_baseline(rbf)
    assert len(data["entries"]) == 2 and data["generation"] == 1
    for entry in data["entries"].values():
        assert 0.0 <= entry["robust_accuracy"] <= 100.0
        assert entry["images"] >= 1
    rc, out, err = _cli("torch", capsys, *argv[:-6], "--device", "cpu")
    assert rc == 0, out + err
    st = RecertScheduler(rdir, baseline_file=rbf).status()
    assert st["generation"] == 2 and st["verdict"]["status"] == "ok"
