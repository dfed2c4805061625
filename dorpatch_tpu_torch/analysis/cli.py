"""Analysis CLI: `python -m dorpatch_tpu_torch.analysis [paths...]`.

Port of `dorpatch_tpu.analysis.cli`: five modes behind one exit contract
(0 = clean, 1 = findings, 2 = usage error):

- **Lint** (default): the AST rules (DP101-DP108 plus the concurrency wing
  DP500-DP504) over the port's package — pure ast/tokenize logic, no
  torch import.
- **Concurrency** (`--concurrency`): ONLY the lock-discipline rules
  (DP500-DP504) over the threaded packages.
- **Trace** (`--trace`): the program auditor (DP200-DP208) over every
  production entry point, traced on fake tensors on the CPU (no device).
- **Baseline** (`--baseline check|update`): the program-baseline tier
  (DP300-DP304) — fingerprints and static cost vectors of every entry
  point, diffed against the checked-in `analysis/baselines.json`
  (`check`, the gate) or regenerated deterministically (`update`).
  `--baseline-cost estimate` is the only cost source: XLA's compiled
  `cost_analysis` (`compiled`) has no eager counterpart and is refused.
- **Fix** (`--fix [--diff]`): the mechanical DP106 rewriter (`fix.py`).

`--comms` (the JAX package's sharding & collectives auditor, DP600-DP603)
is refused by name: it comes with the mesh entry points.

Output: one `path:line:col: DPxxx message` line per finding on stdout
(`--format json` one JSON object per line; `--format sarif` one SARIF
2.1.0 document over the whole set); the human summary goes to stderr so
the finding stream stays machine-parseable.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
from typing import List, Optional

from dorpatch_tpu_torch.analysis.engine import (Finding, all_rules,
                                                analyze_paths)

DEFAULT_PATHS = ["dorpatch_tpu_torch"]


def default_paths() -> List[str]:
    """The no-args targets: the package, cwd-relative when run from a
    checkout, else the installed package location."""
    root = pathlib.Path(__file__).resolve().parents[2]
    out = []
    for name in DEFAULT_PATHS:
        if pathlib.Path(name).exists():
            out.append(name)
        elif (root / name).exists():
            out.append(str(root / name))
    return out or [str(pathlib.Path(__file__).resolve().parents[1])]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dorpatch_tpu_torch.analysis",
        description="Static analysis for the port's tree: AST rules "
                    "DP101-DP108 + concurrency rules DP500-DP504 "
                    "(default), the concurrency wing alone "
                    "(--concurrency), the program auditor DP200-DP208 "
                    "(--trace), and the program-baseline drift gate "
                    "DP300-DP304 (--baseline); see --list-rules")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/directories to lint (default: "
                        f"{' '.join(DEFAULT_PATHS)}; ignored under --trace)")
    p.add_argument("--select", default="",
                   help="comma-separated rule IDs to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("--fixable", action="store_true",
                   help="list only mechanically fixable offenses")
    p.add_argument("--format", choices=("human", "json", "sarif"),
                   default="human",
                   help="finding output format: human `path:line:col:` "
                        "lines (default), one JSON object per line, or "
                        "one SARIF 2.1.0 document over the whole set")
    p.add_argument("--concurrency", action="store_true",
                   help="run only the lock-discipline rules (DP500-DP504) "
                        "over the target paths")
    p.add_argument("--trace", action="store_true",
                   help="audit the production entry points' traced "
                        "programs (DP2xx) instead of linting source")
    p.add_argument("--comms", action="store_true",
                   help="the sharding/collectives auditor (DP600-DP603): "
                        "not ported yet, refused")
    p.add_argument("--entrypoints", default="",
                   help="--trace/--baseline source override, "
                        "`module:callable` returning a list of EntryPoints "
                        "(default: the production registry)")
    p.add_argument("--baseline", nargs="?", const="check", default=None,
                   choices=("check", "update"), metavar="{check,update}",
                   help="program-baseline mode (DP300-DP304): `check` "
                        "diffs the live fingerprints/costs against the "
                        "checked-in baseline, `update` regenerates it "
                        "deterministically (default mode: check)")
    p.add_argument("--baseline-file", default="",
                   help="baseline file override (default: the package's "
                        "analysis/baselines.json)")
    p.add_argument("--baseline-cost", choices=("compiled", "estimate"),
                   default="estimate",
                   help="cost source for --baseline: `estimate` (the "
                        "graph-walk estimates, the only one); `compiled` "
                        "(XLA's cost_analysis) has no eager counterpart "
                        "and is refused")
    p.add_argument("--baseline-report", default="",
                   help="with --baseline check: also write the machine-"
                        "readable result as baseline_check.json into this "
                        "directory")
    p.add_argument("--allow-remove", action="store_true",
                   help="with --baseline update: accept dropping entries "
                        "that exist in the checked-in file but not in the "
                        "regenerated set (without it, update REFUSES)")
    p.add_argument("--fix", action="store_true",
                   help="apply the DP106 unused-import fixer to the "
                        "target paths (idempotent)")
    p.add_argument("--diff", action="store_true",
                   help="with --fix: print the unified diff, write nothing")
    return p


def _trace_rule_table() -> List[tuple]:
    """(id, fixable, name, description) for the trace rules, the ones with
    no torch reading included (marked so)."""
    from dorpatch_tpu_torch.analysis.program import (DP200_ROW,
                                                     NOT_APPLICABLE_ROWS,
                                                     all_trace_rules)

    rows = [(r.id, False, r.name, r.description) for r in all_trace_rules()]
    rows.append((DP200_ROW[0], False, DP200_ROW[1], DP200_ROW[2]))
    rows += [(rid, False, name, desc)
             for rid, name, desc in NOT_APPLICABLE_ROWS]
    return rows


def _baseline_rule_table() -> List[tuple]:
    from dorpatch_tpu_torch.analysis.baseline import BASELINE_RULE_ROWS

    return [(rid, False, name, desc) for rid, name, desc in BASELINE_RULE_ROWS]


#: The comms wing's rules: not ported, listed so no ID vanishes silently.
COMMS_RULE_ROWS = tuple(
    (rid, False, name, "not ported yet: the sharding & collectives auditor "
     "comes with the mesh entry points (--comms is refused)")
    for rid, name in (("DP600", "unpriced-collective"),
                      ("DP601", "accidental-replication"),
                      ("DP602", "boundary-reshard"),
                      ("DP603", "shard-unsafe-kernel")))


def _rule_rows() -> List[tuple]:
    rows = [(r.id, r.fixable, r.name, r.description) for r in all_rules()]
    return (rows + _trace_rule_table() + _baseline_rule_table()
            + list(COMMS_RULE_ROWS))


def list_rules(out=None) -> None:
    out = out if out is not None else sys.stdout
    for rid, fixable, name, description in sorted(_rule_rows()):
        fix = "fixable" if fixable else "       "
        out.write(f"{rid}  {fix}  {name}: {description}\n")


def sarif_report(findings: List[Finding]) -> str:
    """One SARIF 2.1.0 document over a finding set, with the rule metadata
    (name/description) of whichever wings the findings reference."""
    meta = {}
    for rid, _fx, name, desc in _rule_rows():
        meta.setdefault(rid, (name, desc))
    used = sorted({f.rule_id for f in findings})
    index = {rid: i for i, rid in enumerate(used)}
    rules = [{"id": rid,
              "name": meta.get(rid, (rid, ""))[0] or rid,
              "shortDescription": {
                  "text": meta.get(rid, ("", rid))[1] or rid}}
             for rid in used]
    results = [{
        "ruleId": f.rule_id,
        "ruleIndex": index[f.rule_id],
        "level": "error",
        "message": {"text": f.message},
        "locations": [{"physicalLocation": {
            "artifactLocation": {"uri": f.path},
            "region": {"startLine": max(f.line, 1),
                       "startColumn": max(f.col, 1)}}}],
    } for f in findings]
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "dorpatch-analysis",
                                "rules": rules}},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def emit(findings: List[Finding], fmt: str, out=None) -> None:
    """Write `findings` in `fmt`: "human", "json" (one object a line) or
    "sarif" (one document)."""
    out = out if out is not None else sys.stdout
    if fmt not in ("human", "json", "sarif"):
        raise ValueError(f"finding format must be human|json|sarif, got "
                         f"{fmt!r}")
    if fmt == "sarif":
        out.write(sarif_report(findings))
        return
    for f in findings:
        if fmt == "json":
            out.write(json.dumps(
                {"rule": f.rule_id, "path": f.path, "line": f.line,
                 "col": f.col, "message": f.message,
                 "fixable": f.fixable}) + "\n")
        else:
            out.write(f.render() + "\n")


def _parse_select(raw: str, mode: str) -> Optional[List[str]]:
    """Validate --select against the rules of the mode actually running: a
    cross-wing ID would run ZERO rules and pass vacuously — a usage error
    instead."""
    if not raw:
        return None
    select = [s.strip().upper() for s in raw.split(",") if s.strip()]
    from dorpatch_tpu_torch.analysis.baseline import BASELINE_RULE_IDS
    from dorpatch_tpu_torch.analysis.concurrency import CONCURRENCY_RULE_IDS
    from dorpatch_tpu_torch.analysis.program import TRACE_RULE_IDS

    wings = {
        "lint": {r.id for r in all_rules()} | {"DP000"},
        "concurrency": set(CONCURRENCY_RULE_IDS) | {"DP000"},
        "trace": set(TRACE_RULE_IDS),
        "baseline": set(BASELINE_RULE_IDS),
    }
    bad = set(select) - wings[mode]
    if bad:
        hints = [(f"{sorted(bad & ids)}: drop --{mode}" if m == "lint"
                  else f"{sorted(bad & ids)}: add --{m}")
                 for m, ids in wings.items()
                 if m != mode and bad & ids]
        hint = f" ({'; '.join(hints)})" if hints else ""
        sys.stderr.write(
            f"rule id(s) not runnable in this mode: {sorted(bad)}{hint}\n")
        return ["<usage-error>"]
    return select


def _run_fix(paths: List[str], diff_only: bool) -> int:
    from dorpatch_tpu_torch.analysis.fix import fix_paths

    files, removed, diffs = fix_paths(paths, write=not diff_only)
    if diff_only:
        for d in diffs:
            sys.stdout.write(d)
    verb = "would remove" if diff_only else "removed"
    sys.stderr.write(
        f"--fix: {verb} {removed} unused import(s) across {files} "
        "file(s)\n" if removed else "--fix: nothing to fix\n")
    return 0


def _load_entrypoints(spec: str):
    """The audit work list: the `--entrypoints module:callable` override,
    or the production registry. Returns (eps, budgets, ladders,
    uncovered), or None on a bad spec (usage error; message on stderr)."""
    from dorpatch_tpu_torch.analysis import entrypoints as ep_mod

    if spec:
        mod_name, _, attr = spec.partition(":")
        try:
            loader = getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError) as e:
            sys.stderr.write(f"cannot load --entrypoints {spec!r}: {e}\n")
            return None
        ep_mod.clear_entrypoints()  # stale ledgers must not leak into DP303
        eps = list(loader())
        uncovered: List[str] = []
    else:
        eps = ep_mod.production_entrypoints()
        uncovered = ep_mod.uncovered_names()
    return eps, ep_mod.declared_budgets(), ep_mod.bucket_ladders(), uncovered


def _run_trace(select: Optional[List[str]], spec: str, fmt: str) -> int:
    from dorpatch_tpu_torch.analysis import program

    loaded = _load_entrypoints(spec)
    if loaded is None:
        return 2
    eps, _, _, uncovered = loaded
    findings = program.audit_entrypoints(eps, select=select,
                                         uncovered=uncovered)
    emit(findings, fmt)
    if findings:
        sys.stderr.write(
            f"{len(findings)} trace finding(s) across {len(eps)} entry "
            "point(s). Suppress a deliberate one with `# noqa: DP2xx` on "
            "the program's def line, or a reasoned "
            "analysis.program.ALLOWLIST entry when no source line can "
            "own it.\n")
        return 1
    sys.stderr.write(f"trace audit: {len(eps)} entry point(s) clean\n")
    return 0


def _run_baseline(mode: str, select: Optional[List[str]], spec: str,
                  fmt: str, file_override: str, report_dir: str,
                  allow_remove: bool = False) -> int:
    from dorpatch_tpu_torch.analysis import baseline

    loaded = _load_entrypoints(spec)
    if loaded is None:
        return 2
    eps, budgets, ladders, _ = loaded
    path = (pathlib.Path(file_override) if file_override
            else baseline.baseline_path())

    if mode == "update":
        old = baseline.load_baseline(path)
        data, findings = baseline.build_baseline(eps)
        if findings:
            # a baseline with holes would make every later check vacuous
            emit(findings, fmt)
            sys.stderr.write(
                f"--baseline update: {len(findings)} entry point(s) failed "
                "to trace; baseline NOT written\n")
            return 1
        removed = sorted(set((old or {}).get("entries", {}))
                         - set(data.get("entries", {})))
        if removed and not allow_remove:
            sys.stderr.write(
                f"--baseline update: would drop {len(removed)} baselined "
                f"entry point(s): {', '.join(removed[:5])}"
                + (" ..." if len(removed) > 5 else "") + "\n"
                "Pass --allow-remove if the removal is intentional; "
                "baseline NOT written\n")
            return 1
        text = baseline.dump_baseline(data)
        try:
            unchanged = path.read_text(encoding="utf-8") == text
        except OSError:
            unchanged = False
        path.write_text(text, encoding="utf-8")
        verb = "unchanged" if unchanged else "wrote"
        sys.stderr.write(
            f"--baseline update: {verb} {len(data['entries'])} entry "
            f"point(s) -> {path}\n")
        return 0

    data = baseline.load_baseline(path)
    if data is None:
        sys.stderr.write(f"no readable baseline at {path}; run --baseline "
                         "update first\n")
        return 2
    findings = baseline.check_entrypoints(
        eps, data, budgets=budgets, ladders=ladders, select=select)
    emit(findings, fmt)
    if report_dir:
        summary = baseline.check_summary(findings, len(eps), data, path)
        rd = pathlib.Path(report_dir)
        rd.mkdir(parents=True, exist_ok=True)
        (rd / "baseline_check.json").write_text(
            json.dumps(summary, indent=2, sort_keys=True) + "\n",
            encoding="utf-8")
    if findings:
        sys.stderr.write(
            f"{len(findings)} baseline finding(s) across {len(eps)} entry "
            "point(s). An intentional program/cost change must land its "
            "`--baseline update` in the same change; suppress a deliberate "
            "residual with `# noqa: DP3xx` on the program's def line or a "
            "reasoned analysis.baseline.ALLOWLIST entry.\n")
        return 1
    sys.stderr.write(
        f"baseline check: {len(eps)} entry point(s) match "
        f"{path.name} ({len(data.get('entries', {}))} baselined)\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        list_rules()
        return 0
    if args.comms:
        sys.stderr.write(
            "--comms: the sharding & collectives auditor (DP600-DP603) is "
            "not ported yet — it comes with the mesh entry points "
            "(parallel/ over torch.distributed)\n")
        return 2
    if args.baseline_cost == "compiled":
        sys.stderr.write(
            "--baseline-cost compiled: XLA's compiled cost_analysis has no "
            "eager torch counterpart; the port's baseline gates the "
            "graph-walk estimates (--baseline-cost estimate)\n")
        return 2
    mode = ("baseline" if args.baseline
            else "trace" if args.trace
            else "concurrency" if args.concurrency else "lint")
    select = _parse_select(args.select, mode)
    if select == ["<usage-error>"]:
        return 2
    if args.diff and not args.fix:
        sys.stderr.write("--diff requires --fix\n")
        return 2
    if args.fix and (args.trace or args.baseline or args.concurrency):
        sys.stderr.write("--fix and --trace/--baseline/--concurrency are "
                         "separate modes; run them as two invocations\n")
        return 2
    if args.concurrency and (args.trace or args.baseline):
        sys.stderr.write("--concurrency is a lint-side mode; run it "
                         "separately from --trace/--baseline\n")
        return 2
    paths = args.paths or default_paths()
    if args.fix:
        return _run_fix(paths, args.diff)
    if args.baseline:
        return _run_baseline(args.baseline, select, args.entrypoints,
                             args.format, args.baseline_file,
                             args.baseline_report, args.allow_remove)
    if args.trace:
        return _run_trace(select, args.entrypoints, args.format)
    if args.concurrency and select is None:
        from dorpatch_tpu_torch.analysis.concurrency import \
            CONCURRENCY_RULE_IDS
        select = list(CONCURRENCY_RULE_IDS)
    try:
        findings = analyze_paths(paths, select=select)
    except (OSError, UnicodeDecodeError) as e:
        sys.stderr.write(
            f"cannot lint {getattr(e, 'filename', None) or paths}: {e}\n")
        return 2
    if args.fixable:
        findings = [f for f in findings if f.fixable]
    emit(findings, args.format)
    n_fix = sum(1 for f in findings if f.fixable)
    if findings:
        sys.stderr.write(
            f"{len(findings)} finding(s), {n_fix} fixable. Suppress a "
            "deliberate one with `# noqa: DPxxx <reason>`; run --fix for "
            "the fixable ones.\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
