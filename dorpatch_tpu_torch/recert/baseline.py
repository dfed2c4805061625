"""Adversarial regression baseline: robust-accuracy drift gate (DP4xx).

The analysis tier's `baselines.json` pins what the *programs* compute; this
module pins what the *attack* achieves against them. A recert generation
(one (model x defense x attack) grid run through the farm) produces one
robust-accuracy measurement per grid cell; the checked-in
`robustness_baseline.json` records the accepted reference value per cell
with a per-cell ABSOLUTE tolerance (percentage points of robust accuracy —
adversarial numbers are noisy in absolute terms, not relative ones).

Rules (emitted through `analysis.engine.Finding`, so `--format json`,
allowlists, and the 0/1/2 exit-code contract carry over):

- **DP400 robust-accuracy-regression** — a cell's fresh measurement fell
  below its baseline robust accuracy by more than the cell's tolerance
  (or its certified attack-success rate rose past it): the defense got
  weaker against the standing red team. The paper's whole point is that
  this happens silently; this gate makes it a CI failure.
- **DP401 grid-cell-drift** — a cell was measured that the baseline does
  not know, or a baseline cell is no longer in the submitted grid at all:
  the coverage contract changed shape without a baseline update.
- **DP402 stale-cell** — a baseline cell got NO fresh measurement from the
  generation (the owning job quarantined/exhausted — the generation
  completes on the remaining cells and reports the hole instead of
  hanging), or the baseline itself has never been seeded/updated: serving
  from it would mean serving silently-uncertified.

Suppression: `ALLOWLIST` (fnmatch glob over the cell key ->
{rule: reason}) — the noqa analog for measurements, which have no source
line to annotate. Shipped entries must carry their reason.

The baseline file is the adversarial sibling of `analysis/baselines.json`:
shipped inside the package (`recert/robustness_baseline.json`), regenerated
deterministically (`python -m dorpatch_tpu_torch.recert update` — sorted keys,
normalized floats, update-twice byte-identical via the analysis dump), and
reviewed like any other checked-in contract.

Port of `dorpatch_tpu.recert.baseline`: the same cell keys, rule ids,
verdict keys and file bytes (the file starts as a byte copy of the JAX
package's). Its messages name this package's command. Host-only: no
torch.
"""

from __future__ import annotations

import fnmatch
import json
import pathlib
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from dorpatch_tpu_torch.analysis.baseline import dump_baseline as _dump
from dorpatch_tpu_torch.analysis.engine import Finding

#: The checked-in default baseline, shipped inside the package.
BASELINE_FILENAME = "robustness_baseline.json"

#: DP400 default tolerance, in absolute percentage points of robust
#: accuracy (and of certified ASR): a tiny CI batch quantizes accuracy in
#: steps of 100/images, so the default leaves room for one image flipping
#: on re-measurement noise while still catching real regressions.
DEFAULT_TOLERANCE = 2.0

#: Cell-key glob -> {rule_id: reason} — intentional drift with no source
#: line to own it. Shipped entries must carry their reason.
ALLOWLIST: Dict[str, Dict[str, str]] = {}

#: (id, name, description) rows for `--list-rules`-style help.
RECERT_RULE_ROWS: Tuple[Tuple[str, str, str], ...] = (
    ("DP400", "robust-accuracy-regression",
     "a grid cell's fresh robust-accuracy measurement regressed past its "
     "absolute tolerance vs recert/robustness_baseline.json (or certified "
     "ASR rose past it) — the defense got weaker against the standing "
     "red team"),
    ("DP401", "grid-cell-drift",
     "a measured cell is missing from the baseline, or a baseline cell is "
     "no longer in the submitted grid — the coverage contract changed "
     "shape; regenerate with `python -m dorpatch_tpu_torch.recert update`"),
    ("DP402", "stale-cell",
     "a baseline cell got no fresh measurement this generation (owning "
     "job quarantined/exhausted, or the baseline was never seeded) — "
     "serving on it would be serving silently-uncertified"),
)

RECERT_RULE_IDS: Tuple[str, ...] = tuple(r[0] for r in RECERT_RULE_ROWS)

#: Grid-cell hyperparameters (mirrors `sweep.GRID_KEYS`; kept literal so
#: this host-only module never imports the model stack).
GRID_KEYS = ("patch_budget", "density", "structured")


def baseline_path() -> pathlib.Path:
    """The checked-in default baseline file (inside the package)."""
    return pathlib.Path(__file__).with_name(BASELINE_FILENAME)


# ------------------------------------------------------------- cell keys

def _fmt(v: Any) -> str:
    """JSON-roundtrip-stable rendering of a cell-key value: rows come back
    from `rows.jsonl` with json's float formatting, so the key built from a
    spec float and the key built from its recorded row must agree."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return str(v)
    return json.dumps(json.loads(json.dumps(float(v))))


def cell_key(job: Mapping[str, Any], row: Mapping[str, Any]) -> str:
    """Stable identity of one (model, defense, attack) grid cell.

    Built from the job's base config (model identity), its sweep dict
    (defense ratio), its non-grid axis params (e.g. `attack.dropout` axes
    that the row keys alone cannot distinguish), and the row's grid-point
    hyperparameters."""
    base = job.get("base", {}) or {}
    sweep = job.get("sweep", {}) or {}
    model = (f"{base.get('base_arch', '?')}@{base.get('dataset', '?')}"
             f"/{base.get('img_size', '?')}")
    defense = f"pc:r{_fmt(sweep.get('defense_ratio', 0.06))}"
    extras = ",".join(
        f"{k.split('.')[-1]}={_fmt(v)}"
        for k, v in sorted((job.get("params", {}) or {}).items())
        if k.split(".")[-1] not in GRID_KEYS)
    point = ",".join(f"{k}={_fmt(row.get(k, '?'))}" for k in GRID_KEYS)
    attack = f"{extras},{point}" if extras else point
    return f"{model}|{defense}|{attack}"


def job_cells(job: Mapping[str, Any]) -> List[str]:
    """Every cell the job's grid slice is expected to produce — computable
    WITHOUT rows, so a quarantined job's holes are still enumerable."""
    from dorpatch_tpu_torch.farm.worker import job_config  # lazy: pulls config

    cfg = job_config(dict(job))
    sw = dict(job.get("sweep", {}) or {})
    budgets = sw.get("patch_budgets", [cfg.attack.patch_budget])
    densities = sw.get("densities", [cfg.attack.density])
    structureds = sw.get("structureds", [cfg.attack.structured])
    return [cell_key(job, {"patch_budget": b, "density": d, "structured": s})
            for b in budgets for d in densities for s in structureds]


def row_measurement(row: Mapping[str, Any], job_id: str) -> Dict[str, Any]:
    """One row -> the measurement record a baseline entry is built from."""
    return {
        "robust_accuracy": float(row.get("robust_accuracy", 0.0)),
        "certified_asr_pc": float(row.get("certified_asr_pc", 0.0)),
        "images": int(row.get("images", 0) or 0),
        "job": job_id,
    }


# ------------------------------------------------------------- file I/O

def empty_baseline() -> Dict[str, Any]:
    return {"version": 1, "generation": 0,
            "tolerance_default": DEFAULT_TOLERANCE, "entries": {}}


def load_baseline(path: Optional[pathlib.Path] = None
                  ) -> Optional[Dict[str, Any]]:
    p = pathlib.Path(path) if path is not None else baseline_path()
    try:
        return json.loads(p.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None


def dump_baseline(data: Mapping[str, Any]) -> str:
    """Deterministic serialization (sorted keys, normalized floats, one
    trailing newline) — same dump discipline as `analysis/baselines.json`,
    so `update` twice is byte-identical and diffs review cleanly."""
    return _dump(data)


def fold_measurements(data: Optional[Mapping[str, Any]],
                      measured: Mapping[str, Mapping[str, Any]],
                      generation: int) -> Dict[str, Any]:
    """A new baseline with every freshly measured cell's reference values
    set to its measurement (stamped with the generation). Cells the
    generation did not measure keep their old entries untouched — `check`
    (not `update`) is what complains about them."""
    out: Dict[str, Any] = dict(data) if data else empty_baseline()
    entries = dict(out.get("entries", {}))
    for key in sorted(measured):
        m = measured[key]
        prev = dict(entries.get(key, {}))
        prev.update({
            "robust_accuracy": float(m["robust_accuracy"]),
            "certified_asr_pc": float(m["certified_asr_pc"]),
            "images": int(m.get("images", 0)),
            "generation": int(generation),
        })
        entries[key] = prev
    out["entries"] = entries
    out["generation"] = int(generation)
    return out


# --------------------------------------------------------------- checking

def allowed(key: str, rule_id: str,
            allow: Optional[Dict[str, Dict[str, str]]] = None) -> bool:
    for table in (ALLOWLIST, allow or {}):
        for pattern, rules in table.items():
            if fnmatch.fnmatchcase(key, pattern) and rule_id in rules:
                return True
    return False


def tolerance_for(key: str, entry: Mapping[str, Any],
                  data: Mapping[str, Any]) -> float:
    if "tolerance" in entry:
        return float(entry["tolerance"])
    return float(data.get("tolerance_default", DEFAULT_TOLERANCE))


def check_measurements(
        measured: Mapping[str, Mapping[str, Any]],
        holes: Iterable[str],
        data: Optional[Mapping[str, Any]],
        generation: int,
        baseline_file: str = "<baseline>",
        allow: Optional[Dict[str, Dict[str, str]]] = None,
        select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Diff one completed generation's measurements against the baseline:
    DP400 (regression past tolerance), DP401 (cell added/removed), DP402
    (baseline cell with no fresh measurement / unseeded baseline).

    `holes` are cells the generation's grid COVERED but could not measure
    (owning job quarantined or retry-exhausted) — they report as DP402,
    not DP401: the grid did not change shape, the measurement is missing.
    """
    findings: List[Finding] = []

    def add(rule: str, key: str, message: str) -> None:
        findings.append(Finding(path=baseline_file, line=1, col=1,
                                rule_id=rule, message=f"[{key}] {message}"))

    holes = sorted(set(holes))
    if not data or not data.get("entries"):
        add("DP402", "<unseeded>",
            f"baseline has no entries — generation {generation} measured "
            f"{len(measured)} cell(s) but nothing is committed as the "
            "reference; seed it with `python -m dorpatch_tpu_torch.recert "
            "update` and check the file in")
        data = data or empty_baseline()
    entries: Mapping[str, Any] = data.get("entries", {})

    for key in sorted(set(measured) - set(entries)):
        add("DP401", key,
            "cell measured but absent from the baseline — the grid grew; "
            "accept it with `python -m dorpatch_tpu_torch.recert update`")
    for key in sorted(set(entries) - set(measured) - set(holes)):
        add("DP401", key,
            "baseline cell is no longer in the submitted grid — the grid "
            "shrank; accept the removal with `python -m dorpatch_tpu_torch.recert "
            "update --allow-remove`")
    for key in holes:
        if key in entries:
            age = int(generation) - int(entries[key].get("generation", 0))
            add("DP402", key,
                f"no fresh measurement in generation {generation} (owning "
                "farm job quarantined or retry-exhausted; baseline entry is "
                f"{age} generation(s) old) — the cell is a hole, not a pass")
        else:
            add("DP401", key,
                "cell entered the grid but produced no measurement (owning "
                "job failed) and has no baseline entry")

    for key in sorted(set(measured) & set(entries)):
        m, e = measured[key], entries[key]
        tol = tolerance_for(key, e, data)
        ra, ra0 = float(m["robust_accuracy"]), float(e["robust_accuracy"])
        if ra < ra0 - tol:
            add("DP400", key,
                f"robust accuracy regressed {ra0:.2f}% -> {ra:.2f}% "
                f"(drop {ra0 - ra:.2f} > tolerance {tol:.2f} percentage "
                "points) — the attack got stronger or the defense weaker; "
                "investigate before accepting with `recert update`")
            continue
        asr, asr0 = (float(m.get("certified_asr_pc", 0.0)),
                     float(e.get("certified_asr_pc", 0.0)))
        if asr > asr0 + tol:
            add("DP400", key,
                f"certified attack success rose {asr0:.2f}% -> {asr:.2f}% "
                f"(rise {asr - asr0:.2f} > tolerance {tol:.2f} percentage "
                "points) with robust accuracy inside tolerance — the "
                "certificate itself is eroding")

    out = []
    for f in sorted(findings):
        if select is not None and f.rule_id not in select:
            continue
        key = f.message.split("]", 1)[0].lstrip("[")
        if allowed(key, f.rule_id, allow):
            continue
        out.append(f)
    return out


# ---------------------------------------------------------------- verdict

def build_verdict(measured: Mapping[str, Mapping[str, Any]],
                  holes: Iterable[str],
                  data: Optional[Mapping[str, Any]],
                  generation: int,
                  findings: Sequence[Finding],
                  baseline_file: str = "") -> Dict[str, Any]:
    """The machine-readable per-generation verdict the serve boot gate and
    `GET /robustness` consume: per-cell status + margin (percentage points
    above the tolerance floor; negative = failing), worst margin, and the
    findings that produced it."""
    data = data or empty_baseline()
    entries: Mapping[str, Any] = data.get("entries", {})
    holes = set(holes)
    cells: Dict[str, Any] = {}
    failing = {f.message.split("]", 1)[0].lstrip("[")
               for f in findings if f.rule_id == "DP400"}
    worst: Optional[float] = None
    for key in sorted(set(measured) | set(entries) | holes):
        m, e = measured.get(key), entries.get(key)
        cell: Dict[str, Any] = {}
        if m is not None:
            cell["measured"] = float(m["robust_accuracy"])
        if e is not None:
            cell["baseline"] = float(e["robust_accuracy"])
            cell["tolerance"] = tolerance_for(key, e, data)
        if m is not None and e is not None:
            margin = (float(m["robust_accuracy"])
                      - (float(e["robust_accuracy"]) - cell["tolerance"]))
            cell["margin"] = round(margin, 4)
            worst = margin if worst is None else min(worst, margin)
            cell["status"] = "regressed" if key in failing else "ok"
        elif key in holes:
            cell["status"] = "stale"
        elif m is not None:
            cell["status"] = "added"
        else:
            cell["status"] = "removed"
        cells[key] = cell
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule_id] = by_rule.get(f.rule_id, 0) + 1
    seeded = bool(entries)
    if by_rule.get("DP400") or by_rule.get("DP401"):
        status = "failing"
    elif by_rule.get("DP402") or not seeded:
        status = "stale"
    else:
        status = "ok"
    return {
        "version": 1,
        "generation": int(generation),
        "baseline_file": str(baseline_file),
        "baseline_generation": int(data.get("generation", 0)),
        "seeded": seeded,
        "clean": not findings,
        "status": status,
        "worst_margin": None if worst is None else round(worst, 4),
        "findings_by_rule": dict(sorted(by_rule.items())),
        "findings": [{"rule": f.rule_id,
                      "cell": f.message.split("]", 1)[0].lstrip("["),
                      "message": f.message} for f in findings],
        "cells": cells,
    }
