"""Fleet-level aggregation across a farm directory's per-job telemetry.

Port of `dorpatch_tpu.farm.report`: the same summary dict and rendering,
rendered by `python -m dorpatch_tpu_torch.farm report` (the JAX package's
`observe.report` also renders a port farm directory).

Joins every job's `job.json` (state machine, attempts, failures) with its
results dir's `run.json` manifest (attempt chain), `events.jsonl` (block
timing), and `rows.jsonl` (the actual sweep results) into one summary
dict.

Wasted-vs-useful accounting: each `block` event carries its (stage, step)
coordinate. A coordinate executed once is useful work; re-executions of a
coordinate already seen for that job are the work a crash/retry actually
repeated. Crash-resume from a block checkpoint re-runs at most the partial
block after the last snapshot, so its wasted time is near zero; a
from-scratch retry re-runs everything, all of it counted wasted — the
metric measures exactly what checkpointing buys.

Host-only: reads files, never touches torch or a device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from dorpatch_tpu_torch.checkpoint import load_json
from dorpatch_tpu_torch.farm.queue import FARM_NAME, JobQueue
from dorpatch_tpu_torch.observe.heartbeat import heartbeat_filename, last_beat

ROW_KEYS = ("patch_budget", "density", "structured",
            "robust_accuracy", "certified_asr_pc")


def is_farm_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, FARM_NAME))


def _read_jsonl(path: str, stats: Optional[Dict[str, int]] = None
                ) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path, errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    if stats is not None:
                        stats["torn"] = stats.get("torn", 0) + 1
                    continue
    except OSError:
        pass
    return out


def read_result_rows(result_dir: str,
                     stats: Optional[Dict[str, int]] = None) -> List[dict]:
    """The rows a sweep actually recorded, hardened for live readers: the
    fleet report reads `rows.jsonl` while workers append to it, so a torn
    final line, a half-flushed fragment, or a parseable-but-non-dict JSON
    value must read as a missing cell (a hole), never raise. `stats['torn']` counts what was skipped."""
    rows = _read_jsonl(os.path.join(result_dir, "rows.jsonl"), stats=stats)
    good = [r for r in rows if isinstance(r, dict)]
    if stats is not None and len(good) != len(rows):
        stats["torn"] = stats.get("torn", 0) + (len(rows) - len(good))
    return good


def _job_step_time(result_dir: str) -> Dict[str, float]:
    """Useful vs re-executed block seconds for one job, across all its
    attempts (events.jsonl is append-mode, so file order is chronological
    across attempts)."""
    useful = wasted = 0.0
    reexecuted = 0
    seen = set()
    for record in _read_jsonl(os.path.join(result_dir, "events.jsonl")):
        if record.get("kind") != "block":
            continue
        coord = (record.get("stage"), record.get("step"))
        dur = float(record.get("dur_s", 0.0))
        if coord in seen:
            wasted += dur
            reexecuted += 1
        else:
            seen.add(coord)
            useful += dur
    return {"useful_s": useful, "wasted_s": wasted,
            "reexecuted_blocks": reexecuted}


def summarize_fleet(farm_dir: str) -> Optional[dict]:
    """The whole farm as one dict; None when `farm_dir` is not a farm."""
    if not is_farm_dir(farm_dir):
        return None
    jq = JobQueue(farm_dir)
    farm = load_json(os.path.join(farm_dir, FARM_NAME), {})
    jobs: List[dict] = []
    points: List[dict] = []
    attempts_histogram: Dict[str, int] = {}
    failures_by_kind: Dict[str, int] = {}
    quarantined: List[dict] = []
    retries = reclaims = 0
    useful_s = wasted_s = 0.0
    reexecuted_blocks = 0
    for job_id in jq.job_ids():
        job = jq.read_job(job_id)
        if job is None:
            jobs.append({"id": job_id, "state": "unreadable"})
            continue
        attempts = int(job.get("attempts", 0))
        attempts_histogram[str(attempts)] = (
            attempts_histogram.get(str(attempts), 0) + 1)
        retries += max(0, attempts - 1)
        reclaims += int(job.get("reclaims", 0))
        for failure in job.get("failures", []):
            kind = failure.get("kind", "unknown")
            failures_by_kind[kind] = failures_by_kind.get(kind, 0) + 1
        result_dir = os.path.join(jq.job_dir(job_id), "results")
        manifest = load_json(os.path.join(result_dir, "run.json"))
        attempt_chain = []
        if manifest:
            attempt_chain = ([manifest.get("run_id", "")]
                             + list(manifest.get("previous_run_ids", [])))
        step_time = _job_step_time(result_dir)
        useful_s += step_time["useful_s"]
        wasted_s += step_time["wasted_s"]
        reexecuted_blocks += step_time["reexecuted_blocks"]
        row_stats: Dict[str, int] = {}
        rows = read_result_rows(result_dir, stats=row_stats)
        for row in rows:
            point = {"job": job_id}
            point.update({k: row[k] for k in ROW_KEYS if k in row})
            if "resumed_from_iteration" in row:
                point["resumed_from_iteration"] = row["resumed_from_iteration"]
            points.append(point)
        if job.get("state") == "quarantined" and job.get("failures"):
            last = job["failures"][-1]
            quarantined.append({"id": job_id,
                               "kind": last.get("kind", "unknown"),
                               "error": last.get("error", "")})
        jobs.append({
            "id": job_id,
            "state": ("failed_exhausted"
                      if job.get("state") == "failed" and job.get("exhausted")
                      else job.get("state", "")),
            "attempts": attempts,
            "reclaims": int(job.get("reclaims", 0)),
            "run_ids": attempt_chain,
            "rows": len(rows),
            "torn_rows": row_stats.get("torn", 0),
            "resumed_points": sum(
                1 for r in rows if "resumed_from_iteration" in r),
            **step_time,
        })
    # per-worker AOT warm-boot accounting (workers/<id>/aot.json: written
    # by the JAX package's workers booting from an executable store; the
    # port's workers have none yet), live job counters from the newest
    # heartbeat beat, and the final metric-registry snapshot
    # (workers/<id>/metrics.json)
    aot_by_worker: Dict[str, dict] = {}
    workers: Dict[str, dict] = {}
    metrics_by_worker: Dict[str, dict] = {}
    workers_dir = os.path.join(farm_dir, "workers")
    if os.path.isdir(workers_dir):
        for wid in sorted(os.listdir(workers_dir)):
            wdir = os.path.join(workers_dir, wid)
            rec = load_json(os.path.join(wdir, "aot.json"))
            if isinstance(rec, dict):
                aot_by_worker[wid] = {
                    "hits": int(rec.get("hits", 0)),
                    "misses": int(rec.get("misses", 0)),
                    "load_s": float(rec.get("load_s", 0.0)),
                }
            beat = last_beat(os.path.join(wdir, heartbeat_filename(0)))
            if beat is not None:
                workers[wid] = {
                    k: beat[k] for k in (
                        "phase", "seq", "ts", "jobs_done", "jobs_failed",
                        "jobs_quarantined", "jobs_abandoned",
                        "jobs_claimed", "jobs_reclaimed") if k in beat}
            snap = load_json(os.path.join(wdir, "metrics.json"))
            if isinstance(snap, dict):
                totals = {}
                for name, m in sorted(
                        (snap.get("metrics") or {}).items()):
                    if m.get("type") != "counter":
                        continue
                    totals[name] = sum(
                        float(s.get("value", 0.0))
                        for s in m.get("series", []))
                metrics_by_worker[wid] = totals
    return {
        "farm_dir": os.path.abspath(farm_dir),
        "spec_jobs": int(farm.get("jobs", 0)),
        "counts": jq.counts(),
        "attempts_histogram": dict(sorted(attempts_histogram.items())),
        "retries": retries,
        "reclaims": reclaims,
        "failures_by_kind": dict(sorted(failures_by_kind.items())),
        "quarantined": quarantined,
        "step_time": {"useful_s": round(useful_s, 3),
                      "wasted_s": round(wasted_s, 3),
                      "reexecuted_blocks": reexecuted_blocks},
        "aot_by_worker": aot_by_worker,
        "workers": workers,
        "metrics_by_worker": metrics_by_worker,
        "points": points,
        "jobs": jobs,
    }


def format_fleet_report(s: dict) -> str:
    """Human rendering of a `summarize_fleet()` dict, in the same visual
    dialect as `observe.report.format_report`."""
    lines: List[str] = []
    add = lines.append
    add("= DorPatch attack-sweep farm report =")
    add(f"farm dir: {s['farm_dir']}")
    c = s["counts"]
    add("-- farm --")
    add(f"  jobs: {c['total']} total — {c['done']} done, "
        f"{c['quarantined']} quarantined, "
        f"{c['failed_retryable']} retryable, "
        f"{c['failed_exhausted']} exhausted, {c['pending']} pending, "
        f"{c['leased'] + c['running']} in flight, "
        f"{c['unreadable']} unreadable")
    hist = ", ".join(f"{k}: {v}"
                     for k, v in s["attempts_histogram"].items())
    add(f"  attempts histogram: {hist or '(none)'}  "
        f"(retries {s['retries']}, reclaims {s['reclaims']})")
    if s["failures_by_kind"]:
        add("  failures: " + ", ".join(
            f"{k}: {v}" for k, v in s["failures_by_kind"].items()))
    st = s["step_time"]
    total = st["useful_s"] + st["wasted_s"]
    pct = (100.0 * st["wasted_s"] / total) if total else 0.0
    add(f"  step time: {st['useful_s']:.3f}s useful, "
        f"{st['wasted_s']:.3f}s re-executed ({pct:.1f}% waste, "
        f"{st['reexecuted_blocks']} re-run block(s))")
    if s.get("aot_by_worker"):
        add("  aot warm boot: " + ", ".join(
            f"{w}: {a['hits']} hit(s)/{a['misses']} miss(es)"
            for w, a in sorted(s["aot_by_worker"].items())))
    for wid, w in sorted(s.get("workers", {}).items()):
        add(f"  worker {wid}: phase {w.get('phase', '')!r} "
            f"(beat seq {w.get('seq', '?')}) — "
            f"claimed {w.get('jobs_claimed', 0)}, "
            f"done {w.get('jobs_done', 0)}, "
            f"failed {w.get('jobs_failed', 0)}, "
            f"quarantined {w.get('jobs_quarantined', 0)}, "
            f"abandoned {w.get('jobs_abandoned', 0)}, "
            f"reclaimed {w.get('jobs_reclaimed', 0)}")
    for q in s["quarantined"]:
        add(f"  quarantined {q['id']}: [{q['kind']}] {q['error'][:90]}")
    add("-- jobs --")
    for j in s["jobs"]:
        if j.get("state") == "unreadable":
            add(f"  {j['id']}: UNREADABLE job.json")
            continue
        resumed = (f", {j['resumed_points']} resumed"
                   if j.get("resumed_points") else "")
        torn = (f", {j['torn_rows']} torn"
                if j.get("torn_rows") else "")
        add(f"  {j['id']:<28} {j['state']:<12} "
            f"attempts {j['attempts']}"
            f" ({len(j.get('run_ids', []))} run id(s))"
            f", rows {j.get('rows', 0)}{torn}{resumed}")
    holes = [j for j in s["jobs"]
             if j.get("torn_rows")
             or (j.get("state") == "done" and not j.get("rows"))]
    if s["points"] or holes:
        add("-- robust accuracy --")
        for p in s["points"]:
            ra = p.get("robust_accuracy", "?")
            ca = p.get("certified_asr_pc", "?")
            resumed = (f"  [resumed @ {p['resumed_from_iteration']}]"
                       if "resumed_from_iteration" in p else "")
            add(f"  {p['job']:<28} budget {p.get('patch_budget', '?')} "
                f"density {p.get('density', '?')} "
                f"structured {p.get('structured', '?')}: "
                f"robust acc {ra}%, certified ASR {ca}%{resumed}")
        # a done job with torn or absent rows is a measurement HOLE, not a
        # pass — render it explicitly so the grid never looks complete
        for j in holes:
            add(f"  {j['id']:<28} HOLE — {j.get('rows', 0)} recorded, "
                f"{j.get('torn_rows', 0)} torn row(s)")
    return "\n".join(lines)
