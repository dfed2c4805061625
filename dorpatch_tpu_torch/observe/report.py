"""Offline telemetry report: join `run.json` + `events.jsonl` +
`metrics.jsonl` + `heartbeat_*.jsonl` into a human summary.

    python -m dorpatch_tpu_torch.observe.report <results_dir> [--json]

Port of `dorpatch_tpu.observe.report`: the same summary dicts, the same
text and JSON, over the port's run, serve, farm, recert and fleet
directories (the backend line names torch's version where the manifest
carries it). Host-only: parses JSONL, never imports torch — safe to run
on a host without a card, or against a results dir a wedged job left
behind. Shows, per the
latest attempt (run_id): the per-phase time breakdown and span coverage,
compile vs run time, attack/certification throughput (MFU via the shared
`StepTimer.summary` FLOPs path when the manifest carries FLOPs accounting),
device-memory peaks, heartbeat stall detection, and spans left open by a
hang or crash.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from dorpatch_tpu_torch.observe.heartbeat import summarize_heartbeats
from dorpatch_tpu_torch.observe.manifest import MANIFEST_NAME
from dorpatch_tpu_torch.observe.metrics import labeled_values
from dorpatch_tpu_torch.observe.timing import (StepTimer,
                                               nearest_rank_percentile)


def _read_jsonl(path: str) -> List[dict]:
    rows = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue  # truncated tail of an aborted run
    except OSError:
        pass
    return rows


def load_manifest(result_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(result_dir, MANIFEST_NAME)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def load_events(result_dir: str) -> List[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(result_dir, "events*.jsonl"))):
        rows.extend(_read_jsonl(path))
    return rows


def _aggregate(spans: List[dict]) -> List[dict]:
    """[{name, count, total_s}] sorted by total descending."""
    agg: Dict[str, dict] = {}
    for s in spans:
        a = agg.setdefault(s.get("name", "?"),
                           {"name": s.get("name", "?"), "count": 0,
                            "total_s": 0.0})
        a["count"] += 1
        a["total_s"] += float(s.get("dur_s", 0.0))
    out = sorted(agg.values(), key=lambda a: -a["total_s"])
    for a in out:
        a["total_s"] = round(a["total_s"], 3)
    return out


def summarize(result_dir: str, stall_factor: float = 5.0) -> dict:
    """Join every telemetry file in `result_dir` into one summary dict."""
    manifest = load_manifest(result_dir)
    events = load_events(result_dir)
    metrics = _read_jsonl(os.path.join(result_dir, "metrics.jsonl"))

    attempts: List[str] = list((manifest or {}).get("previous_run_ids", []))[::-1]
    for r in metrics + events:
        rid = r.get("run_id", "")
        if rid and rid not in attempts:
            attempts.append(rid)
    run_id = (manifest or {}).get("run_id") or (attempts[-1] if attempts else "")

    # latest attempt, process 0 only, for the time accounting
    ev = [r for r in events
          if r.get("proc", 0) == 0 and r.get("run_id", "") == run_id]
    spans = [r for r in ev if r.get("kind") == "span"]
    begins = [r for r in ev if r.get("kind") == "begin"]
    compiles = [r for r in ev if r.get("kind") == "compile"]
    blocks = [r for r in ev if r.get("kind") == "block"]

    # run wall time: the closing "run" span, else (hang/crash) the distance
    # from its begin record to the last record seen
    run_spans = [s for s in spans if s.get("name") == "run"]
    run_complete = bool(run_spans)
    if run_spans:
        run_seconds = float(run_spans[-1]["dur_s"])
    else:
        run_begin = [b for b in begins if b.get("name") == "run"]
        run_seconds = (float(ev[-1]["ts"]) - float(run_begin[-1]["ts"])
                       if run_begin and ev else 0.0)

    top = [s for s in spans if s.get("depth") == 1]
    phases = _aggregate(top)
    covered = sum(p["total_s"] for p in phases)
    for p in phases:
        p["pct"] = round(100.0 * p["total_s"] / run_seconds, 1) \
            if run_seconds else 0.0
    inner = _aggregate([s for s in spans if s.get("depth", 0) >= 2])

    # spans left open: begin paths minus closed span paths (multiset)
    closed: Dict[str, int] = {}
    for s in spans:
        closed[s.get("path", "")] = closed.get(s.get("path", ""), 0) + 1
    open_spans = []
    for b in begins:
        p = b.get("path", "")
        if closed.get(p, 0) > 0:
            closed[p] -= 1
        else:
            open_spans.append(p)

    compile_total = round(sum(float(c.get("dur_s", 0.0)) for c in compiles), 3)

    # attack accounting: steps from metrics.jsonl (max step per batch/stage),
    # seconds from the attack.stage* spans, images from batch-span attrs
    mrecs = [m for m in metrics if m.get("run_id", run_id) == run_id]
    steps_by_key: Dict[tuple, int] = {}
    for m in mrecs:
        key = (m.get("batch", 0), m.get("stage", 0))
        steps_by_key[key] = max(steps_by_key.get(key, 0), int(m.get("step", 0)))
    attack_steps = sum(steps_by_key.values())
    attack_seconds = sum(float(s.get("dur_s", 0.0)) for s in spans
                         if str(s.get("name", "")).startswith("attack.stage"))
    batch_spans = [s for s in spans if s.get("name") == "batch"]
    images_total = sum(int(s.get("images", 0)) for s in batch_spans)
    images_generated = sum(int(s.get("images", 0)) for s in batch_spans
                           if not s.get("cached"))
    # certify accounting from the certify spans themselves: on resumed runs
    # cached batches skip certification entirely, so dividing ALL images by
    # certify time would inflate the rate
    certify_spans = [s for s in spans if s.get("name") == "certify"]
    certify_seconds = sum(float(s.get("dur_s", 0.0)) for s in certify_spans)
    certify_images = sum(int(s.get("images", 0)) for s in certify_spans)
    # pruned-certification accounting: executed vs
    # exhaustive-equivalent masked forwards, from the span attrs the
    # pipeline records per batch; zero on pre-prune telemetry
    certify_fwd = sum(int(s.get("forwards", 0)) for s in certify_spans)
    certify_exh = sum(int(s.get("forwards_exhaustive", 0))
                      for s in certify_spans)
    # incremental accounting (mask-aware incremental forwards): the spans'
    # fractional full-forward cost; falls back to the entry count on
    # pre-incremental telemetry so the two totals coincide there
    certify_fe = sum(float(s.get("forward_equivalents", s.get("forwards", 0)))
                     for s in certify_spans)
    # mixed-precision accounting (bf16 certify bank): each certify span is
    # stamped with the DefenseConfig.compute_dtype it ran under; when one
    # results dir holds BOTH banks (an A/B run, or two attempts at
    # different precisions) the per-dtype image rates give the measured
    # speedup directly. Pre-bf16 telemetry carries no dtype attr -> None.
    dtype_rates: Dict[str, dict] = {}
    for s in certify_spans:
        dt = s.get("compute_dtype")
        if not dt:
            continue
        r = dtype_rates.setdefault(str(dt), {"seconds": 0.0, "images": 0})
        r["seconds"] += float(s.get("dur_s", 0.0))
        r["images"] += int(s.get("images", 0))
    certify_dtype = "+".join(sorted(dtype_rates)) if dtype_rates else None
    certify_dtype_speedup = None
    if {"f32", "bf16"} <= set(dtype_rates):
        f32, b16 = dtype_rates["f32"], dtype_rates["bf16"]
        if f32["seconds"] and b16["seconds"] and f32["images"] \
                and b16["images"]:
            certify_dtype_speedup = round(
                (b16["images"] / b16["seconds"])
                / (f32["images"] / f32["seconds"]), 3)

    peak_mem = 0
    for b in blocks:
        for d in b.get("mem") or []:
            peak_mem = max(peak_mem,
                           int(d.get("peak_bytes_in_use",
                                     d.get("bytes_in_use", 0)) or 0))

    # MFU through the one shared formula (StepTimer.summary): available when
    # the manifest records FLOPs accounting (e.g. a bench-style run)
    mfu = None
    tele = (manifest or {}).get("telemetry") or {}
    if attack_steps and attack_seconds and tele.get("flops_per_step") \
            and tele.get("peak_flops"):
        t = StepTimer()
        t.block_seconds = [attack_seconds]
        mfu = t.summary(steps_per_block=attack_steps, batch=1,
                        flops_per_step=float(tele["flops_per_step"]),
                        peak_flops=float(tele["peak_flops"]))

    serve = _summarize_serve(ev)
    replicas = _summarize_replicas(ev)
    baseline = _load_baseline_check(result_dir)

    metrics_by_attempt: Dict[str, int] = {}
    for m in metrics:
        rid = m.get("run_id", "(unstamped)")
        metrics_by_attempt[rid] = metrics_by_attempt.get(rid, 0) + 1

    return {
        "result_dir": result_dir,
        "manifest": manifest,
        "run_id": run_id,
        "attempts": attempts,
        "run_complete": run_complete,
        "run_seconds": round(run_seconds, 3),
        "phases": phases,
        "coverage": round(covered / run_seconds, 4) if run_seconds else 0.0,
        "inner_spans": inner,
        "open_spans": open_spans,
        "compile": {"total_s": compile_total, "programs": _aggregate(compiles)},
        "blocks": {"count": len(blocks),
                   "total_s": round(sum(float(b.get("dur_s", 0.0))
                                        for b in blocks), 3)},
        "attack": {
            "steps": attack_steps,
            "seconds": round(attack_seconds, 3),
            "steps_per_sec": round(attack_steps / attack_seconds, 3)
            if attack_seconds else 0.0,
            "images": images_total,
            "images_generated": images_generated,
            "images_per_sec": round(images_generated / attack_seconds, 3)
            if attack_seconds and images_generated else 0.0,
        },
        "certify": {
            "seconds": round(certify_seconds, 3),
            "images": certify_images,
            "images_per_sec": round(certify_images / certify_seconds, 3)
            if certify_seconds and certify_images else 0.0,
            "forwards": certify_fwd,
            "forwards_per_image": round(certify_fwd / certify_images, 1)
            if certify_fwd and certify_images else None,
            "forward_equivalents_per_image": round(
                certify_fe / certify_images, 2)
            if certify_fe and certify_images else None,
            "prune_rate": round(1.0 - certify_fwd / certify_exh, 4)
            if certify_fwd and certify_exh else None,
            "exhaustive_speedup": round(certify_exh / certify_fe, 2)
            if certify_fe and certify_exh else None,
            "compute_dtype": certify_dtype,
            "dtype_speedup": certify_dtype_speedup,
        },
        "mfu": mfu,
        "serve": serve,
        "replicas": replicas,
        "aot": _summarize_aot(ev),
        "baseline": baseline,
        "peak_device_bytes": peak_mem or None,
        "heartbeats": summarize_heartbeats(result_dir,
                                           stall_factor=stall_factor),
        "metrics_records": {"total": len(metrics),
                            "by_attempt": metrics_by_attempt},
    }


def _percentile_ms(sorted_s: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ascending seconds list, in ms."""
    v = nearest_rank_percentile(sorted_s, q)
    return None if v is None else round(v * 1e3, 3)


def _summarize_serve(ev: List[dict]) -> Optional[dict]:
    """The serving section: request latency percentiles, throughput,
    batch occupancy, and reject rate — from the `serve.request` events and
    `serve.batch` spans the service emits. None when the results dir holds
    no serving telemetry (batch runs keep their report unchanged)."""
    reqs = [r for r in ev
            if r.get("kind") == "event" and r.get("name") == "serve.request"]
    batches = [r for r in ev
               if r.get("kind") == "span" and r.get("name") == "serve.batch"]
    if not reqs and not batches:
        return None
    by_status: Dict[str, int] = {}
    for r in reqs:
        st = str(r.get("status", "?"))
        by_status[st] = by_status.get(st, 0) + 1
    ok_lat = sorted(float(r.get("latency_s", 0.0)) for r in reqs
                    if r.get("status") == "ok")
    # per-request certify cost (pruned-scheduling PR): executed masked
    # forwards vs the bank's exhaustive-equivalent, stamped on ok events
    fwd = sum(int(r.get("forwards", 0)) for r in reqs
              if r.get("status") == "ok")
    fwd_exh = sum(int(r.get("forwards_exhaustive", 0)) for r in reqs
                  if r.get("status") == "ok")
    # fractional full-forward cost under the incremental paths (== fwd on
    # pre-incremental telemetry, where the attr is absent)
    fe = sum(float(r.get("forward_equivalents", r.get("forwards", 0)))
             for r in reqs if r.get("status") == "ok")
    total = sum(by_status.values())
    rejected = by_status.get("overloaded", 0)
    ts = [float(r["ts"]) for r in reqs if "ts" in r]
    wall = (max(ts) - min(ts)) if len(ts) >= 2 else 0.0
    images = sum(int(b.get("images", 0)) for b in batches)
    slots = sum(int(b.get("bucket", 0)) for b in batches)
    # the certify-bank precision the replicas batched under (stamped per
    # serve.batch span); absent on pre-bf16 telemetry
    dtypes = sorted({str(b["compute_dtype"]) for b in batches
                     if b.get("compute_dtype")})
    return {
        "requests": total,
        "by_status": dict(sorted(by_status.items())),
        "latency_ms": {"count": len(ok_lat),
                       "p50": _percentile_ms(ok_lat, 0.50),
                       "p95": _percentile_ms(ok_lat, 0.95),
                       "p99": _percentile_ms(ok_lat, 0.99)},
        "throughput_rps": round(len(ok_lat) / wall, 3) if wall else None,
        "batches": len(batches),
        "batch_seconds": round(sum(float(b.get("dur_s", 0.0))
                                   for b in batches), 3),
        "occupancy": round(images / slots, 4) if slots else None,
        "reject_rate": round(rejected / total, 4) if total else 0.0,
        "certify_forwards_per_request": round(fwd / len(ok_lat), 1)
        if fwd and ok_lat else None,
        "certify_forward_equivalents_per_request": round(fe / len(ok_lat), 2)
        if fe and ok_lat else None,
        "certify_prune_rate": round(1.0 - fwd / fwd_exh, 4)
        if fwd and fwd_exh else None,
        "compute_dtype": "+".join(dtypes) if dtypes else None,
    }


def _summarize_replicas(ev: List[dict]) -> Optional[dict]:
    """The replica-pool section: per-replica lifecycle accounting from the
    `serve.replica.{start,sick,quarantine,restart,retire}` events the
    supervised pool emits, plus per-replica batch counts from the
    `serve.batch` spans. None when the dir predates the replica pool (or
    the run never served) so old reports render unchanged."""
    life = [r for r in ev if r.get("kind") == "event"
            and str(r.get("name", "")).startswith("serve.replica.")]
    if not life:
        return None
    batches = [r for r in ev
               if r.get("kind") == "span" and r.get("name") == "serve.batch"]
    per: Dict[int, dict] = {}

    def rep(i):
        return per.setdefault(int(i), {
            "replica": int(i), "generation": 0, "restarts": 0,
            "sick": 0, "sick_kinds": {}, "retired": False,
            "failed_over": 0, "batches": 0, "aot": None})

    drains = 0
    for r in life:
        if "replica" not in r:
            continue
        p = rep(r["replica"])
        name = r["name"]
        if name == "serve.replica.start":
            p["generation"] = max(p["generation"], int(r.get("generation", 0)))
            if r.get("aot") is not None:
                p["aot"] = bool(r["aot"])
        elif name == "serve.replica.sick":
            p["sick"] += 1
            cause = str(r.get("cause", "?"))
            p["sick_kinds"][cause] = p["sick_kinds"].get(cause, 0) + 1
            p["failed_over"] += int(r.get("inflight", 0))
        elif name == "serve.replica.restart":
            p["generation"] = max(p["generation"], int(r.get("generation", 0)))
            p["restarts"] = max(p["restarts"], int(r.get("restarts", 0)))
            p["restart_s"] = round(float(r.get("dur_s", 0.0)), 3)
            p["restart_traces"] = int(r.get("trace_counts", 0))
        elif name == "serve.replica.quarantine":
            p["restarts"] = max(p["restarts"], int(r.get("restarts", 0)))
        elif name == "serve.replica.retire":
            p["retired"] = True
            p["restarts"] = max(p["restarts"], int(r.get("restarts", 0)))
    for b in batches:
        if "replica" in b:
            rep(b["replica"])["batches"] += 1
    drains = sum(1 for r in ev if r.get("kind") == "event"
                 and r.get("name") == "serve.drain_timeout")
    out = sorted(per.values(), key=lambda p: p["replica"])
    return {
        "count": len(out),
        "retired": sum(1 for p in out if p["retired"]),
        "restarts": sum(p["restarts"] for p in out),
        "failed_over": sum(p["failed_over"] for p in out),
        "drain_timeouts": drains,
        "per_replica": out,
    }


def _summarize_aot(ev: List[dict]) -> Optional[dict]:
    """The AOT executable-store section: warm-boot hit rate and estimated
    compile seconds saved — from the `aot.load` / `aot.miss` / `aot.build`
    events the boot path emits plus the closing `aot.boot` summary event.
    None when the run never touched a store (every pre-AOT results dir
    renders unchanged)."""
    loads = [r for r in ev
             if r.get("kind") == "event" and r.get("name") == "aot.load"]
    misses = [r for r in ev
              if r.get("kind") == "event" and r.get("name") == "aot.miss"]
    builds = [r for r in ev
              if r.get("kind") == "event" and r.get("name") == "aot.build"]
    boots = [r for r in ev
             if r.get("kind") == "event" and r.get("name") == "aot.boot"]
    if not (loads or misses or builds or boots):
        return None
    miss_reasons: Dict[str, int] = {}
    for r in misses:
        reason = str(r.get("reason", "?"))
        miss_reasons[reason] = miss_reasons.get(reason, 0) + 1
    attempts = len(loads) + len(misses)
    out = {
        "loads": len(loads),
        "misses": len(misses),
        "builds": len(builds),
        "hit_rate": round(len(loads) / attempts, 4) if attempts else None,
        "miss_reasons": dict(sorted(miss_reasons.items())),
        "saved_s": round(sum(float(r.get("saved_s", 0.0)) for r in loads), 3),
    }
    if boots:
        b = boots[-1]
        out["boot"] = {"mode": b.get("mode", "?"),
                       "hits": int(b.get("hits", 0)),
                       "misses": int(b.get("misses", 0)),
                       "builds": int(b.get("builds", 0)),
                       "boot_s": round(float(b.get("boot_s", 0.0)), 3),
                       "saved_s": round(float(b.get("saved_s", 0.0)), 3)}
    return out


def _load_baseline_check(result_dir: str) -> Optional[dict]:
    """The program-baseline gate's machine-readable result, when a
    `--baseline check --baseline-report <dir>` run dropped one next to the
    telemetry (`baseline_check.json`). None when absent — results dirs
    predating the baseline tier render unchanged."""
    try:
        with open(os.path.join(result_dir, "baseline_check.json")) as fh:
            out = json.load(fh)
    except (OSError, ValueError):
        return None
    return out if isinstance(out, dict) else None


def _format_recert_report(st: dict, verdict: Optional[dict]) -> str:
    """Human rendering of a re-certification dir: scheduler status plus the
    latest generation's verdict (per-cell robust-accuracy vs baseline)."""
    lines = []
    add = lines.append
    add("= DorPatch re-certification report =")
    add(f"recert dir: {st['recert_dir']}")
    add(f"baseline: {st['baseline_file']}")
    add(f"completed generation: {st['generation']}")
    infl = st.get("inflight")
    if infl:
        c = infl.get("counts") or {}
        add(f"inflight: generation {infl['generation']} "
            f"({c.get('done', 0)}/{c.get('total', 0)} jobs done, "
            f"{c.get('failed_exhausted', 0)} exhausted, "
            f"{c.get('quarantined', 0)} quarantined)")
    if not verdict:
        add("(no verdict yet — run `python -m dorpatch_tpu_torch.recert run`)")
        return "\n".join(lines)
    add(f"-- verdict (generation {verdict.get('generation')}, "
        f"baseline generation {verdict.get('baseline_generation')}) --")
    wm = verdict.get("worst_margin")
    add(f"  status: {verdict.get('status', '?')}"
        + (f", worst margin {wm:+.2f} pts above the tolerance floor"
           if wm is not None else "")
        + ("" if verdict.get("seeded") else " (baseline UNSEEDED)"))
    by_rule = verdict.get("findings_by_rule") or {}
    if by_rule:
        add("  findings: "
            + ", ".join(f"{k}: {v}" for k, v in sorted(by_rule.items())))
    cells = verdict.get("cells") or {}
    if cells:
        add(f"-- cells ({len(cells)}) --")
    for key, c in sorted(cells.items()):
        parts = []
        if "measured" in c:
            parts.append(f"measured {c['measured']:.2f}")
        if "baseline" in c:
            parts.append(f"baseline {c['baseline']:.2f} "
                         f"(tol {c.get('tolerance', '?')})")
        if "margin" in c:
            parts.append(f"margin {c['margin']:+.2f}")
        flag = str(c.get("status", "?"))
        add(f"  [{flag:>9}] {key}: " + ", ".join(parts or ["no data"]))
    for f in (verdict.get("findings") or [])[:8]:
        add(f"  {f.get('rule', '?')} {f.get('message', '')[:110]}")
    return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def format_report(s: dict) -> str:
    """Human rendering of a `summarize()` dict."""
    lines = []
    add = lines.append
    add("= DorPatch run telemetry report =")
    add(f"results dir: {s['result_dir']}")
    m = s.get("manifest") or {}
    attempt = (f"attempt {len(s['attempts'])}" if len(s["attempts"]) > 1
               else "single attempt")
    add(f"run: {s['run_id'] or '(no run_id)'} ({attempt})"
        + (f" started {m['started_iso']}" if m.get("started_iso") else "")
        + (f" on {m['hostname']}" if m.get("hostname") else "")
        + (f" @ {m['git_sha'][:10]}" if m.get("git_sha") else ""))
    if m.get("backend") or m.get("jax") or m.get("torch"):
        # the port's manifest names torch's version, the JAX package's jax's
        impl = ("torch" if m.get("torch") and not m.get("jax") else "jax")
        add(f"backend: {m.get('backend', '?')} "
            f"({m.get('device_count', '?')} x {m.get('device_kind', '?')}, "
            f"{m.get('process_count', '?')} process(es)) "
            f"{impl} {m.get(impl, '?')}")
    if not s["run_complete"]:
        add("!! run span never closed: the run hung or crashed mid-flight")

    add(f"-- phase breakdown (proc 0, run {s['run_seconds']}s) --")
    for p in s["phases"]:
        add(f"  {p['name']:<14} {p['total_s']:>9.3f}s  {p['pct']:>5.1f}%  "
            f"({p['count']} span{'s' if p['count'] != 1 else ''})")
    add(f"  span coverage: {100.0 * s['coverage']:.1f}% of run wall time")
    if s["inner_spans"]:
        add("-- inner spans --")
        for p in s["inner_spans"]:
            add(f"  {p['name']:<24} {p['total_s']:>9.3f}s  ({p['count']})")
    if s["open_spans"]:
        add("-- spans left OPEN (hang/crash signature) --")
        for p in s["open_spans"]:
            add(f"  {p}")

    c = s["compile"]
    add("-- compile --")
    pct = (100.0 * c["total_s"] / s["run_seconds"]) if s["run_seconds"] else 0.0
    add(f"  compile time: {c['total_s']}s ({pct:.1f}% of run) over "
        f"{len(c['programs'])} program(s)")
    for p in c["programs"]:
        add(f"  {p['name']:<36} {p['count']} x {p['total_s']:.3f}s")

    a, ce = s["attack"], s["certify"]
    add("-- throughput --")
    add(f"  attack: {a['steps']} steps in {a['seconds']}s -> "
        f"{a['steps_per_sec']} steps/sec; {a['images_generated']} images "
        f"generated -> {a['images_per_sec']} images/sec")
    dt = f" [{ce['compute_dtype']}]" if ce.get("compute_dtype") else ""
    add(f"  certify{dt}: {ce['images']} images in {ce['seconds']}s -> "
        f"{ce['images_per_sec']} images/sec")
    if ce.get("dtype_speedup") is not None:
        add(f"  certify dtype speedup: {ce['dtype_speedup']}x "
            "(bf16 vs f32 images/sec, both banks in this dir)")
    if ce.get("forwards_per_image"):
        prune = (f", prune rate {100.0 * ce['prune_rate']:.1f}%, "
                 f"{ce['exhaustive_speedup']}x vs exhaustive"
                 if ce.get("prune_rate") is not None else "")
        incr = ""
        fe = ce.get("forward_equivalents_per_image")
        # the annotation marks a genuinely fractional cost, not the two
        # aggregates' different rounding precision
        if fe is not None and fe < ce["forwards_per_image"] - 0.5:
            incr = f" ({fe} full-forward equivalents, incremental)"
        add(f"  certify forwards: {ce['forwards_per_image']} "
            f"executed/image{incr}{prune}")
    if s["mfu"]:
        add(f"  mfu: {s['mfu'].get('mfu')} "
            f"({s['mfu'].get('achieved_tflops')} TFLOP/s achieved)")
    else:
        add("  mfu: n/a (no FLOPs accounting in run.json:telemetry)")
    if s["peak_device_bytes"]:
        add(f"  peak device memory: {_fmt_bytes(s['peak_device_bytes'])}")

    sv = s.get("serve")
    if sv:
        add("-- serve --")
        statuses = ", ".join(f"{k}: {v}" for k, v in sv["by_status"].items())
        add(f"  requests: {sv['requests']} ({statuses})"
            + (f", certify bank {sv['compute_dtype']}"
               if sv.get("compute_dtype") else ""))
        lat = sv["latency_ms"]
        if lat["count"]:
            add(f"  latency: p50 {lat['p50']} ms, p95 {lat['p95']} ms, "
                f"p99 {lat['p99']} ms ({lat['count']} ok)")
        if sv["throughput_rps"] is not None:
            add(f"  throughput: {sv['throughput_rps']} req/sec")
        occ = (f"{100.0 * sv['occupancy']:.1f}%"
               if sv["occupancy"] is not None else "n/a")
        add(f"  batches: {sv['batches']} in {sv['batch_seconds']}s, "
            f"occupancy {occ}, reject rate {100.0 * sv['reject_rate']:.1f}%")
        if sv.get("certify_forwards_per_request"):
            prune = (f", prune rate {100.0 * sv['certify_prune_rate']:.1f}%"
                     if sv.get("certify_prune_rate") is not None else "")
            incr = ""
            fe = sv.get("certify_forward_equivalents_per_request")
            if fe is not None and \
                    fe < sv["certify_forwards_per_request"] - 0.5:
                incr = f" ({fe} full-forward equivalents, incremental)"
            add(f"  certify forwards: "
                f"{sv['certify_forwards_per_request']}/request{incr}{prune}")

    rp = s.get("replicas")
    if rp:
        add("-- replicas --")
        add(f"  pool: {rp['count']} replica(s), {rp['restarts']} restart(s), "
            f"{rp['retired']} retired, "
            f"{rp['failed_over']} request(s) failed over"
            + (f", {rp['drain_timeouts']} drain timeout(s)"
               if rp["drain_timeouts"] else ""))
        for p in rp["per_replica"]:
            sick = (" sick[" + ", ".join(f"{k}: {v}" for k, v
                                         in sorted(p["sick_kinds"].items()))
                    + "]" if p["sick_kinds"] else "")
            restart = ""
            if "restart_s" in p:
                restart = (f" last restart {p['restart_s']}s "
                           f"({p['restart_traces']} trace(s))")
            add(f"  r{p['replica']}: gen {p['generation']}, "
                f"{p['batches']} batch(es), {p['restarts']} restart(s)"
                f"{sick}{restart}"
                + (" RETIRED" if p["retired"] else ""))

    ao = s.get("aot")
    if ao:
        add("-- aot --")
        rate = (f"{100.0 * ao['hit_rate']:.1f}%"
                if ao.get("hit_rate") is not None else "n/a")
        add(f"  executable store: {ao['loads']} load(s), "
            f"{ao['misses']} miss(es), {ao['builds']} build(s), "
            f"hit rate {rate}")
        if ao.get("miss_reasons"):
            add("  miss reasons: " + ", ".join(
                f"{k}: {v}" for k, v in ao["miss_reasons"].items()))
        bo = ao.get("boot")
        if bo:
            add(f"  warm boot [{bo['mode']}]: {bo['boot_s']}s to ready, "
                f"est {bo['saved_s']}s compile time saved")

    bl = s.get("baseline")
    if bl:
        add("-- program baseline --")
        verdict = "clean" if bl.get("clean") else "DRIFTED"
        add(f"  {verdict}: {bl.get('entries', '?')} entry point(s) vs "
            f"{bl.get('baseline_entries', '?')} baselined "
            f"(set {bl.get('fingerprint_set', '?')})")
        by_rule = bl.get("findings_by_rule") or {}
        if by_rule:
            add("  findings: "
                + ", ".join(f"{k}: {v}" for k, v in sorted(by_rule.items())))
            for f in (bl.get("findings") or [])[:8]:
                add(f"  {f.get('rule', '?')} {f.get('message', '')[:110]}")
        db = bl.get("dtype_bytes")
        if db and db.get("ratio") is not None:
            add(f"  bf16 bank: {db['paired_entries']} entry pair(s), "
                f"predicted HBM bytes ratio {db['ratio']} vs f32 twins")
        rows = bl.get("intensity") or []
        if rows:
            # estimated bytes accessed + arithmetic intensity (flops/byte)
            # per heaviest entry: low AI = bandwidth-bound, the programs
            # the Pallas kernel tier targets
            add("  heaviest entries (est bytes, flops/byte):")
            for r in rows:
                add(f"    {r.get('name', '?')}: "
                    f"{r.get('est_bytes', 0) / 1e6:,.1f} MB, "
                    f"AI {r.get('est_ai', 0):.2f}")

    add("-- heartbeats --")
    if not s["heartbeats"]:
        add("  (no heartbeat files)")
    for h in s["heartbeats"]:
        if not h.get("beats"):
            add(f"  {h['file']}: empty")
            continue
        flag = "  ** STALL **" if h.get("stalled") else ""
        exit_ = "clean exit" if h.get("clean_exit") else \
            f"last phase {h.get('last_phase', '')!r}"
        add(f"  {h['file']}: {h['beats']} beats, {exit_}, "
            f"median gap {h.get('median_gap_s')}s, "
            f"max {h.get('max_gap_s')}s{flag}")

    mr = s["metrics_records"]
    add("-- metrics.jsonl --")
    if mr["total"]:
        parts = ", ".join(f"{rid}: {n}" for rid, n in mr["by_attempt"].items())
        add(f"  {mr['total']} records across {len(mr['by_attempt'])} "
            f"attempt(s) ({parts})")
    else:
        add("  (no metrics records)")
    return "\n".join(lines)


# ---------------- cross-process fleet join (--fleet) ----------------


def summarize_fleet_dirs(dirs: List[str]) -> dict:
    """Merge several run/farm/recert dirs into one cross-process view.

    Two joins, both file-only:

    - **trace correlation** — every ingress (HTTP request, farm job claim,
      recert generation begin) records an `opens_trace` event carrying its
      trace id; every downstream record carries the same id (`trace` field,
      or the `traces` list on serve.batch span closes). An opened trace
      that no other record ever mentions is an ORPHAN: work that entered
      the system and left no telemetry of being answered.
    - **counter reconciliation** — the client-side registry snapshot
      (`metrics_client.json` from tools/loadgen.py) against the server-side
      snapshots (`metrics.json` from serve/farm/recert): per-status request
      counts must agree bit-for-bit, and the farm's outcome counters are
      folded in so a fleet that lost work cannot read as healthy.

    When a GATEWAY snapshot is among the dirs (a `metrics.json` carrying
    `gateway_requests_total`), the reconciliation becomes a three-way
    chain instead of the flat client-vs-server check: client counts must
    equal the gateway's per-status books (`kind: "client-gateway"`), and
    the gateway's per-backend response counts must equal the sum of the
    backends' own `serve_requests_total` books (`kind:
    "gateway-backend"`) — gateway-local rejects (fleet `overloaded`)
    live only in the first leg, and a SIGKILLed backend's unresolved
    batch is counted NOWHERE, so both legs stay exact across failover.
    """
    events: List[dict] = []
    event_files = 0
    server_snaps: List[dict] = []
    client_snaps: List[dict] = []
    for d in dirs:
        for root, _dirnames, files in os.walk(d):
            for fname in sorted(files):
                path = os.path.join(root, fname)
                if fname.startswith("events") and fname.endswith(".jsonl"):
                    event_files += 1
                    events.extend(_read_jsonl(path))
                elif fname == "metrics.json":
                    snap = _load_metrics_snapshot(path)
                    if snap is not None:
                        server_snaps.append(snap)
                elif fname == "metrics_client.json":
                    snap = _load_metrics_snapshot(path)
                    if snap is not None:
                        client_snaps.append(snap)

    opened: Dict[str, str] = {}
    closed: set = set()
    for r in events:
        ids = []
        trace = r.get("trace")
        if isinstance(trace, str) and trace:
            ids.append(trace)
        traces = r.get("traces")
        # only a LIST is a trace-id fan-out; `sanitize.retrace` events
        # reuse the key for an integer trace-cache size
        if isinstance(traces, (list, tuple)):
            for t in traces:
                if isinstance(t, str) and t:
                    ids.append(t)
        if not ids:
            continue
        if r.get("opens_trace"):
            for t in ids:
                opened.setdefault(t, str(r.get("name", "?")))
        else:
            closed.update(ids)
    orphans = sorted(t for t in opened if t not in closed)

    server_status = _sum_labeled(server_snaps, "serve_requests_total",
                                 "status")
    client_status = _sum_labeled(client_snaps, "loadgen_requests_total",
                                 "status")
    farm_outcomes = _sum_labeled(server_snaps, "farm_jobs_total", "outcome")
    recert_status = _sum_labeled(server_snaps, "recert_generations_total",
                                 "status")
    gateway_status = _sum_labeled(server_snaps, "gateway_requests_total",
                                  "status")
    gateway_backend_status = _sum_labeled(
        server_snaps, "gateway_backend_responses_total", "status")
    gateway_by_backend = _sum_labeled(
        server_snaps, "gateway_backend_responses_total", "backend")
    rollbacks = _sum_total(server_snaps, "gateway_rollbacks_total")
    autoscale = _sum_labeled(server_snaps, "gateway_autoscale_events_total",
                             "direction")

    checks: List[dict] = []
    if gateway_status:
        # gateway in the fleet: reconcile the chain, one leg at a time
        if client_snaps:
            for status in sorted(set(gateway_status) | set(client_status)):
                client_n = int(client_status.get(status, 0))
                gw_n = int(gateway_status.get(status, 0))
                checks.append({"kind": "client-gateway", "status": status,
                               "client": client_n, "server": gw_n,
                               "ok": client_n == gw_n})
        for status in sorted(set(gateway_backend_status)
                             | set(server_status)):
            gw_n = int(gateway_backend_status.get(status, 0))
            server_n = int(server_status.get(status, 0))
            checks.append({"kind": "gateway-backend", "status": status,
                           "client": gw_n, "server": server_n,
                           "ok": gw_n == server_n})
    elif client_snaps:
        for status in sorted(set(server_status) | set(client_status)):
            client_n = int(client_status.get(status, 0))
            server_n = int(server_status.get(status, 0))
            checks.append({"kind": "client-server", "status": status,
                           "client": client_n, "server": server_n,
                           "ok": client_n == server_n})
    consistent = all(c["ok"] for c in checks) and not orphans
    return {
        "dirs": [os.path.abspath(d) for d in dirs],
        "events_files": event_files,
        "records": len(events),
        "snapshots": {"server": len(server_snaps),
                      "client": len(client_snaps)},
        "traces": {"opened": len(opened), "closed_or_referenced": len(closed),
                   "orphans": orphans,
                   "opened_by_kind": _count_values(opened.values())},
        "requests": {"server_by_status": server_status,
                     "client_by_status": client_status},
        "gateway": {"by_status": gateway_status,
                    "backend_responses_by_status": gateway_backend_status,
                    "by_backend": gateway_by_backend,
                    "rollbacks": rollbacks,
                    "autoscale_by_direction": autoscale},
        "farm_jobs_by_outcome": farm_outcomes,
        "recert_generations_by_status": recert_status,
        "checks": checks,
        "consistent": consistent,
    }


def _load_metrics_snapshot(path: str) -> Optional[dict]:
    try:
        with open(path) as fh:
            snap = json.load(fh)
    except (OSError, ValueError):
        return None
    return snap if isinstance(snap, dict) and "metrics" in snap else None


def _sum_labeled(snaps: List[dict], name: str, label: str) -> Dict[str, int]:
    """Sum one counter's series across snapshots, keyed by `label` value."""
    out: Dict[str, int] = {}
    for snap in snaps:
        for value, count in labeled_values(snap, name, label).items():
            out[value] = out.get(value, 0) + int(count)
    return dict(sorted(out.items()))


def _sum_total(snaps: List[dict], name: str) -> int:
    """Sum one counter's every series across snapshots (label-blind)."""
    total = 0.0
    for snap in snaps:
        metric = (snap or {}).get("metrics", {}).get(name)
        if not isinstance(metric, dict):
            continue
        for s in metric.get("series", ()):
            total += float(s.get("value", 0.0))
    return int(total)


def _count_values(values) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in values:
        out[v] = out.get(v, 0) + 1
    return dict(sorted(out.items()))


def format_fleet_dirs(s: dict) -> str:
    """Human rendering of a `summarize_fleet_dirs()` dict."""
    lines: List[str] = []
    add = lines.append
    add("= DorPatch fleet telemetry report =")
    for d in s["dirs"]:
        add(f"dir: {d}")
    add(f"records: {s['records']} across {s['events_files']} events file(s); "
        f"{s['snapshots']['server']} server / {s['snapshots']['client']} "
        f"client metric snapshot(s)")
    add("-- cross-process --")
    tr = s["traces"]
    kinds = ", ".join(f"{k}: {v}" for k, v in tr["opened_by_kind"].items())
    add(f"  traces opened: {tr['opened']} ({kinds or 'none'})")
    if tr["orphans"]:
        add(f"  !! ORPHANED traces ({len(tr['orphans'])}): work entered but "
            "no other record ever mentioned it")
        for t in tr["orphans"][:8]:
            add(f"     {t}")
    else:
        add("  orphaned traces: 0 — every ingress joined to downstream "
            "telemetry")
    rq = s["requests"]
    if rq["server_by_status"]:
        add("  server requests: " + ", ".join(
            f"{k}: {v}" for k, v in rq["server_by_status"].items()))
    if rq["client_by_status"]:
        add("  client requests: " + ", ".join(
            f"{k}: {v}" for k, v in rq["client_by_status"].items()))
    gw = s.get("gateway") or {}
    if gw.get("by_status"):
        add("  gateway requests: " + ", ".join(
            f"{k}: {v}" for k, v in gw["by_status"].items()))
    if gw.get("by_backend"):
        add("  gateway responses by backend: " + ", ".join(
            f"{k}: {v}" for k, v in gw["by_backend"].items()))
    if gw.get("by_status") or gw.get("rollbacks"):
        add(f"  gateway rollbacks: {gw.get('rollbacks', 0)}")
    if gw.get("autoscale_by_direction"):
        add("  gateway autoscale signals: " + ", ".join(
            f"{k}: {v}" for k, v in gw["autoscale_by_direction"].items()))
    for c in s["checks"]:
        verdict = "ok" if c["ok"] else "MISMATCH"
        kind = c.get("kind", "client-server")
        left, right = (kind.split("-") + ["server"])[:2]
        add(f"  [{verdict:>8}] {kind} {c['status']}: {left} {c['client']} "
            f"vs {right} {c['server']}")
    if s["farm_jobs_by_outcome"]:
        add("  farm jobs: " + ", ".join(
            f"{k}: {v}" for k, v in s["farm_jobs_by_outcome"].items()))
    if s["recert_generations_by_status"]:
        add("  recert generations: " + ", ".join(
            f"{k}: {v}" for k, v in
            s["recert_generations_by_status"].items()))
    add("  consistent: " + ("yes" if s["consistent"] else "NO"))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dorpatch_tpu_torch.observe.report",
        description="Offline telemetry report for a DorPatch results dir")
    p.add_argument("result_dir", nargs="?", default=None,
                   help="results dir holding run.json / "
                        "events.jsonl / metrics.jsonl / "
                        "heartbeat_*.jsonl")
    p.add_argument("--fleet", nargs="+", metavar="DIR",
                   help="merge several run/farm/recert dirs: cross-process "
                        "trace correlation + client/server counter "
                        "reconciliation")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable summary instead of text")
    p.add_argument("--stall-factor", type=float, default=5.0,
                   help="heartbeat gap > factor x median interval = stall")
    args = p.parse_args(argv)

    if args.fleet:
        bad = [d for d in args.fleet if not os.path.isdir(d)]
        if bad:
            print(f"not a directory: {', '.join(bad)}")
            return 2
        fleet = summarize_fleet_dirs(args.fleet)
        try:
            if args.json:
                print(json.dumps(fleet, indent=1, default=float))
            else:
                print(format_fleet_dirs(fleet))
        except BrokenPipeError:
            return 0
        return 0 if fleet["consistent"] else 1
    if args.result_dir is None:
        p.error("result_dir is required unless --fleet is given")
    if not os.path.isdir(args.result_dir):
        print(f"not a directory: {args.result_dir}")
        return 2
    # a recert dir (marked by recert_state.json) gets the re-certification
    # report: scheduler status + the latest verdict; lazy, host-only import
    if os.path.exists(os.path.join(args.result_dir, "recert_state.json")):
        from dorpatch_tpu_torch.checkpoint import load_json
        from dorpatch_tpu_torch.recert.scheduler import RecertScheduler

        sched = RecertScheduler(args.result_dir)
        st = sched.status()
        verdict = load_json(sched.verdict_path)
        try:
            if args.json:
                print(json.dumps({"status": st, "verdict": verdict},
                                 indent=1, default=float))
            else:
                print(_format_recert_report(
                    st, verdict if isinstance(verdict, dict) else None))
        except BrokenPipeError:
            return 0
        return 0
    # a farm dir (marked by farm.json) gets the fleet-level report; the
    # import is lazy and farm.report is host-only, same contract as here
    farm_marker = os.path.join(args.result_dir, "farm.json")
    if os.path.exists(farm_marker):
        from dorpatch_tpu_torch.farm.report import (format_fleet_report,
                                                    summarize_fleet)

        fleet = summarize_fleet(args.result_dir)
        try:
            if args.json:
                print(json.dumps(fleet, indent=1, default=float))
            else:
                print(format_fleet_report(fleet))
        except BrokenPipeError:
            return 0
        return 0
    s = summarize(args.result_dir, stall_factor=args.stall_factor)
    if not s["manifest"] and not s["attempts"] and not s["heartbeats"] \
            and not s["metrics_records"]["total"]:
        print(f"no telemetry files under {args.result_dir} "
              f"(expected {MANIFEST_NAME} / events.jsonl / metrics.jsonl / "
              "heartbeat_*.jsonl)")
        return 2
    try:
        if args.json:
            print(json.dumps(s, indent=1, default=float))
        else:
            print(format_report(s))
    except BrokenPipeError:
        return 0  # `report ... | head` is a legitimate way to read this
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
