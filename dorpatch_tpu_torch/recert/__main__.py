"""`python -m dorpatch_tpu_torch.recert` — the re-certification operator
surface.

- ``schedule <dir> --spec spec.json``  begin (or resume) a generation:
  commit the inflight record, submit the grid to the generation's farm
  dir, return — external farm workers drain it
  (``python -m dorpatch_tpu_torch.farm work <dir>/gen_NNNN``)
- ``run <dir> [--spec ...]``           one full cycle in-process: begin or
  resume, drain (in-process worker by default, or poll for external
  workers with ``--external-workers``), harvest, check, publish verdict
- ``check <dir>``                      re-check the newest completed
  generation against the current baseline (exit 1 on DP400-DP402)
- ``update <dir> [--allow-remove]``    fold the newest completed
  generation into the baseline file (refuses to drop entries without
  ``--allow-remove``)
- ``status <dir>``                     one JSON line of scheduler state

Findings go to stdout (`--format json` for one JSON object per line),
the human summary to stderr, exit 0/1/2 — the exit contract
of the JAX package's `python -m dorpatch_tpu.analysis`.

Port of `dorpatch_tpu.recert.__main__`, the same subcommands, flags and
exit codes. `run` also takes `--device` (the in-process farm worker's
device: "cuda" unless "cpu" is asked for, as `farm work` has it). Give
every command `--baseline-file` unless the package's own
`recert/robustness_baseline.json` is meant: `run --update-baseline` and
`update` write that file.

    python -m dorpatch_tpu_torch.recert run "$TMPDIR"/recert \
        --spec spec.json --baseline-file "$TMPDIR"/rb.json \
        --update-baseline --device cpu
    python -m dorpatch_tpu_torch.recert check "$TMPDIR"/recert \
        --baseline-file "$TMPDIR"/rb.json

Importing this module, and `--help`, `--list-rules`, `status`, `check`,
`schedule` and `update`, load no torch: only `run`'s in-process worker
loads the model stack.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.analysis.cli import emit
from dorpatch_tpu_torch.recert.baseline import RECERT_RULE_IDS, RECERT_RULE_ROWS
from dorpatch_tpu_torch.recert.scheduler import RecertError, RecertScheduler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dorpatch_tpu_torch.recert",
        description="Continuous re-certification: grid generations on the "
                    "farm, checked against the adversarial regression "
                    "baseline (DP400-DP402)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("recert_dir")
        sp.add_argument("--baseline-file", default="",
                        help="baseline file override (default: the "
                             "package's recert/robustness_baseline.json)")

    ps = sub.add_parser("schedule",
                        help="begin or resume a generation (submit only)")
    common(ps)
    ps.add_argument("--spec", default="",
                    help="JSON file: the farm grid spec {base, axes, sweep, "
                         "max_attempts} (optional when resuming)")

    pr = sub.add_parser("run", help="one full cycle: begin/resume, drain, "
                                    "harvest, check, publish verdict")
    common(pr)
    pr.add_argument("--spec", default="")
    pr.add_argument("--cycles", type=int, default=1,
                    help="run N back-to-back generations (default 1)")
    pr.add_argument("--update-baseline", action="store_true",
                    help="fold each completed generation's measurements "
                         "into the baseline file before checking")
    pr.add_argument("--external-workers", action="store_true",
                    help="do not run an in-process worker; poll until "
                         "external farm workers drain the generation")
    pr.add_argument("--poll-interval", type=float, default=0.5)
    pr.add_argument("--timeout", type=float, default=None,
                    help="give up waiting for drain after this many "
                         "seconds (exit 2)")
    pr.add_argument("--worker-id", default="recert-w0")
    pr.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the in-process worker runs the jobs: the "
                         "GPU (default) or, on request, the CPU with the "
                         "kernels' plain versions")
    pr.add_argument("--lease-ttl", type=float, default=30.0)
    pr.add_argument("--chaos", default="",
                    help="comma-joined scheduler faults: recert_kill_cycle "
                         "(SIGKILL after submit), recert_torn_state (tear "
                         "recert_state.json after submit)")
    pr.add_argument("--worker-chaos", default="",
                    help="comma-joined farm faults for the in-process "
                         "worker (crash_block, ckpt_raise, ...)")
    pr.add_argument("--crash-mode", choices=["kill", "raise"],
                    default="kill")
    pr.add_argument("--format", choices=("human", "json"), default="human")

    pc = sub.add_parser("check", help="re-check the newest completed "
                                      "generation against the baseline")
    common(pc)
    pc.add_argument("--select", default="",
                    help="comma-separated rule IDs (DP400,DP401,DP402)")
    pc.add_argument("--format", choices=("human", "json"), default="human")

    pu = sub.add_parser("update", help="fold the newest completed "
                                       "generation into the baseline")
    common(pu)
    pu.add_argument("--allow-remove", action="store_true",
                    help="accept dropping baseline entries that are no "
                         "longer in the grid (refused otherwise)")

    pst = sub.add_parser("status", help="scheduler state as one JSON line")
    common(pst)

    p.add_argument("--list-rules", action="store_true",
                   help="print the DP4xx rule table and exit")
    return p


def _scheduler(args, chaos=None) -> RecertScheduler:
    return RecertScheduler(args.recert_dir,
                           baseline_file=args.baseline_file, chaos=chaos)


def _parse_select(raw: str) -> Optional[List[str]]:
    if not raw:
        return None
    select = [s.strip().upper() for s in raw.split(",") if s.strip()]
    bad = set(select) - set(RECERT_RULE_IDS)
    if bad:
        sys.stderr.write(
            f"rule id(s) not in the recert wing: {sorted(bad)} "
            f"(have {', '.join(RECERT_RULE_IDS)})\n")
        return ["<usage-error>"]
    return select


def _load_spec(path: str) -> Optional[dict]:
    if not path:
        return None
    with open(path) as fh:
        return json.load(fh)


def _finish(findings, verdict, generation: int, fmt: str) -> int:
    emit(findings, fmt)
    if findings:
        sys.stderr.write(
            f"{len(findings)} recert finding(s) for generation "
            f"{generation} (status: {verdict['status']}). Accept an "
            "intentional shift with `python -m dorpatch_tpu_torch.recert "
            "update`, or a reasoned recert.ALLOWLIST entry.\n")
        return 1
    sys.stderr.write(
        f"recert check: generation {generation} clean against "
        f"{verdict['baseline_file']} "
        f"({len(verdict.get('cells', {}))} cell(s))\n")
    return 0


def _run_cycles(args) -> int:
    chaos = None
    if args.chaos:
        from dorpatch_tpu_torch.chaos import Chaos, parse_faults

        chaos = Chaos(parse_faults(args.chaos), job_id="recert",
                      state_dir=args.recert_dir, crash_mode=args.crash_mode)
    sched = _scheduler(args, chaos=chaos)
    rc = 0
    for _ in range(max(1, args.cycles)):
        generation, farm_dir = sched.begin_generation(_load_spec(args.spec))
        observe.log(json.dumps({"recert": "begin", "generation": generation,
                                "farm_dir": farm_dir}))
        if args.external_workers:
            if not sched.wait_drained(farm_dir,
                                      poll_interval=args.poll_interval,
                                      timeout=args.timeout):
                sys.stderr.write(
                    f"generation {generation} not drained within "
                    f"{args.timeout}s\n")
                return 2
        else:
            from dorpatch_tpu_torch.farm.worker import FarmWorker  # lazy: models

            FarmWorker(farm_dir, worker_id=args.worker_id,
                       lease_ttl=args.lease_ttl,
                       poll_interval=args.poll_interval,
                       chaos=args.worker_chaos,
                       crash_mode=args.crash_mode,
                       device=args.device).run()
            if not sched.drained(farm_dir):
                sys.stderr.write(
                    f"generation {generation} worker exited but farm not "
                    "drained\n")
                return 2
        verdict = sched.complete_generation(
            generation, farm_dir, update_baseline=args.update_baseline)
        findings_n = len(verdict.get("findings", []))
        observe.log(json.dumps({
            "recert": "complete", "generation": generation,
            "status": verdict["status"],
            "worst_margin": verdict.get("worst_margin"),
            "findings": findings_n}))
        if findings_n:
            rc = 1
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    argv = list(argv) if argv is not None else sys.argv[1:]
    if "--list-rules" in argv:
        for rid, name, desc in RECERT_RULE_ROWS:
            sys.stdout.write(f"{rid}  {name}: {desc}\n")
        return 0
    args = parser.parse_args(argv)
    try:
        if args.cmd == "schedule":
            sched = _scheduler(args)
            generation, farm_dir = sched.begin_generation(
                _load_spec(args.spec))
            observe.log(json.dumps({
                "recert": "scheduled", "generation": generation,
                "farm_dir": farm_dir, "counts": sched.counts(farm_dir)}))
            return 0
        if args.cmd == "run":
            return _run_cycles(args)
        if args.cmd == "check":
            select = _parse_select(args.select)
            if select == ["<usage-error>"]:
                return 2
            generation, findings, verdict = _scheduler(args).check_latest(
                select=select)
            return _finish(findings, verdict, generation, args.format)
        if args.cmd == "update":
            summary = _scheduler(args).update_from_latest(
                allow_remove=args.allow_remove)
            observe.log(json.dumps(summary))
            sys.stderr.write(
                f"recert update: folded {summary['folded']} cell(s) from "
                f"generation {summary['generation']} -> "
                f"{summary['baseline_file']} "
                f"({summary['entries']} entr(ies)"
                + (f", removed {len(summary['removed'])}"
                   if summary["removed"] else "")
                + ")\n")
            return 0
        # status
        observe.log(json.dumps(_scheduler(args).status(), sort_keys=True))
        return 0
    except RecertError as e:
        sys.stderr.write(f"recert {args.cmd}: {e}\n")
        return 2 if args.cmd in ("schedule", "run", "check", "status") else 1


if __name__ == "__main__":
    raise SystemExit(main())
