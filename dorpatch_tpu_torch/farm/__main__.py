"""`python -m dorpatch_tpu_torch.farm`: the farm's operator surface.

- ``submit <farm_dir> --spec spec.json``  expand the grid into job dirs
- ``work   <farm_dir> [--chaos ...]``     run one worker until drained
- ``status <farm_dir>``                   one JSON line of queue counts
- ``report <farm_dir> [--json]``          the fleet report

Port of `dorpatch_tpu.farm.__main__`, plus `work --device` ("cuda" unless
"cpu" is asked for). `work --aot-store DIR [--aot auto|off]` resolves the
jobs' programs from an executable store, read-only (`aot/`). `report` renders
`report.format_fleet_report` itself (the JAX package hands it to its
`observe.report`, which reads a port farm directory too).

Run:  python -m dorpatch_tpu_torch.farm submit FARM --spec spec.json
      python -m dorpatch_tpu_torch.farm work FARM [--device cpu]
      python -m dorpatch_tpu_torch.farm report FARM
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.config import FarmConfig
from dorpatch_tpu_torch.farm.queue import JobQueue


def build_parser() -> argparse.ArgumentParser:
    fc = FarmConfig()
    p = argparse.ArgumentParser(
        prog="python -m dorpatch_tpu_torch.farm",
        description="Fault-tolerant attack-sweep farm over a shared "
                    "farm directory")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("submit", help="expand a grid spec into jobs")
    ps.add_argument("farm_dir")
    ps.add_argument("--spec", required=True,
                    help="JSON: {base: partial config dict, axes: {dotted "
                         "param: [values]}, sweep: {...}, max_attempts: N}")

    pw = sub.add_parser("work", help="claim and run jobs until drained")
    pw.add_argument("farm_dir")
    pw.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the jobs run: the GPU (default) or, on "
                         "request, the CPU with the kernels' plain versions")
    pw.add_argument("--worker-id", default=None)
    pw.add_argument("--lease-ttl", type=float, default=fc.lease_ttl)
    pw.add_argument("--poll-interval", type=float, default=fc.poll_interval)
    pw.add_argument("--heartbeat-interval", type=float,
                    default=fc.heartbeat_interval)
    pw.add_argument("--backoff-base", type=float, default=fc.backoff_base)
    pw.add_argument("--backoff-cap", type=float, default=fc.backoff_cap)
    pw.add_argument("--backoff-jitter", type=float,
                    default=fc.backoff_jitter)
    pw.add_argument("--max-jobs", type=int, default=None,
                    help="stop after handling this many jobs")
    pw.add_argument("--chaos", default=fc.chaos,
                    help="comma-joined fault list: crash_block, ckpt_raise, "
                         "wedge_heartbeat, enospc_events")
    pw.add_argument("--crash-mode", choices=["kill", "raise"],
                    default="kill",
                    help="crash_block dies by SIGKILL (kill) or by a "
                         "catchable SimulatedPreemption (raise)")
    pw.add_argument("--aot-store", default="",
                    help="shared AOT executable store (read-only): a "
                         "program's first call of a signature is looked up "
                         "by fingerprint and, on a hit, replays a captured "
                         "CUDA graph from then on, so reclaimed jobs resume "
                         "warm ('' = disabled)")
    pw.add_argument("--aot", choices=["off", "auto"], default="auto",
                    help="warm-boot mode with --aot-store (workers never "
                         "write the store; 'auto' here means "
                         "load-what-hits, run the rest as without a store)")

    pst = sub.add_parser("status", help="queue counts as one JSON line")
    pst.add_argument("farm_dir")

    pr = sub.add_parser("report", help="fleet-level report")
    pr.add_argument("farm_dir")
    pr.add_argument("--json", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "submit":
        with open(args.spec) as fh:
            spec = json.load(fh)
        ids = JobQueue(args.farm_dir).submit_spec(spec)
        observe.log(json.dumps({"farm_dir": args.farm_dir,
                                "jobs": len(ids)}))
        return 0
    if args.cmd == "work":
        from dorpatch_tpu_torch.farm.worker import FarmWorker

        worker = FarmWorker(
            args.farm_dir, worker_id=args.worker_id,
            lease_ttl=args.lease_ttl, poll_interval=args.poll_interval,
            heartbeat_interval=args.heartbeat_interval,
            backoff_base=args.backoff_base, backoff_cap=args.backoff_cap,
            backoff_jitter=args.backoff_jitter, chaos=args.chaos,
            crash_mode=args.crash_mode, device=args.device,
            aot_store=args.aot_store, aot_mode=args.aot)
        summary = worker.run(max_jobs=args.max_jobs)
        observe.log(json.dumps(summary))
        return 0
    if args.cmd == "status":
        observe.log(json.dumps(JobQueue(args.farm_dir).counts()))
        return 0
    from dorpatch_tpu_torch.farm.report import (format_fleet_report,
                                                summarize_fleet)

    fleet = summarize_fleet(args.farm_dir)
    if fleet is None:
        observe.log(f"{args.farm_dir} is not a farm directory (no farm.json)")
        return 1
    print(json.dumps(fleet, indent=1, default=float) if args.json  # noqa: DP101 — the report on stdout is in-contract
          else format_fleet_report(fleet))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
