"""Build/verify/ls/gc behind `python -m dorpatch_tpu_torch.aot`.

Port of `dorpatch_tpu.aot.build`. `build` is the deploy-time half of the
warm-boot story: enumerate `production_entrypoints()`, gate on the program
baseline (`baseline.check_entrypoints` over the registry built on the CPU,
as `baselines.json` was recorded: a store built from a drifted tree must
not exist — the refusal comes before anything is run or written), then
build the registry anew on the device, write the kernel library once as a
sha-verified blob and one entry a program: its baseline fingerprint and
interface hash (the gate's own records, so the store and `baselines.json`
hold one key: where a program's recorded call, which a boot keys it by,
renders another fingerprint, the entry records it as
`recorded_fingerprint` and the build names it — a boot would miss it),
the seconds of its cold first call on example inputs made from a seed, and
its method — `cuda_graph` when a capture replays bit-equal to that call,
else `eager` with the reason (`capture:<Error>`, `replay_differs`, `cpu`).

Exit codes mirror `dorpatch_tpu_torch.analysis`: 0 clean, 1
findings/refusal, 2 usage error.
"""

from __future__ import annotations

import fnmatch
import sys
import time
from typing import List, Optional

from dorpatch_tpu_torch.aot.store import ExecutableStore

#: the seed of the example inputs a build runs each program on
EXAMPLE_SEED = 0


def _err(msg: str) -> None:
    sys.stderr.write(msg + "\n")


def _load_baseline(baseline_file: str):
    from dorpatch_tpu_torch.analysis import baseline as baseline_mod

    path = baseline_file or baseline_mod.baseline_path()
    data = baseline_mod.load_baseline(path)
    if data is None:
        _err(
            f"aot: cannot read baseline file {str(path)!r} — run "
            "`python -m dorpatch_tpu_torch.analysis --baseline update` first"
        )
    return path, data


def example_inputs(tree, seed: int = EXAMPLE_SEED):
    """Real inputs for a program's example arguments (fake tensors): each
    floating tensor uniform in [0, 1) from one seeded generator, every
    other tensor zeros (valid indices and flags), each on its own device
    with its own strides; a generator becomes a new one on its device with
    the same seed."""
    import torch

    from dorpatch_tpu_torch.aot.boot import _map

    gen = torch.Generator().manual_seed(int(seed))

    def real(x):
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.manual_seed(x.initial_seed())
            return g
        out = torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                  dtype=x.dtype, device=x.device)
        if x.dtype.is_floating_point:
            vals = torch.rand(tuple(x.shape), generator=gen)
            out.copy_(vals)
        else:
            out.zero_()
        return out

    return _map(real, tree)


def build_store(store_dir: str, baseline_file: str = "",
                only: Optional[List[str]] = None, fmt: str = "human",
                entrypoints_spec: str = "", device: str = "cuda") -> int:
    """Materialize every production program on `device` into
    ``store_dir`` (refused, with nothing written, on baseline drift)."""
    import torch

    from dorpatch_tpu_torch import utils
    from dorpatch_tpu_torch.analysis import baseline as baseline_mod
    from dorpatch_tpu_torch.analysis import entrypoints as ep_mod
    from dorpatch_tpu_torch.analysis.cli import _load_entrypoints, emit
    from dorpatch_tpu_torch.aot import boot

    path, data = _load_baseline(baseline_file)
    if data is None:
        return 2
    dev = utils.resolve_device(device)
    utils.configure_numerics()
    # the gate's registry: built on the CPU, as baselines.json was recorded
    loaded = _load_entrypoints(entrypoints_spec)
    if loaded is None:
        return 2
    eps, budgets, ladders, _uncovered = loaded
    # refusal gate: the live tree must match the baseline before a single
    # program runs or an entry is written
    live: dict = {}
    findings = baseline_mod.check_entrypoints(eps, data, budgets, ladders,
                                              live_out=live)
    if findings:
        emit(findings, fmt)
        _err(
            f"aot build REFUSED: --baseline check failed with "
            f"{len(findings)} finding(s) against {path}; nothing written. "
            "Fix the drift or regenerate the baseline, then rebuild."
        )
        return 1

    # the programs that run: the same registry built anew on the device
    # (the gate's was traced, and a traced program's state is fake)
    with ep_mod.registry_device(dev):
        ran = {ep.name: ep for ep in _load_entrypoints(entrypoints_spec)[0]}
    store = ExecutableStore(store_dir, check_env=False, device=dev)
    store.manifest = {"version": 1, "env": None, "entries": {}}
    store.env_reason = None
    cuda = dev.type == "cuda"
    if cuda:
        from dorpatch_tpu_torch.ops import _build

        _build.library()
    built, methods, split = 0, {}, []
    for ep in eps:
        if only and not any(fnmatch.fnmatch(ep.name, g) for g in only):
            continue
        live_ep = ran[ep.name]
        args = example_inputs(tuple(live_ep.args))
        kwargs = example_inputs(dict(live_ep.kwargs))
        run = boot._recorded_call(live_ep.fn, args, kwargs,
                                  time.perf_counter)
        t0 = time.perf_counter()
        # a pool a program: nothing of one program's graph is kept for the
        # next (the build records how each materializes, and drops it)
        ex = boot._materialize(live_ep.fn, args, kwargs, run,
                               boot._Pool() if cuda else None)
        capture_s = time.perf_counter() - t0
        extra = {"capture_s": round(capture_s, 6)}
        if ex.method == "eager":
            extra["reason"] = ex.reason
            if ex.detail:
                extra["detail"] = ex.detail
        snap = live[ep.name]
        # one key: a boot looks a program up by its recorded call, so an
        # entry whose record is not the gate's trace would never hit
        if (run.fingerprint, run.interface_sha) != (
                snap["fingerprint"], snap["interface"]["sha"]):
            extra["recorded_fingerprint"] = run.fingerprint
            extra["recorded_interface_sha"] = run.interface_sha
            split.append(ep.name)
        store.put(ep.name, snap["fingerprint"], snap["interface"]["sha"],
                  ex.method, b"", run.seconds, **extra)
        methods[ex.method] = methods.get(ex.method, 0) + 1
        built += 1
        del ex, run, args, kwargs
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        store.put_kernels(str(_build.library_path()))
    store.stamp_baseline(
        baseline_mod.fingerprint_set_hash(data.get("entries", {})), path
    )
    store.save()
    _err(
        f"aot build: {built} program(s) -> {store.store_dir} "
        f"(state {store.state_hash()}; "
        + ", ".join(f"{k} {v}" for k, v in sorted(methods.items())) + ")"
        + (f"; recorded call not the trace, a boot would miss: "
           f"{', '.join(split)}" if split else "")
    )
    return 0


def verify_store(store_dir: str, baseline_file: str = "",
                 fmt: str = "human") -> int:
    path, data = _load_baseline(baseline_file)
    if data is None:
        return 2
    from dorpatch_tpu_torch.analysis.cli import emit

    store = ExecutableStore(store_dir, check_env=False)
    findings = store.verify_against(data)
    if findings:
        emit(findings, fmt)
        _err(f"aot verify: {len(findings)} DP305 finding(s) against {path}")
        return 1
    _err(
        f"aot verify: OK — {len(store.entries())} entr(ies) consistent "
        f"with {path} (state {store.state_hash()})"
    )
    return 0


def ls_store(store_dir: str, as_json: bool = False) -> int:
    import json

    store = ExecutableStore(store_dir, check_env=False)
    if as_json:
        sys.stdout.write(
            json.dumps(
                {
                    "store": store.store_dir,
                    "state": store.state_hash(),
                    "env": store.manifest.get("env"),
                    "kernels": store.kernels(),
                    "entries": store.entries(),
                },
                indent=2,
                sort_keys=True,
            )
            + "\n"
        )
        return 0
    env = store.manifest.get("env") or {}
    kern = store.kernels() or {}
    sys.stdout.write(
        f"store {store.store_dir}  state {store.state_hash()}  "
        f"env torch={env.get('torch')} cuda={env.get('cuda')} "
        f"backend={env.get('backend')} topology={env.get('topology')}  "
        f"kernels={kern.get('payload', '-')} "
        f"{kern.get('payload_bytes', 0)}B\n"
    )
    for name, e in sorted(store.entries().items()):
        why = f" ({e['reason']})" if e.get("reason") else ""
        if e.get("recorded_fingerprint"):
            why += f"  recorded={e['recorded_fingerprint']} (a boot misses)"
        sys.stdout.write(
            f"  {name}  fp={e.get('fingerprint')}  "
            f"iface={e.get('interface_sha')}  method={e.get('method')}{why}  "
            f"first={e.get('build_compile_s', 0.0):.3f}s  "
            f"capture={e.get('capture_s', 0.0):.3f}s\n"
        )
    return 0


def gc_store(store_dir: str, baseline_file: str = "") -> int:
    path, data = _load_baseline(baseline_file)
    if data is None:
        return 2
    store = ExecutableStore(store_dir, check_env=False)
    removed = store.gc(data.get("entries", {}))
    store.save()
    _err(
        f"aot gc: removed {len(removed)} entr(ies) whose fingerprint left "
        f"{path}" + (f": {', '.join(removed)}" if removed else "")
    )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m dorpatch_tpu_torch.aot",
        description=(
            "AOT executable store: build at deploy time, warm-boot at "
            "serve time (README 'AOT executable store')."
        ),
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--store", required=True,
                       help="store directory (manifest.json + blobs/)")

    pb = sub.add_parser("build", help="materialize every production "
                        "program (refuses on baseline drift)")
    common(pb)
    pb.add_argument("--baseline-file", default="",
                    help="override analysis/baselines.json")
    pb.add_argument("--only", action="append", default=[],
                    help="fnmatch glob over entry names (repeatable)")
    pb.add_argument("--entrypoints", default="",
                    help="module:callable override for the registry loader")
    pb.add_argument("--format", choices=("human", "json"), default="human")
    pb.add_argument("--device", default="cuda",
                    help="device the programs run and are captured on "
                         "('cuda', the default, or 'cpu' on request)")

    pv = sub.add_parser("verify", help="DP305 drift check: store manifest "
                        "vs analysis/baselines.json")
    common(pv)
    pv.add_argument("--baseline-file", default="")
    pv.add_argument("--format", choices=("human", "json"), default="human")

    pl = sub.add_parser("ls", help="list store entries")
    common(pl)
    pl.add_argument("--json", action="store_true")

    pg = sub.add_parser("gc", help="drop entries whose fingerprint left "
                        "baselines.json")
    common(pg)
    pg.add_argument("--baseline-file", default="")

    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if args.cmd == "build":
        return build_store(args.store, args.baseline_file, args.only,
                           args.format, args.entrypoints, args.device)
    if args.cmd == "verify":
        return verify_store(args.store, args.baseline_file, args.format)
    if args.cmd == "ls":
        return ls_store(args.store, args.json)
    if args.cmd == "gc":
        return gc_store(args.store, args.baseline_file)
    return 2


__all__ = ["build_store", "verify_store", "ls_store", "gc_store", "main",
           "example_inputs"]
