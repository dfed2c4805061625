#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`dorpatch_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. prints the environment and the card (nvidia-smi name, power limit);
   exits nonzero without a CUDA device;
2. builds the CUDA kernels from `dorpatch_tpu_torch/csrc` (nvcc, sm_90a);
3. holds every kernel against its plain PyTorch version on the card at the
   main path's shapes and times both (median over REPS warmed
   repetitions; a repetition replays a CUDA graph of INNER calls,
   bracketed by synchronizes, so host launch cost is not counted);
4. runs the main path through its user entry point: the CLI flags
   `--synthetic --dataset cifar10 --base_arch resnet18 --img-size 32 -b 8
   --sampling-size 128 --dropout 2 --max-iterations 20 --num-batches 1`
   (full-width CIFAR ResNet-18, random weights from the seed; certification
   at the four radii with prune="exact", incremental="auto" -> stem),
   with every kernel's launch count set to 0 just before and read just
   after; fails if a kernel of the path was not launched;
5. certifies one radius both ways (stem fold = kernel C, and full masked
   forwards = kernel A) and asserts the first-round tables agree wherever
   both top-2 margins exceed 1e-3;
6. prints the per-kernel JSON line, the nvidia-smi line and, last,
   `{"ok": true, "device": {...}}`.

Any failed phase raises: the script then exits nonzero and prints no
result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
#: float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12

INNER, REPS = 20, 15                 # calls per timed graph, timed graphs

TOL_B = dict(rtol=1e-5, atol=1e-6)   # summation order over S
TOL_C = 1e-4                         # summation order of the delta conv


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _device_ms(fn, inner: int = INNER, reps: int = REPS) -> float:
    """Median device milliseconds of one `fn()` call: a CUDA graph of
    `inner` calls is replayed `reps` times, each replay bracketed by
    synchronizes and timed with CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """(least milliseconds, what bounds it) for the bytes a call must move
    and the operations it must do."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phases(torch, dev):
    """Kernels A, B, C against their plain versions at the main path's
    shapes. Returns the per-kernel records (launches filled in later)."""
    import numpy as np

    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.models.registry import get_model, normalize
    from dorpatch_tpu_torch.ops import masked_fill as mf
    from dorpatch_tpu_torch.ops import stem_fold as sf

    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    b, size, fill = 8, 32, 0.5
    universe = masks_lib.dropout_universe(size, 2)
    imgs = torch.as_tensor(rng.uniform(0, 1, (b, size, size, 3)),
                           dtype=torch.float32, device=dev)
    out = []

    # -- A: fill forward at the attack step (S=128), sweep (S=126) and the
    #    certification pair audit (S=63 of a 630-pair chunking) --
    for s in (128, 126, 63):
        rects = torch.as_tensor(universe[rng.choice(len(universe), s, False)],
                                device=dev)
        got = mf.masked_fill_fwd_kernel(imgs, rects, fill)
        want = mf.masked_fill_reference(imgs, rects, fill)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel A differs from its plain version "
                                 f"at S={s}")
    rects = torch.as_tensor(universe[rng.choice(len(universe), 128, False)],
                            device=dev)
    hwc = size * size * 3
    s, k = rects.shape[0], rects.shape[1]
    a_err = float((mf.masked_fill_fwd_kernel(imgs, rects, fill)
                   - mf.masked_fill_reference(imgs, rects, fill))
                  .abs().max())
    a_ms = _device_ms(lambda: mf.masked_fill_fwd_kernel(imgs, rects, fill))
    a_plain = _device_ms(lambda: mf.masked_fill_reference(imgs, rects, fill))
    bound, by = _bound(4 * b * hwc + 16 * s * k + 4 * b * s * hwc, 0.0)
    out.append(dict(name="masked_fill_fwd", route="cuda",
                    source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                    replaces="dorpatch_tpu/ops/masked_fill.py:53",
                    launches=0, max_abs_err=a_err, ms=a_ms, plain_ms=a_plain,
                    bound_ms=bound, bound_by=by, library_ms=None))
    print(f"kernel A masked_fill_fwd [B={b},S={s},K={k},{size}x{size}x3]: "
          f"exact, max_abs_err {a_err:.3g}, {a_ms * 1e3:.2f} us "
          f"(plain {a_plain * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
          f"by {by})", flush=True)

    # -- B: fill backward at the attack step --
    g = torch.as_tensor(rng.standard_normal((b, s, size, size, 3)),
                        dtype=torch.float32, device=dev)

    def plain_grad(dtype):
        x = imgs.to(dtype).requires_grad_(True)
        (gx,) = torch.autograd.grad(
            mf.masked_fill_reference(x, rects, fill), x, g.to(dtype))
        return gx.float()

    # the reference is autograd of the plain version in float64: the f32
    # autograd sums 128 signed unit-variance terms with its own rounding
    # (reported beside it), which alone can exceed atol 1e-6
    want = plain_grad(torch.float64)
    got = mf.masked_fill_bwd_kernel(rects, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL_B)
    b_err = float((got - want).abs().max())
    b_err32 = float((got - plain_grad(torch.float32)).abs().max())
    keep = masks_lib.rasterize(rects, size)[None, :, :, :, None]
    zero = torch.zeros((), device=dev)
    b_ms = _device_ms(lambda: mf.masked_fill_bwd_kernel(rects, g))
    b_plain = _device_ms(lambda: torch.where(keep, g, zero).sum(1))
    bound, by = _bound(4 * b * s * hwc + 16 * s * k + 4 * b * hwc,
                       float(b * s * hwc), PEAK_F64_FLOPS)
    out.append(dict(name="masked_fill_bwd", route="cuda",
                    source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                    replaces="dorpatch_tpu/ops/masked_fill.py:66",
                    launches=0, max_abs_err=b_err, ms=b_ms, plain_ms=b_plain,
                    bound_ms=bound, bound_by=by, library_ms=None))
    print(f"kernel B masked_fill_bwd [B={b},S={s}]: max_abs_err {b_err:.3g} "
          f"vs float64 autograd of the plain version (rtol {TOL_B['rtol']}, "
          f"atol {TOL_B['atol']}); {b_err32:.3g} vs float32 autograd, "
          f"{b_ms * 1e3:.2f} us (plain where+sum {b_plain * 1e3:.2f} us, "
          f"bound {bound * 1e3:.2f} us by {by})", flush=True)

    # -- C: stem fold, one phase-1 chunk (3 masks) of the 0.12 radius on
    #    the full-width CIFAR ResNet-18 stem --
    victim = get_model("cifar10", "resnet18", "/nonexistent", size, seed=0,
                       device=dev)
    eng = victim.incremental
    spec = masks_lib.geometry(size, 0.12)
    singles, _ = masks_lib.mask_sets(spec)
    plan = sf.plan_windows(singles, size, eng.kernel_hw, 1, eng.pads)
    n_chunk = 3
    part = plan[:n_chunk]
    with torch.no_grad():
        clean = eng.module(normalize(imgs), "stem").contiguous()
        u = eng.norm_scale * (fill - imgs)
        kern = eng.kernel_fn().contiguous()
        up = sf.pad_for_kernel(u, eng.pads, 1)
        oh, ow, geo_np, occ_np = sf._uniform_plan(part, size, size, 3, 1)
        geo = torch.as_tensor(geo_np, device=dev)
        occ = torch.as_tensor(occ_np, device=dev)
        got = sf.fold_masked_stem_kernel(kern, clean, up, geo, occ, oh, ow, 1)
        want = sf.fold_masked_stem(kern, clean, u, part, (1, 1), eng.pads)
        torch.cuda.synchronize()
        c_err = float((got - want).abs().max())
        if not c_err <= TOL_C:
            raise AssertionError(f"kernel C max_abs_err {c_err} > {TOL_C}")
        # the fold's algebra: the same activations as the stem conv of the
        # masked images
        xm = mf.masked_fill_reference(
            imgs, torch.as_tensor(singles[:n_chunk], device=dev), fill)
        xm = normalize(xm.reshape(-1, size, size, 3)).permute(0, 3, 1, 2)
        w_oihw = eng.module.stem.weight
        lib = F.conv2d(xm, w_oihw, None, 1, 1).permute(0, 2, 3, 1)
        lib_err = float((lib.reshape(got.shape) - got).abs().max())
        if not lib_err <= TOL_C:
            raise AssertionError(f"kernel C vs conv of the masked batch: "
                                 f"{lib_err} > {TOL_C}")
        c_ms = _device_ms(lambda: sf.fold_masked_stem_kernel(
            kern, clean, up, geo, occ, oh, ow, 1))
        # the plain fold with its occlusion windows already on the card (a
        # host-to-device copy cannot be captured in a CUDA graph)
        part_dev = [w._replace(occ=torch.as_tensor(w.occ, device=dev))
                    for w in part]
        c_plain = _device_ms(lambda: sf.fold_masked_stem(
            kern, clean, u, part_dev, (1, 1), eng.pads))
        c_lib = _device_ms(lambda: F.conv2d(xm, w_oihw, None, 1, 1))
    _, hp, wp, cin = up.shape
    cout = clean.shape[-1]
    n_out = sum((w.o1 - w.o0) * (w.oc1 - w.oc0) for w in part)
    nbytes = 4 * (b * hp * wp * cin + occ.numel() + clean.numel()
                  + kern.numel() + b * n_chunk * clean[0].numel()) \
        + 16 * n_chunk
    flops = 2.0 * b * n_out * cout * 9 * cin
    bound, by = _bound(nbytes, flops)
    out.append(dict(name="stem_fold", route="cuda",
                    source="dorpatch_tpu_torch/csrc/stem_fold.cu",
                    replaces="dorpatch_tpu/ops/stem_fold.py:214",
                    launches=0, max_abs_err=c_err, ms=c_ms, plain_ms=c_plain,
                    bound_ms=bound, bound_by=by, library_ms=c_lib))
    print(f"kernel C stem_fold [B={b},N={n_chunk},32x32x64, OH/OW {oh}/{ow}]: "
          f"max_abs_err {c_err:.3g} (atol {TOL_C}; vs conv of the masked "
          f"batch {lib_err:.3g}), {c_ms * 1e3:.2f} us (plain "
          f"{c_plain * 1e3:.2f} us, conv2d of the masked batch "
          f"{c_lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us by {by})",
          flush=True)
    return out


def main_path(torch, dev):
    """The main path through the CLI entry point. Returns (metrics,
    launch counts of the run)."""
    from dorpatch_tpu_torch import ops
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.pipeline import run_experiment

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        argv = ["--synthetic", "--dataset", "cifar10", "--base_arch",
                "resnet18", "--img-size", "32", "-b", "8",
                "--sampling-size", "128", "--dropout", "2",
                "--max-iterations", "20", "--num-batches", "1",
                "--results-root", root]
        cfg = config_from_args(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        m = run_experiment(cfg, verbose=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
    print(f"main path: {wall:.2f} s wall; attack seconds "
          f"{m.get('attack_seconds')}; certify seconds "
          f"{m.get('certify_seconds')}; forwards {m.get('forwards')} of "
          f"{m.get('forwards_exhaustive')} exhaustive; launches {counts}",
          flush=True)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    vals = ([m["clean_accuracy"], m["robust_accuracy"]] + m["acc_pc"]
            + m["certified_acc_pc"] + m["certified_asr_pc"])
    if (m["evaluated_images"] < 1 or len(m["acc_pc"]) != 4
            or not all(math.isfinite(v) for v in vals)):
        raise AssertionError(f"malformed main-path metrics: {m}")
    return m, counts


def cross_check(torch, dev):
    """One radius certified both ways on the card: the stem fold (kernel C)
    and full masked forwards (kernel A) give the same first-round table
    wherever both top-2 margins exceed 1e-3."""
    from dorpatch_tpu_torch import data
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry
    from dorpatch_tpu_torch.models import get_model

    victim = get_model("cifar10", "resnet18", "/nonexistent", 32, seed=0,
                       device=dev)
    x_np, _ = next(data.synthetic_batches("cifar10", 8, 32, 1234))
    x = torch.as_tensor(x_np, device=dev)
    pc = PatchCleanser(victim.apply, geometry(32, 0.12), DefenseConfig(),
                       incremental_engine=victim.incremental, device=dev)
    with torch.no_grad():
        p_stem, m_stem = pc._phase1_incr(x)
        p_off, m_off = pc._phase1(x, with_margins=True)
    sure = torch.minimum(m_stem, m_off) > 1e-3
    bad = int(((p_stem != p_off) & sure).sum())
    n_sure = int(sure.sum())
    rec_stem = pc.robust_predict(x, victim.num_classes, incremental="stem")
    rec_off = pc.robust_predict(x, victim.num_classes, incremental="off")
    same = sum((a.prediction, a.certification) == (b.prediction,
                                                   b.certification)
               for a, b in zip(rec_stem, rec_off))
    print(f"cross-check r=0.12: preds_1 stem vs off: {bad} disagreements "
          f"among {n_sure} of {sure.numel()} entries with margin > 1e-3; "
          f"verdicts equal for {same}/{len(rec_stem)} images", flush=True)
    if bad:
        raise AssertionError(f"stem-fold and full-forward first-round tables "
                             f"disagree on {bad} confident entries")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = _smi()
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card: {smi}", flush=True)

    from dorpatch_tpu_torch import utils
    from dorpatch_tpu_torch.ops import _build

    dev = utils.resolve_device("cuda")
    utils.configure_numerics()
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    kernels = kernel_phases(torch, dev)
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    _, counts = main_path(torch, dev)
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
    print(f"main-path phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cross_check(torch, dev)
    print(f"cross-check phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
