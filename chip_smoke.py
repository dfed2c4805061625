#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`dorpatch_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. prints the environment and the card (nvidia-smi name, power limit);
   exits nonzero without a CUDA device;
2. builds the CUDA kernels from `dorpatch_tpu_torch/csrc` (nvcc, sm_90a);
3. holds every kernel against its plain PyTorch version on the card at the
   main paths' shapes and times both (median over REPS warmed
   repetitions; a repetition replays a CUDA graph of INNER calls,
   bracketed by synchronizes, so host launch cost is not counted):
   kernels A and B at the CIFAR path's shapes and at the 224 paths'
   (A exact at S = 128, 126 and 63; B against float64 autograd and bit for
   bit on a repeat; both timed at the attack step's S = 128 beside the
   plain versions and one-call PyTorch yardsticks), kernel C at CIFAR's
   stem, the GroupNorm+ReLU forward and backward at every (HW, C) of the
   RN50 victim at 224 with
   the attack step's N = 256 (one-pass route; route, time, bytes bound,
   plain and library times and calls per forward printed per shape, and
   launches x (time - bound) summed over a forward's 49 calls) and at one
   slab of the split route, each against float64 and repeated bit for
   bit, kernel C at RN50's 7x7/2 stem at 224, and kernel H (the masked-KV
   attention) at the
   ViT-B/16 token engine's phase-1 chunk and pair-audit chunk of the 0.12
   radius, against its plain version in float64 (and bit for bit against
   itself), with `F.scaled_dot_product_attention` timed beside it; kernel
   C's bound is its bytes (its operations printed beside), kernel H's the
   least time of a float32-accurate tensor-core design (three TF32 products
   each) against its bytes (the FFMA operations bound printed beside);
4. runs three main paths through their user entry point, the CLI, each
   with every kernel's launch count set to 0 just before and read just
   after, and fails if a kernel of that path was not launched (or a
   GroupNorm launch took another route than the one-pass route):
   - CIFAR: `--synthetic --dataset cifar10 --base_arch resnet18
     --img-size 32 -b 8 --sampling-size 128 --dropout 2 --max-iterations
     20 --num-batches 1` (full-width CIFAR ResNet-18; kernels A, B, C);
   - RN50: `--synthetic --dataset imagenet --base_arch resnetv2
     --img-size 224 -b 2 --sampling-size 128 --dropout 2 --max-iterations
     20 --num-batches 1` (ResNetV2-50x1 BiT at full depth and width;
     kernels A, B, C and the GroupNorm+ReLU forward and backward);
   - ViT: the same flags with `--base_arch vit` (ViT-B/16 at full depth
     and width; kernels A, B and H);
   random weights from the seed, certification at the four radii with
   prune="exact", incremental="auto" (-> stem for the conv victims,
   -> token-exact for the ViT);
   and prints A's and B's launches x (time - bound) per path;
5. computes the RN50 victim's input gradient on one masked batch 10
   times and runs the RN50 attack's first 5 steps twice from one seed,
   and fails unless every gradient equals the first and the patches are
   bit-equal (`repeat.victim_repeat`, `repeat.attack_steps`; without
   cuDNN determinism the gradient differs in almost every call);
6. certifies one radius both ways on each conv victim (stem fold = kernel
   C, and full masked forwards = kernel A) and asserts the first-round
   tables agree wherever both top-2 margins exceed 1e-3; on RN50 also
   holds the victim's logits with the GroupNorm kernels against its plain
   GroupNorm (argmax equal wherever the top-2 margin exceeds 1e-3); on the
   ViT (as seeded, and with one class's head bias raised so that images
   clear the escalation margin) holds the token engine's first-round logits with
   kernel H against the engine with the plain attention (1e-4) and
   against full masked forwards (predictions equal wherever both margins
   exceed `incremental_margin`), and asserts that "token-exact" gives every
   image the (prediction, certification) of incremental="off";
7. prints the per-kernel JSON line, the nvidia-smi line and, last,
   `{"ok": true, "device": {...}}`.

Any failed phase raises: the script then exits nonzero and prints no
result line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
#: float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_TF32_FLOPS = 495e12             # dense, tensor cores

INNER, REPS = 20, 15                 # calls per timed graph, timed graphs

TOL_B = dict(rtol=1e-5, atol=1e-6)   # summation order over S
TOL_C = 1e-4                         # summation order of the delta conv
# GroupNorm+ReLU against the float64 plain versions: f32 rounding of a few
# flops per element (the group statistics are summed in float64); dscale and
# dbias sum N*HW terms per channel from per-thread f32 partials. Gate flips of
# pre-activations within GN_NEAR of 0 are allowed for by
# `fused_gn.gate_flip_bounds`, and those elements are left out of dx.
TOL_GN = dict(rtol=1e-5, atol=1e-5)
TOL_GN_PARAMS = dict(rtol=1e-5, atol=1e-3)
GN_NEAR = 1e-5
#: GroupNorm slabs of the RN50 attack step: N = 2 images x 128 masks at
#: every (HW, C) of the victim; and [N, HW, C] of a slab whose one-group
#: chunk fits no cluster of CTAs (the split route)
GN_N = 256
GN_SPLIT_SLAB = (4, 256 * 256, 64)
# kernel H against its plain version in float64: float32 rounding of the
# logits (64-term dots), the exp-sum over T+1+S keys and the weighted sum;
# the engine's logits with kernel H and with the plain attention after 12
# blocks of it
TOL_H = dict(rtol=1e-5, atol=1e-5)
TOL_H_LOGITS = 1e-4

CIFAR_ARGV = ["--synthetic", "--dataset", "cifar10", "--base_arch",
              "resnet18", "--img-size", "32", "-b", "8",
              "--sampling-size", "128", "--dropout", "2",
              "--max-iterations", "20", "--num-batches", "1"]
RN50_ARGV = ["--synthetic", "--dataset", "imagenet", "--base_arch",
             "resnetv2", "--img-size", "224", "-b", "2",
             "--sampling-size", "128", "--dropout", "2",
             "--max-iterations", "20", "--num-batches", "1"]
VIT_ARGV = [a if a != "resnetv2" else "vit" for a in RN50_ARGV]
CIFAR_KERNELS = ("masked_fill_fwd", "masked_fill_bwd", "stem_fold")
#: the count each record's launches are read from: kernels A and B at 224,
#: kernel C at RN50's stem and kernel H at the pair audit's shape count as
#: their kernel; the GroupNorm records by their route
COUNT_OF = {"stem_fold_rn50": "stem_fold",
            "masked_fill_fwd_224": "masked_fill_fwd",
            "masked_fill_bwd_224": "masked_fill_bwd",
            "masked_kv_attn_pairs": "masked_kv_attn",
            "gn_relu_fwd": "gn_relu_fwd/one_pass",
            "gn_relu_bwd": "gn_relu_bwd/one_pass",
            "gn_relu_fwd_split": "gn_relu_fwd/split",
            "gn_relu_bwd_split": "gn_relu_bwd/split"}
RN50_KERNELS = CIFAR_KERNELS + ("gn_relu_fwd", "gn_relu_bwd")
VIT_KERNELS = ("masked_fill_fwd", "masked_fill_bwd", "masked_kv_attn")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _device_ms(fn, inner: int = INNER, reps: int = REPS) -> float:
    """Median device milliseconds of one `fn()` call: a CUDA graph of
    `inner` calls is replayed `reps` times, each replay bracketed by
    synchronizes and timed with CUDA events (`gn_bench.device_ms`)."""
    from dorpatch_tpu_torch.gn_bench import device_ms

    return device_ms(fn, inner, reps)


def _bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """(least milliseconds, what bounds it) for the bytes a call must move
    and the operations it must do."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fill_phase(torch, dev, b, size, suffix=""):
    """Kernels A and B at one main path's image shape: A exact against its
    plain version at the attack step's S = 128, the sweep's chunk of 126
    and the pair audit's chunk of 63; B within TOL_B of float64 autograd
    of the plain version and bit-equal on a repeat, at S = 128; both timed
    at S = 128 beside the plain versions and the one-call PyTorch
    yardsticks (`fill_bench.yardsticks`). Returns the two records."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.fill_bench import (bwd_bytes, fill_inputs,
                                               kept_load_share, kept_share,
                                               yardsticks)
    from dorpatch_tpu_torch.ops import masked_fill as mf

    fill = 0.5
    label = f"[B={b},S=128,K=2,{size}x{size}x3]"
    for s in (126, 63, 128):
        imgs, rects, g = fill_inputs(torch, dev, b, size, s, seed=s)
        got = mf.masked_fill_fwd_kernel(imgs, rects, fill)
        want = mf.masked_fill_reference(imgs, rects, fill)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel A differs from its plain version "
                                 f"at [B={b},S={s},{size}x{size}x3]")
    a_err = float((got - want).abs().max())
    del got, want
    hwc = size * size * 3
    s, k = rects.shape[0], rects.shape[1]
    keep = masks_lib.rasterize(rects, size)
    plain_b, lib_a, lib_b = yardsticks(torch, imgs, keep, g, fill)
    a_ms = _device_ms(lambda: mf.masked_fill_fwd_kernel(imgs, rects, fill))
    a_plain = _device_ms(lambda: mf.masked_fill_reference(imgs, rects, fill))
    a_lib = _device_ms(lib_a)
    bound, by = _bound(4 * b * hwc + 16 * s * k + 4 * b * s * hwc, 0.0)
    plan = mf.fwd_plan(b, s, size, size, 3)
    rec_a = dict(name="masked_fill_fwd" + suffix, route="cuda",
                 source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                 replaces="dorpatch_tpu/ops/masked_fill.py:53",
                 launches=0, max_abs_err=a_err, ms=a_ms, plain_ms=a_plain,
                 bound_ms=bound, bound_by=by, library_ms=a_lib)
    print(f"kernel A masked_fill_fwd {label} ({plan}): exact at S=128, 126 "
          f"and 63, {a_ms * 1e3:.2f} us (plain {a_plain * 1e3:.2f} us, "
          f"torch.where on a rasterized keep-mask {a_lib * 1e3:.2f} us; "
          f"bound {bound * 1e3:.2f} us by {by}, {bound / a_ms:.0%} of it)",
          flush=True)

    # B against autograd of the plain version in float64: the f32 autograd
    # sums 128 signed unit-variance terms with its own rounding (reported
    # beside it), which alone can exceed atol 1e-6
    def plain_grad(dtype):
        x = imgs.to(dtype).requires_grad_(True)
        (gx,) = torch.autograd.grad(
            mf.masked_fill_reference(x, rects, fill), x, g.to(dtype))
        return gx.float()

    want = plain_grad(torch.float64)
    got = mf.masked_fill_bwd_kernel(rects, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL_B)
    if not torch.equal(mf.masked_fill_bwd_kernel(rects, g), got):
        raise AssertionError(f"kernel B {label} does not repeat bit for bit")
    b_err = float((got - want).abs().max())
    b_err32 = float((got - plain_grad(torch.float32)).abs().max())
    del got, want
    b_ms = _device_ms(lambda: mf.masked_fill_bwd_kernel(rects, g))
    b_plain = _device_ms(plain_b)
    b_lib = _device_ms(lib_b)
    # B needs g only where keep is 1: its bound counts those bytes and
    # adds; the bound over all of g is printed beside it
    need, whole = bwd_bytes(g.shape, k, keep)
    share = kept_share(keep)
    bound, by = _bound(need, b * s * hwc * share, PEAK_F64_FLOPS)
    whole_ms = whole / PEAK_BYTES_PER_S * 1e3
    rec_b = dict(name="masked_fill_bwd" + suffix, route="cuda",
                 source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                 replaces="dorpatch_tpu/ops/masked_fill.py:66",
                 launches=0, max_abs_err=b_err, ms=b_ms, plain_ms=b_plain,
                 bound_ms=bound, bound_by=by, library_ms=b_lib)
    print(f"kernel B masked_fill_bwd {label} "
          f"({mf.bwd_plan(b, s, size, size, 3)}): max_abs_err {b_err:.3g} "
          f"vs float64 autograd of the plain version (rtol {TOL_B['rtol']}, "
          f"atol {TOL_B['atol']}), {b_err32:.3g} vs float32 autograd, "
          f"repeats bit for bit; {b_ms * 1e3:.2f} us (plain where+sum "
          f"{b_plain * 1e3:.2f} us, einsum on a keep-mask {b_lib * 1e3:.2f} "
          f"us; bound {bound * 1e3:.2f} us by {by}, {bound / b_ms:.0%} of "
          f"it, for the {share:.1%} of g that is kept; over all of g "
          f"{whole_ms * 1e3:.2f} us; the kernel makes "
          f"{kept_load_share(keep):.1%} of g's 16-byte loads)", flush=True)
    del imgs, g, keep, plain_b, lib_a, lib_b
    torch.cuda.empty_cache()
    return [rec_a, rec_b]


def kernel_phases(torch, dev):
    """Kernels A, B and C against their plain versions at the CIFAR main
    path's shapes. Returns the per-kernel records (launches filled in
    later)."""
    out = fill_phase(torch, dev, 8, 32)
    # -- C: stem fold, one phase-1 chunk (3 masks) of the 0.12 radius on
    #    the full-width CIFAR ResNet-18 stem --
    out.append(stem_fold_phase(torch, dev, "cifar10", "resnet18", 32, 8,
                               "stem_fold"))
    return out


def stem_fold_phase(torch, dev, dataset, arch, size, b, name):
    """Kernel C on one phase-1 chunk of the 0.12 radius (the chunk the
    engine takes by the stem's inflation), against the plain fold and
    against the stem conv of the masked batch."""
    import numpy as np

    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.models.registry import get_model, normalize
    from dorpatch_tpu_torch.ops import masked_fill as mf
    from dorpatch_tpu_torch.ops import stem_fold as sf

    import torch.nn.functional as F

    rng = np.random.default_rng(2)
    fill = 0.5
    imgs = torch.as_tensor(rng.uniform(0, 1, (b, size, size, 3)),
                           dtype=torch.float32, device=dev)
    victim = get_model(dataset, arch, "/nonexistent", size, seed=0,
                       device=dev)
    eng = victim.incremental
    k, s = eng.kernel_hw, eng.strides[0]
    spec = masks_lib.geometry(size, 0.12)
    singles, _ = masks_lib.mask_sets(spec)
    plan = sf.plan_windows(singles, size, k, s, eng.pads)
    with torch.no_grad():
        clean = eng.module(normalize(imgs), "stem").contiguous()
        # the engine's chunk: chunk_size shrunk by the stem's inflation
        inflation = clean[0].numel() / imgs[0].numel()
        n_chunk = max(1, int(DefenseConfig().chunk_size / max(1.0,
                                                               inflation)))
        part = plan[:n_chunk]
        u = eng.norm_scale * (fill - imgs)
        kern = eng.kernel_fn().contiguous()
        up = sf.pad_for_kernel(u, eng.pads, s)
        _, h, w, cout = clean.shape
        oh, ow, geo_np, occ_np = sf._uniform_plan(part, h, w, k, s)
        geo = torch.as_tensor(geo_np, device=dev)
        occ = torch.as_tensor(occ_np, device=dev)
        got = sf.fold_masked_stem_kernel(kern, clean, up, geo, occ, oh, ow, s)
        want = sf.fold_masked_stem(kern, clean, u, part, (s, s), eng.pads)
        torch.cuda.synchronize()
        c_err = float((got - want).abs().max())
        if not c_err <= TOL_C:
            raise AssertionError(f"kernel C ({name}) max_abs_err {c_err} > "
                                 f"{TOL_C}")
        # the fold's algebra: the same activations as the stem conv of the
        # masked images
        xm = mf.masked_fill_reference(
            imgs, torch.as_tensor(singles[:n_chunk], device=dev), fill)
        xm = normalize(xm.reshape(-1, size, size, 3))
        (pr0, pr1), (pc0, pc1) = eng.pads
        xm = F.pad(xm, (0, 0, pc0, pc1, pr0, pr1)).permute(0, 3, 1, 2)
        w_oihw = kern.permute(3, 2, 0, 1).contiguous()
        lib = F.conv2d(xm, w_oihw, None, s).permute(0, 2, 3, 1)
        lib_err = float((lib.reshape(got.shape) - got).abs().max())
        if not lib_err <= TOL_C:
            raise AssertionError(f"kernel C ({name}) vs conv of the masked "
                                 f"batch: {lib_err} > {TOL_C}")
        c_ms = _device_ms(lambda: sf.fold_masked_stem_kernel(
            kern, clean, up, geo, occ, oh, ow, s))
        # the plain fold with its occlusion windows already on the card (a
        # host-to-device copy cannot be captured in a CUDA graph)
        part_dev = [pw._replace(occ=torch.as_tensor(pw.occ, device=dev))
                    for pw in part]
        c_plain = _device_ms(lambda: sf.fold_masked_stem(
            kern, clean, u, part_dev, (s, s), eng.pads))
        c_lib = _device_ms(lambda: F.conv2d(xm, w_oihw, None, s))
    _, hp, wp, cin = up.shape
    n_out = sum((pw.o1 - pw.o0) * (pw.oc1 - pw.oc0) for pw in part)
    nbytes = 4 * (b * hp * wp * cin + occ.numel() + clean.numel()
                  + kern.numel() + b * n_chunk * clean[0].numel()) \
        + 16 * n_chunk
    flops = 2.0 * b * n_out * cout * k * k * cin
    bound, by = _bound(nbytes, flops)
    ops_bound, _ = _bound(0.0, flops)
    print(f"kernel C {name} [B={b},N={n_chunk},{h}x{w}x{cout}, k={k} s={s}, "
          f"OH/OW {oh}/{ow}]: max_abs_err {c_err:.3g} (atol {TOL_C}; vs conv "
          f"of the masked batch {lib_err:.3g}), {c_ms * 1e3:.2f} us (plain "
          f"{c_plain * 1e3:.2f} us, conv2d of the masked batch "
          f"{c_lib * 1e3:.2f} us, {c_lib / c_ms:.2f}x the kernel's time; "
          f"bound {bound * 1e3:.2f} us by {by}: {nbytes / 1e6:.2f} MB; "
          f"operations bound {ops_bound * 1e3:.2f} us, {flops / 1e9:.3f} "
          f"GFLOP on the FFMA pipes)", flush=True)
    return dict(name=name, route="cuda",
                source="dorpatch_tpu_torch/csrc/stem_fold.cu",
                replaces="dorpatch_tpu/ops/stem_fold.py:214",
                launches=0, max_abs_err=c_err, ms=c_ms, plain_ms=c_plain,
                bound_ms=bound, bound_by=by, library_ms=c_lib)


def gn_slab(torch, dev, gen, n, hw, c, calls):
    """The GroupNorm+ReLU forward and backward kernels at one [n, hw, c]
    slab: the route `fused_gn.gn_plan` takes, held against the plain
    versions in float64 (gate flips allowed for), a repeated call bit-equal,
    and timed beside the plain f32 versions and PyTorch's group norm (which
    leaves out the ReLU). Returns the forward and backward records."""
    from dorpatch_tpu_torch import ops
    from dorpatch_tpu_torch.ops import fused_gn as fgn

    import torch.nn.functional as F

    side = math.isqrt(hw)
    shape = (n, side, side, c)
    g = 32

    def rand(*size):
        return torch.randn(size, generator=gen, device=dev)

    x = rand(*shape) + 0.5 * rand(c)
    s, b = 1 + 0.2 * rand(c), 0.3 * rand(c)
    dy = rand(*shape)
    label = f"[{n},{hw},{c}]"
    routes = {d: fgn.gn_plan(d, n, hw, c) for d in ("fwd", "bwd")}

    # forward against float64, and again bit for bit
    ops.reset_launch_counts()
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    torch.cuda.synchronize()
    x64, s64, b64, dy64 = (t.double() for t in (x, s, b, dy))
    want = fgn.gn_relu_reference(x64, s64, b64)
    fwd_err = float((y.double() - want).abs().max())
    torch.testing.assert_close(y.double(), want, **TOL_GN)
    del want
    m64, r64 = fgn.gn_stats_reference(x64, g)
    stat_err = max(float((mean.double() - m64).abs().max()),
                   float(((rstd.double() - r64) / r64).abs().max()))
    again = fgn.gn_relu_fwd_kernel(x, s, b)
    if not all(torch.equal(p, q) for p, q in zip(again, (y, mean, rstd))):
        raise AssertionError(f"GN forward {label} does not repeat bit for "
                             "bit")
    del again

    # backward against float64, gate flips allowed for, and again
    dx, ds, db = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd)
    torch.cuda.synchronize()
    again = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd)
    if not all(torch.equal(p, q) for p, q in zip(again, (dx, ds, db))):
        raise AssertionError(f"GN backward {label} does not repeat bit for "
                             "bit")
    del again
    launched = ops.route_counts()
    want_routes = {f"gn_relu_fwd/{routes['fwd'].route}": 2,
                   f"gn_relu_bwd/{routes['bwd'].route}": 2}
    if launched != want_routes:
        raise AssertionError(f"GN {label}: routes launched {launched}, "
                             f"planned {want_routes}")
    wdx, wds, wdb = fgn.gn_relu_backward_reference(x64, dy64, s64, b64, m64,
                                                   r64, g)
    near, dx_b, ds_b, db_b = fgn.gate_flip_bounds(x64, dy64, s64, b64, m64,
                                                  r64, g, GN_NEAR)
    n_near = int(near.sum())
    dx_err = (dx.double() - wdx).abs()
    dx_bad = int(((dx_err > TOL_GN["atol"] + TOL_GN["rtol"] * wdx.abs()
                   + dx_b) & ~near).sum())
    dx_max = float(dx_err[~near].max())
    flip_max = float(dx_b.max())
    del dx_err, dx_b, wdx, near
    param_bad = 0
    param_err = 0.0
    for got, want, bnd in ((ds, wds, ds_b), (db, wdb, db_b)):
        err = (got.double() - want).abs()
        param_err = max(param_err, float(err.max()))
        param_bad += int((err > TOL_GN_PARAMS["atol"]
                          + TOL_GN_PARAMS["rtol"] * want.abs()
                          + bnd).sum())
    print(f"GN {label}: forward max_abs_err {fwd_err:.3g} (atol "
          f"{TOL_GN['atol']}, rtol {TOL_GN['rtol']} of float64), stats err "
          f"{stat_err:.3g}; backward dx max_abs_err {dx_max:.3g} over the "
          f"elements not within {GN_NEAR} of the gate ({n_near} near-zero "
          f"pre-activations left out, flip bound up to {flip_max:.3g}), "
          f"dscale/dbias max_abs_err {param_err:.3g} (atol "
          f"{TOL_GN_PARAMS['atol']}, rtol {TOL_GN_PARAMS['rtol']}); both "
          f"repeat bit for bit", flush=True)
    if dx_bad or param_bad:
        raise AssertionError(f"GN backward {label}: {dx_bad} dx and "
                             f"{param_bad} dscale/dbias elements out of "
                             "tolerance")
    del x64, dy64, m64, r64, wds, wdb

    # times: the kernels as the victim calls them (frozen affine: no
    # parameter cotangents), the plain f32 versions, and PyTorch's group
    # norm on the channels-last view (no ReLU)
    fwd_ms = _device_ms(lambda: fgn.gn_relu_fwd_kernel(x, s, b), 5, 7)
    fwd_plain = _device_ms(lambda: fgn.gn_relu_reference(x, s, b), 5, 7)
    xv = x.permute(0, 3, 1, 2)
    fwd_lib = _device_ms(lambda: F.group_norm(xv, g, s, b, 1e-5), 5, 7)
    bwd_ms = _device_ms(lambda: fgn.gn_relu_bwd_kernel(
        x, dy, s, b, mean, rstd, params=False), 5, 7)
    bwd_plain = _device_ms(lambda: fgn.gn_relu_backward_reference(
        x, dy, s, b, mean, rstd, g), 5, 7)
    # PyTorch's group norm backward takes NCHW-contiguous tensors
    xc, dyc = xv.contiguous(), dy.permute(0, 3, 1, 2).contiguous()
    _, lmean, lrstd = torch.ops.aten.native_group_norm(
        xc, s, b, n, c, hw, g, 1e-5)
    bwd_lib = _device_ms(lambda: torch.ops.aten.native_group_norm_backward(
        dyc, xc, lmean, lrstd, s, n, c, hw, g, [True, False, False]), 5, 7)
    del xc, dyc
    slab = 4.0 * n * hw * c
    small = 4.0 * (2 * c + 2 * n * g)
    fwd_bound, fwd_by = _bound(2 * slab + small, 8.0 * n * hw * c)
    bwd_bound, bwd_by = _bound(3 * slab + small, 12.0 * n * hw * c)
    pf, pb = routes["fwd"], routes["bwd"]
    print(f"GN {label} ({calls} calls per RN50 forward): forward route "
          f"{pf.route} (width {pf.width}, cluster {pf.cluster}, smem "
          f"{pf.smem}) {fwd_ms * 1e3:.2f} us (bound {fwd_bound * 1e3:.2f} "
          f"us by {fwd_by}, plain {fwd_plain * 1e3:.2f} us, F.group_norm "
          f"without the ReLU {fwd_lib * 1e3:.2f} us); backward route "
          f"{pb.route} (width {pb.width}, cluster {pb.cluster}, smem "
          f"{pb.smem}) {bwd_ms * 1e3:.2f} us (bound {bwd_bound * 1e3:.2f} us "
          f"by {bwd_by}, plain {bwd_plain * 1e3:.2f} us, "
          f"native_group_norm_backward on NCHW copies, without the ReLU "
          f"{bwd_lib * 1e3:.2f} us)", flush=True)
    split = routes["fwd"].route == "split"
    suffix = "_split" if split else ""
    fwd_rec = dict(name="gn_relu_fwd" + suffix, route="cuda",
                   source="dorpatch_tpu_torch/csrc/fused_gn.cu",
                   replaces="dorpatch_tpu/ops/fused_gn.py:"
                   + ("159" if split else "115"), launches=0,
                   max_abs_err=max(fwd_err, stat_err), ms=fwd_ms,
                   plain_ms=fwd_plain, bound_ms=fwd_bound, bound_by=fwd_by,
                   library_ms=fwd_lib)
    bwd_rec = dict(name="gn_relu_bwd" + suffix, route="cuda",
                   source="dorpatch_tpu_torch/csrc/fused_gn.cu",
                   replaces="dorpatch_tpu/ops/fused_gn.py:"
                   + ("278" if split else "135"), launches=0,
                   max_abs_err=max(dx_max, param_err), ms=bwd_ms,
                   plain_ms=bwd_plain, bound_ms=bwd_bound, bound_by=bwd_by,
                   library_ms=bwd_lib)
    del x, dy, y, dx, xv
    torch.cuda.empty_cache()
    return fwd_rec, bwd_rec


def gn_phases(torch, dev):
    """The GroupNorm+ReLU kernels at every (HW, C) of the RN50 victim at
    224 (N = 256, the attack step's 2 images x 128 masks), each on the
    one-pass route, and at GN_SPLIT_SLAB on the split route. Prints the
    launches x (time - bound) summed over a forward's 49 calls. Returns the
    records of the largest slab [256, 3136, 256] and of the split slab."""
    from dorpatch_tpu_torch.gn_bench import RN50_GN_CALLS

    gen = torch.Generator(device=dev).manual_seed(3)
    recs, over = {}, [0.0, 0.0]
    for (hw, c), calls in sorted(RN50_GN_CALLS.items(),
                                 key=lambda kv: (-kv[0][0], kv[0][1])):
        fwd, bwd = gn_slab(torch, dev, gen, GN_N, hw, c, calls)
        if fwd["name"] != "gn_relu_fwd" or bwd["name"] != "gn_relu_bwd":
            raise AssertionError(f"RN50 GN shape ({hw}, {c}) did not take "
                                 "the one-pass route")
        over[0] += calls * (fwd["ms"] - fwd["bound_ms"])
        over[1] += calls * (bwd["ms"] - bwd["bound_ms"])
        recs[(hw, c)] = (fwd, bwd)
    print(f"GN over the 49 calls of an RN50 forward at N={GN_N}: forward "
          f"{over[0]:.4f} ms over its bytes bound, backward {over[1]:.4f} "
          f"ms", flush=True)
    split = gn_slab(torch, dev, gen, *GN_SPLIT_SLAB, 0)
    if split[0]["name"] != "gn_relu_fwd_split" or \
            split[1]["name"] != "gn_relu_bwd_split":
        raise AssertionError(f"GN slab {GN_SPLIT_SLAB} did not take the "
                             "split route")
    return list(recs[(3136, 256)]) + list(split)


def attn_phase(torch, dev):
    """Kernel H at the ViT-B/16 token engine's two shapes of the 0.12
    radius (2 images; T+1 = 197 tokens, 12 heads of 64): the phase-1 chunk
    (all 36 first-round masks) and the first pair-audit chunk (64 of the
    630 pairs). The biases are the engine's own: the stale clean columns
    of the masks' token sets and the duplicate dirty slots of their
    padding. Held against the plain version in float64 and timed beside
    the plain f32 version and `F.scaled_dot_product_attention` over the
    concatenated clean and dirty keys with the biases as its mask."""
    import numpy as np

    import torch.nn.functional as F

    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.models import vit
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    size, patch, b, h, f = 224, 16, 2, 12, 64
    t1 = (size // patch) ** 2 + 1
    singles, doubles = masks_lib.mask_sets(masks_lib.geometry(size, 0.12))
    m = singles.shape[0]
    rng = np.random.default_rng(4)
    recs = []
    for name, rects, c in (("masked_kv_attn", singles, m),
                           ("masked_kv_attn_pairs", doubles, 64)):
        table = vit.build_tables(rects, size, patch)
        idx = table.idx[:c]
        s = idx.shape[1]
        stale = (idx[:, :, None] == np.arange(t1)).any(axis=1)   # [c, T+1]
        biases = (np.where(stale, -1e9, 0.0), table.slot_bias[:c])
        cb, db = (torch.as_tensor(np.tile(a, (b, 1, 1)), dtype=torch.float32,
                                  device=dev)
                  for a in biases)
        q, kd, vd = (torch.as_tensor(rng.standard_normal((b, c, s, h, f)),
                                     dtype=torch.float32, device=dev)
                     for _ in range(3))
        q = q / math.sqrt(f)
        kc, vc = (torch.as_tensor(rng.standard_normal((b, t1, h, f)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2))
        args = (q, kd, vd, kc, vc, cb, db)
        got = mka.masked_kv_attention_kernel(*args)
        torch.cuda.synchronize()
        want = mka.masked_kv_attention_reference(*(a.double() for a in args))
        err = float((got.double() - want).abs().max())
        err32 = float((got - mka.masked_kv_attention_reference(*args))
                      .abs().max())
        torch.testing.assert_close(got.double(), want, **TOL_H)
        if not torch.equal(mka.masked_kv_attention_kernel(*args), got):
            raise AssertionError(f"kernel H ({name}) does not repeat bit for "
                                 "bit")
        del want
        # the library yardstick: one SDPA call over [B*C, H, T+1+S, f]
        # keys and values, concatenated outside the timing
        def heads(t):
            return t.permute(0, 1, 3, 2, 4).reshape(b * c, h, -1, f)

        qs = heads(q).contiguous()
        ks, vs = (heads(torch.cat([cl[:, None].expand(b, c, t1, h, f), dt],
                                  dim=2)).contiguous()
                  for cl, dt in ((kc, kd), (vc, vd)))
        mask = torch.cat([cb, db], dim=-1).reshape(b * c, 1, 1, t1 + s)
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                 scale=1.0)
        lib_err = float((lib_out - heads(got)).abs().max())
        ms = _device_ms(lambda: mka.masked_kv_attention_kernel(*args))
        plain = _device_ms(lambda: mka.masked_kv_attention_reference(*args))
        lib = _device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=1.0))
        nbytes = 4 * (4 * b * c * s * h * f + 2 * b * t1 * h * f
                      + b * c * (t1 + s))
        flops = 4.0 * b * c * h * s * (t1 + s) * f
        ffma_bound, _ = _bound(0.0, flops)
        bound, by = _bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)
        print(f"kernel H {name} [B={b},C={c},S={s},H={h},f={f},T+1={t1}]: "
              f"max_abs_err {err:.3g} vs float64 plain (rtol "
              f"{TOL_H['rtol']}, atol {TOL_H['atol']}), {err32:.3g} vs f32 "
              f"plain, {lib_err:.3g} vs SDPA; {ms * 1e3:.2f} us (plain "
              f"{plain * 1e3:.2f} us, SDPA {lib * 1e3:.2f} us, {lib / ms:.2f}x "
              f"the kernel's time; bound {bound * 1e3:.2f} us by {by}: "
              f"{flops / 1e9:.3f} GFLOP x 3 TF32 products at "
              f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB "
              f"at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; FFMA operations bound "
              f"{ffma_bound * 1e3:.2f} us)", flush=True)
        recs.append(dict(name=name, route="cuda",
                         source="dorpatch_tpu_torch/csrc/masked_kv_attn.cu",
                         replaces="dorpatch_tpu/ops/masked_kv_attn.py:56",
                         launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by, library_ms=lib))
        del args, q, kd, vd, got, qs, ks, vs, lib_out
        torch.cuda.empty_cache()
    return recs


def main_path(torch, dev, label, argv, required):
    """One main path through the CLI entry point, with the launch counts
    set to 0 just before and read just after; every kernel in `required`
    must have launched, and every GroupNorm launch must have taken the
    one-pass route. Returns (metrics, launch and route counts of the
    run)."""
    from dorpatch_tpu_torch import ops
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.pipeline import run_experiment

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        cfg = config_from_args(build_parser().parse_args(
            argv + ["--results-root", root]))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        m = run_experiment(cfg, verbose=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        routes = ops.route_counts()
        wall = time.perf_counter() - t0
    print(f"{label} main path: {wall:.2f} s wall; attack seconds "
          f"{m.get('attack_seconds')}; certify seconds "
          f"{m.get('certify_seconds')}; forwards {m.get('forwards')} of "
          f"{m.get('forwards_exhaustive')} exhaustive, forward equivalents "
          f"{m.get('forward_equivalents')}, escalated (image, radius) "
          f"records {m.get('escalated')}; launches {counts}; GN routes "
          f"{routes}", flush=True)
    for name in required:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} main path")
    for name in ("gn_relu_fwd", "gn_relu_bwd"):
        if routes.get(f"{name}/one_pass", 0) != counts[name]:
            raise AssertionError(f"{label} main path: {name} took routes "
                                 f"{routes}, not the one-pass route alone")
    vals = ([m["clean_accuracy"], m["robust_accuracy"]] + m["acc_pc"]
            + m["certified_acc_pc"] + m["certified_asr_pc"])
    if (m["evaluated_images"] < 1 or len(m["acc_pc"]) != 4
            or not all(math.isfinite(v) for v in vals)):
        raise AssertionError(f"malformed {label} main-path metrics: {m}")
    return m, {**counts, **routes}


def cross_check(torch, dev, dataset, arch, size, b):
    """One radius certified both ways on the card: the stem fold (kernel C)
    and full masked forwards (kernel A) give the same first-round table
    wherever both top-2 margins exceed 1e-3. Returns the victim and the
    images."""
    from dorpatch_tpu_torch import data
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry
    from dorpatch_tpu_torch.models import get_model

    victim = get_model(dataset, arch, "/nonexistent", size, seed=0,
                       device=dev)
    x_np, _ = next(data.synthetic_batches(dataset, b, size, 1234))
    x = torch.as_tensor(x_np, device=dev)
    pc = PatchCleanser(victim.apply, geometry(size, 0.12), DefenseConfig(),
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
    print(f"cross-check {arch} {size}px r=0.12: preds_1 stem vs off: {bad} "
          f"disagreements among {n_sure} of {sure.numel()} entries with "
          f"margin > 1e-3 (largest margin gap "
          f"{float((m_stem - m_off).abs().max()):.3g}); verdicts equal for "
          f"{same}/{len(rec_stem)} images", flush=True)
    if bad:
        raise AssertionError(f"stem-fold and full-forward first-round tables "
                             f"disagree on {bad} confident entries")
    return victim, x


def gn_logits_check(torch, dev, victim, x):
    """The RN50 victim's logits with the GroupNorm kernels against its plain
    GroupNorm on the card, on the images and their 36 single-masked copies
    of the 0.12 radius: argmax equal wherever the top-2 margin exceeds
    1e-3."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch import ops, utils
    from dorpatch_tpu_torch.ops import masked_fill as mf

    singles, _ = masks_lib.mask_sets(masks_lib.geometry(x.shape[1], 0.12))
    with torch.no_grad():
        xs = torch.cat([x, mf.masked_fill(x, singles, 0.5).reshape(
            (-1,) + tuple(x.shape[1:]))])
        ops.reset_launch_counts()
        got = victim.apply(xs)
        launched = ops.launch_counts()["gn_relu_fwd"]
        victim.model.set_gn_impl("plain")
        try:
            want = victim.apply(xs)
        finally:
            victim.model.set_gn_impl("auto")
    p_got, m_got = utils.preds_margins(got)
    p_want, m_want = utils.preds_margins(want)
    sure = torch.minimum(m_got, m_want) > 1e-3
    bad = int(((p_got != p_want) & sure).sum())
    print(f"RN50 logits, GN kernels ({launched} forward launches) vs plain "
          f"GroupNorm on {xs.shape[0]} images: max_abs_err "
          f"{float((got - want).abs().max()):.3g}; {bad} argmax "
          f"disagreements among {int(sure.sum())} with margin > 1e-3; "
          f"{len(set(p_want.tolist()))} distinct classes", flush=True)
    if bad or launched != 49:
        raise AssertionError(f"GN kernel logits: {bad} confident argmax "
                             f"disagreements, {launched} launches (want 49)")


def vit_cross_check(torch, dev, b, lift):
    """The ViT-B/16 victim at 224 and the 0.12 radius on the card, with its
    head bias of class 0 raised by `lift` (a random victim's top-2 margins
    are mostly below `incremental_margin`, so unlifted nearly every image
    escalates; the lift widens the margins without changing the engine's
    logit drift, a difference of logits):
    - the token engine's first-round logits with kernel H against the same
      engine with the plain attention: within TOL_H_LOGITS, argmax equal
      wherever the margin exceeds 1e-3;
    - its first-round predictions against full masked forwards (kernel A):
      equal wherever both margins exceed `incremental_margin`;
    - "token-exact" certification gives every image the (prediction,
      certification) of incremental="off"; prints how many images
      escalated and the largest logit gap to the full forwards over the
      images that did not."""
    from dorpatch_tpu_torch import data, ops, utils
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry, mask_sets
    from dorpatch_tpu_torch.models import get_model, vit
    from dorpatch_tpu_torch.ops import masked_fill as mf
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    size, cfg = 224, DefenseConfig()
    victim = get_model("imagenet", "vit", "/nonexistent", size, seed=0,
                       device=dev)
    victim.model.head.bias[0] += lift
    x_np, _ = next(data.synthetic_batches("imagenet", b, size, 1234))
    x = torch.as_tensor(x_np, device=dev)
    pc = PatchCleanser(victim.apply, geometry(size, 0.12), cfg,
                       incremental_engine=victim.incremental, device=dev)
    eng, table = victim.incremental, pc._incr_family.first
    singles, _ = mask_sets(pc.spec)
    m = singles.shape[0]

    def per_image(t):
        return t[None].expand((b,) + t.shape)

    with torch.no_grad():
        patches, cls0, kcs, vcs = eng._clean(x)

        def first_round():
            return eng._chunk(patches, cls0, kcs, vcs, per_image(table.idx),
                              per_image(table.keep),
                              per_image(table.slot_bias), cfg.mask_fill)

        ops.reset_launch_counts()
        lg_tok = first_round()
        launched = ops.launch_counts()["masked_kv_attn"]
        # the same engine with the plain attention on the card, for this
        # comparison only
        vit.masked_kv_attention = mka.masked_kv_attention_reference
        try:
            lg_plain = first_round()
        finally:
            vit.masked_kv_attention = mka.masked_kv_attention
        xm = mf.masked_fill(x, torch.as_tensor(singles, device=dev),
                            cfg.mask_fill)
        lg_full = victim.apply(xm.reshape(-1, size, size, 3)).reshape(
            b, m, -1)
    p_tok, m_tok = utils.preds_margins(lg_tok)
    p_plain, m_plain = utils.preds_margins(lg_plain)
    p_full, m_full = utils.preds_margins(lg_full)
    kern_err = float((lg_tok - lg_plain).abs().max())
    kern_bad = int(((p_tok != p_plain)
                    & (torch.minimum(m_tok, m_plain) > 1e-3)).sum())
    sure = torch.minimum(m_tok, m_full) > cfg.incremental_margin
    full_bad = int(((p_tok != p_full) & sure).sum())

    rec_tok = pc.robust_predict(x, victim.num_classes,
                                incremental="token-exact")
    esc = pc.last_min_margin < cfg.incremental_margin
    margins = [round(float(v), 4) for v in pc.last_min_margin]
    rec_off = pc.robust_predict(x, victim.num_classes, incremental="off")
    differ = [i for i, (a, o) in enumerate(zip(rec_tok, rec_off))
              if (a.prediction, a.certification)
              != (o.prediction, o.certification)]
    kept = torch.as_tensor(~esc, device=dev)
    gap = (float((lg_tok - lg_full)[kept].abs().max()) if bool(kept.any())
           else None)
    print(f"ViT cross-check 224px r=0.12, class-0 bias +{lift}: kernel H vs "
          f"plain-attention engine logits max_abs_err {kern_err:.3g} "
          f"(atol {TOL_H_LOGITS}; {launched} launches), {kern_bad} argmax "
          f"disagreements with margin > 1e-3; token vs full forwards: "
          f"{full_bad} disagreements among {int(sure.sum())} of "
          f"{sure.numel()} first-round entries with both margins > "
          f"{cfg.incremental_margin}; escalated {int(esc.sum())} of {b} "
          f"images (min margins {margins}); largest token-vs-full logit "
          f"gap over the images not escalated {gap}; verdicts token-exact "
          f"vs off differ for images {differ}", flush=True)
    if kern_err > TOL_H_LOGITS or kern_bad or launched != eng.module.depth:
        raise AssertionError(f"kernel H engine logits: max_abs_err "
                             f"{kern_err}, {kern_bad} confident argmax "
                             f"disagreements, {launched} launches")
    if full_bad or differ:
        raise AssertionError(f"token engine vs full forwards: {full_bad} "
                             f"confident first-round disagreements, "
                             f"verdicts differ for images {differ}")


def fill_overhead(counts, cifar, at224) -> None:
    """Launches of A and B on each main path and launches x (time - bound)
    at the path's image shape (CIFAR's records for the CIFAR path, the 224
    records for RN50 and ViT)."""
    parts = []
    for label in ("CIFAR", "RN50", "ViT"):
        for rec in cifar if label == "CIFAR" else at224:
            kernel = COUNT_OF.get(rec["name"], rec["name"])
            n = counts[label][kernel]
            parts.append(f"{label} {kernel} {n} x ({rec['ms']:.5f} - "
                         f"{rec['bound_ms']:.5f}) = "
                         f"{n * (rec['ms'] - rec['bound_ms']):.3f} ms")
    print("A/B launches x (time - bound): " + "; ".join(parts), flush=True)


def repeat_check(torch, dev, steps: int = 5) -> None:
    """Under `utils.configure_numerics`, on the RN50 main path's victim
    (ResNetV2-50x1 at 224, 2 images, sampling size 128, dropout 2): the
    logits and input gradient of one masked batch, `repeat.TRIALS` times,
    must all equal the first call's; the attack's first `steps` stage-0
    steps, twice from one seed, must give bit-equal patches and step
    metrics."""
    from dorpatch_tpu_torch import data, repeat
    from dorpatch_tpu_torch.models import get_model

    spec = repeat.VICTIMS["resnetv2"]
    victim = get_model(spec.dataset, "resnetv2", "/nonexistent",
                       spec.img_size, device=dev)
    x_np, _ = next(data.synthetic_batches(spec.dataset, spec.batch,
                                          spec.img_size, repeat.SEED))
    x = torch.as_tensor(x_np, device=dev)
    grads = repeat.victim_repeat(victim, x, "repeat: RN50 victim",
                                 repeat.TRIALS)
    if grads["logits_differing"] or grads["input_grad_differing"]:
        raise AssertionError(f"the RN50 victim's gradient does not repeat: "
                             f"{grads}")
    runs = [repeat.attack_steps(victim, x, steps) for _ in range(2)]
    rec = repeat.compare(f"repeat: RN50 attack, {steps} steps twice from "
                         f"seed {repeat.SEED}", *runs)
    if rec["first_step"] is not None:
        raise AssertionError(f"the RN50 attack does not repeat: {rec}")


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
    cifar_kernels = kernel_phases(torch, dev)
    rn50_kernels = fill_phase(torch, dev, 2, 224, "_224")
    rn50_kernels.append(stem_fold_phase(torch, dev, "imagenet", "resnetv2",
                                        224, 2, "stem_fold_rn50"))
    rn50_kernels += gn_phases(torch, dev)
    vit_kernels = attn_phase(torch, dev)
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)

    fills = {}
    for label, argv, required, records in (
            ("CIFAR", CIFAR_ARGV, CIFAR_KERNELS, cifar_kernels),
            ("RN50", RN50_ARGV, RN50_KERNELS, rn50_kernels),
            ("ViT", VIT_ARGV, VIT_KERNELS, vit_kernels)):
        t0 = time.perf_counter()
        _, counts = main_path(torch, dev, label, argv, required)
        for rec in records:
            rec["launches"] = counts.get(COUNT_OF.get(rec["name"],
                                                      rec["name"]), 0)
        fills[label] = counts
        print(f"{label} main-path phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
    fill_overhead(fills, cifar_kernels[:2], rn50_kernels[:2])

    t0 = time.perf_counter()
    repeat_check(torch, dev)
    print(f"repeat phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cross_check(torch, dev, "cifar10", "resnet18", 32, 8)
    victim, x = cross_check(torch, dev, "imagenet", "resnetv2", 224, 4)
    gn_logits_check(torch, dev, victim, x)
    del victim, x
    for lift in (0.0, 4.0):
        vit_cross_check(torch, dev, 4, lift)
    print(f"cross-check phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": cifar_kernels + rn50_kernels
                                  + vit_kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
