"""Kernel C times on the card at the conv victims' phase-1 chunks.

    python -m dorpatch_tpu_torch.stem_bench                # this checkout
    python dorpatch_tpu_torch/stem_bench.py --tree DIR     # DIR's kernel
    python -m dorpatch_tpu_torch.stem_bench --sweep        # other bf16 plans

At the 0.12 radius the stem-fold engine folds the first round's masks in
chunks (the engine's chunk_size shrunk by the stem's inflation); `SHAPES`
are the first chunk of each conv main path: the CIFAR ResNet-18's 3x3/1
stem (8 images, 3 masks), ResNetV2-50x1's 7x7/2 stem at 224 px (2 images,
12 masks) and at 480 px (1 image, 12 masks), each on the victim's stem
kernel (random weights from the seed). For each shape and each form
(float32 and bf16, the victim's bf16 copy) it holds kernel C against the
plain fold under `chip_smoke.py`'s gates (`stem_case`, `stem_gate`) and
times, as `chip_smoke.py` does (`gn_bench.device_ms`: the median of REPS
replays of a CUDA graph of INNER calls), the kernel, the plain fold,
`F.conv2d` of the masked batch in the same type, and a one-element
`zero_` (the floor a launch pays in the same graph), and prints one JSON
line per (shape, form) with the bounds: the bytes each input is read and
the output written once at 3.35 TB/s, and the delta's operations at the
FFMA rate (float32, 67 TFLOP/s) or the bf16 tensor cores' (989 TFLOP/s).

`--tree DIR` imports `dorpatch_tpu_torch` from another checkout (the
parent of a change, unpacked with `git archive`), so that one chip call
times both designs in turn (parent, change, change, parent). `--sweep`
also times the bf16 form's other launch plans (`stem_fold.Bf16FoldPlan`:
copy lanes, mask group, m-tiles a warp, store policy), each bit-equal to the default
plan's output, where the checkout has them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

#: (name, dataset, arch, image size, images): the phase-1 chunks
SHAPES = (("cifar", "cifar10", "resnet18", 32, 8),
          ("rn50", "imagenet", "resnetv2", 224, 2),
          ("480", "imagenet", "resnetv2", 480, 1))
RADIUS = 0.12
FILL = 0.5
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
#: float32: the delta's summation order
TOL_F32 = 1e-4


def stem_case(torch, dev, dataset, arch, size, b, dtype):
    """Kernel C's inputs on one phase-1 chunk of the RADIUS family, as the
    engine makes them (the victim's stem at `dtype`, seeded images), with
    the plain fold's window plan and the masked batch the conv yardstick
    runs on."""
    import numpy as np
    import torch.nn.functional as F

    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.models.registry import get_model, normalize
    from dorpatch_tpu_torch.ops import masked_fill as mf
    from dorpatch_tpu_torch.ops import stem_fold as sf

    rng = np.random.default_rng(2)
    imgs = torch.as_tensor(rng.uniform(0, 1, (b, size, size, 3)),
                           dtype=torch.float32, device=dev).to(dtype)
    victim = get_model(dataset, arch, "/nonexistent", size, seed=0,
                       device=dev)
    eng = victim.incremental.at(dtype)
    k, s = eng.kernel_hw, eng.strides[0]
    singles, _ = masks_lib.mask_sets(masks_lib.geometry(size, RADIUS))
    plan = sf.plan_windows(singles, size, k, s, eng.pads)
    with torch.no_grad():
        clean = eng.module(normalize(imgs), "stem").contiguous()
        # the engine's chunk: chunk_size shrunk by the stem's inflation
        inflation = clean[0].numel() / imgs[0].numel()
        n = max(1, int(DefenseConfig().chunk_size / max(1.0, inflation)))
        u = eng.norm_scale * (FILL - imgs)
        kern = eng.kernel_fn(eng.module).contiguous()
        up = sf.pad_for_kernel(u, eng.pads, s)
        oh, ow, geo, occ = sf._uniform_plan(plan[:n], clean.shape[1],
                                            clean.shape[2], k, s)
        xm = mf.masked_fill_reference(
            imgs, torch.as_tensor(singles[:n], device=dev), FILL)
        xm = normalize(xm.reshape(-1, size, size, 3))
        (pr0, pr1), (pc0, pc1) = eng.pads
        xm = F.pad(xm, (0, 0, pc0, pc1, pr0, pr1)).permute(0, 3, 1, 2)
    return SimpleNamespace(
        imgs=imgs, kern=kern, clean=clean, u=u, up=up, k=k, s=s, n=n,
        pads=eng.pads, part=plan[:n], oh=oh, ow=ow,
        geo=torch.as_tensor(geo, device=dev),
        occ=torch.as_tensor(occ, dtype=dtype, device=dev), xm=xm,
        w_oihw=kern.permute(3, 2, 0, 1).contiguous(), dtype=dtype,
        bf16=dtype == torch.bfloat16)


def kernel_args(case):
    """`fold_masked_stem_kernel`'s positional arguments for `case`."""
    return (case.kern, case.clean, case.up, case.geo, case.occ, case.oh,
            case.ow, case.s)


def plain(case):
    """The plain fold of `case` (`fold_masked_stem`)."""
    from dorpatch_tpu_torch.ops import stem_fold as sf

    return sf.fold_masked_stem(case.kern, case.clean, case.u, case.part,
                               (case.s, case.s), case.pads)


def ulp16(torch, x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def stem_gate(torch, case, got, want):
    """Kernel C's output `got` against the plain fold `want`: float32
    within TOL_F32; bf16 within one ulp of the output and one of the delta,
    plus twice the error bound of a float32 sum of the delta's n =
    k*k*Cin products, gamma_n * sum |w x| (the two sum the delta in float32
    in other orders, and where it cancels to near 0 they may round it an
    ulp or more apart). Returns (max abs error, elements out of the gate,
    a note on the elements only the sums' bound admits)."""
    from dorpatch_tpu_torch.ops import stem_fold as sf

    err = (got.float() - want.float()).abs()
    c_err = float(err.max())
    if not case.bf16:
        return c_err, int((err > TOL_F32).sum()), ""
    delta = want.float() - case.clean[:, None].float()
    n_terms = case.k * case.k * case.up.shape[-1]
    gamma = n_terms * 2.0 ** -24 / (1 - n_terms * 2.0 ** -24)
    mag = sf.fold_masked_stem(
        case.kern.float().abs(),
        torch.zeros_like(case.clean, dtype=torch.float),
        case.u.float().abs(), case.part, (case.s, case.s), case.pads)
    ulps = ulp16(torch, want) + ulp16(torch, delta)
    gate = ulps + 2 * gamma * mag
    bad = int((err > gate).sum())
    # the elements that only the sums' bound admits, and the one furthest
    # beyond its ulps
    beyond = (err - ulps).flatten()
    i = int(beyond.argmax())
    note = ""
    if float(beyond[i]) > 0:
        at = [float(t.flatten()[i]) for t in (
            case.clean[:, None].expand_as(want), want, got, mag, gate)]
        note = (f"; {int((beyond > 0).sum())} elements beyond the ulps "
                f"alone, the furthest: clean {at[0]:.4g}, plain {at[1]:.4g}"
                f", kernel {at[2]:.4g}, sum |w x| {at[3]:.4g}, bound "
                f"{at[4]:.4g}")
    return c_err, bad, note


def bounds(case):
    """(bytes, flops, bytes ms, operations ms at the form's rate, FFMA
    operations ms) of one kernel C call on `case`: each input read once
    and the output written once; the delta's 2 k*k*Cin flops an output of
    the masks' true windows."""
    b, cin = case.up.shape[0], case.up.shape[-1]
    _, hp, wp, _ = case.up.shape
    cout = case.clean.shape[-1]
    n_out = sum((pw.o1 - pw.o0) * (pw.oc1 - pw.oc0) for pw in case.part)
    nbytes = case.imgs.element_size() * (
        b * hp * wp * cin + case.occ.numel() + case.clean.numel()
        + case.kern.numel() + b * case.n * case.clean[0].numel()) \
        + 16 * case.n
    flops = 2.0 * b * n_out * cout * case.k * case.k * cin
    peak = PEAK_BF16_FLOPS if case.bf16 else PEAK_F32_FLOPS
    return (nbytes, flops, nbytes / PEAK_BYTES_PER_S * 1e3,
            flops / peak * 1e3, flops / PEAK_F32_FLOPS * 1e3)


def _plans(sf, case):
    """The bf16 form's default launch plan at `case` and its others: copy
    lanes 1, 2, 4, mask groups 1, 2, 4 and the whole chunk, one or two
    m-tiles a warp, both store policies."""
    b, h, w, c = case.clean.shape
    default = sf.bf16_plan(b, case.n, h, w, c, case.oh, case.ow)
    others = {sf.Bf16FoldPlan(lanes, min(group, case.n), mtiles, stream)
              for lanes in (1, 2, 4) for group in (1, 2, 4, case.n)
              for mtiles in (1, 2) for stream in (False, True)} - {default}
    return default, sorted(others)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=None,
                   help="checkout whose dorpatch_tpu_torch to time")
    p.add_argument("--sweep", action="store_true")
    args = p.parse_args(argv)
    if args.tree and "dorpatch_tpu_torch" in sys.modules:
        p.error("--tree needs the script path (python "
                "dorpatch_tpu_torch/stem_bench.py --tree DIR), not -m")
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
    root = os.path.abspath(args.tree or here)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from dorpatch_tpu_torch import utils
    from dorpatch_tpu_torch.gn_bench import device_ms
    from dorpatch_tpu_torch.ops import stem_fold as sf

    if not torch.cuda.is_available():
        print("stem_bench: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    utils.configure_numerics()
    one = torch.zeros(1, device=dev)
    print(f"tree {root}; device {torch.cuda.get_device_name(0)}; radius "
          f"{RADIUS}", flush=True)
    failed = 0
    for name, dataset, arch, size, b in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            case = stem_case(torch, dev, dataset, arch, size, b, dtype)
            a = kernel_args(case)
            with torch.no_grad():
                got = sf.fold_masked_stem_kernel(*a)
                want = plain(case)
                torch.cuda.synchronize()
                err, bad, note = stem_gate(torch, case, got, want)
                repeats = torch.equal(sf.fold_masked_stem_kernel(*a), got)
                del want
                part_dev = [pw._replace(occ=torch.as_tensor(pw.occ,
                                                            device=dev))
                            for pw in case.part]
                plain_case = SimpleNamespace(**{**vars(case),
                                                "part": part_dev})
                nbytes, flops, bytes_ms, ops_ms, ffma_ms = bounds(case)
                rec = dict(
                    shape=name, dtype=str(dtype).replace("torch.", ""), B=b,
                    N=case.n, hwc=list(case.clean.shape[1:]), k=case.k,
                    s=case.s, OH=case.oh, OW=case.ow,
                    max_abs_err=err, out_of_gate=bad, repeats=repeats,
                    ms=device_ms(lambda: sf.fold_masked_stem_kernel(*a)),
                    plain_ms=device_ms(lambda: plain(plain_case)),
                    library_ms=device_ms(lambda: F.conv2d(
                        case.xm, case.w_oihw, None, case.s)),
                    launch_floor_ms=device_ms(one.zero_),
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    bytes_ms=bytes_ms, ops_ms=ops_ms, ffma_ms=ffma_ms,
                    bytes=nbytes, flops=flops, note=note)
                if case.bf16 and hasattr(sf, "bf16_plan"):
                    default, others = _plans(sf, case)
                    rec["plan"] = default._asdict()
                    if args.sweep:
                        rec["sweep"] = []
                        for plan in others:
                            same = torch.equal(sf.fold_masked_stem_kernel(
                                *a, plan=plan), got)
                            failed += not same
                            rec["sweep"].append(dict(
                                plan._asdict(), equal=same, ms=device_ms(
                                    lambda: sf.fold_masked_stem_kernel(
                                        *a, plan=plan))))
            failed += bad > 0 or not repeats
            print(json.dumps(rec), flush=True)
            del case, a, got
            torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
