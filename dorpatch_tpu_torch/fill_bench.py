"""Masked-fill kernel times (A forward, B backward) on the card at the main
paths' shapes.

    python -m dorpatch_tpu_torch.fill_bench               # this checkout
    python dorpatch_tpu_torch/fill_bench.py --tree DIR    # DIR's kernels
    python -m dorpatch_tpu_torch.fill_bench --sweep       # other plans too
    python -m dorpatch_tpu_torch.fill_bench --dtype bfloat16   # A's bf16 form
    python dorpatch_tpu_torch/fill_bench.py --host [--tree DIR]  # host us

At the CIFAR shape (8 images, 32x32x3) and the 224 shape (2 images,
224x224x3), each with the attack step's S = 128 masks, the failure sweep's
chunk of 126 and the pair audit's chunk of 63 (K = 2 rectangles a mask,
drawn from the dropout universe with a fixed seed), it times kernel A and
kernel B as `chip_smoke.py` times kernels (`gn_bench.device_ms`: the
median of REPS replays of a CUDA graph of INNER calls), beside the plain
versions (A: `masked_fill_reference`; B: where + sum), the one-call
PyTorch yardsticks (A: `torch.where` with the keep-mask rasterized
beforehand; B: one einsum with the keep-mask), and the bytes bound at
3.35 TB/s. B's bound counts the bytes of g it needs, the kept floats
(`kept_share`), plus dx and the rectangles; beside it stand the bound over
all of g and the share of 16-byte loads the kernel makes
(`kept_load_share`: lanes with a kept float). It prints one
JSON line per shape and a summary last.

`--dtype bfloat16` times kernel A's bf16 form instead, at the bf16
certify bank's shapes (`SHAPES16`: the CIFAR path's 8 images at 32 px, the
224 path's 2 and the 480 path's 1, each at the bank's phase-1 chunk of
S = 36 masks and pair-audit chunk of 63, K = 2), exact against its plain
version, beside the plain version, one bf16 `torch.where` on the
keep-mask, the bytes bound (2 bytes an element) and a one-element `zero_`
(the floor a launch pays in the same graph).

`--host` times the host instead: microseconds to launch one eager call of
kernel A at the CIFAR attack step's shape (8 images, S = 128) through the
user's wrapper (`masked_fill`, no gradient) and through the kernel entry
(`masked_fill_fwd_kernel`), and, where the checkout has it, the direct
ctypes launch under them (`_fwd_launch`, no dispatcher): the median over
HOST_REPS loops of HOST_CALLS calls made back to back (one synchronize
after each loop, so the card keeps up and the host's cost is what is
timed). With `--tree DIR`, the parent's wrapper against this one's.

`--tree DIR` imports `dorpatch_tpu_torch` from another checkout (the
parent of a change, unpacked with `git archive`), so that one chip call
times both designs in turn. `--sweep` also times, at each shape, every
plan of A (1-32 masks a block; plain or evict-first stores) and of B (4,
8, 16 or 32 lanes a block); with `--dtype bfloat16`, every plan of A's
bf16 form (1-8 lanes a thread, 1 to S masks a block, both store
policies; each exact), where the checkout has them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: (label, images, size, masks): the attack step, the sweep's chunk and the
#: pair audit's chunk at the CIFAR path's and the 224 paths' shapes
SHAPES = [("cifar_step", 8, 32, 128), ("cifar_sweep", 8, 32, 126),
          ("cifar_pairs", 8, 32, 63), ("224_step", 2, 224, 128),
          ("224_sweep", 2, 224, 126), ("224_pairs", 2, 224, 63)]
#: (label, images, size, masks): the bf16 bank's phase-1 and pair-audit
#: chunks at the CIFAR, 224 and 480 paths' shapes
SHAPES16 = [(f"{name}_bank{s}", b, size, s)
            for name, b, size in (("cifar", 8, 32), ("224", 2, 224),
                                  ("480", 1, 480)) for s in (36, 63)]
PEAK_BYTES_PER_S = 3.35e12
INNER, REPS = 20, 15
#: `--host`: calls a timed loop makes, and timed loops
HOST_CALLS, HOST_REPS = 200, 9


def host_us(torch, fn, calls: int = HOST_CALLS,
            reps: int = HOST_REPS) -> float:
    """Median host microseconds to make one call of `fn`: `calls` calls
    back to back, a synchronize after each loop (not timed)."""
    import time

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(out)[reps // 2]


def host_costs(torch, mf, dev) -> dict:
    """`--host`'s record: host us a call of A at the CIFAR step's shape
    through the wrapper, the kernel entry and (where the checkout has it)
    the direct launch."""
    _, b, size, s = SHAPES[0]
    imgs, rects, _ = fill_inputs(torch, dev, b, size, s)
    rec = dict(shape=SHAPES[0][0], b=b, size=size, s=s,
               wrapper_us=host_us(torch, lambda: mf.masked_fill(imgs, rects,
                                                                0.5)),
               entry_us=host_us(torch, lambda: mf.masked_fill_fwd_kernel(
                   imgs, rects, 0.5)))
    if hasattr(mf, "_fwd_launch"):
        rec["launch_us"] = host_us(
            torch, lambda: mf._fwd_launch(imgs, rects, 0.5, None))
    return rec


def bytes_bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def fill_inputs(torch, dev, b, size, s, seed=0):
    """Images, S dropout-universe rectangle pairs and a cotangent `g` of
    A's output, from `seed`."""
    import numpy as np

    from dorpatch_tpu_torch import masks as masks_lib

    rng = np.random.default_rng(seed)
    universe = masks_lib.dropout_universe(size, 2)
    imgs = torch.as_tensor(rng.uniform(0, 1, (b, size, size, 3)),
                           dtype=torch.float32, device=dev)
    rects = torch.as_tensor(universe[rng.choice(len(universe), s, False)],
                            device=dev)
    g = torch.as_tensor(rng.standard_normal((b, s, size, size, 3)),
                        dtype=torch.float32, device=dev)
    return imgs, rects, g


def kept_share(keep) -> float:
    """Share of g's floats that kernel B needs (keep 1), from the
    keep-mask `[S,H,W]`."""
    return float(keep.float().mean())


def kept_load_share(keep, c=3) -> float:
    """Share of kernel B's 16-byte loads of g with a float not occluded,
    from the keep-mask `[S,H,W]`."""
    keep = keep[..., None].expand(-1, -1, -1, c)
    return float(keep.reshape(keep.shape[0], -1, 4).any(-1).float().mean())


def bwd_bytes(g_shape, k: int, keep) -> tuple:
    """(bytes kernel B needs, bytes with all of g): the kept floats of g
    read once, dx written once, the rectangles read once."""
    b, s, h, w, c = g_shape
    rest = 16 * s * k + 4 * b * h * w * c
    whole = 4 * b * s * h * w * c
    return whole * kept_share(keep) + rest, whole + rest


def yardsticks(torch, imgs, keep, g, fill):
    """The plain B (where + sum) and the one-call PyTorch versions of A
    and B, all on the keep-mask `[S,H,W]` rasterized beforehand:
    (plain B, library A, library B) as callables."""
    b, s, h, w, c = g.shape
    keep5 = keep[None, :, :, :, None]
    keepf = keep.reshape(s, h * w).to(g.dtype)
    gv = g.view(b, s, h * w, c)
    zero = torch.zeros((), device=g.device)
    return (lambda: torch.where(keep5, g, zero).sum(1),
            lambda: torch.where(keep5, imgs[:, None], fill),
            lambda: torch.einsum("bspc,sp->bpc", gv, keepf))


def _sweep(mf, device_ms, imgs, rects, g, fill):
    s = rects.shape[0]
    out = []
    for group in (1, 2, 4, 8, 16, 32):
        if group > s:
            continue
        for stream in (False, True):
            plan = mf.FwdPlan(4, group, stream)
            out.append(dict(kernel="A", group=group, stream=stream,
                            ms=device_ms(lambda: mf._fwd_launch(
                                imgs, rects, fill, plan))))
    for cols in mf.BWD_COLS:
        plan = mf.BwdPlan(4, cols)
        out.append(dict(kernel="B", cols=cols, ms=device_ms(
            lambda: mf._bwd_launch(rects, g, plan))))
    return out


def torch_equal(a, b) -> bool:
    """Whether two card tensors are equal, after a synchronize."""
    import torch

    torch.cuda.synchronize()
    return bool(torch.equal(a, b))


def _sweep16(mf, device_ms, imgs, rects, fill, want):
    """Every plan of A's bf16 form at one shape, each held exact: 1, 2, 4
    or 8 lanes a thread, 1, 2, 4, 8, 16, 32 or all S masks a block (up to
    MAX_GROUP16), both store policies. Returns the records and the count
    of plans that differ from the plain version."""
    s = rects.shape[0]
    out, bad = [], 0
    for lanes in (1, 2, 4, 8):
        for group in sorted({g for g in (1, 2, 4, 8, 16, 32, s)
                             if g <= min(s, mf.MAX_GROUP16)}):
            for stream in (False, True):
                plan = mf.FwdPlan(8, group, stream, lanes)
                exact = torch_equal(mf._fwd_launch(imgs, rects, fill, plan),
                                    want)
                bad += not exact
                out.append(dict(lanes=lanes, group=group, stream=stream,
                                exact=exact, ms=device_ms(
                                    lambda: mf._fwd_launch(imgs, rects, fill,
                                                           plan))))
    return out, bad


def main16(args, root, torch, mf, device_ms) -> int:
    """`--dtype bfloat16`: kernel A's bf16 form at SHAPES16."""
    from dorpatch_tpu_torch import masks as masks_lib

    dev = torch.device("cuda")
    fill = 0.5
    one = torch.zeros(1, device=dev)
    plans = "lanes" in mf.FwdPlan._fields
    bad = 0
    summary = []
    for label, b, size, s in SHAPES16:
        imgs, rects, _ = fill_inputs(torch, dev, b, size, s)
        imgs = imgs.bfloat16()
        k = rects.shape[1]
        hwc = size * size * 3
        keep = masks_lib.rasterize(rects, size)[None, :, :, :, None]
        want = mf.masked_fill_reference(imgs, rects, fill)
        exact = torch_equal(mf.masked_fill_fwd_kernel(imgs, rects, fill),
                            want)
        bad += not exact
        rec = dict(
            shape=label, dtype="bfloat16", b=b, size=size, s=s, k=k,
            exact=exact,
            a_ms=device_ms(lambda: mf.masked_fill_fwd_kernel(imgs, rects,
                                                             fill),
                           INNER, REPS),
            a_plain_ms=device_ms(lambda: mf.masked_fill_reference(
                imgs, rects, fill), INNER, REPS),
            a_library_ms=device_ms(lambda: torch.where(keep, imgs[:, None],
                                                       fill), INNER, REPS),
            a_bound_ms=bytes_bound_ms(2 * b * hwc + 16 * s * k
                                      + 2 * b * s * hwc),
            launch_floor_ms=device_ms(one.zero_, INNER, REPS))
        rec["plan"] = mf.fwd_plan(b, s, size, size, 3, True, 2)._asdict()
        if args.sweep and plans:
            rec["sweep"], n_bad = _sweep16(
                mf, lambda fn: device_ms(fn, INNER, REPS), imgs, rects, fill,
                want)
            bad += n_bad
        summary.append({key: rec[key] for key in
                        ("shape", "a_ms", "a_bound_ms", "exact")})
        print(json.dumps(rec), flush=True)  # noqa: DP101 — the tool's result stream
        del imgs, keep, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),  # noqa: DP101 — the tool's result stream
                      "tree": root, "dtype": "bfloat16",
                      "shapes": summary}), flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=None,
                   help="checkout whose dorpatch_tpu_torch to time")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--host", action="store_true",
                   help="host microseconds a call of A (CIFAR step shape)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    args = p.parse_args(argv)
    if args.tree and "dorpatch_tpu_torch" in sys.modules:
        p.error("--tree needs the script path (python "
                "dorpatch_tpu_torch/fill_bench.py --tree DIR), not -m")
    root = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, root)
    import torch

    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.gn_bench import device_ms
    from dorpatch_tpu_torch.ops import masked_fill as mf

    if not torch.cuda.is_available():
        print("fill_bench: no CUDA device is available", file=sys.stderr)  # noqa: DP101 — the tool's result stream
        return 2
    dev = torch.device("cuda")
    print(f"tree {root}; device {torch.cuda.get_device_name(0)}", flush=True)  # noqa: DP101 — the tool's result stream
    if args.host:
        with torch.no_grad():
            rec = host_costs(torch, mf, dev)
        print(json.dumps({"device": torch.cuda.get_device_name(0),  # noqa: DP101 — the tool's result stream
                          "tree": root, "host": rec}), flush=True)
        return 0
    if args.dtype == "bfloat16":
        return main16(args, root, torch, mf, device_ms)
    fill = 0.5
    plans = hasattr(mf, "_fwd_launch")
    summary = []
    for label, b, size, s in SHAPES:
        imgs, rects, g = fill_inputs(torch, dev, b, size, s)
        k = rects.shape[1]
        hwc = size * size * 3
        keep = masks_lib.rasterize(rects, size)
        plain_b, lib_a, lib_b = yardsticks(torch, imgs, keep, g, fill)
        b_need, b_all = bwd_bytes(g.shape, k, keep)
        rec = dict(
            shape=label, b=b, size=size, s=s, k=k,
            a_ms=device_ms(lambda: mf.masked_fill_fwd_kernel(imgs, rects,
                                                             fill),
                           INNER, REPS),
            a_plain_ms=device_ms(lambda: mf.masked_fill_reference(
                imgs, rects, fill), INNER, REPS),
            a_library_ms=device_ms(lib_a, INNER, REPS),
            a_bound_ms=bytes_bound_ms(4 * b * hwc + 16 * s * k
                                      + 4 * b * s * hwc),
            b_ms=device_ms(lambda: mf.masked_fill_bwd_kernel(rects, g),
                           INNER, REPS),
            b_plain_ms=device_ms(plain_b, INNER, REPS),
            b_library_ms=device_ms(lib_b, INNER, REPS),
            b_bound_ms=bytes_bound_ms(b_need),
            b_bound_all_g_ms=bytes_bound_ms(b_all),
            b_kept_share=kept_share(keep),
            b_kept_load_share=kept_load_share(keep))
        if plans:
            rec["plans"] = dict(
                fwd=mf.fwd_plan(b, s, size, size, 3)._asdict(),
                bwd=mf.bwd_plan(b, s, size, size, 3)._asdict())
        if args.sweep and plans:
            rec["sweep"] = _sweep(mf, lambda fn: device_ms(fn, INNER, REPS),
                                  imgs, rects, g, fill)
        summary.append({key: rec[key] for key in
                        ("shape", "a_ms", "a_bound_ms", "b_ms",
                         "b_bound_ms")})
        print(json.dumps(rec), flush=True)  # noqa: DP101 — the tool's result stream
        del imgs, g, keep, plain_b, lib_a, lib_b
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),  # noqa: DP101 — the tool's result stream
                      "tree": root, "shapes": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
