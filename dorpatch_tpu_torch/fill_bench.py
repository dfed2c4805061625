"""Masked-fill kernel times (A forward, B backward) on the card at the main
paths' shapes.

    python -m dorpatch_tpu_torch.fill_bench               # this checkout
    python dorpatch_tpu_torch/fill_bench.py --tree DIR    # DIR's kernels
    python -m dorpatch_tpu_torch.fill_bench --sweep       # other plans too

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

`--tree DIR` imports `dorpatch_tpu_torch` from another checkout (the
parent of a change, unpacked with `git archive`), so that one chip call
times both designs in turn. `--sweep` also times, at each shape, every
plan of A (1-32 masks a block; plain or evict-first stores) and of B (4,
8, 16 or 32 lanes a block). Needs a CUDA device.
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
PEAK_BYTES_PER_S = 3.35e12
INNER, REPS = 20, 15


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=None,
                   help="checkout whose dorpatch_tpu_torch to time")
    p.add_argument("--sweep", action="store_true")
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
        print("fill_bench: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"tree {root}; device {torch.cuda.get_device_name(0)}", flush=True)
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
        print(json.dumps(rec), flush=True)
        del imgs, g, keep, plain_b, lib_a, lib_b
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "tree": root, "shapes": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
