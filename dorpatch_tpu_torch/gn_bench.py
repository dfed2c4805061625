"""GroupNorm+ReLU kernel times on the card at every GroupNorm shape of
ResNetV2-50x1 at 224 px (or 480 px).

    python -m dorpatch_tpu_torch.gn_bench                 # this checkout
    python dorpatch_tpu_torch/gn_bench.py --tree DIR      # DIR's kernels
    python -m dorpatch_tpu_torch.gn_bench --sweep         # other chunks too
    python -m dorpatch_tpu_torch.gn_bench --dtype bfloat16  # the bf16 forms
    python -m dorpatch_tpu_torch.gn_bench --img-size 480  # BiT's 480 px

For each of the victim's 11 (HW, C) shapes at the image size
(`rn50_gn_calls`) and the attack step's N masked images (`STEP_N`: 2
images x 128 masks at 224, 1 x 128 at 480) it times the forward kernel and
the backward kernel as the victim calls it (dx only), as `chip_smoke.py`
does: the median of REPS replays of a CUDA graph of INNER calls, each
replay bracketed by synchronizes. It prints one JSON line per shape
(route, times, bytes bound at 3.35 TB/s, calls per forward; the forward
split route's floor of three slab passes is `bwd_bound_ms`) and last a
JSON summary: the sums over the 49 calls of a forward of time and of time
minus bound (`--split`'s slab counts 0 calls).

`--tree DIR` imports `dorpatch_tpu_torch` from another checkout (the
parent of a change, unpacked with `git archive`), so that one chip call
times both designs in turn. `--split` times the split route's slab [4,
65536, 64] (`SPLIT_SLAB`) after the victim's shapes, and at every shape
also the forward forced to the split route (`fwd_split_ms`), so that one
call sets kernel E beside kernel D, and first prints how many clusters of
1 to 16 of E's CTAs the card holds at once (`fwd_split_max_clusters`, from
`cudaOccupancyMaxActiveClusters`). `--sweep` also times, at each shape,
every one-pass chunk width with rows of 64 bytes or more over 1, 2, 4 and
8 CTAs of a cluster, where a CTA's shared memory fits, at a split
backward the statistics pass's other chunks and clusters, and with
`--split` at the tallest shapes the forward split route's chunks and
clusters. `--dtype bfloat16` times the bf16 forms on bf16 slabs (bounds
at 2 bytes an element). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
from collections import Counter
from typing import Dict, Tuple


@functools.lru_cache(maxsize=None)
def rn50_gn_calls(img_size: int) -> Dict[Tuple[int, int], int]:
    """(HW, C) -> calls per forward of ResNetV2-50x1's GroupNorm+ReLU at
    `img_size` px, counted by forward pre-hooks on one forward of one
    image through the victim's module on the CPU (its default
    initialization: only the shapes are read). The dict is shared between
    calls; do not change it."""
    import torch

    from dorpatch_tpu_torch.models import resnetv2

    model = resnetv2.resnetv2_50x1(1000).eval()
    calls: Counter = Counter()

    def count(_, args):
        _, h, w, c = args[0].shape
        calls[h * w, c] += 1

    for m in model.modules():
        if isinstance(m, resnetv2.GroupNormRelu):
            m.register_forward_pre_hook(count)
    with torch.no_grad():
        model(torch.zeros((1, img_size, img_size, 3)))
    return dict(calls)


#: the attack step's masked images at each image size: the main paths'
#: batch (2 at 224, 1 at 480) x 128 masks
STEP_N = {224: 256, 480: 128}
#: [N, HW, C] of a slab on the split route both ways (`--split`)
SPLIT_SLAB = (4, 256 * 256, 64)
PEAK_BYTES_PER_S = 3.35e12
INNER, REPS = 5, 7


def device_ms(fn, inner: int = INNER, reps: int = REPS) -> float:
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
    with torch.cuda.graph(graph):  # noqa: DP105 — a timing capture, not a program
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


def bytes_bound_ms(n: int, hw: int, c: int, slabs: int,
                   itemsize: int = 4) -> float:
    """Reading the inputs and writing the output once (`slabs` slabs of
    [n, hw, c] elements of `itemsize` bytes) at the card's memory rate."""
    return float(itemsize) * slabs * n * hw * c / PEAK_BYTES_PER_S * 1e3


def _split_planner(fgn):
    """(direction, n, hw, c, itemsize) -> the tree's split plan of the
    statistics pass, or None where the tree has none for `direction`."""
    if hasattr(fgn, "split_plan"):
        return lambda d, n, hw, c, isz: fgn.split_plan(d, n, hw, c, 32, isz)
    if hasattr(fgn, "bwd_split_plan"):
        return lambda d, n, hw, c, isz: (
            fgn.bwd_split_plan(n, hw, c, 32, isz) if d == "bwd" else None)
    return lambda *_: None


def _sweep_plans(fgn, n, hw, c, itemsize=4, fwd_split=False):
    """Other plans of one shape: every one-pass width whose rows are at
    least MIN_ROW_BYTES, over 1, 2, 4 and 8 CTAs of a cluster, where the
    CTA's shared memory fits a block. A direction on the split route (the
    forward too, with `fwd_split`) also tries its statistics pass's other
    plans (the widths of rows of 64 bytes or more, over clusters of 1 to 16
    CTAs). Yields (direction, plan)."""
    from dorpatch_tpu_torch.ops import _build

    planner = _split_planner(fgn)
    for direction in ("fwd", "bwd"):
        split = fgn.gn_plan(direction, n, hw, c, 32, itemsize).route == "split"
        default = planner(direction, n, hw, c, itemsize)
        if default is None or not (split or (fwd_split
                                             and direction == "fwd")):
            continue
        for w in fgn.split_widths(c, 32, itemsize):
            for cl in (1, 2, 4, 8, 16):
                if (itemsize * w >= fgn.MIN_ROW_BYTES
                        and (w, cl) != tuple(default)):
                    yield direction, fgn.GNPlan("split", w, cl, 0)
    for direction, slabs in (("fwd", 1), ("bwd", 2)):
        default = fgn.gn_plan(direction, n, hw, c, 32, itemsize)
        for w in fgn.one_pass_widths(c, 32, itemsize):
            for cl in (1, 2, 4, 8):
                smem = fgn.one_pass_smem(hw, w, cl, slabs, itemsize)
                if (itemsize * w >= fgn.MIN_ROW_BYTES
                        and smem <= _build.MAX_SMEM_BYTES
                        and (w, cl) != (default.width, default.cluster)):
                    yield direction, fgn.GNPlan("one_pass", w, cl, smem)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=None,
                   help="checkout whose dorpatch_tpu_torch to time")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--split", action="store_true",
                   help="also time SPLIT_SLAB (not one of the victim's)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--img-size", type=int, default=224,
                   choices=sorted(STEP_N))
    args = p.parse_args(argv)
    if args.tree and "dorpatch_tpu_torch" in sys.modules:
        p.error("--tree needs the script path (python "
                "dorpatch_tpu_torch/gn_bench.py --tree DIR), not -m")
    root = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, root)
    import torch

    from dorpatch_tpu_torch.ops import fused_gn as fgn

    if not torch.cuda.is_available():
        print("gn_bench: no CUDA device is available", file=sys.stderr)  # noqa: DP101 — the tool's result stream
        return 2
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    isz = torch.empty((), dtype=dtype).element_size()
    plan_args = (32, isz) if isz != 4 else ()
    step_n = STEP_N[args.img_size]
    print(f"tree {root}; device {torch.cuda.get_device_name(0)}; "  # noqa: DP101 — the tool's result stream
          f"{args.dtype}; RN50 at {args.img_size} px, N = {step_n}",
          flush=True)
    if args.split and hasattr(fgn, "split_plan"):
        from dorpatch_tpu_torch.ops import _build

        lib = _build.library()
        print(json.dumps({"fwd_split_max_clusters": {  # noqa: DP101 — the tool's result stream
            cl: lib.dp_gn_fwd_split_clusters(cl, int(isz == 2))
            for cl in range(1, fgn.SPLIT_MAX_CLUSTER + 1)}}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    total = dict(fwd_ms=0.0, bwd_ms=0.0, fwd_bound_ms=0.0, bwd_bound_ms=0.0)
    slabs = [(step_n, hw, c, calls) for (hw, c), calls in sorted(
        rn50_gn_calls(args.img_size).items(),
        key=lambda kv: (-kv[0][0], kv[0][1]))]
    if args.split:
        slabs.append(SPLIT_SLAB + (0,))
    for n, hw, c, calls in slabs:
        side = int(round(hw ** 0.5))
        x = torch.randn((n, side, side, c), generator=gen,
                        device=dev).to(dtype)
        dy = torch.randn((n, side, side, c), generator=gen,
                         device=dev).to(dtype)
        s = 1 + 0.2 * torch.randn((c,), generator=gen, device=dev)
        b = 0.3 * torch.randn((c,), generator=gen, device=dev)
        _, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
        rec = dict(n=n, hw=hw, c=c, calls=calls,
                   fwd_ms=device_ms(lambda: fgn.gn_relu_fwd_kernel(x, s, b)),
                   bwd_ms=device_ms(lambda: fgn.gn_relu_bwd_kernel(
                       x, dy, s, b, mean, rstd, params=False)),
                   fwd_bound_ms=bytes_bound_ms(n, hw, c, 2, isz),
                   bwd_bound_ms=bytes_bound_ms(n, hw, c, 3, isz))
        if hasattr(fgn, "gn_plan"):
            rec["plans"] = {d: fgn.gn_plan(d, n, hw, c, *plan_args)._asdict()
                            for d in ("fwd", "bwd")}
            for d in ("fwd", "bwd"):
                sp = _split_planner(fgn)(d, n, hw, c, isz)
                if sp is not None and (rec["plans"][d]["route"] == "split"
                                       or args.split):
                    rec["plans"][f"{d}_split"] = sp._asdict()
        if args.split:
            split = fgn.GNPlan("split", 0, 0, 0)
            rec["fwd_split_ms"] = device_ms(
                lambda: fgn.gn_relu_fwd_kernel(x, s, b, plan=split))
        if args.sweep and hasattr(fgn, "gn_plan"):
            rec["sweep"] = []
            tall = hw >= max(rn50_gn_calls(args.img_size))[0]
            for direction, plan in _sweep_plans(fgn, n, hw, c, isz,
                                                args.split and tall):
                if direction == "fwd":
                    ms = device_ms(lambda: fgn.gn_relu_fwd_kernel(
                        x, s, b, plan=plan))
                else:
                    ms = device_ms(lambda: fgn.gn_relu_bwd_kernel(
                        x, dy, s, b, mean, rstd, params=False, plan=plan))
                rec["sweep"].append(dict(direction=direction,
                                         route=plan.route,
                                         width=plan.width,
                                         cluster=plan.cluster, ms=ms))
        for k in total:
            total[k] += calls * rec[k]
        print(json.dumps(rec), flush=True)  # noqa: DP101 — the tool's result stream
        del x, dy
        torch.cuda.empty_cache()
    total["fwd_over_bound_ms"] = total["fwd_ms"] - total["fwd_bound_ms"]
    total["bwd_over_bound_ms"] = total["bwd_ms"] - total["bwd_bound_ms"]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "n": step_n,  # noqa: DP101 — the tool's result stream
                      "img_size": args.img_size, "dtype": args.dtype,
                      "per_forward_49_calls": total}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
