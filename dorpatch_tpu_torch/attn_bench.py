"""Kernel H times on the card at the ViT-B/16 token engine's two shapes.

    python -m dorpatch_tpu_torch.attn_bench                # this checkout
    python dorpatch_tpu_torch/attn_bench.py --tree DIR     # DIR's kernel
    python -m dorpatch_tpu_torch.attn_bench --sweep        # other bf16 plans

At the 0.12 radius of ViT-B/16 at 224 px (2 images, T+1 = 197 tokens, 12
heads of 64) the engine runs kernel H on two shapes (`SHAPES`): the
phase-1 chunk (all 36 first-round masks, S 50 dirty rows an entry) and a
pair-audit chunk (64 of the 630 pairs, S 99), with the engine's own
biases (the stale clean columns of each mask's token set, the duplicate
dirty slots of its padding). For each shape and each form (float32 and
bf16) it times the kernel, its plain version and one
`F.scaled_dot_product_attention` call over the concatenated clean and
dirty keys with the biases as its mask, in the same type, as
`chip_smoke.py` does (`gn_bench.device_ms`: the median of REPS replays of
a CUDA graph of INNER calls), and prints one JSON line per (shape, form)
with the bound: the bytes each input is read and the output written once
at 3.35 TB/s, or the products at the tensor cores' rate (float32: three
TF32 products at 495 TFLOP/s; bf16: one at 989), whichever is longer.

`--tree DIR` imports `dorpatch_tpu_torch` from another checkout (the
parent of a change, unpacked with `git archive`), so that one chip call
times both designs in turn (parent, change, change, parent). `--sweep`
also times the bf16 form's other block plans (`masked_kv_attn.Bf16Plan`:
entries a block, entries a phase, warps), where the checkout has them.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

#: (name, masks of the 0.12 radius: "singles" or "pairs", entries a chunk;
#: None = all of them)
SHAPES = (("phase1", "singles", None), ("pairs", "pairs", 64))
IMG, PATCH, B, H, F = 224, 16, 2, 12, 64
RADIUS = 0.12
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12


def engine_case(torch, dev, kind: str, c, rng):
    """Kernel H's float32 inputs at one engine shape: `(q, kd, vd, kc, vc,
    clean_bias, dirty_bias)` with q scaled by 1/sqrt(f), from `rng`."""
    import numpy as np

    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.models import vit

    t1 = (IMG // PATCH) ** 2 + 1
    singles, doubles = masks_lib.mask_sets(masks_lib.geometry(IMG, RADIUS))
    rects = singles if kind == "singles" else doubles
    table = vit.build_tables(rects, IMG, PATCH)
    idx = table.idx[:c] if c else table.idx
    c, s = idx.shape[0], idx.shape[1]
    stale = (idx[:, :, None] == np.arange(t1)).any(axis=1)   # [c, T+1]
    cb, db = (torch.as_tensor(np.tile(a, (B, 1, 1)), dtype=torch.float32,
                              device=dev)
              for a in (np.where(stale, -1e9, 0.0), table.slot_bias[:c]))
    q, kd, vd = (torch.as_tensor(rng.standard_normal((B, c, s, H, F)),
                                 dtype=torch.float32, device=dev)
                 for _ in range(3))
    kc, vc = (torch.as_tensor(rng.standard_normal((B, t1, H, F)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return q / math.sqrt(F), kd, vd, kc, vc, cb, db


def sdpa_inputs(torch, args):
    """One SDPA call's `(q, k, v, mask)` `[B*C, H, ., f]` for kernel H's
    arguments: the clean keys broadcast to every entry and concatenated
    with its dirty keys, the two biases as the additive mask."""
    q, kd, vd, kc, vc, cb, db = args
    b, c, s, h, f = q.shape
    t1 = kc.shape[1]

    def heads(t):
        return t.permute(0, 1, 3, 2, 4).reshape(b * c, h, -1, f)

    ks, vs = (heads(torch.cat([cl[:, None].expand(b, c, t1, h, f), dt],
                              dim=2)).contiguous()
              for cl, dt in ((kc, kd), (vc, vd)))
    mask = torch.cat([cb, db], dim=-1).reshape(b * c, 1, 1, t1 + s)
    return heads(q).contiguous(), ks, vs, mask


def bound(args):
    """(least milliseconds, "bytes" or "operations", bytes, flops) of
    kernel H on `args`."""
    q, kc = args[0], args[3]
    b, c, s, h, f = q.shape
    t1 = kc.shape[1]
    nbytes = q.element_size() * (4 * b * c * s * h * f + 2 * b * t1 * h * f
                                 + b * c * (t1 + s))
    flops = 4.0 * b * c * h * s * (t1 + s) * f
    ops_ms = (flops / PEAK_BF16_FLOPS if q.element_size() == 2
              else 3 * flops / PEAK_TF32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", nbytes, flops)


def _plans(mka, b, c, s, h, t, f, sms):
    """Other bf16 block plans of one shape: entries a block 1 to 8 and the
    default's, a phase 1 to the default's, warps of one item each, where
    the shared memory fits a block."""
    from dorpatch_tpu_torch.ops import _build

    default = mka.bf16_plan(b, c, s, h, t, f, sms)
    tiles = -(-s // mka.ITEM_ROWS)
    out = []
    for g in sorted({1, 2, 3, 4, 6, 8, default.entries}):
        for e in range(1, min(g, default.per_phase) + 1):
            smem = mka.bf16_smem(t, s, f, e, min(mka.MAX_SLOTS, -(-g // e)),
                                 default.clean)
            plan = mka.Bf16Plan(g, e, min(mka.MAX_WARPS, e * tiles),
                                default.clean, smem)
            if plan != default and smem <= _build.MAX_SMEM_BYTES:
                out.append(plan)
    return default, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=None,
                   help="checkout whose dorpatch_tpu_torch to time")
    p.add_argument("--sweep", action="store_true")
    args = p.parse_args(argv)
    if args.tree and "dorpatch_tpu_torch" in sys.modules:
        p.error("--tree needs the script path (python "
                "dorpatch_tpu_torch/attn_bench.py --tree DIR), not -m")
    root = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as Fn

    from dorpatch_tpu_torch.gn_bench import device_ms
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    if not torch.cuda.is_available():
        print("attn_bench: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"tree {root}; device {torch.cuda.get_device_name(0)}; ViT-B/16 "
          f"at {IMG} px, radius {RADIUS}, B = {B}", flush=True)
    rng = np.random.default_rng(4)
    for name, kind, c in SHAPES:
        args32 = engine_case(torch, dev, kind, c, rng)
        for dtype in (torch.float32, torch.bfloat16):
            a = tuple(t.to(dtype) for t in args32)
            lib_args = sdpa_inputs(torch, a)
            ms_bound, by, nbytes, flops = bound(a)
            b, cc, s, h, f = a[0].shape
            t1 = a[3].shape[1]
            rec = dict(
                shape=name, dtype=str(dtype).replace("torch.", ""),
                B=b, C=cc, S=s, H=h, f=f, T=t1,
                ms=device_ms(lambda: mka.masked_kv_attention_kernel(*a)),
                plain_ms=device_ms(
                    lambda: mka.masked_kv_attention_reference(*a)),
                library_ms=device_ms(lambda: Fn.scaled_dot_product_attention(
                    *lib_args[:3], attn_mask=lib_args[3], scale=1.0)),
                bound_ms=ms_bound, bound_by=by, bytes=nbytes, flops=flops)
            if dtype == torch.bfloat16 and hasattr(mka, "bf16_plan"):
                default, others = _plans(
                    mka, b, cc, s, h, t1, f,
                    torch.cuda.get_device_properties(0).multi_processor_count)
                rec["plan"] = default._asdict()
                if args.sweep:
                    rec["sweep"] = [dict(plan._asdict(), ms=device_ms(
                        lambda: mka.masked_kv_attention_kernel(
                            *a, plan=plan))) for plan in others]
            print(json.dumps(rec), flush=True)
            del a, lib_args
        del args32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
