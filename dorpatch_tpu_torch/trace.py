"""Where a main path's device time goes, on the card.

    python -m dorpatch_tpu_torch.trace                   # ResNetV2-50x1, 224
    python -m dorpatch_tpu_torch.trace --base_arch resnet18 --img-size 32 \\
        --batch 8                                        # CIFAR ResNet-18
    python -m dorpatch_tpu_torch.trace --base_arch vit   # ViT-B/16, 224
    python -m dorpatch_tpu_torch.trace --compute-dtype bfloat16 \
        --certify-dtype bfloat16                         # the bf16 paths

Runs the pieces of the main path for the victim given (by default the
port's default victim at 224 px and 2 images, as the RN50 main path runs
it; full width, random weights from the seed; `cifar10` for resnet18,
`imagenet` for resnetv2 and vit; synthetic images) under `torch.profiler`,
each after a warm-up:

- `attack_step`: 5 stage-0 optimizer steps at sampling size 128
  over the dropout=2 universe (2520 masks);
- `sweep`: one full-universe failure sweep;
- `certify`: one pruned certification at each of the four radii, with the
  family's incremental engine ("auto": the stem fold for the conv
  victims, the token-pruned engine with its escalations for the ViT).

`--compute-dtype` sets the attack's precision (steps and sweep) and
`--certify-dtype` the certification's, as the CLI's flags do.

For each phase it prints the wall time per call (host clock around work
that ends in a synchronize), the device-busy time (union of the kernels'
intervals), the idle share of the wall time, and device time by kernel
group (the GroupNorm kernels, kernel H, the port's other kernels,
convolutions and matrix products, softmax, reductions, elementwise,
other), then one
JSON line with all of it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from dorpatch_tpu_torch import data, masks, utils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.config import AttackConfig, DefenseConfig
from dorpatch_tpu_torch.defense import build_defenses
from dorpatch_tpu_torch.losses import local_variance
from dorpatch_tpu_torch.models import get_model

SEED, STEPS = 1234, 5
DATASET = {"resnet18": "cifar10", "resnetv2": "imagenet", "vit": "imagenet"}

_GROUPS = (
    ("gn kernels", ("gn_fwd_", "gn_bwd_", "gn_param_")),
    ("kernel H", ("masked_kv_attn",)),
    ("port kernels", ("fill_fwd", "fill_bwd", "stem_fold")),
    ("conv/matmul", ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad",
                     "dgrad", "implicit", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_events(prof):
    out = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out.append((ev.time_range.start, ev.time_range.end, ev.name))
    return out


def _busy_us(events) -> float:
    """Length of the union of the device intervals (microseconds)."""
    busy, end = 0.0, -float("inf")
    for s, e, _ in sorted(events):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_phase(name: str, fn, calls: int) -> dict:
    fn()                                   # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    by_group = defaultdict(float)
    by_kernel = defaultdict(float)
    for s, e, kname in events:
        by_group[_group(kname)] += (e - s) / 1e3
        by_kernel[kname] += (e - s) / 1e3
    busy_ms = _busy_us(events) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    rec = dict(phase=name, calls=calls, wall_ms=wall_ms / calls,
               device_busy_ms=busy_ms / calls if events else None,
               idle_share=(1.0 - busy_ms / wall_ms) if events else None,
               kernels=len(events),
               group_ms={g: v / calls for g, v in sorted(by_group.items())},
               top_kernels=[(k[:90], v / calls) for k, v in top])
    print(f"{name}: {rec['wall_ms']:.3f} ms wall per call, device busy "
          f"{rec['device_busy_ms']} ms, idle share {rec['idle_share']}",
          flush=True)
    for g, v in rec["group_ms"].items():
        print(f"  {g:14s} {v:10.3f} ms", flush=True)
    for k, v in rec["top_kernels"]:
        print(f"  {v:10.3f} ms  {k}", flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--base_arch", default="resnetv2", choices=sorted(DATASET))
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--certify-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    args = p.parse_args(argv)
    size, batch, dataset = args.img_size, args.batch, DATASET[args.base_arch]
    dev = utils.resolve_device("cuda")
    utils.configure_numerics()
    victim = get_model(dataset, args.base_arch, "/nonexistent", size,
                       device=dev)
    x_np, _ = next(data.synthetic_batches(dataset, batch, size, SEED))
    x = torch.as_tensor(x_np, device=dev)
    with torch.no_grad():
        y = torch.argmax(victim.apply(x), -1)
    cfg = AttackConfig(sampling_size=128, dropout=2,
                       compute_dtype=args.compute_dtype)
    attack = DorPatch(victim.apply, victim.num_classes, cfg)
    universe = torch.as_tensor(masks.dropout_universe(size, 2), device=dev)
    lvx = torch.mean(local_variance(x)[0], dim=-1)
    state = attack._init_state(utils.generator(SEED, dev), x, y, False,
                               universe.shape[0])
    holder = {"state": state}

    def step():
        holder["state"] = attack._step(holder["state"], x, lvx, universe, 0)

    def sweep():
        s = holder["state"]
        attack.sweep_failures(s.adv_mask, s.adv_pattern, x, s.y, s.targeted,
                              universe)

    defenses = build_defenses(
        victim.apply, size, DefenseConfig(compute_dtype=args.certify_dtype),
        incremental=victim.incremental, device=dev)

    def certify():
        for d in defenses:
            d.robust_predict(x, victim.num_classes,
                             bucket_sizes=data.batch_buckets(batch))

    name = torch.cuda.get_device_name(dev)
    print(f"device: {name}", flush=True)
    phases = [profile_phase("attack_step", step, STEPS),
              profile_phase("sweep", sweep, 1),
              profile_phase("certify", certify, 1)]
    print(json.dumps({"device": name, "arch": victim.name, "img_size": size,
                      "batch": batch, "compute_dtype": args.compute_dtype,
                      "certify_dtype": args.certify_dtype, "phases": phases},
                     default=float), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
