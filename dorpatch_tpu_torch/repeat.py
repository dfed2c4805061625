"""Whether the RN50 attack repeats bit for bit on the card.

    python -m dorpatch_tpu_torch.repeat            # 5 steps
    python -m dorpatch_tpu_torch.repeat --steps 20

From one seed, on ResNetV2-50x1 at 224 px (2 images, sampling size 128,
dropout 2: the RN50 main path's attack), it runs:

1. the victim's logits and their input gradient on one masked batch (256
   images), twice each, with the GroupNorm kernels and with the plain
   GroupNorm;
2. the first `--steps` stage-0 attack steps twice with the GroupNorm
   kernels and twice with the plain GroupNorm, comparing the patch (mask
   and pattern) and the step metrics after every step bit for bit;
3. the same steps under `torch.use_deterministic_algorithms(True,
   warn_only=True)` twice, printing the distinct warnings (the operations
   that have no deterministic implementation) and whether those two runs
   agree;
4. the same steps twice with only `torch.backends.cudnn.deterministic`
   set, which restricts cuDNN's convolutions to deterministic algorithms
   and changes nothing else.

Prints one line per comparison (first step that differs, largest
difference) and a JSON summary last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import warnings

import torch

from dorpatch_tpu_torch import data, masks, utils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.config import AttackConfig
from dorpatch_tpu_torch.losses import local_variance
from dorpatch_tpu_torch.models import get_model
from dorpatch_tpu_torch.ops import masked_fill as mf

SEED, SIZE, BATCH = 1234, 224, 2


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def _steps(victim, x, steps: int):
    """The patch (mask, pattern) and metrics after each of `steps` attack
    steps from the seed."""
    cfg = AttackConfig(sampling_size=128, dropout=2)
    attack = DorPatch(victim.apply, victim.num_classes, cfg)
    universe = torch.as_tensor(masks.dropout_universe(SIZE, 2),
                               device=x.device)
    with torch.no_grad():
        y = torch.argmax(victim.apply(x), -1)
    lvx = torch.mean(local_variance(x)[0], dim=-1)
    state = attack._init_state(utils.generator(SEED, x.device), x, y, False,
                               universe.shape[0])
    out = []
    for _ in range(steps):
        state = attack._step(state, x, lvx, universe, 0)
        out.append((state.adv_mask.clone(), state.adv_pattern.clone(),
                    state.metrics.clone()))
    torch.cuda.synchronize()
    return out


def _compare(label: str, a, b) -> dict:
    first, worst = None, 0.0
    for i, (sa, sb) in enumerate(zip(a, b)):
        d = max(_diff(p, q) for p, q in zip(sa, sb))
        if d > 0 and first is None:
            first = i + 1
        worst = max(worst, d)
    print(f"{label}: {'bit-equal' if first is None else 'differ'} over "
          f"{len(a)} steps; first differing step {first}, largest "
          f"difference {worst:.3g}", flush=True)
    return dict(first_step=first, max_abs=worst)


def _victim_repeat(victim, x, label: str) -> dict:
    """Logits and input gradient of one masked batch, twice each."""
    rects = torch.as_tensor(masks.dropout_universe(SIZE, 2)[:128],
                            device=x.device)
    xm = mf.masked_fill(x, rects, 0.5).reshape(-1, SIZE, SIZE, 3)
    outs = []
    for _ in range(2):
        xi = xm.clone().requires_grad_(True)
        logits = victim.apply(xi)
        (g,) = torch.autograd.grad(logits.logsumexp(-1).sum(), xi)
        outs.append((logits.detach(), g))
    torch.cuda.synchronize()
    rec = dict(logits=_diff(outs[0][0], outs[1][0]),
               input_grad=_diff(outs[0][1], outs[1][1]))
    same = "bit-equal" if rec["logits"] == 0 else "differ"
    print(f"{label}: logits repeat {same} (largest difference "
          f"{rec['logits']:.3g}); input gradient "
          f"{'bit-equal' if rec['input_grad'] == 0 else 'differs'} "
          f"(largest difference {rec['input_grad']:.3g})", flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    dev = utils.resolve_device("cuda")
    utils.configure_numerics()
    victim = get_model("imagenet", "resnetv2", "/nonexistent", SIZE,
                       device=dev)
    x_np, _ = next(data.synthetic_batches("imagenet", BATCH, SIZE, SEED))
    x = torch.as_tensor(x_np, device=dev)
    print(f"device: {torch.cuda.get_device_name(dev)}; cudnn benchmark "
          f"{torch.backends.cudnn.benchmark}, deterministic "
          f"{torch.backends.cudnn.deterministic}", flush=True)
    summary = {}
    for impl in ("auto", "plain"):
        victim.model.set_gn_impl(impl)
        name = "GN kernels" if impl == "auto" else "plain GN"
        summary[f"victim/{impl}"] = _victim_repeat(victim, x, name)
        runs = [_steps(victim, x, args.steps) for _ in range(2)]
        summary[f"attack/{impl}"] = _compare(f"attack steps, {name}", *runs)
    victim.model.set_gn_impl("auto")

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [_steps(victim, x, args.steps) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0] for w in caught})
    for msg in ops:
        print(f"deterministic-mode warning: {msg}", flush=True)
    summary["attack/deterministic"] = _compare(
        "attack steps, GN kernels, deterministic algorithms", *runs)
    summary["deterministic_warnings"] = ops

    torch.backends.cudnn.deterministic = True
    try:
        runs = [_steps(victim, x, args.steps) for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = False
    summary["attack/cudnn_deterministic"] = _compare(
        "attack steps, GN kernels, cuDNN deterministic only", *runs)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
