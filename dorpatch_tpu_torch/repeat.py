"""Whether the attack repeats bit for bit on the card.

    python -m dorpatch_tpu_torch.repeat                        # RN50, 5 steps
    python -m dorpatch_tpu_torch.repeat --steps 20
    python -m dorpatch_tpu_torch.repeat --base_arch resnet18   # CIFAR
    python -m dorpatch_tpu_torch.repeat --base_arch vit        # ViT-B/16
    python -m dorpatch_tpu_torch.repeat --trials 50            # 50 gradients

From one seed, on the victim given at its main path's dataset, size and
batch (`VICTIMS`, the argv of `chip_smoke.py`'s CIFAR, RN50 and ViT paths;
sampling size 128, dropout 2), under the default numerics
(`utils.configure_numerics`), it runs:

1. the victim's logits and their input gradient on one masked batch,
   `--trials` times each (TRIALS by default), counting the calls that
   differ from the first (part of the check below);
2. the first `--steps` stage-0 attack steps twice, comparing the patch
   (mask and pattern) and the step metrics after every step bit for bit.
   This and step 1 are the check: the exit code is 1 unless every
   gradient call equals the first and the two runs are bit-equal. On
   ResNetV2 steps 1-2 run with the GroupNorm kernels and again with the
   plain GroupNorm.

Two diagnostics follow, which name what a difference comes from:

3. the same steps under `torch.use_deterministic_algorithms(True,
   warn_only=True)` twice, printing the distinct warnings (the operations
   that have no deterministic implementation) and whether those two runs
   agree;
4. step 1's `--trials` gradients and the same steps twice with
   `torch.backends.cudnn.deterministic` off (PyTorch's default, and the
   numerics before `configure_numerics` set it), the one setting that
   restricts cuDNN's convolutions to deterministic algorithms: whether
   the victim needs it, and how often a gradient differs without it.

Prints one line per comparison (first step that differs, largest
difference) and a JSON summary last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import warnings
from typing import NamedTuple

import torch

from dorpatch_tpu_torch import data, masks, utils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.config import AttackConfig
from dorpatch_tpu_torch.losses import local_variance
from dorpatch_tpu_torch.models import get_model
from dorpatch_tpu_torch.ops import masked_fill as mf


class Victim(NamedTuple):
    dataset: str
    img_size: int
    batch: int


#: each victim's main path, as `chip_smoke.py` runs it through the CLI
VICTIMS = {"resnetv2": Victim("imagenet", 224, 2),
           "resnet18": Victim("cifar10", 32, 8),
           "vit": Victim("imagenet", 224, 2)}
SEED, SAMPLING_SIZE, DROPOUT = 1234, 128, 2
#: calls of the victim's gradient the check compares: without cuDNN
#: determinism almost every call differs from the first
TRIALS = 10


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def attack_steps(victim, x: torch.Tensor, steps: int, seed: int = SEED):
    """The patch (mask, pattern) and metrics after each of `steps` stage-0
    attack steps from `seed` (sampling size 128, dropout 2)."""
    cfg = AttackConfig(sampling_size=SAMPLING_SIZE, dropout=DROPOUT)
    attack = DorPatch(victim.apply, victim.num_classes, cfg)
    universe = torch.as_tensor(masks.dropout_universe(x.shape[1], DROPOUT),
                               device=x.device)
    with torch.no_grad():
        y = torch.argmax(victim.apply(x), -1)
    lvx = torch.mean(local_variance(x)[0], dim=-1)
    state = attack._init_state(utils.generator(seed, x.device), x, y, False,
                               universe.shape[0])
    out = []
    for _ in range(steps):
        state = attack._step(state, x, lvx, universe, 0)
        out.append((state.adv_mask.clone(), state.adv_pattern.clone(),
                    state.metrics.clone()))
    if x.is_cuda:
        torch.cuda.synchronize()
    return out


def compare(label: str, a, b) -> dict:
    """First step (1-based) at which two runs of `attack_steps` differ
    (None when bit-equal) and the largest difference."""
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


def victim_repeat(victim, x, label: str, trials: int) -> dict:
    """Logits and input gradient of one masked batch, `trials` times each:
    the largest difference from the first call and how many calls
    differ from it."""
    rects = torch.as_tensor(
        masks.dropout_universe(x.shape[1], DROPOUT)[:SAMPLING_SIZE],
        device=x.device)
    xm = mf.masked_fill(x, rects, 0.5).reshape((-1,) + tuple(x.shape[1:]))
    outs = []
    for _ in range(trials):
        xi = xm.clone().requires_grad_(True)
        logits = victim.apply(xi)
        (g,) = torch.autograd.grad(logits.logsumexp(-1).sum(), xi)
        outs.append((logits.detach(), g))
    if x.is_cuda:
        torch.cuda.synchronize()
    rec = {}
    for i, key in enumerate(("logits", "input_grad")):
        diffs = [_diff(outs[0][i], o[i]) for o in outs[1:]]
        rec[key] = max(diffs, default=0.0)
        rec[key + "_differing"] = sum(d > 0 for d in diffs)
    print(f"{label}: over {trials} calls, logits differ from the first in "
          f"{rec['logits_differing']} (largest difference "
          f"{rec['logits']:.3g}), the input gradient in "
          f"{rec['input_grad_differing']} (largest difference "
          f"{rec['input_grad']:.3g})", flush=True)
    return rec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--base_arch", default="resnetv2", choices=sorted(VICTIMS))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trials", type=int, default=TRIALS,
                   help="calls of the victim's gradient to compare")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    spec = VICTIMS[args.base_arch]
    dev = utils.resolve_device("cuda")
    utils.configure_numerics()
    victim = get_model(spec.dataset, args.base_arch, "/nonexistent",
                       spec.img_size, device=dev)
    x_np, _ = next(data.synthetic_batches(spec.dataset, spec.batch,
                                          spec.img_size, SEED))
    x = torch.as_tensor(x_np, device=dev)
    print(f"device: {torch.cuda.get_device_name(dev)}; {victim.name} at "
          f"{spec.img_size} px, batch {spec.batch}; cudnn benchmark "
          f"{torch.backends.cudnn.benchmark}, deterministic "
          f"{torch.backends.cudnn.deterministic}", flush=True)
    summary = {"arch": victim.name, "steps": args.steps}
    gn = hasattr(victim.model, "set_gn_impl")
    for impl in ("auto", "plain") if gn else ("auto",):
        if gn:
            victim.model.set_gn_impl(impl)
        name = {"auto": "GN kernels", "plain": "plain GN"}[impl] if gn \
            else "default numerics"
        summary[f"victim/{impl}"] = victim_repeat(victim, x, name,
                                                   args.trials)
        runs = [attack_steps(victim, x, args.steps) for _ in range(2)]
        summary[f"attack/{impl}"] = compare(f"attack steps, {name}", *runs)
    if gn:
        victim.model.set_gn_impl("auto")
    repeats = all(summary[f"attack/{impl}"]["first_step"] is None
                  and summary[f"victim/{impl}"]["logits_differing"] == 0
                  and summary[f"victim/{impl}"]["input_grad_differing"] == 0
                  for impl in (("auto", "plain") if gn else ("auto",)))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [attack_steps(victim, x, args.steps) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0] for w in caught})
    for msg in ops:
        print(f"deterministic-mode warning: {msg}", flush=True)
    summary["attack/deterministic"] = compare(
        "diagnostic: attack steps, deterministic algorithms", *runs)
    summary["deterministic_warnings"] = ops

    torch.backends.cudnn.deterministic = False
    try:
        summary["victim/cudnn_nondeterministic"] = victim_repeat(
            victim, x, "diagnostic: cuDNN determinism off", args.trials)
        runs = [attack_steps(victim, x, args.steps) for _ in range(2)]
    finally:
        utils.configure_numerics()
    summary["attack/cudnn_nondeterministic"] = compare(
        "diagnostic: attack steps, cuDNN determinism off", *runs)
    summary["repeats"] = repeats
    print(json.dumps(summary), flush=True)
    return 0 if repeats else 1


if __name__ == "__main__":
    raise SystemExit(main())
