"""Checkpoint verifier: `python -m dorpatch_tpu_torch.models.verify <ckpt.pth>`.

Port of `dorpatch_tpu.models.verify`. The reference's model layer is "timm
model + PatchCleanser-release checkpoint"; the port's victims carry timm's
parameter names, so such a `.pth` loads into them with `strict=True`
(`models/registry.get_model`). This tool takes a checkpoint file and

- diffs its key/shape set against the vendored timm-0.6.7 contract
  (`models/timm_keys.py`): missing, unexpected and shape-drifted keys;
- loads it into the port's victim with `strict=True`;
- on the card (`--device cuda`, the default), runs the victim on a batch
  of seeded random images with its kernels, and again on the CPU with
  their plain versions, and reports `max_abs_delta` (the largest
  |logit delta|), `per_image_delta` and `argmax_agree`. Within `--tol`
  (default 1e-4, the port's logit tolerance) and with every argmax equal
  it exits 0; otherwise 1.

The JAX tool compares its flax model with a torch twin on the same
weights; the port has no flax side, so its logit check holds the kernels
against their plain versions on the loaded weights. `--device cpu` (and
`--keys-only`) stops at keys and shapes.

Usage:
  python -m dorpatch_tpu_torch.models.verify path/to/resnetv2_50x1_bit_distilled_cutout2_128_imagenet.pth
  python -m dorpatch_tpu_torch.models.verify ckpt.pth --arch vit --dataset imagenet
  python -m dorpatch_tpu_torch.models.verify ckpt.pth --keys-only
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from dorpatch_tpu_torch import observe, utils
from dorpatch_tpu_torch.config import NUM_CLASSES
from dorpatch_tpu_torch.models import registry, timm_keys
from dorpatch_tpu_torch.models.convert import load_state_dict


def _infer_arch(path: str) -> str:
    base = os.path.basename(path)
    # cifar_vit before vit: a "cifar_vit_*" filename contains both
    for arch in ("cifar_vit", "resnetv2", "vit", "resmlp", "resnet18"):
        if arch in base:
            return arch
    return "resnetv2"


def _infer_dataset(path: str) -> str:
    base = os.path.basename(path)
    for ds in ("imagenet", "cifar100", "cifar10"):
        if ds in base:
            return ds
    return "imagenet"


def verify_keys(ckpt_path: str, arch: str, dataset: str) -> dict:
    """Diff the checkpoint's keys/shapes against the vendored timm contract.

    Returns {"arch", "n_keys", "missing", "unexpected", "shape_drift"};
    clean iff the last three are empty."""
    timm_name = registry.resolve_arch(arch)
    sd = load_state_dict(ckpt_path)
    report = timm_keys.diff_against_contract(
        sd.keys(), timm_name, NUM_CLASSES[dataset],
        sd_shapes={k: tuple(v.shape) for k, v in sd.items()})
    report.update(arch=timm_name, n_keys=len(sd))
    return report


def verify_checkpoint(ckpt_path: str, arch: str, dataset: str,
                      batch: int = 4, img_size: int = 224, seed: int = 0,
                      device="cuda") -> dict:
    """Hold the checkpoint to the key contract, load it with `strict=True`
    and, on the card, compare the victim's logits there with the CPU's on
    seeded images. Raises KeyError when the keys miss the contract.

    Report keys: `arch`, `dataset`, `n_params` (state-dict tensors),
    `device`, and on the card `max_abs_delta`, `per_image_delta`,
    `argmax_agree`."""
    keys = verify_keys(ckpt_path, arch, dataset)
    drift = keys["missing"] or keys["unexpected"] or keys["shape_drift"]
    if drift:
        raise KeyError(
            f"checkpoint keys miss the {keys['arch']} contract: "
            f"missing={keys['missing'][:5]} "
            f"unexpected={keys['unexpected'][:5]} "
            f"shape_drift={keys['shape_drift'][:5]} (of "
            f"{len(keys['missing'])}/{len(keys['unexpected'])}/"
            f"{len(keys['shape_drift'])})")
    dev = utils.resolve_device(device)
    timm_name, n_classes = keys["arch"], NUM_CLASSES[dataset]
    model = registry.build_bare_model(timm_name, n_classes, img_size, seed)
    model.load_state_dict(load_state_dict(ckpt_path), strict=True)
    model = model.eval().requires_grad_(False)
    report = {"arch": timm_name, "dataset": dataset,
              "n_params": keys["n_keys"], "device": str(dev)}
    if dev.type == "cpu":
        return report
    utils.configure_numerics()
    x = np.random.default_rng(seed).random(
        (batch, img_size, img_size, 3), dtype=np.float32)
    with torch.no_grad():
        cpu = registry.VictimForward(model)(torch.from_numpy(x)).numpy()
        card = registry.VictimForward(model.to(dev))(
            torch.from_numpy(x).to(dev)).cpu().numpy()
    delta = np.abs(card - cpu)
    report.update(
        max_abs_delta=float(delta.max()),
        per_image_delta=[float(d) for d in delta.max(axis=1)],
        argmax_agree=bool((card.argmax(-1) == cpu.argmax(-1)).all()))
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Verify a timm/PatchCleanser checkpoint against the "
        "vendored timm key contract and the port's kernels against their "
        "plain versions on its weights")
    p.add_argument("checkpoint", help="path to the .pth file")
    p.add_argument("--arch", default=None,
                   choices=["resnetv2", "vit", "resmlp", "resnet18",
                            "cifar_vit"],
                   help="architecture (default: inferred from the filename)")
    p.add_argument("--dataset", default=None,
                   choices=["imagenet", "cifar10", "cifar100"],
                   help="dataset -> class count (default: inferred)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--img-size", type=int, default=0,
                   help="0 = by arch: 32 for the small trained-victim "
                        "families (fixed pos_embed for cifar_vit), 224 "
                        "for the timm models")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tol", type=float, default=1e-4,
                   help="largest |logit delta| between the card and the CPU")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: compare the card's logits with the CPU's; "
                        "cpu: keys and shapes only")
    p.add_argument("--keys-only", action="store_true",
                   help="only diff the checkpoint's key/shape set against "
                   "the vendored timm-0.6.7 contract (models/timm_keys.py)")
    args = p.parse_args(argv)

    if not os.path.exists(args.checkpoint):
        observe.log(f"checkpoint not found: {args.checkpoint}",
                    file=sys.stderr)
        return 2
    arch = args.arch or _infer_arch(args.checkpoint)
    dataset = args.dataset or _infer_dataset(args.checkpoint)
    if args.keys_only:
        report = verify_keys(args.checkpoint, arch, dataset)
        drift = (report["missing"] or report["unexpected"]
                 or report["shape_drift"])
        verdict = "FAIL" if drift else "OK"
        observe.log(f"[{verdict}] {report['arch']}: {report['n_keys']} keys "
                    f"vs vendored timm-0.6.7 contract — "
                    f"{len(report['missing'])} missing, "
                    f"{len(report['unexpected'])} unexpected, "
                    f"{len(report['shape_drift'])} shape-drifted")
        for field in ("missing", "unexpected", "shape_drift"):
            for item in report[field][:20]:
                observe.log(f"  {field}: {item}")
        return 1 if drift else 0
    img_size = args.img_size or (
        32 if arch in ("resnet18", "cifar_resnet18", "cifar_vit") else 224)
    try:
        report = verify_checkpoint(args.checkpoint, arch, dataset,
                                   args.batch, img_size, args.seed,
                                   args.device)
    except KeyError as e:
        observe.log(f"[FAIL] {e.args[0]}")
        return 1
    if args.device == "cpu":
        observe.log(f"[OK] {report['arch']} ({report['dataset']}): "
                    f"{report['n_params']} keys meet the vendored timm "
                    "contract and load with strict=True")
        ok = True
    else:
        ok = report["max_abs_delta"] <= args.tol and report["argmax_agree"]
        observe.log(f"[{'OK' if ok else 'FAIL'}] {report['arch']} "
                    f"({report['dataset']}): max |logit delta| card vs "
                    f"CPU = {report['max_abs_delta']:.3e} (tol "
                    f"{args.tol:g}), argmax agree = "
                    f"{report['argmax_agree']}, {report['n_params']} "
                    "state-dict tensors")
        if not ok:
            observe.log(f"per-image max deltas: {report['per_image_delta']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
