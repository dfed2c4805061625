"""Victim-model factory.

Resolves an architecture name, loads the `<model_dir>/<dataset>/
<arch>_cutout2_128_<dataset>.pth` checkpoint when present (seeded random
initialization otherwise) and wraps the model as a `Victim` whose `apply`
(a `VictimForward`) takes NHWC images in [0, 1] with the `(x - 0.5) / 0.5`
normalization folded in; `apply.at(torch.bfloat16)` is the same forward on
a once-cast bf16 copy of the model (the bf16 attack and certify bank).
Port of `dorpatch_tpu.models.registry` for the CIFAR ResNet-18,
ResNetV2-50x1 BiT and the ViT family (ViT-B/16 and the small `cifar_vit`).
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple

import torch

from dorpatch_tpu_torch import utils
from dorpatch_tpu_torch.config import NUM_CLASSES
from dorpatch_tpu_torch.models import resnetv2, small, vit
from dorpatch_tpu_torch.ops.stem_fold import StemFoldEngine, same_pads

#: timm model names, matched by substring as in the JAX package (the ResMLP
#: family joins with its slice)
TIMM_MODELS = ("resnetv2_50x1_bit_distilled", "vit_base_patch16_224")
SUPPORTED = TIMM_MODELS + ("cifar_resnet18", "cifar_vit")
#: the families whose module is sized by the image (the position embedding)
#: and whose incremental engine is the token-pruned one
VIT_FAMILIES = ("vit_base_patch16_224", "cifar_vit")


def normalize(images01: torch.Tensor) -> torch.Tensor:
    """The folded victim normalization (mean = std = 0.5)."""
    return (images01 - 0.5) / 0.5


class VictimForward:
    """`logits = forward(images01)`: the model on NHWC images in [0, 1],
    the normalization folded in. `at(dtype)` is the same forward on a
    `dtype` copy of the model (`utils.cast_module`, made at the first call
    and kept), which casts the images at its boundary and returns float32
    logits; `at(float32)` is the forward itself. A change to the model's
    weights after that first call does not reach the copy."""

    def __init__(self, model: torch.nn.Module,
                 dtype: torch.dtype = torch.float32):
        self.model = model
        self.dtype = dtype
        self._casts = {}

    def __call__(self, images01: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return self.model(normalize(images01))
        return self.model(normalize(images01.to(self.dtype))).float()

    def at(self, dtype: torch.dtype) -> "VictimForward":
        if dtype == self.dtype:
            return self
        if self.dtype != torch.float32:
            raise ValueError("cast copies are made from the float32 forward")
        if dtype not in self._casts:
            self._casts[dtype] = VictimForward(
                utils.cast_module(self.model, dtype), dtype)
        return self._casts[dtype]


class Victim(NamedTuple):
    """A frozen classifier: `logits = apply(images01)`, images NHWC in
    [0, 1] on `device`. `incremental` is the family's incremental engine
    (masked-stem fold or token-pruned ViT)."""

    name: str
    apply: Callable[[torch.Tensor], torch.Tensor]
    model: torch.nn.Module
    num_classes: int
    from_checkpoint: bool
    device: torch.device
    incremental: Any = None


def resolve_arch(arch: str) -> str:
    """'resnet18'/'cifar_resnet18', 'cifar_vit', or a substring of a
    supported timm name (`--base_arch resnetv2`, `--base_arch vit`)."""
    if arch in ("resnet18", "cifar_resnet18"):
        return "cifar_resnet18"
    if arch == "cifar_vit":
        return "cifar_vit"
    for tm in TIMM_MODELS:
        if arch in tm:
            return tm
    raise ValueError(f"unknown architecture {arch!r}; this port supports "
                     f"{SUPPORTED}")


def checkpoint_path(model_dir: str, dataset: str, timm_name: str) -> str:
    """The PatchCleanser-release checkpoint naming contract."""
    return os.path.join(model_dir, dataset,
                        f"{timm_name}_cutout2_128_{dataset}.pth")


#: each family's constructor and seeded initializer `(module, generator)`,
#: by resolved name; the constructor takes `(num_classes)`, and
#: `(num_classes, img_size)` for the `VIT_FAMILIES`
_FAMILIES = {
    "resnetv2_50x1_bit_distilled": (resnetv2.resnetv2_50x1,
                                    resnetv2.init_weights),
    "cifar_resnet18": (lambda k: small.CifarResNet18(num_classes=k),
                       small.init_weights),
    "vit_base_patch16_224": (vit.vit_base_patch16, vit.init_weights),
    "cifar_vit": (vit.vit_cifar, vit.init_weights),
}


#: d(normalized)/d(image01): the scale the masked-stem fold applies to the
#: fill delta.
NORM_SCALE = 2.0


def incremental_engine(timm_name: str, model, img_size: int):
    """The family's mask-aware incremental engine: the token-pruned engine
    of a ViT (None when the patch does not divide the image), or the
    masked-stem fold of the CIFAR ResNet-18's 3x3, stride-1, pad-1 stem or
    of ResNetV2's 7x7, stride-2, SAME-padded std-conv stem (the fold's delta
    conv uses the standardized kernel, the stem's effective one). The
    engines run at the defense's `compute_dtype`: its families are built
    with it (`build_family(..., compute_dtype)`) and take the engine's
    once-cast copy (`at`)."""
    if timm_name in VIT_FAMILIES:
        if img_size % model.patch_size:
            return None
        return vit.TokenPrunedViT(model, img_size, normalize=normalize)
    if timm_name == "cifar_resnet18":
        return StemFoldEngine(
            model, img_size,
            kernel_fn=lambda m: m.stem.weight.permute(2, 3, 1, 0),
            kernel_hw=3, strides=(1, 1), pads=((1, 1), (1, 1)),
            normalize=normalize, norm_scale=NORM_SCALE)
    if timm_name == "resnetv2_50x1_bit_distilled":
        stem = model.stem["conv"]
        pads = same_pads(img_size, stem.k, stem.stride)
        return StemFoldEngine(
            model, img_size,
            kernel_fn=lambda m: m.stem["conv"].standardized().permute(
                2, 3, 1, 0),
            kernel_hw=stem.k, strides=(stem.stride, stem.stride),
            pads=(pads, pads), normalize=normalize, norm_scale=NORM_SCALE)
    return None


def get_model(
    dataset: str,
    arch: str = "resnetv2",
    model_dir: str = "pretrained_models/",
    img_size: int = 224,
    seed: int = 0,
    device="cuda",
) -> Victim:
    """Build the victim on `device` ("cuda" unless the caller asks for
    "cpu"). Loads the checkpoint when present, else initializes from
    `seed`."""
    dev = utils.resolve_device(device)
    timm_name = resolve_arch(arch)
    num_classes = NUM_CLASSES[dataset]
    build, init_weights = _FAMILIES[timm_name]
    model = (build(num_classes, img_size) if timm_name in VIT_FAMILIES
             else build(num_classes))
    ckpt = checkpoint_path(model_dir, dataset, timm_name)
    if os.path.exists(ckpt):
        from dorpatch_tpu_torch.models.convert import load_state_dict

        model.load_state_dict(load_state_dict(ckpt))
        from_checkpoint = True
    else:
        init_weights(model, utils.generator(seed, torch.device("cpu")))
        from_checkpoint = False
    model = model.to(dev).eval().requires_grad_(False)
    return Victim(name=timm_name, apply=VictimForward(model), model=model,
                  num_classes=num_classes, from_checkpoint=from_checkpoint,
                  device=dev,
                  incremental=incremental_engine(timm_name, model, img_size))
