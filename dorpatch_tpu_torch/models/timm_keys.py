"""Vendored timm 0.6.7 state-dict key contracts for the reference victims.

A copy of `dorpatch_tpu.models.timm_keys` (plain Python, the same
functions, keys and shapes). The reference's model layer is "timm model +
PatchCleanser checkpoint", and no timm nor real checkpoint exists in this
build environment, so the port's module trees, whose parameter names
follow timm's so that a `.pth` loads with `strict=True`
(`models/registry.get_model`), are held to this pinned contract instead:
the exact state-dict keys (and shapes) of the three timm 0.6.7
architectures, reconstructed from their module trees:

- `timm/models/resnetv2.py` — ResNetV2(layers=(3,4,6,3)) of `ResNetStage`s
  of `PreActBottleneck`s (norm1..3 GroupNormAct, conv1..3 StdConv2d,
  `DownsampleConv(preact=True)` = bare conv on every stage's block 0), a
  bias-free stem conv, final GroupNormAct `norm`, and a
  `ClassifierHead(use_conv=True)` 1x1-conv `head.fc`.
- `timm/models/vision_transformer.py` — VisionTransformer(depth=12):
  cls_token/pos_embed, `patch_embed.proj` conv, per-block
  norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 / mlp.fc2, final `norm`,
  Linear `head` (no pre_logits/fc_norm/dist_token in this variant; ls1/ls2
  are Identity at init_values=None).
- `timm/models/mlp_mixer.py` — MlpMixer(block_layer=ResBlock, depth=24):
  the patch embed is named `stem` (NOT ViT's `patch_embed`), `Affine`
  alpha/beta are stored [1, 1, D], ls1/ls2 are bare [D] parameters, and
  blocks live in one flat `nn.Sequential` (`blocks.{i}.`).

Checkpoints are saved *after* `reset_classifier(num_classes)`, so head
shapes take `num_classes`.

`state_dict_contract(timm_name, num_classes)` -> OrderedDict[key, shape].
Consumer: `python -m dorpatch_tpu_torch.models.verify` (`--keys-only` and
the key check before its logit comparison).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

Shape = Tuple[int, ...]


def resnetv2_50x1_keys(num_classes: int) -> "OrderedDict[str, Shape]":
    """`resnetv2_50x1_bit_distilled`: layers (3,4,6,3), width factor 1."""
    keys: "OrderedDict[str, Shape]" = OrderedDict()
    keys["stem.conv.weight"] = (64, 3, 7, 7)
    layers = (3, 4, 6, 3)
    for s, depth in enumerate(layers):
        mid = 64 * (2 ** s)
        out = 4 * mid
        for b in range(depth):
            cin = (64 if s == 0 else 2 * mid) if b == 0 else out
            pre = f"stages.{s}.blocks.{b}."
            keys[pre + "norm1.weight"] = (cin,)
            keys[pre + "norm1.bias"] = (cin,)
            keys[pre + "conv1.weight"] = (mid, cin, 1, 1)
            keys[pre + "norm2.weight"] = (mid,)
            keys[pre + "norm2.bias"] = (mid,)
            keys[pre + "conv2.weight"] = (mid, mid, 3, 3)
            keys[pre + "norm3.weight"] = (mid,)
            keys[pre + "norm3.bias"] = (mid,)
            keys[pre + "conv3.weight"] = (out, mid, 1, 1)
            if b == 0:
                keys[pre + "downsample.conv.weight"] = (out, cin, 1, 1)
    keys["norm.weight"] = (2048,)
    keys["norm.bias"] = (2048,)
    keys["head.fc.weight"] = (num_classes, 2048, 1, 1)
    keys["head.fc.bias"] = (num_classes,)
    return keys


def vit_base_patch16_224_keys(num_classes: int) -> "OrderedDict[str, Shape]":
    return _vit_keys(num_classes, dim=768, depth=12, n_tokens=197, patch=16)


def cifar_vit_keys(num_classes: int) -> "OrderedDict[str, Shape]":
    """The framework's OWN small transformer-victim contract (not a timm
    model): `models/vit.py:CIFAR_VIT` as `train.py` exports it — 8x8
    grid of 4px patches + cls = 65 tokens, dim 128, depth 6."""
    return _vit_keys(num_classes, dim=128, depth=6, n_tokens=65, patch=4)


def _vit_keys(num_classes: int, dim: int, depth: int, n_tokens: int,
              patch: int) -> "OrderedDict[str, Shape]":
    mlp = 4 * dim
    keys: "OrderedDict[str, Shape]" = OrderedDict()
    keys["cls_token"] = (1, 1, dim)
    keys["pos_embed"] = (1, n_tokens, dim)
    keys["patch_embed.proj.weight"] = (dim, 3, patch, patch)
    keys["patch_embed.proj.bias"] = (dim,)
    for i in range(depth):
        pre = f"blocks.{i}."
        keys[pre + "norm1.weight"] = (dim,)
        keys[pre + "norm1.bias"] = (dim,)
        keys[pre + "attn.qkv.weight"] = (3 * dim, dim)
        keys[pre + "attn.qkv.bias"] = (3 * dim,)
        keys[pre + "attn.proj.weight"] = (dim, dim)
        keys[pre + "attn.proj.bias"] = (dim,)
        keys[pre + "norm2.weight"] = (dim,)
        keys[pre + "norm2.bias"] = (dim,)
        keys[pre + "mlp.fc1.weight"] = (mlp, dim)
        keys[pre + "mlp.fc1.bias"] = (mlp,)
        keys[pre + "mlp.fc2.weight"] = (dim, mlp)
        keys[pre + "mlp.fc2.bias"] = (dim,)
    keys["norm.weight"] = (dim,)
    keys["norm.bias"] = (dim,)
    keys["head.weight"] = (num_classes, dim)
    keys["head.bias"] = (num_classes,)
    return keys


def resmlp_24_keys(num_classes: int) -> "OrderedDict[str, Shape]":
    dim, depth, seq, hidden = 384, 24, 196, 1536
    keys: "OrderedDict[str, Shape]" = OrderedDict()
    keys["stem.proj.weight"] = (dim, 3, 16, 16)
    keys["stem.proj.bias"] = (dim,)
    for i in range(depth):
        pre = f"blocks.{i}."
        keys[pre + "norm1.alpha"] = (1, 1, dim)
        keys[pre + "norm1.beta"] = (1, 1, dim)
        keys[pre + "linear_tokens.weight"] = (seq, seq)
        keys[pre + "linear_tokens.bias"] = (seq,)
        keys[pre + "norm2.alpha"] = (1, 1, dim)
        keys[pre + "norm2.beta"] = (1, 1, dim)
        keys[pre + "mlp_channels.fc1.weight"] = (hidden, dim)
        keys[pre + "mlp_channels.fc1.bias"] = (hidden,)
        keys[pre + "mlp_channels.fc2.weight"] = (dim, hidden)
        keys[pre + "mlp_channels.fc2.bias"] = (dim,)
        keys[pre + "ls1"] = (dim,)
        keys[pre + "ls2"] = (dim,)
    keys["norm.alpha"] = (1, 1, dim)
    keys["norm.beta"] = (1, 1, dim)
    keys["head.weight"] = (num_classes, dim)
    keys["head.bias"] = (num_classes,)
    return keys


def cifar_resnet18_keys(num_classes: int) -> "OrderedDict[str, Shape]":
    """The framework's OWN small-victim checkpoint contract (not a timm
    model): `models/small.CifarResNet18`, the format `train.py` exports
    and `get_model` loads. Pinned here so `verify` covers trained-victim
    checkpoints too."""
    keys: "OrderedDict[str, Shape]" = OrderedDict()
    keys["stem.weight"] = (64, 3, 3, 3)
    keys["stem_norm.weight"] = (64,)
    keys["stem_norm.bias"] = (64,)
    in_ch, features, flat = 64, 64, 0
    for si, depth in enumerate((2, 2, 2, 2)):
        for bi in range(depth):
            pre = f"blocks.{flat}."
            keys[pre + "conv1.weight"] = (features, in_ch, 3, 3)
            keys[pre + "norm1.weight"] = (features,)
            keys[pre + "norm1.bias"] = (features,)
            keys[pre + "conv2.weight"] = (features, features, 3, 3)
            keys[pre + "norm2.weight"] = (features,)
            keys[pre + "norm2.bias"] = (features,)
            if bi == 0 and si > 0:   # stage transition: projection shortcut
                keys[pre + "proj.0.weight"] = (features, in_ch, 1, 1)
                keys[pre + "proj.1.weight"] = (features,)
                keys[pre + "proj.1.bias"] = (features,)
            in_ch = features
            flat += 1
        features *= 2
    keys["head.weight"] = (num_classes, in_ch)
    keys["head.bias"] = (num_classes,)
    return keys


_CONTRACTS = {
    "resnetv2_50x1_bit_distilled": resnetv2_50x1_keys,
    "vit_base_patch16_224": vit_base_patch16_224_keys,
    "resmlp_24_distilled_224": resmlp_24_keys,
    "cifar_resnet18": cifar_resnet18_keys,
    "cifar_vit": cifar_vit_keys,
}


def state_dict_contract(timm_name: str, num_classes: int) -> Dict[str, Shape]:
    """The pinned timm-0.6.7 state-dict (key -> shape) map for `timm_name`."""
    try:
        return _CONTRACTS[timm_name](num_classes)
    except KeyError:
        raise KeyError(
            f"no vendored key contract for {timm_name!r} "
            f"(have {sorted(_CONTRACTS)})") from None


def diff_against_contract(sd_keys, timm_name: str, num_classes: int,
                          sd_shapes=None) -> Dict[str, list]:
    """Drift report of a state_dict against the vendored contract.

    Returns {"missing": [...], "unexpected": [...], "shape_drift": [...]}
    — all empty iff the checkpoint matches timm 0.6.7 naming exactly.
    """
    contract = state_dict_contract(timm_name, num_classes)
    have = set(sd_keys)
    want = set(contract)
    report = {
        "missing": sorted(want - have),
        "unexpected": sorted(have - want),
        "shape_drift": [],
    }
    if sd_shapes is not None:
        for k in sorted(want & have):
            got = tuple(sd_shapes[k])
            if got != contract[k]:
                report["shape_drift"].append(
                    f"{k}: checkpoint {got} != contract {contract[k]}")
    return report
