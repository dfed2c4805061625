"""Carry weights into the port's models.

- `from_flax_params`: the JAX package's `CifarResNet18` parameter tree, as
  nested numpy arrays, -> the port's state_dict. Conv kernels go from HWIO
  to OIHW, the dense head from `[in, out]` to `[out, in]`, GroupNorm
  `scale`/`bias` to `weight`/`bias`.
- `from_flax_resnetv2`: the same for the JAX package's `ResNetV2` tree, into
  timm's `resnetv2` key names; the Dense head becomes the 1x1 conv
  `head.fc.weight [K, C, 1, 1]`.
- `from_flax_vit`: the JAX package's `ViT` tree into timm's
  `vit_base_patch16_224` key names: the per-head query/key/value kernels
  `[D, H, f]` fuse into `attn.qkv.weight [3D, D]`, the `[H, f, D]` output
  kernel becomes `attn.proj.weight`, the patch embed goes HWIO to OIHW.
- `from_flax_resmlp`: the JAX package's `ResMLP` tree into timm's
  `resmlp_24_distilled_224` key names: the key map of the JAX package's
  `convert_resmlp` run the other way (the patch embed `stem.proj`, HWIO to
  OIHW; the Affines' `[D]` alpha and beta to timm's `[1, 1, D]`;
  `linear_tokens` and `mlp_channels.fc1/fc2` from `[in, out]` kernels to
  `[out, in]` weights; `ls1`/`ls2` as they are). The port's `ResMLP`
  carries timm's names and shapes, so a timm `.pth` loads into it with
  `strict=True`.
- `load_state_dict`: a `.pth` checkpoint (bare or `{'state_dict': ...}`,
  DataParallel `module.` prefixes stripped), as `dorpatch_tpu.train`
  exports it or as timm saves it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def from_flax_params(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `CifarResNet18` params (`{"params": {...}}` or the inner dict,
    any stage depths) -> the port's `CifarResNet18` state_dict."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, torch.Tensor] = {
        "stem.weight": _conv(p["stem"]["kernel"]),
        "stem_norm.weight": _t(p["stem_norm"]["scale"]),
        "stem_norm.bias": _t(p["stem_norm"]["bias"]),
        "head.weight": _t(np.asarray(p["head"]["kernel"]).T),
        "head.bias": _t(p["head"]["bias"]),
    }
    for i, name in enumerate(_stage_block_names(p)):
        blk = p[name]
        dst = f"blocks.{i}."
        sd[dst + "conv1.weight"] = _conv(blk["conv1"]["kernel"])
        sd[dst + "norm1.weight"] = _t(blk["norm1"]["scale"])
        sd[dst + "norm1.bias"] = _t(blk["norm1"]["bias"])
        sd[dst + "conv2.weight"] = _conv(blk["conv2"]["kernel"])
        sd[dst + "norm2.weight"] = _t(blk["norm2"]["scale"])
        sd[dst + "norm2.bias"] = _t(blk["norm2"]["bias"])
        if "proj" in blk:
            sd[dst + "proj.0.weight"] = _conv(blk["proj"]["kernel"])
            sd[dst + "proj.1.weight"] = _t(blk["proj_norm"]["scale"])
            sd[dst + "proj.1.bias"] = _t(blk["proj_norm"]["bias"])
    return sd


def _stage_block_names(p: Mapping):
    """The `stageS_blockB` keys of a flax tree, in (S, B) order."""
    return sorted(
        (k for k in p if k.startswith("stage")),
        key=lambda k: tuple(int(v) for v in
                            k[len("stage"):].split("_block")))


def from_flax_resnetv2(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `ResNetV2` params (`{"params": {...}}` or the inner dict, any
    `layers`) -> the port's `ResNetV2` state_dict (timm's key names)."""
    p = params_np["params"] if "params" in params_np else params_np

    def gn(node):
        return node["GroupNorm_0"]

    head_k = np.asarray(p["head"]["kernel"])                 # [C, K]
    sd: Dict[str, torch.Tensor] = {
        "stem.conv.weight": _conv(p["stem_conv"]["kernel"]),
        "norm.weight": _t(gn(p["norm"])["scale"]),
        "norm.bias": _t(gn(p["norm"])["bias"]),
        "head.fc.weight": _t(head_k.T[:, :, None, None]),
        "head.fc.bias": _t(p["head"]["bias"]),
    }
    for name in _stage_block_names(p):
        si, bi = (int(v) for v in name[len("stage"):].split("_block"))
        blk = p[name]
        dst = f"stages.{si}.blocks.{bi}."
        for k in (1, 2, 3):
            sd[dst + f"norm{k}.weight"] = _t(gn(blk[f"norm{k}"])["scale"])
            sd[dst + f"norm{k}.bias"] = _t(gn(blk[f"norm{k}"])["bias"])
            sd[dst + f"conv{k}.weight"] = _conv(blk[f"conv{k}"]["kernel"])
        if "downsample_conv" in blk:
            sd[dst + "downsample.conv.weight"] = _conv(
                blk["downsample_conv"]["kernel"])
    return sd


def from_flax_vit(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `ViT` params (`{"params": {...}}` or the inner dict, any depth
    and width) -> the port's `ViT` state_dict (timm's key names)."""
    p = params_np["params"] if "params" in params_np else params_np
    dim = np.asarray(p["cls_token"]).shape[-1]

    def dense(node):
        return _t(np.asarray(node["kernel"]).T), _t(node["bias"])

    sd: Dict[str, torch.Tensor] = {
        "cls_token": _t(p["cls_token"]),
        "pos_embed": _t(p["pos_embed"]),
        "patch_embed.proj.weight": _conv(p["patch_embed"]["kernel"]),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
        "norm.weight": _t(p["norm"]["scale"]),
        "norm.bias": _t(p["norm"]["bias"]),
    }
    sd["head.weight"], sd["head.bias"] = dense(p["head"])
    depth = sum(1 for k in p if k.startswith("block"))
    for i in range(depth):
        blk = p[f"block{i}"]
        dst = f"blocks.{i}."
        for k in ("norm1", "norm2"):
            sd[dst + k + ".weight"] = _t(blk[k]["scale"])
            sd[dst + k + ".bias"] = _t(blk[k]["bias"])
        attn = blk["attn"]
        qkv = ("query", "key", "value")
        sd[dst + "attn.qkv.weight"] = _t(np.concatenate(
            [np.asarray(attn[n]["kernel"]).reshape(dim, dim).T for n in qkv]))
        sd[dst + "attn.qkv.bias"] = _t(np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(dim) for n in qkv]))
        sd[dst + "attn.proj.weight"] = _t(
            np.asarray(attn["out"]["kernel"]).reshape(dim, dim).T)
        sd[dst + "attn.proj.bias"] = _t(attn["out"]["bias"])
        for k in ("fc1", "fc2"):
            (sd[dst + f"mlp.{k}.weight"],
             sd[dst + f"mlp.{k}.bias"]) = dense(blk[f"mlp_{k}"])
    return sd


def from_flax_resmlp(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `ResMLP` params (`{"params": {...}}` or the inner dict, any depth
    and width) -> the port's `ResMLP` state_dict (timm's key names)."""
    p = params_np["params"] if "params" in params_np else params_np

    def dense(sd, key, node):
        sd[key + ".weight"] = _t(np.asarray(node["kernel"]).T)
        sd[key + ".bias"] = _t(node["bias"])

    def affine(sd, key, node):
        sd[key + ".alpha"] = _t(np.asarray(node["alpha"]).reshape(1, 1, -1))
        sd[key + ".beta"] = _t(np.asarray(node["beta"]).reshape(1, 1, -1))

    sd: Dict[str, torch.Tensor] = {
        "stem.proj.weight": _conv(p["patch_embed"]["kernel"]),
        "stem.proj.bias": _t(p["patch_embed"]["bias"]),
    }
    depth = sum(1 for k in p if k.startswith("block"))
    for i in range(depth):
        blk = p[f"block{i}"]
        dst = f"blocks.{i}."
        affine(sd, dst + "norm1", blk["norm1"])
        dense(sd, dst + "linear_tokens", blk["linear_tokens"])
        affine(sd, dst + "norm2", blk["norm2"])
        dense(sd, dst + "mlp_channels.fc1", blk["mlp_fc1"])
        dense(sd, dst + "mlp_channels.fc2", blk["mlp_fc2"])
        sd[dst + "ls1"] = _t(blk["ls1"])
        sd[dst + "ls2"] = _t(blk["ls2"])
    affine(sd, "norm", p["norm"])
    dense(sd, "head", p["head"])
    return sd


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file -> flat state_dict of float32 CPU tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = torch.as_tensor(np.asarray(v, dtype=np.float32))
    return out
