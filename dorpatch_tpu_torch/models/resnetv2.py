"""ResNetV2-50x1 (BiT), NHWC at its boundary, timm's
`resnetv2_50x1_bit_distilled`.

Port of `dorpatch_tpu.models.resnetv2`:

- weight-standardized convs (`StdConv`, timm `StdConv2dSame`): per output
  channel `(w - mean) * rsqrt(biased_var + 1e-8)` over (I, H, W), with TF
  "SAME" padding, which is asymmetric: `F.pad`, then a VALID conv;
- pre-activation bottlenecks with GroupNorm(32, eps 1e-5) + ReLU
  (`GroupNormRelu`, the `fused_gn` kernels on the card); the projection
  shortcut takes the *pre-activated* input;
- the "fixed" stem: 7x7/2 std-conv, then a zero pad of 1 (not -inf) and a
  VALID 3x3/2 max-pool;
- head: final GroupNorm+ReLU, global average pool, 1x1 conv classifier.

Parameter names follow timm's state_dict (`stem.conv.weight`,
`stages.S.blocks.B.normK.weight`, `...downsample.conv.weight`, `norm.*`,
`head.fc.*`), so a PatchCleanser `.pth` loads as it is.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dorpatch_tpu_torch.ops.fused_gn import (gn_preserve_dtype, gn_relu,
                                             gn_relu_reference)
from dorpatch_tpu_torch.ops.stem_fold import same_pads

GN_IMPLS = ("auto", "plain")


class StdConv(nn.Module):
    """Weight-standardized bias-free conv on NHWC tensors (OIHW weight),
    TF "SAME" padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 eps: float = 1e-8):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.eps = k, stride, eps

    def standardized(self) -> torch.Tensor:
        """The effective OIHW kernel."""
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), correction=0, keepdim=True)
        return (w - mean) * torch.rsqrt(var + self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pr0, pr1 = same_pads(x.shape[1], self.k, self.stride)
        pc0, pc1 = same_pads(x.shape[2], self.k, self.stride)
        if pr0 or pr1 or pc0 or pc1:
            x = F.pad(x, (0, 0, pc0, pc1, pr0, pr1))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.standardized(), None,
                     self.stride)
        return y.permute(0, 2, 3, 1)


class GroupNormRelu(nn.Module):
    """GroupNorm(32, eps 1e-5) + ReLU (timm `GroupNormAct`).

    `impl` "auto" follows the kernels' dispatch rule (a CUDA tensor runs the
    `fused_gn` kernels, a CPU tensor their plain version); "plain", set
    through `ResNetV2.set_gn_impl`, runs the plain model code on any device
    (tests and the card checks). At float32 the two compute the same
    function. Below float32 they differ, as in the JAX package: "auto"
    normalizes in float32 and rounds the output once (the kernels, and
    `gn_relu_reference` on the CPU), "plain" is `gn_preserve_dtype` + ReLU
    (the normalize chain in the input's type)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps, self.impl = num_groups, eps, "auto"
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "plain":
            if x.dtype != torch.float32:
                return torch.relu(gn_preserve_dtype(
                    x, self.weight, self.bias, self.num_groups, self.eps))
            return gn_relu_reference(x, self.weight, self.bias,
                                     self.num_groups, self.eps)
        return gn_relu(x, self.weight, self.bias, self.num_groups, self.eps)


class PreActBottleneck(nn.Module):
    """GN/ReLU -> 1x1 -> GN/ReLU -> 3x3(stride) -> GN/ReLU -> 1x1, plus the
    shortcut (a strided 1x1 std-conv of the pre-activated input where the
    shape changes)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 bottle_ratio: float = 0.25):
        super().__init__()
        mid = int(round(cout * bottle_ratio))
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.ModuleDict(
                {"conv": StdConv(cin, cout, 1, stride)})
        self.norm1 = GroupNormRelu(cin)
        self.conv1 = StdConv(cin, mid, 1)
        self.norm2 = GroupNormRelu(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm3 = GroupNormRelu(mid)
        self.conv3 = StdConv(mid, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        preact = self.norm1(x)
        shortcut = x if self.downsample is None else \
            self.downsample["conv"](preact)
        y = self.conv1(preact)
        y = self.conv2(self.norm2(y))
        y = self.conv3(self.norm3(y))
        return y + shortcut


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """timm's "fixed" stem pool on NHWC: a zero pad of 1 (not -inf), then a
    VALID 3x3/2 max-pool."""
    x = F.pad(x, (0, 0, 1, 1, 1, 1))
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


class ResNetV2(nn.Module):
    """BiT ResNetV2 trunk; the defaults are 50x1 (layers 3-4-6-3, width 1).

    mode="full": logits from (normalized) NHWC images. mode="stem": only
    the std-conv stem's output, before the pad and pool (the linear cache
    of the masked-stem fold). mode="trunk": `x` is a stem output; run the
    pad, pool and everything after. `full(x) == trunk(stem(x))`."""

    def __init__(self, num_classes: int, layers: Sequence[int] = (3, 4, 6, 3),
                 width_factor: int = 1, stem_features: int = 64):
        super().__init__()
        wf = width_factor
        self.layers = tuple(layers)
        self.stem = nn.ModuleDict(
            {"conv": StdConv(3, stem_features * wf, 7, 2)})
        cin, features = stem_features * wf, 256
        stages = []
        for si, depth in enumerate(self.layers):
            blocks = []
            for bi in range(depth):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(PreActBottleneck(cin, features * wf, stride))
                cin = features * wf
            stages.append(nn.ModuleDict({"blocks": nn.ModuleList(blocks)}))
            features *= 2
        self.stages = nn.ModuleList(stages)
        self.norm = GroupNormRelu(cin)
        self.head = nn.ModuleDict({"fc": nn.Conv2d(cin, num_classes, 1)})

    def set_gn_impl(self, impl: str) -> None:
        """Switch every GroupNorm+ReLU to `impl` ("auto" or "plain")."""
        if impl not in GN_IMPLS:
            raise ValueError(f"impl={impl!r} (use one of {GN_IMPLS})")
        for mod in self.modules():
            if isinstance(mod, GroupNormRelu):
                mod.impl = impl

    def forward(self, x: torch.Tensor, mode: str = "full") -> torch.Tensor:
        if mode not in ("full", "stem", "trunk"):
            raise ValueError(f"mode={mode!r} (use 'full', 'stem' or 'trunk')")
        if mode != "trunk":
            x = self.stem["conv"](x)
            if mode == "stem":
                return x
        x = stem_pool(x)
        for stage in self.stages:
            for block in stage["blocks"]:
                x = block(x)
        x = self.norm(x).mean(dim=(1, 2))
        fc = self.head["fc"]
        return F.linear(x, fc.weight.flatten(1), fc.bias)


def resnetv2_50x1(num_classes: int) -> ResNetV2:
    return ResNetV2(num_classes=num_classes)


def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded initialization with the JAX module's initializers: std-conv
    kernels he-normal and the head lecun-normal (truncated normals of
    variance 2/fan_in and 1/fan_in), head bias 0, GroupNorm scale 1 and
    bias 0. The numbers differ from flax's own draw; the distribution is
    the same."""
    # stddev of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978

    def trunc_normal(w, variance):
        std = math.sqrt(variance / w[0].numel()) / trunc_std
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, StdConv):
                trunc_normal(mod.weight, 2.0)
            elif isinstance(mod, nn.Conv2d):
                trunc_normal(mod.weight, 1.0)
                mod.bias.zero_()
            elif isinstance(mod, GroupNormRelu):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
