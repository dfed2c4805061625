"""The CIFAR ResNet-18 victim (GroupNorm, 3x3 stem), NHWC at its boundary.

Port of `dorpatch_tpu.models.small`. The modules take and return NHWC
tensors; a convolution views its NHWC input as NCHW in `channels_last`
memory (`permute`, no copy), so cuDNN runs channels-last and the result
permutes back to NHWC for free. Parameter names follow the state_dict that
`dorpatch_tpu.train` exports (`stem.weight`, `blocks.N.conv1.weight`,
`blocks.N.proj.0.weight`, `head.weight`, ...), so its `.pth` loads as is.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dorpatch_tpu_torch.ops.fused_gn import gn_preserve_dtype


class Conv2dNHWC(nn.Conv2d):
    """Bias-free conv on NHWC tensors, OIHW weight."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, None, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm8(nn.Module):
    """GroupNorm(8) on NHWC tensors, computed as flax's `nn.GroupNorm`:
    eps 1e-6, mean and the fast variance `E[x^2] - E[x]^2` over (H, W,
    channels of the group), clipped at 0, then
    `(x - mean) * (rsqrt(var + eps) * scale) + bias`. `F.group_norm` takes a
    two-pass variance and would differ from the JAX package in the last
    bits of every layer. Inputs narrower than float32 (the bf16 certify
    bank's cast victim) take `fused_gn.gn_preserve_dtype`: float32
    statistics, the normalize chain in their own type."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-6):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return gn_preserve_dtype(x, self.weight, self.bias, self.groups,
                                     self.eps)
        n, h, w, c = x.shape
        g = self.groups
        xg = x.reshape(n, h * w, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, 1, g, c // g)
        y = (xg - mean) * mul + self.bias.reshape(1, 1, g, c // g)
        return y.reshape(n, h, w, c)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2dNHWC(cin, features, 3, stride, padding=1)
        self.norm1 = GroupNorm8(features)
        self.conv2 = Conv2dNHWC(features, features, 3, 1, padding=1)
        self.norm2 = GroupNorm8(features)
        self.proj: Optional[nn.Sequential] = None
        if cin != features or stride != 1:
            # flax's default "SAME" padding for the 1x1 projection: none
            self.proj = nn.Sequential(Conv2dNHWC(cin, features, 1, stride),
                                      GroupNorm8(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + y)


class CifarResNet18(nn.Module):
    """mode="full": logits from (normalized) NHWC images. mode="stem": only
    the bias-free stem conv's pre-norm output (the linear cache of the
    masked-stem fold). mode="trunk": `x` is a stem output; run everything
    after the stem conv. `full(x) == trunk(stem(x))`."""

    def __init__(self, num_classes: int = 10,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stem = Conv2dNHWC(3, 64, 3, 1, padding=1)
        self.stem_norm = GroupNorm8(64)
        blocks = []
        cin, features = 64, 64
        for si, depth in enumerate(self.stage_sizes):
            for bi in range(depth):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(BasicBlock(cin, features, stride))
                cin = features
            features *= 2
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, mode: str = "full") -> torch.Tensor:
        if mode not in ("full", "stem", "trunk"):
            raise ValueError(f"mode={mode!r} (use 'full', 'stem' or 'trunk')")
        if mode != "trunk":
            x = self.stem(x)
            if mode == "stem":
                return x
        x = F.relu(self.stem_norm(x))
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(1, 2)))


def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded initialization with flax's defaults: conv and dense kernels
    lecun-normal (truncated normal, variance 1/fan_in), dense bias 0,
    GroupNorm scale 1 and bias 0. The numbers differ from flax's own draw;
    the distribution is the same."""
    # stddev of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / trunc_std
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, GroupNorm8):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
