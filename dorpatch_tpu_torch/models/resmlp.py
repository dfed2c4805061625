"""ResMLP-24 (timm `resmlp_24_distilled_224`) on NHWC images, and the
mixer-pruned incremental engine of its certification.

Port of `dorpatch_tpu.models.resmlp`:

- `ResMLP`: a p x p, stride-p patch-embed conv (timm's `stem.proj`) to T
  tokens of width D, `depth` residual blocks of [Affine -> token-mixing
  Linear(T, T) over the transposed sequence -> layerscale] and [Affine ->
  channel MLP (ratio 4, exact erf GELU) -> layerscale], a final Affine, a
  mean pool over the tokens and a linear head. Parameter names and shapes
  are timm's (the Affine's alpha and beta `[1, 1, D]`), so a PatchCleanser
  `.pth` loads with `strict=True`. The token mix and the channel MLP are
  `nn.Linear` (cuBLAS on the card); the JAX package computes them outside
  any Pallas kernel too. `mode="cache"` returns the per-block inputs, the
  per-block token-mix outputs and the final pre-Affine activations.
- `MixerPrunedResMLP`: a PatchCleanser mask touches a few patch tokens, and
  ResMLP's only cross-token operator, the Affine -> token-mix path, is
  linear. So per mask the engine carries only the S touched (dirty) token
  rows through the blocks against the image's clean cache: the token-mix
  value at a dirty row is the cached clean mix plus the dirty rows' delta
  through the `[S, S]` slice `K[idx][:, idx]` of the `[T, T]` mixing
  matrix (a gather and a batched matmul), then the channel MLP runs on the
  S rows; the mean-pool head is linear too, so the logits are the cached
  clean logits plus a pooled dirty delta through the head. Untouched
  tokens keep their clean activations at every depth, so the logits drift
  from a full masked forward; the engine returns each entry's top-2
  margin, and `defense.py`'s "mixer-exact" mode re-certifies every image
  whose read entries come within `DefenseConfig.incremental_margin` of the
  decision boundary through the exhaustive sweep.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dorpatch_tpu_torch import masks as masks_lib
from dorpatch_tpu_torch import utils
from dorpatch_tpu_torch.models import remat


class Affine(nn.Module):
    """Per-channel scale and shift, `alpha * x + beta` (timm's Affine)."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha * x + self.beta


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ResMLPBlock(nn.Module):
    def __init__(self, dim: int, seq_len: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = Affine(dim)
        self.linear_tokens = nn.Linear(seq_len, seq_len)
        self.norm2 = Affine(dim)
        self.mlp_channels = Mlp(dim, dim * mlp_ratio)
        self.ls1 = nn.Parameter(torch.ones(dim))
        self.ls2 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor):
        """(block output, token-mix output `[B, T, D]`: bias included,
        before the layerscale)."""
        z = self.linear_tokens(self.norm1(x).transpose(1, 2)).transpose(1, 2)
        x = x + self.ls1 * z
        return x + self.ls2 * self.mlp_channels(self.norm2(x)), z


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> `[B, T, D]` row-major patch tokens."""
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class ResMLP(nn.Module):
    """mode="full": logits of (normalized) NHWC images. mode="cache":
    `(block_inputs, mix_outputs, final)`, the `depth x [B, T, D]` block
    inputs, the `depth x [B, T, D]` token-mix outputs and the final
    pre-Affine activations `[B, T, D]`: the mixer engine's clean cache, at
    the cost of one forward without the head."""

    def __init__(self, num_classes: int, patch_size: int = 16, dim: int = 384,
                 depth: int = 24, img_size: int = 224):
        super().__init__()
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        tokens = (img_size // patch_size) ** 2
        self.stem = PatchEmbed(patch_size, dim)
        self.blocks = nn.ModuleList(ResMLPBlock(dim, tokens)
                                    for _ in range(depth))
        self.norm = Affine(dim)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor, mode: str = "full"):
        if mode not in ("full", "cache"):
            raise ValueError(f"mode={mode!r} (use 'full' or 'cache')")
        x = self.stem(x)
        xs: List[torch.Tensor] = []
        zs: List[torch.Tensor] = []
        for block in self.blocks:
            xs.append(x)
            x, z = remat.block(block, x)
            zs.append(z)
        if mode == "cache":
            return xs, zs, x
        return self.head(self.norm(x).mean(dim=1))


def resmlp_24(num_classes: int, img_size: int = 224) -> ResMLP:
    return ResMLP(num_classes, img_size=img_size)


#: the JAX package's CIFAR-scale ResMLP: 4 px patches on 32 px images, 64
#: tokens of width 128, 6 blocks
CIFAR_RESMLP = dict(patch_size=4, dim=128, depth=6)


def resmlp_cifar(num_classes: int, img_size: int = 32) -> ResMLP:
    return ResMLP(num_classes, img_size=img_size, **CIFAR_RESMLP)


def init_weights(model: ResMLP, gen: torch.Generator) -> None:
    """Seeded initialization with the JAX module's initializers: every
    Dense (the token mix, the channel MLP, the head) and the patch-embed
    conv lecun-normal (a normal truncated to 2 stddevs, variance 1/fan_in),
    biases 0, the Affines' alpha 1 and beta 0, the layerscales 1. The
    numbers differ from flax's own draw; the distributions are the same."""
    trunc_std = 0.87962566103423978   # stddev of N(0, 1) truncated to [-2, 2]
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / trunc_std
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, Affine):
                mod.alpha.fill_(1.0)
                mod.beta.zero_()
            elif isinstance(mod, ResMLPBlock):
                mod.ls1.fill_(1.0)
                mod.ls2.fill_(1.0)


# ------------------------------------------- mixer-pruned incremental engine


class MixerTables(NamedTuple):
    """Static lookup tables of one rectangle table (numpy, or tensors on
    the engine's device once a family holds them). No cls slot: ResMLP
    mean-pools."""

    idx: np.ndarray   # [N, S] dirty token ids (padding repeats the first)
    keep: np.ndarray  # [N, S, p, p, 1] f32 pixel keep-mask per dirty slot
    w: np.ndarray     # [N, S] f32 slot weight: 1 real, 0 duplicate padding
    fe: np.ndarray    # [N] float64 forward equivalents: dirty tokens / T


def _build_mixer_tables(rects: np.ndarray, img_size: int,
                        patch: int) -> MixerTables:
    """Token sets and per-token pixel keep masks of one rectangle table.
    Slots beyond a mask's own coverage repeat its first token (the same
    keep mask, so they compute the same dirty row) and carry weight 0: the
    mixer sums dirty contributions, so a duplicate must add nothing."""
    rects = np.asarray(rects, np.int64)
    if rects.ndim == 2:
        rects = rects[:, None, :]
    grid = img_size // patch
    cov = masks_lib.rect_token_coverage(rects, img_size, patch)   # [N, T]
    n, t_total = cov.shape
    counts = cov.sum(axis=1)
    s_max = int(counts.max()) if n else 1
    idx = np.zeros((n, s_max), np.int32)
    for i in range(n):
        own = np.nonzero(cov[i])[0]
        idx[i, :len(own)] = own
        idx[i, len(own):] = own[0]
    w = (np.arange(s_max)[None] < counts[:, None]).astype(np.float32)
    # per-pixel occlusion of each mask, cut into patches, gathered by token
    ar = np.arange(img_size)
    r0, r1, c0, c1 = (rects[..., k, None, None] for k in range(4))
    occ = ((ar[:, None] >= r0) & (ar[:, None] < r1)
           & (ar[None, :] >= c0) & (ar[None, :] < c1)).any(axis=1)  # [N, H, W]
    keep_px = (~occ).reshape(n, grid, patch, grid, patch) \
        .transpose(0, 1, 3, 2, 4).reshape(n, grid * grid, patch, patch)
    keep = keep_px[np.arange(n)[:, None], idx][..., None].astype(np.float32)
    fe = counts / float(t_total)
    return MixerTables(idx, keep, w, fe)


def _on_device(tables: MixerTables, device,
               dtype: torch.dtype = torch.float32) -> MixerTables:
    """The tables on `device`, the float ones (keep, w) in the family's
    `dtype`."""
    return MixerTables(
        torch.as_tensor(tables.idx, dtype=torch.long, device=device),
        torch.as_tensor(tables.keep, dtype=dtype, device=device),
        torch.as_tensor(tables.w, dtype=dtype, device=device),
        tables.fe)


class ResMLPMixerFamily:
    """One mask family's incremental programs over the combined rectangle
    table `[singles; pairs]` of a certifier, with the contract of
    `models.vit.TokenViTFamily`: `phase1(imgs)`, `pairs(imgs)` and
    `rows(imgs_g, sets_idx)` return `(preds int32, margins f32)`; `fe`,
    `fe_first`, `fe_pairs` and `cache_fe` are the forward equivalents.
    `compute_dtype` "bfloat16" runs the engine on a once-cast bf16 copy of
    the victim, with the tables in bf16 and the images cast at each
    program's boundary; the margins stay float32."""

    def __init__(self, engine: "MixerPrunedResMLP", rects: np.ndarray,
                 num_singles: int, chunk_size: int, fill: float,
                 compute_dtype: str = "float32"):
        self.dtype = utils.compute_dtype(compute_dtype)
        self.engine = engine = engine.at(self.dtype)
        self.num_singles = int(num_singles)
        self.chunk_size = max(1, int(chunk_size))
        self.fill = float(fill)
        img, patch, dev = engine.img_size, engine.patch, engine.device
        m, dt = self.num_singles, self.dtype
        self.first = _on_device(_build_mixer_tables(rects[:m], img, patch),
                                dev, dt)
        self.pair_tables = _on_device(
            _build_mixer_tables(rects[m:], img, patch), dev, dt)
        self.combined = _on_device(_build_mixer_tables(rects, img, patch),
                                   dev, dt)
        self.fe = self.combined.fe
        self.fe_first = float(self.fe[:m].sum())
        self.fe_pairs = float(self.fe[m:].sum())
        # the clean cache runs every block: one forward without the head
        self.cache_fe = 1.0

    @torch.no_grad()
    def phase1(self, imgs: torch.Tensor):
        return self.engine._table(imgs.to(self.dtype), self.first, self.fill,
                                  self.chunk_size)

    @torch.no_grad()
    def pairs(self, imgs: torch.Tensor):
        return self.engine._table(imgs.to(self.dtype), self.pair_tables,
                                  self.fill, self.chunk_size)

    @torch.no_grad()
    def rows(self, imgs_g: torch.Tensor, sets_idx: torch.Tensor):
        return self.engine._rows(imgs_g.to(self.dtype), sets_idx,
                                 self.combined, self.fill, self.chunk_size)


class MixerPrunedResMLP:
    """Mixer-pruned incremental masked inference for one ResMLP victim;
    the certifier calls `build_family` once per radius with its combined
    rectangle table."""

    kind = "mixer"

    def __init__(self, module: ResMLP, img_size: int,
                 normalize: Optional[Callable] = None):
        if img_size % module.patch_size:
            raise ValueError(f"img_size={img_size} not divisible by patch "
                             f"{module.patch_size}")
        self.module = module
        self.img_size = int(img_size)
        self.patch = int(module.patch_size)
        self.grid = self.img_size // self.patch
        self.tokens = self.grid * self.grid
        self.normalize = normalize or (lambda x: (x - 0.5) / 0.5)
        self._casts = {}

    @property
    def device(self) -> torch.device:
        return self.module.head.weight.device

    def at(self, dtype: torch.dtype) -> "MixerPrunedResMLP":
        """This engine on a `dtype` copy of its module (`utils.cast_module`,
        made at the first call and kept); itself at float32."""
        if dtype == torch.float32:
            return self
        return utils.cached_cast(self._casts, dtype, lambda: MixerPrunedResMLP(
            utils.cast_module(self.module, dtype), self.img_size,
            self.normalize))

    def build_family(self, rects: np.ndarray, num_singles: int,
                     chunk_size: int, fill: float,
                     compute_dtype: str = "float32") -> ResMLPMixerFamily:
        return ResMLPMixerFamily(self, rects, num_singles, chunk_size, fill,
                                 compute_dtype)

    # ------------------------------------------------------------ internals

    def _patches(self, imgs: torch.Tensor) -> torch.Tensor:
        """`[B, H, W, C]` -> `[B, T, p, p, C]` row-major patches (the patch
        embed's token order)."""
        b, _, _, c = imgs.shape
        p, g = self.patch, self.grid
        return imgs.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, g * g, p, p, c)

    def _embed(self, patches_g, keep, fill):
        """Dirty-token embeddings: occlude the gathered patches with their
        keep masks, normalize, apply the patch-embed conv (one matmul per
        token). ResMLP has no cls token and no position embedding."""
        proj = self.module.stem.proj
        masked = patches_g * keep + fill * (1.0 - keep)
        xn = self.normalize(masked)
        kernel = proj.weight.permute(2, 3, 1, 0).reshape(-1, proj.weight.shape[0])
        return torch.matmul(xn.flatten(-3), kernel) + proj.bias

    def _clean(self, imgs):
        """The per-image clean cache (block inputs, token-mix outputs,
        final pre-Affine activations) and the clean logits: the final
        Affine, mean pool and head are linear, so an entry adds only a
        pooled dirty delta through the head."""
        mod = self.module
        xs, zs, xf = mod(self.normalize(imgs), "cache")
        logits0 = mod.head(mod.norm(xf).mean(dim=1))
        return xs, zs, xf, logits0

    def _forward(self, d, xs, zs, xf, logits0, idx, w):
        """Dirty tokens `d [B, C, S, D]` (C masks an image) through every
        block against the per-image clean cache -> logits `[B, C, classes]`.
        Per block the token-mix value at each dirty row is the cached clean
        mix there plus the dirty rows' delta through `K[idx][:, idx]`, the
        `[S, S]` slice of the mixing matrix (`K = linear_tokens.weight^T`):
        exact when every other token holds its clean activation, since the
        mix is linear. Then the channel MLP runs on the S rows. `w [B, C,
        S]` zeroes duplicate slots out of every sum."""
        mod = self.module
        rows = torch.arange(d.shape[0], device=d.device)[:, None, None]
        wc = w[..., None]
        for layer, block in enumerate(mod.blocks):
            weight = block.linear_tokens.weight                  # [T, T]
            a1 = block.norm1.alpha * (d - xs[layer][rows, idx]) * wc
            # kss[s, t] = K[idx_s, idx_t] = weight[idx_t, idx_s]
            kss = weight[idx[..., None, :], idx[..., :, None]]  # [B,C,S,S]
            dz = torch.matmul(kss.transpose(-1, -2), a1)
            d = d + block.ls1 * (zs[layer][rows, idx] + dz)
            mlp = block.mlp_channels
            hid = F.gelu(F.linear(block.norm2(d), mlp.fc1.weight,
                                  mlp.fc1.bias))
            d = d + block.ls2 * F.linear(hid, mlp.fc2.weight, mlp.fc2.bias)
        pooled = ((d - xf[rows, idx]) * wc).sum(dim=2) / float(self.tokens)
        return logits0[:, None] + F.linear(mod.norm.alpha[0] * pooled,
                                           mod.head.weight)

    def _chunk(self, patches, clean, idx, keep, w, fill):
        """One chunk of c masks over B images; the tables are per image
        (`[B, c, ...]`). Returns `(preds, margins)` `[B, c]`."""
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        d = self._embed(patches[rows, idx], keep, fill)          # [B,c,S,D]
        return utils.preds_margins(self._forward(d, *clean, idx, w))

    def _table(self, imgs: torch.Tensor, tables: MixerTables, fill: float,
               chunk_size: int):
        """All N masks of `tables` over the batch -> `(preds, margins)`
        `[B, N]`, in mask chunks of at most `chunk_size`."""
        b = imgs.shape[0]
        n = int(tables.idx.shape[0])
        c = min(max(1, int(chunk_size)), max(1, n))
        clean = self._clean(imgs)
        patches = self._patches(imgs)
        preds, margins = [], []
        for off in range(0, n, c):
            sl = slice(off, off + c)

            def per_image(t):
                return t[sl][None].expand((b,) + t[sl].shape)

            p, m = self._chunk(patches, clean, per_image(tables.idx),
                               per_image(tables.keep), per_image(tables.w),
                               fill)
            preds.append(p)
            margins.append(m)
        return torch.cat(preds, dim=1), torch.cat(margins, dim=1)

    def _rows(self, imgs_g: torch.Tensor, sets_idx: torch.Tensor,
              combined: MixerTables, fill: float, chunk_size: int):
        """Second-round rows: entry w is gathered image w against the
        combined-table masks `sets_idx[w]` `[M2]` -> `(preds, margins)`
        `[W, M2]`, the second-mask axis in chunks of `max(1, chunk_size //
        W)` (`models.vit.TokenPrunedViT.rows`'s chunking)."""
        w, m2 = int(sets_idx.shape[0]), int(sets_idx.shape[1])
        c = max(1, min(m2, int(chunk_size) // max(1, w)))
        sets = sets_idx.to(device=combined.idx.device, dtype=torch.long)
        clean = self._clean(imgs_g)
        patches = self._patches(imgs_g)
        preds, margins = [], []
        for off in range(0, m2, c):
            cols = sets[:, off:off + c]                            # [W, c]
            p, m = self._chunk(patches, clean, combined.idx[cols],
                               combined.keep[cols], combined.w[cols], fill)
            preds.append(p)
            margins.append(m)
        return torch.cat(preds, dim=1), torch.cat(margins, dim=1)
