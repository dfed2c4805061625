"""ViT-B/16 (timm `vit_base_patch16_224`) on NHWC images, and the
token-pruned incremental engine of its certification.

Port of `dorpatch_tpu.models.vit`:

- `ViT`: a p x p, stride-p patch-embed conv, the cls token, a learned
  position embedding added after the cls concat, pre-norm blocks
  (LayerNorm eps 1e-6 with flax's fast variance, multi-head attention with
  qkv bias, an MLP of ratio 4 with the exact erf GELU), a final LayerNorm
  and a linear head on the cls token. Parameter names are timm's, so a
  PatchCleanser `.pth` loads with `strict=True`. `mode="cache"` returns the
  `depth` per-block input activations and stops before the last block.
- `TokenPrunedViT`: a PatchCleanser mask touches a few patch tokens, so the
  engine computes an image's clean block inputs and their keys and values
  once (the clean KV cache) and, per mask, recomputes only the touched
  tokens plus the cls readout: their queries, keys, values and MLP, and
  their attention over the clean cache (stale rows masked) and their own
  fresh rows (`ops.masked_kv_attn`, kernel H on the card). Untouched tokens
  keep their clean activations at every depth, so the logits drift a little
  from a full masked forward; the engine returns each entry's top-2 logit
  margin, and `defense.py`'s "token-exact" mode re-certifies every image
  whose read entries come within `DefenseConfig.incremental_margin` of the
  decision boundary through the exhaustive sweep. On a mesh (`parallel/`)
  each rank runs its `[images, masks]` block of a table, kernel H through
  its sharded form, and the tables are gathered after it.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dorpatch_tpu_torch import masks as masks_lib
from dorpatch_tpu_torch import utils
from dorpatch_tpu_torch.models import remat
from dorpatch_tpu_torch.ops.masked_kv_attn import (
    masked_kv_attention, masked_kv_attention_sharded)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax `nn.LayerNorm` at float32: the fast variance `E[x^2] - E[x]^2`
    clipped at 0, then `(x - mean) * (rsqrt(var + eps) * scale) + bias`."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def fast_ln(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The JAX package's `_fast_ln` at `x.dtype`: the same statistics (the
    means reduce in float32 and round back), then `(x - mean) * rsqrt(var +
    eps) * scale + bias`, every slab-sized tensor in the input's type."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class LayerNorm(nn.Module):
    """LayerNorm parameters under timm's names, applied by `layer_norm` at
    float32 and by `fast_ln` below it (`LayerNormDT` of the JAX
    package)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return fast_ln(x, self.weight, self.bias, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """Multi-head self-attention with the fused `qkv` projection (rows q,
    k, v, each head-major) and the output `proj`."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, h, d // h) \
            .permute(2, 0, 3, 1, 4)                        # [B, H, N, f] each
        q = q / math.sqrt(d // h)
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        o = torch.matmul(w, v).transpose(1, 2).reshape(b, n, d)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> `[B, T, D]` row-major patch tokens."""
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class ViT(nn.Module):
    """mode="full": logits of (normalized) NHWC images. mode="cache": the
    list of per-block input activations `depth x [B, T+1, D]`, the token
    engine's clean cache; it stops before the last block runs."""

    def __init__(self, num_classes: int, patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, img_size: int = 224):
        super().__init__()
        self.patch_size, self.dim = patch_size, dim
        self.depth, self.num_heads = depth, num_heads
        tokens = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, num_heads)
                                    for _ in range(depth))
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor, mode: str = "full"):
        if mode not in ("full", "cache"):
            raise ValueError(f"mode={mode!r} (use 'full' or 'cache')")
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        cache: List[torch.Tensor] = []
        for i, block in enumerate(self.blocks):
            cache.append(x)
            if mode == "cache" and i == self.depth - 1:
                return cache
            x = remat.block(block, x)
        return self.head(self.norm(x)[:, 0])


def vit_base_patch16(num_classes: int, img_size: int = 224) -> ViT:
    return ViT(num_classes, img_size=img_size)


#: the JAX package's small transformer victim for 32 px runs: an 8x8 grid
#: of 4x4 patches plus cls, 65 tokens
CIFAR_VIT = dict(patch_size=4, dim=128, depth=6, num_heads=4)


def vit_cifar(num_classes: int, img_size: int = 32) -> ViT:
    return ViT(num_classes, img_size=img_size, **CIFAR_VIT)


def init_weights(model: ViT, gen: torch.Generator) -> None:
    """Seeded initialization with the JAX module's initializers: every
    Dense, attention projection and the patch-embed conv lecun-normal (a
    normal truncated to 2 stddevs, variance 1/fan_in), biases 0,
    `pos_embed` N(0, 0.02), `cls_token` 0, LayerNorm 1 and 0. The numbers
    differ from flax's own draw; the distributions are the same."""
    trunc_std = 0.87962566103423978   # stddev of N(0, 1) truncated to [-2, 2]
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / trunc_std
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        model.cls_token.zero_()
        model.pos_embed.normal_(0.0, 0.02, generator=gen)


# ------------------------------------------- token-pruned incremental engine


class TokenTables(NamedTuple):
    """Static lookup tables of one rectangle table (numpy, or tensors on
    the engine's device once a family holds them)."""

    idx: np.ndarray        # [N, S] sequence positions (0 = cls, token t -> t+1)
    keep: np.ndarray       # [N, S-1, p, p, 1] f32 pixel keep-mask per dirty slot
    slot_bias: np.ndarray  # [N, S] f32: 0 for real slots, -1e9 for duplicates
    fe: np.ndarray         # [N] float64 forward equivalents (dirty + 1) / (T + 1)


def build_tables(rects: np.ndarray, img_size: int, patch: int) -> TokenTables:
    """Token sets and per-token pixel keep masks of one rectangle table.
    Slots beyond a mask's own coverage repeat its first token (the same
    keep mask, so they compute the same dirty row) and carry -1e9 in
    `slot_bias`, so their duplicate keys count once."""
    rects = np.asarray(rects, np.int64)
    if rects.ndim == 2:
        rects = rects[:, None, :]
    grid = img_size // patch
    cov = masks_lib.rect_token_coverage(rects, img_size, patch)   # [N, T]
    n, t_total = cov.shape
    counts = cov.sum(axis=1)
    s_max = int(counts.max())
    toks = np.zeros((n, s_max), np.int64)
    for i in range(n):
        own = np.nonzero(cov[i])[0]
        toks[i, :len(own)] = own
        toks[i, len(own):] = own[0]
    idx = np.zeros((n, s_max + 1), np.int32)
    idx[:, 1:] = toks + 1
    slot_bias = np.where(np.arange(s_max + 1)[None] > counts[:, None],
                         np.float32(-1e9), np.float32(0.0)).astype(np.float32)
    # per-pixel occlusion of each mask, cut into patches, gathered by token
    ar = np.arange(img_size)
    r0, r1, c0, c1 = (rects[..., k, None, None] for k in range(4))
    occ = ((ar[:, None] >= r0) & (ar[:, None] < r1)
           & (ar[None, :] >= c0) & (ar[None, :] < c1)).any(axis=1)  # [N, H, W]
    keep_px = (~occ).reshape(n, grid, patch, grid, patch) \
        .transpose(0, 1, 3, 2, 4).reshape(n, grid * grid, patch, patch)
    keep = keep_px[np.arange(n)[:, None], toks][..., None].astype(np.float32)
    fe = (counts + 1.0) / float(t_total + 1)
    return TokenTables(idx, keep, slot_bias, fe)


def _on_device(tables: TokenTables, device,
               dtype: torch.dtype = torch.float32) -> TokenTables:
    """The tables on `device`, the float ones (keep, slot_bias) in the
    family's `dtype` (-1e9 is a bf16 value too)."""
    return TokenTables(
        torch.as_tensor(tables.idx, dtype=torch.long, device=device),
        torch.as_tensor(tables.keep, dtype=dtype, device=device),
        torch.as_tensor(tables.slot_bias, dtype=dtype, device=device),
        tables.fe)


class TokenViTFamily:
    """One mask family's incremental programs over the combined rectangle
    table `[singles; pairs]` of a certifier:

    - `phase1(imgs)`: the `[B, M]` first-round table,
    - `pairs(imgs)`: the `[B, P]` pair-audit table,
    - `rows(imgs_g, sets_idx)`: second-round rows, one gathered image and
      one `[M2]` row of combined-table indices per entry,

    each returning `(preds int32, margins f32)`. `fe` holds each combined
    mask's forward equivalents; `fe_first`/`fe_pairs` are the per-image
    sums and `cache_fe` the clean cache's cost per image and call.
    `compute_dtype` "bfloat16" runs the engine on a once-cast bf16 copy of
    the victim, with the tables in bf16 and the images cast at each
    program's boundary; the margins stay float32. On a `mesh` each program
    runs this rank's block and gathers the tables."""

    def __init__(self, engine: "TokenPrunedViT", rects: np.ndarray,
                 num_singles: int, chunk_size: int, fill: float,
                 compute_dtype: str = "float32", mesh=None):
        self.mesh = mesh
        self.dtype = utils.compute_dtype(compute_dtype)
        self.engine = engine = engine.at(self.dtype)
        self.num_singles = int(num_singles)
        self.chunk_size = max(1, int(chunk_size))
        self.fill = float(fill)
        img, patch, dev = engine.img_size, engine.patch, engine.device
        m = self.num_singles
        dt = self.dtype
        self.first = _on_device(build_tables(rects[:m], img, patch), dev, dt)
        self.pair_tables = _on_device(build_tables(rects[m:], img, patch),
                                      dev, dt)
        self.combined = _on_device(build_tables(rects, img, patch), dev, dt)
        self.fe = self.combined.fe
        self.fe_first = float(self.fe[:m].sum())
        self.fe_pairs = float(self.fe[m:].sum())
        # the clean cache of each call: about (depth-1)/depth of a forward
        # for the cached activations plus 1/6 for the K/V projections (2 of
        # a block's 12 D^2 matmuls)
        depth = max(1, int(engine.module.depth))
        self.cache_fe = (depth - 1) / depth + 1.0 / 6.0

    @torch.no_grad()
    def phase1(self, imgs: torch.Tensor):
        return self.engine.table(imgs.to(self.dtype), self.first, self.fill,
                                 self.chunk_size, self.mesh)

    @torch.no_grad()
    def pairs(self, imgs: torch.Tensor):
        return self.engine.table(imgs.to(self.dtype), self.pair_tables,
                                 self.fill, self.chunk_size, self.mesh)

    @torch.no_grad()
    def rows(self, imgs_g: torch.Tensor, sets_idx: torch.Tensor):
        return self.engine.rows(imgs_g.to(self.dtype), sets_idx,
                                self.combined, self.fill, self.chunk_size,
                                self.mesh)


class TokenPrunedViT:
    """Token-pruned incremental masked inference for one ViT victim; the
    certifier calls `build_family` once per radius with its combined
    rectangle table."""

    kind = "token"

    def __init__(self, module: ViT, img_size: int,
                 normalize: Optional[Callable] = None):
        if img_size % module.patch_size:
            raise ValueError(f"img_size={img_size} not divisible by patch "
                             f"{module.patch_size}")
        self.module = module
        self.img_size = int(img_size)
        self.patch = int(module.patch_size)
        self.grid = self.img_size // self.patch
        self.normalize = normalize or (lambda x: (x - 0.5) / 0.5)
        self._casts = {}

    @property
    def device(self) -> torch.device:
        return self.module.pos_embed.device

    def at(self, dtype: torch.dtype) -> "TokenPrunedViT":
        """This engine on a `dtype` copy of its module (`utils.cast_module`,
        made at the first call and kept); itself at float32."""
        if dtype == torch.float32:
            return self
        return utils.cached_cast(self._casts, dtype, lambda: TokenPrunedViT(
            utils.cast_module(self.module, dtype), self.img_size,
            self.normalize))

    def build_family(self, rects: np.ndarray, num_singles: int,
                     chunk_size: int, fill: float,
                     compute_dtype: str = "float32",
                     mesh=None) -> TokenViTFamily:
        return TokenViTFamily(self, rects, num_singles, chunk_size, fill,
                              compute_dtype, mesh)

    # ------------------------------------------------------------ internals

    def _patches(self, imgs: torch.Tensor) -> torch.Tensor:
        """`[B, H, W, C]` -> `[B, T, p, p, C]` row-major patches."""
        b, _, _, c = imgs.shape
        p, g = self.patch, self.grid
        return imgs.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, g * g, p, p, c)

    def _embed(self, patches_g, keep, seq_pos, fill):
        """Dirty-token embeddings: occlude the gathered patches with their
        keep masks, normalize, apply the patch-embed conv (one matmul per
        token) and add the position rows."""
        proj = self.module.patch_embed.proj
        masked = patches_g * keep + fill * (1.0 - keep)
        xn = self.normalize(masked)
        kernel = proj.weight.permute(2, 3, 1, 0).reshape(-1, proj.weight.shape[0])
        emb = torch.matmul(xn.flatten(-3), kernel) + proj.bias
        return emb + self.module.pos_embed[0][seq_pos]

    @staticmethod
    def _ln(x, norm: LayerNorm):
        """The engine's LayerNorm at every dtype, the JAX engine's
        `_fast_ln`."""
        return fast_ln(x, norm.weight, norm.bias, norm.eps)

    def _clean_kv(self, cache) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per block, the clean keys and values `[B, T+1, H, f]` of the
        cached activations, computed once per image and call."""
        mod = self.module
        d, h = mod.dim, mod.num_heads
        ks, vs = [], []
        for x, block in zip(cache, mod.blocks):
            ln = self._ln(x, block.norm1)
            w, bias = block.attn.qkv.weight, block.attn.qkv.bias
            shape = x.shape[:2] + (h, d // h)
            ks.append(F.linear(ln, w[d:2 * d], bias[d:2 * d]).reshape(shape))
            vs.append(F.linear(ln, w[2 * d:], bias[2 * d:]).reshape(shape))
        return ks, vs

    def _forward(self, d, kcs, vcs, idx, slot_bias, attend):
        """Dirty tokens `d [B, C, S, D]` through every block against the
        per-image clean caches `kcs`/`vcs` (`depth x [B, T+1, H, f]`), then
        the cls readout -> logits `[B, C, classes]`. The clean rows at the
        dirty positions are stale and masked with -1e9; the S fresh rows
        replace them (duplicate slots masked by `slot_bias`). `attend` is
        the attention read (`masked_kv_attention` or its sharded form)."""
        mod = self.module
        b, c, s, dim = d.shape
        h = mod.num_heads
        hd = dim // h
        scale = 1.0 / float(np.sqrt(hd))
        t1 = kcs[0].shape[1]
        stale = (idx[..., None] == torch.arange(t1, device=idx.device)) \
            .any(dim=-2)                                         # [B, C, T+1]
        clean_bias = torch.where(stale, -1e9, 0.0).to(d.dtype)
        for block, kc, vc in zip(mod.blocks, kcs, vcs):
            attn = block.attn
            ln = self._ln(d, block.norm1)
            w, bias = attn.qkv.weight, attn.qkv.bias
            # q, k and v each from its rows of the fused weight, so that
            # each comes out contiguous in the kernel's layout
            q, kd, vd = (F.linear(ln, w[i * dim:(i + 1) * dim],
                                  bias[i * dim:(i + 1) * dim])
                         .reshape(b, c, s, h, hd) for i in range(3))
            o = attend(q * scale, kd, vd, kc, vc, clean_bias, slot_bias)
            d = d + F.linear(o.reshape(b, c, s, dim), attn.proj.weight,
                             attn.proj.bias)
            mlp = block.mlp
            hid = F.gelu(F.linear(self._ln(d, block.norm2), mlp.fc1.weight,
                                  mlp.fc1.bias))
            d = d + F.linear(hid, mlp.fc2.weight, mlp.fc2.bias)
        cls = self._ln(d[..., 0, :], mod.norm)
        return F.linear(cls, mod.head.weight, mod.head.bias)

    def _chunk(self, patches, cls0, kcs, vcs, idx, keep, bias, fill, attn):
        """One chunk of c masks over B images; the tables are per image
        (`[B, c, ...]`). Returns the logits `[B, c, classes]`."""
        b, c = idx.shape[0], idx.shape[1]
        tok = idx[..., 1:] - 1                                    # [B, c, S-1]
        rows = torch.arange(b, device=idx.device)[:, None, None]
        emb = self._embed(patches[rows, tok], keep, idx[..., 1:], fill)
        cls = cls0[:, None].expand(b, c, 1, cls0.shape[-1])
        d = torch.cat([cls, emb], dim=2)                           # [B, c, S, D]
        return self._forward(d, kcs, vcs, idx, bias, attn)

    def _clean(self, imgs):
        cache = self.module(self.normalize(imgs), "cache")
        kcs, vcs = self._clean_kv(cache)
        return self._patches(imgs), cache[0][:, :1], kcs, vcs

    @staticmethod
    def _attn(mesh):
        if mesh is None:
            return masked_kv_attention
        return lambda *ops: masked_kv_attention_sharded(*ops, mesh=mesh)

    def table(self, imgs: torch.Tensor, tables: TokenTables, fill: float,
              chunk_size: int, mesh=None):
        """All N masks of `tables` over the batch -> `(preds, margins)`
        `[B, N]`, in mask chunks of at most `chunk_size`; on a `mesh`, this
        rank's block, gathered."""
        if mesh is not None:
            return tuple(mesh.tables(
                int(imgs.shape[0]), int(tables.idx.shape[0]),
                lambda rows, cols: self._table(
                    imgs[rows], TokenTables(tables.idx[cols],
                                            tables.keep[cols],
                                            tables.slot_bias[cols],
                                            tables.fe),
                    fill, chunk_size, self._attn(mesh)),
                (torch.int32, torch.float32), "token"))
        return self._table(imgs, tables, fill, chunk_size, self._attn(None))

    def _table(self, imgs, tables, fill, chunk_size, attn):
        b = imgs.shape[0]
        n = int(tables.idx.shape[0])
        c = min(max(1, int(chunk_size)), max(1, n))
        patches, cls0, kcs, vcs = self._clean(imgs)
        preds, margins = [], []
        for off in range(0, n, c):
            sl = slice(off, off + c)

            def per_image(t):
                return t[sl][None].expand((b,) + t[sl].shape)

            p, m = utils.preds_margins(self._chunk(
                patches, cls0, kcs, vcs, per_image(tables.idx),
                per_image(tables.keep), per_image(tables.slot_bias), fill,
                attn))
            preds.append(p)
            margins.append(m)
        return torch.cat(preds, dim=1), torch.cat(margins, dim=1)

    def rows(self, imgs_g: torch.Tensor, sets_idx: torch.Tensor,
             combined: TokenTables, fill: float, chunk_size: int, mesh=None):
        """Second-round rows: entry w is gathered image w against the
        combined-table masks `sets_idx[w]` `[M2]` -> `(preds, margins)`
        `[W, M2]`. The second-mask axis runs in chunks of
        `max(1, chunk_size // W)`, so a chunk holds at most `chunk_size`
        entries; on a `mesh`, this rank's block, gathered."""
        if mesh is not None:
            return tuple(mesh.tables(
                int(sets_idx.shape[0]), int(sets_idx.shape[1]),
                lambda rows, cols: self._rows(
                    imgs_g[rows], sets_idx[rows][:, cols], combined, fill,
                    chunk_size, self._attn(mesh)),
                (torch.int32, torch.float32), "token"))
        return self._rows(imgs_g, sets_idx, combined, fill, chunk_size,
                          self._attn(None))

    def _rows(self, imgs_g, sets_idx, combined, fill, chunk_size, attn):
        w, m2 = int(sets_idx.shape[0]), int(sets_idx.shape[1])
        c = max(1, min(m2, int(chunk_size) // max(1, w)))
        sets = sets_idx.to(device=combined.idx.device, dtype=torch.long)
        patches, cls0, kcs, vcs = self._clean(imgs_g)
        preds, margins = [], []
        for off in range(0, m2, c):
            cols = sets[:, off:off + c]                            # [W, c]
            p, m = utils.preds_margins(self._chunk(
                patches, cls0, kcs, vcs, combined.idx[cols],
                combined.keep[cols], combined.slot_bias[cols], fill, attn))
            preds.append(p)
            margins.append(m)
        return torch.cat(preds, dim=1), torch.cat(margins, dim=1)
