"""R-covering occlusion-mask geometry.

Every mask is a small set of occlusion rectangles `[K, 4]` int32 rows
`(r0, r1, c0, c1)`, half-open and clipped to the image; empty `(0,0,0,0)`
rows occlude nothing. The geometry is host numpy, identical to
`dorpatch_tpu.masks`; `rasterize` and `apply_masks` are the torch versions.

Mask convention: **True = pixel kept, False = occluded**. A mask with K
rectangles rasterizes to `AND_k (outside rect_k)`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dorpatch_tpu_torch.config import DEFAULT_RATIOS, NUM_MASKS_PER_AXIS

class MaskSpec(NamedTuple):
    """Geometry of one R-covering mask family."""

    img_size: int
    patch_ratio: float
    n_patch: int
    mask_size: int
    stride: int
    window_size: int
    num_mask_per_axis: int


def geometry(
    img_size: int,
    patch_ratio: float = 0.03,
    n_patch: int = 1,
    num_mask_per_axis: int = NUM_MASKS_PER_AXIS,
) -> MaskSpec:
    """mask = floor(sqrt(img^2 * ratio / n_patch));
    stride = ceil((img - mask + 1) / num_mask_per_axis);
    window = mask + stride - 1."""
    mask_size = math.floor(math.sqrt(img_size**2 * patch_ratio / n_patch))
    stride = math.ceil((img_size - mask_size + 1) / num_mask_per_axis)
    window_size = mask_size + stride - 1
    return MaskSpec(img_size, patch_ratio, n_patch, mask_size, stride,
                    window_size, num_mask_per_axis)


def first_order_rects(spec: MaskSpec) -> np.ndarray:
    """The `num^2` single occlusion windows, int32 `[num^2, 4]`, row-major
    order `i * num + j`."""
    num = spec.num_mask_per_axis
    rects = np.zeros((num * num, 4), dtype=np.int32)
    for i in range(num):
        for j in range(num):
            r0 = spec.stride * i
            c0 = spec.stride * j
            rects[i * num + j] = (r0, min(spec.img_size, r0 + spec.window_size),
                                  c0, min(spec.img_size, c0 + spec.window_size))
    return rects


def pair_rects(rects: np.ndarray) -> np.ndarray:
    """Upper-triangular (i<j) pairs of rectangles, `[C(M,2), 2, 4]`, in
    row-major pair order (0,1),(0,2),...,(1,2),..."""
    ii, jj = np.triu_indices(rects.shape[0], k=1)
    return np.stack([rects[ii], rects[jj]], axis=1).astype(np.int32)


def pair_index(n: int, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Index into `pair_rects` output for pair (i<j) of an n-mask family."""
    i = np.asarray(i)
    j = np.asarray(j)
    return (i * (2 * n - i - 1)) // 2 + (j - i - 1)


def second_round_table_indices(n: int) -> np.ndarray:
    """`grid[i, j]` = index of the {i, j} double mask into the combined
    `[singles; pairs]` table; the diagonal maps to the single mask itself
    (masking is idempotent), so row i is the second-round mask set of
    first-round mask i."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    grid = n + pair_index(n, np.minimum(ii, jj), np.maximum(ii, jj))
    grid[np.eye(n, dtype=bool)] = np.arange(n)
    return grid.astype(np.int32)


def mask_sets(spec: MaskSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(mask_set, double_mask_set) as rectangle sets.

    n_patch=1: singles `[M,1,4]` and pairs `[C(M,2),2,4]`.
    n_patch=2: pairs and basic-major triples `[M*C(M,2),3,4]`.
    """
    basic = first_order_rects(spec)
    pairs = pair_rects(basic)
    if spec.n_patch == 1:
        return basic[:, None, :], pairs
    if spec.n_patch == 2:
        n_basic, n_pairs = basic.shape[0], pairs.shape[0]
        triples = np.concatenate(
            [np.broadcast_to(basic[:, None, None, :], (n_basic, n_pairs, 1, 4)),
             np.broadcast_to(pairs[None, :, :, :], (n_basic, n_pairs, 2, 4))],
            axis=2,
        ).reshape(n_basic * n_pairs, 3, 4)
        return pairs, triples.astype(np.int32)
    raise NotImplementedError(f"n_patch={spec.n_patch}")


def pad_rects(rects: np.ndarray, k: int) -> np.ndarray:
    """Pad the rectangle axis to K entries with empty (0,0,0,0) rectangles,
    which occlude nothing."""
    n, cur, _ = rects.shape
    if cur > k:
        raise ValueError(f"cannot pad {cur} rectangles down to K={k}")
    if cur == k:
        return rects
    return np.concatenate([rects, np.zeros((n, k - cur, 4), np.int32)], axis=1)


def dropout_universe(
    img_size: int,
    dropout: int = 2,
    dropout_sizes: Sequence[float] = DEFAULT_RATIOS,
    num_mask_per_axis: int = NUM_MASKS_PER_AXIS,
) -> np.ndarray:
    """The attack's occlusion universe: the n_patch=1 family's singles
    (dropout=1) or pairs (dropout=2) over every dropout ratio; dropout=0 is
    one empty (identity) mask."""
    if dropout == 0:
        return np.zeros((1, 1, 4), dtype=np.int32)
    if dropout not in (1, 2):
        raise ValueError(f"dropout={dropout} (supported: 0, 1, 2)")
    parts = []
    for ratio in dropout_sizes:
        spec = geometry(img_size, ratio, n_patch=1,
                        num_mask_per_axis=num_mask_per_axis)
        singles, doubles = mask_sets(spec)
        parts.append(singles if dropout == 1 else doubles)
    return np.concatenate(parts, axis=0)


def rect_token_coverage(rects: np.ndarray, img_size: int,
                        patch_px: int) -> np.ndarray:
    """`[N, K, 4]` rectangle sets -> `[N, T]` bool over the row-major ViT
    patch tokens (`T = (img_size // patch_px) ** 2`): True where any
    rectangle of the mask overlaps the token's pixel window. A rectangle
    whose edge straddles a patch boundary covers both tokens."""
    rects = np.asarray(rects, dtype=np.int64)
    if rects.ndim == 2:
        rects = rects[:, None, :]
    grid = img_size // patch_px
    starts = np.arange(grid) * patch_px
    r0, r1 = rects[..., 0:1], rects[..., 1:2]                # [N, K, 1]
    c0, c1 = rects[..., 2:3], rects[..., 3:4]
    rows = (r0 < starts + patch_px) & (r1 > starts)          # [N, K, G]
    cols = (c0 < starts + patch_px) & (c1 > starts)
    cover = rows[..., :, None] & cols[..., None, :]          # [N, K, G, G]
    return cover.any(axis=1).reshape(rects.shape[0], grid * grid)


def token_coverage(spec: MaskSpec, patch_px: int) -> np.ndarray:
    """`[M, T]` bool: first-round mask i touches patch token t."""
    if spec.img_size % patch_px:
        raise ValueError(f"patch_px={patch_px} does not divide "
                         f"img_size={spec.img_size}")
    return rect_token_coverage(first_order_rects(spec)[:, None, :],
                               spec.img_size, patch_px)


def rasterize(rects: torch.Tensor, img_size: int) -> torch.Tensor:
    """Rectangle sets `[..., K, 4]` -> boolean keep-masks `[..., H, W]`
    (True = keep), on the rectangles' device."""
    rects = torch.as_tensor(rects, dtype=torch.int32)
    ar = torch.arange(img_size, device=rects.device, dtype=torch.int32)
    rows = ar[:, None]
    cols = ar[None, :]
    r0 = rects[..., 0, None, None]
    r1 = rects[..., 1, None, None]
    c0 = rects[..., 2, None, None]
    c1 = rects[..., 3, None, None]
    occluded = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    return ~occluded.any(dim=-3)


def apply_masks(imgs: torch.Tensor, masks: torch.Tensor,
                fill: float = 0.5) -> torch.Tensor:
    """`img * m + fill * (1 - m)`: imgs `[B,H,W,C]`, masks `[N,H,W]` bool
    -> `[B,N,H,W,C]`."""
    m = masks[None, :, :, :, None].to(imgs.dtype)
    return imgs[:, None] * m + fill * (1.0 - m)
