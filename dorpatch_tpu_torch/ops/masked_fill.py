"""Fused rasterize + occlusion fill: `[B,H,W,C] x [S,K,4] -> [B,S,H,W,C]`.

The attack's EOT step, the failure sweep and the certification sweeps all
occlude images with rectangle sets and fill the occluded pixels with gray.
On the card two hand-written kernels (`csrc/masked_fill.cu`) do it:

- kernel A, the forward: rasterizes each mask's K rectangles inside the
  kernel and writes `where(occluded, fill, img)`; no mask tensor exists;
- kernel B, the backward: the image cotangent `sum_s g[b, s] * keep[s]`.

`MaskedFill` pairs them as a `torch.autograd.Function`, so the attack
differentiates through the fill. `masked_fill_reference` is the plain
version, which a CPU tensor takes. Rectangles and the fill value carry no
gradient.

`fwd_plan` and `bwd_plan` choose each launch's geometry from the shape:
16-byte lanes or the scalar route, masks per block (A), lanes per block
(B), and A's store policy from the output's size against the L2.
`fwd_grid` and `bwd_grid` turn a plan into the grid, which the C entries
launch as given (they refuse a grid that does not cover the work once).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dorpatch_tpu_torch import masks as masks_lib
from dorpatch_tpu_torch.ops import _backend, _build

#: threads of a block of either kernel (`kThreads` in csrc/masked_fill.cu)
THREADS = 256
#: lanes a thread of kernel A holds (`kLanes`): a tile is 1024 lanes
LANES = 4
#: the card's L2 (H100: 50 MB); a larger output of kernel A is stored
#: evict-first, a smaller one stays in L2 for the convolution that reads it
L2_BYTES = 50 * 2**20
#: blocks of 256 threads a launch should have at least: one an SM
MIN_BLOCKS = 128
#: mask groups of kernel A: each image tile is read this many times from L2
#: (fewer groups leave SMs idle, more re-read the image; the best count at
#: every main-path shape, `fill_bench.py --sweep`)
FWD_GROUPS = 16
MAX_GROUP = 32                     # kMaxGroup
BWD_COLS = (32, 16, 8, 4)


class FwdPlan(NamedTuple):
    """Kernel A's launch: `vec` floats a lane (4: 16-byte lanes; 1: the
    scalar route), `group` masks a block walks, `stream` evict-first
    stores."""

    vec: int
    group: int
    stream: bool


class BwdPlan(NamedTuple):
    """Kernel B's launch: `vec` as for A, `cols` lanes a block owns (its
    256 / cols thread rows split the masks)."""

    vec: int
    cols: int


def lane_width(w: int, c: int, aligned: bool) -> int:
    """4 when a row of `w * c` floats splits into 16-byte lanes (and the
    buffers are 16-byte aligned), else 1."""
    return 4 if aligned and (w * c) % 4 == 0 else 1


def fwd_grid(plan: FwdPlan, b: int, s: int, h: int, w: int,
             c: int) -> Tuple[int, int, int]:
    """Kernel A's grid: (tiles of an image, mask groups, images)."""
    nl = h * w * c // plan.vec
    return math.ceil(nl / (THREADS * LANES)), math.ceil(s / plan.group), b


def bwd_grid(plan: BwdPlan, b: int, h: int, w: int,
             c: int) -> Tuple[int, int]:
    """Kernel B's grid: (lane blocks of an image, images)."""
    return math.ceil(h * w * c // plan.vec / plan.cols), b


def fwd_plan(b: int, s: int, h: int, w: int, c: int,
             aligned: bool = True) -> FwdPlan:
    """FWD_GROUPS mask groups, more where the tiles leave fewer than
    MIN_BLOCKS blocks; evict-first stores when the output outgrows L2."""
    vec = lane_width(w, c, aligned)
    tiles = math.prod(fwd_grid(FwdPlan(vec, s, False), b, s, h, w, c))
    groups = max(FWD_GROUPS, math.ceil(MIN_BLOCKS / tiles))
    group = max(1, min(MAX_GROUP, math.ceil(s / groups)))
    return FwdPlan(vec, group, 4 * b * s * h * w * c > L2_BYTES)


def bwd_plan(b: int, s: int, h: int, w: int, c: int,
             aligned: bool = True) -> BwdPlan:
    """The widest block (lanes along the image) that still leaves two
    blocks an SM; narrower blocks split the masks more ways."""
    vec = lane_width(w, c, aligned)
    for cols in BWD_COLS:
        if math.prod(bwd_grid(BwdPlan(vec, cols), b, h, w, c)) \
                >= 2 * MIN_BLOCKS:
            break
    return BwdPlan(vec, cols)


def masked_fill_reference(imgs: torch.Tensor, rects: torch.Tensor,
                          fill: float) -> torch.Tensor:
    """The plain version: rasterize, then `where(keep, img, fill)`."""
    keep = masks_lib.rasterize(rects, imgs.shape[1])          # [S, H, W]
    return torch.where(keep[None, :, :, :, None], imgs[:, None], float(fill))


def _rects_i32(rects: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(rects, dtype=torch.int32, device=device).contiguous()


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def masked_fill_fwd_kernel(imgs: torch.Tensor, rects: torch.Tensor,
                           fill: float) -> torch.Tensor:
    """Kernel A on CUDA tensors: imgs `[B,H,W,C]` f32, rects `[S,K,4]`
    int32 -> `[B,S,H,W,C]` f32, launched with `fwd_plan`."""
    return _fwd_launch(imgs, rects, fill, None)


def masked_fill_bwd_kernel(rects: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """Kernel B on CUDA tensors: g `[B,S,H,W,C]` f32 -> `[B,H,W,C]` f32,
    launched with `bwd_plan`."""
    return _bwd_launch(rects, g, None)


def _check_vec(vec: int, w: int, c: int, aligned: bool) -> None:
    if vec not in (1, 4) or vec > lane_width(w, c, aligned):
        raise ValueError(f"{vec} floats a lane do not fit rows of {w}x{c} "
                         f"floats (16-byte aligned: {aligned})")


def _fwd_launch(imgs: torch.Tensor, rects: torch.Tensor, fill: float,
                plan: Optional[FwdPlan]) -> torch.Tensor:
    """Kernel A with `plan` (None: `fwd_plan` of the shape)."""
    _backend.require(imgs, "imgs", torch.float32, 4)
    _backend.require(rects, "rects", torch.int32, 3)
    if rects.shape[2] != 4 or rects.device != imgs.device:
        raise ValueError(f"rects must be [S,K,4] on {imgs.device}")
    b, h, w, c = imgs.shape
    s, k = int(rects.shape[0]), int(rects.shape[1])
    out = torch.empty((b, s, h, w, c), dtype=imgs.dtype, device=imgs.device)
    aligned = _aligned(imgs, out)
    if plan is None:
        plan = fwd_plan(b, s, h, w, c, aligned)
    _check_vec(plan.vec, w, c, aligned)
    tiles, groups, _ = fwd_grid(plan, b, s, h, w, c)
    lib = _build.library()
    _backend.count_launch("masked_fill_fwd")
    _build.check(lib.dp_masked_fill_fwd(
        imgs.data_ptr(), rects.data_ptr(), out.data_ptr(), b, s, k, h, w, c,
        float(fill), int(plan.vec == 4), plan.group, int(plan.stream), tiles,
        groups, _backend.stream_handle(imgs)), "masked_fill_fwd")
    return out


def _bwd_launch(rects: torch.Tensor, g: torch.Tensor,
                plan: Optional[BwdPlan]) -> torch.Tensor:
    """Kernel B with `plan` (None: `bwd_plan` of the shape)."""
    _backend.require(g, "g", torch.float32, 5)
    _backend.require(rects, "rects", torch.int32, 3)
    b, s, h, w, c = g.shape
    if rects.shape[0] != s or rects.shape[2] != 4:
        raise ValueError(f"rects {tuple(rects.shape)} do not match g "
                         f"{tuple(g.shape)}")
    dx = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    aligned = _aligned(g, dx)
    if plan is None:
        plan = bwd_plan(b, s, h, w, c, aligned)
    _check_vec(plan.vec, w, c, aligned)
    blocks, _ = bwd_grid(plan, b, h, w, c)
    lib = _build.library()
    _backend.count_launch("masked_fill_bwd")
    _build.check(lib.dp_masked_fill_bwd(
        g.data_ptr(), rects.data_ptr(), dx.data_ptr(), b, s,
        int(rects.shape[1]), h, w, c, int(plan.vec == 4), plan.cols, blocks,
        _backend.stream_handle(g)), "masked_fill_bwd")
    return dx


class MaskedFill(torch.autograd.Function):
    """Kernel A forward, kernel B backward (image cotangent only)."""

    @staticmethod
    def forward(ctx, imgs, rects, fill):
        ctx.save_for_backward(rects)
        return masked_fill_fwd_kernel(imgs.contiguous(), rects, fill)

    @staticmethod
    def backward(ctx, g):
        (rects,) = ctx.saved_tensors
        return masked_fill_bwd_kernel(rects, g.contiguous()), None, None


def masked_fill(imgs: torch.Tensor, rects, fill: float = 0.5) -> torch.Tensor:
    """Occlude `imgs` `[B,H,W,C]` with every rectangle set in `rects`
    `[S,K,4]` (int32 rows `(r0, r1, c0, c1)`, half-open; zero-area rows are
    no-ops), filling with `fill`. Returns `[B,S,H,W,C]`, differentiable
    with respect to `imgs`. CUDA tensors run kernels A and B; CPU tensors
    run the plain version."""
    rects = _rects_i32(rects, imgs.device)
    if _backend.on_card(imgs):
        return MaskedFill.apply(imgs, rects, float(fill))
    return masked_fill_reference(imgs, rects, fill)
