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
"""

from __future__ import annotations

import torch

from dorpatch_tpu_torch import masks as masks_lib
from dorpatch_tpu_torch.ops import _backend, _build


def masked_fill_reference(imgs: torch.Tensor, rects: torch.Tensor,
                          fill: float) -> torch.Tensor:
    """The plain version: rasterize, then `where(keep, img, fill)`."""
    keep = masks_lib.rasterize(rects, imgs.shape[1])          # [S, H, W]
    return torch.where(keep[None, :, :, :, None], imgs[:, None], float(fill))


def _rects_i32(rects: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(rects, dtype=torch.int32, device=device).contiguous()


def masked_fill_fwd_kernel(imgs: torch.Tensor, rects: torch.Tensor,
                           fill: float) -> torch.Tensor:
    """Kernel A on CUDA tensors: imgs `[B,H,W,C]` f32, rects `[S,K,4]`
    int32 -> `[B,S,H,W,C]` f32."""
    _backend.require(imgs, "imgs", torch.float32, 4)
    _backend.require(rects, "rects", torch.int32, 3)
    if rects.shape[2] != 4 or rects.device != imgs.device:
        raise ValueError(f"rects must be [S,K,4] on {imgs.device}")
    b, h, w, c = imgs.shape
    s, k = int(rects.shape[0]), int(rects.shape[1])
    out = torch.empty((b, s, h, w, c), dtype=imgs.dtype, device=imgs.device)
    vec4 = int((h * w * c) % 4 == 0 and imgs.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    lib = _build.library()
    _backend.count_launch("masked_fill_fwd")
    _build.check(lib.dp_masked_fill_fwd(
        imgs.data_ptr(), rects.data_ptr(), out.data_ptr(), b, s, k, h, w, c,
        float(fill), vec4, _backend.stream_handle(imgs)), "masked_fill_fwd")
    return out


def masked_fill_bwd_kernel(rects: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """Kernel B on CUDA tensors: g `[B,S,H,W,C]` f32 -> `[B,H,W,C]` f32."""
    _backend.require(g, "g", torch.float32, 5)
    _backend.require(rects, "rects", torch.int32, 3)
    b, s, h, w, c = g.shape
    if rects.shape[0] != s or rects.shape[2] != 4:
        raise ValueError(f"rects {tuple(rects.shape)} do not match g "
                         f"{tuple(g.shape)}")
    dx = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    lib = _build.library()
    _backend.count_launch("masked_fill_bwd")
    _build.check(lib.dp_masked_fill_bwd(
        g.data_ptr(), rects.data_ptr(), dx.data_ptr(), b, s,
        int(rects.shape[1]), h, w, c, _backend.stream_handle(g)),
        "masked_fill_bwd")
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
