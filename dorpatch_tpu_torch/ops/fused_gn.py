"""GroupNorm(G)+ReLU on NHWC tensors, with its backward.

ResNetV2-50 BiT runs 49 GroupNorm(32)+ReLU pairs per forward. On the card
hand-written kernels (`csrc/fused_gn.cu`) run both directions:

- the forward (kernels D/E of the JAX package) writes `y` and the `[N, G]`
  mean and rstd that the backward reads;
- the backward (kernels F/G) recomputes `xhat` and the ReLU gate from the
  saved statistics and writes `dx`, plus the parameter cotangents when they
  are asked for.

`GNRelu` pairs them as a `torch.autograd.Function`; it saves only `x` and
the `[N, G]` statistics (and the affine parameters). `gn_relu_reference` and
`gn_relu_backward_reference` are the plain versions, which a CPU tensor
takes. Port of `dorpatch_tpu.ops.fused_gn` for float32 (the JAX kernels are
dtype-generic; bf16 comes with the bf16 bank).
"""

from __future__ import annotations

from typing import Optional

import torch

from dorpatch_tpu_torch.ops import _backend, _build

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 statistics for float32 and narrower inputs, float64 for
    float64 inputs (the card checks' reference)."""
    return torch.promote_types(dtype, torch.float32)


def gn_stats_reference(x: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """Per-(sample, group) mean and rstd `[N, G]` of NHWC `x`, as flax's
    `_compute_stats`: the fast variance `E[x^2] - E[x]^2` clipped at 0."""
    n, h, w, c = x.shape
    xf = x.to(_acc_dtype(x.dtype)).reshape(n, h * w, num_groups,
                                           c // num_groups)
    mean = xf.mean(dim=(1, 3))
    msq = (xf * xf).mean(dim=(1, 3))
    var = torch.clamp(msq - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def gn_relu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """The plain forward, in flax's op order: `(x - mean) * (rsqrt(var +
    eps) * scale) + bias`, then ReLU, cast to `x.dtype`. `F.group_norm` takes
    a two-pass variance and would differ from the JAX package in the last
    bits."""
    n, h, w, c = x.shape
    g, gs = num_groups, c // num_groups
    acc = _acc_dtype(x.dtype)
    xf = x.to(acc).reshape(n, h * w, g, gs)
    mean, rstd = gn_stats_reference(x, g, eps)
    mul = rstd[:, None, :, None] * scale.to(acc).reshape(1, 1, g, gs)
    y = (xf - mean[:, None, :, None]) * mul + bias.to(acc).reshape(1, 1, g, gs)
    return torch.relu(y).reshape(n, h, w, c).to(x.dtype)


def gn_relu_backward_reference(x, dy, scale, bias, mean, rstd,
                               num_groups: int = 32):
    """The plain backward, the kernels' formula written out: recompute
    `xhat` and the ReLU gate from the saved `[N, G]` mean and rstd, take the
    per-channel `db_c = sum dyr` and `ds_c = sum dyr * xhat`, the group sums
    `a_g`/`b_g` of `scale * db_c`/`scale * ds_c`, and
    `dx = rstd * (dyr * scale - (a_g + xhat * b_g) / count)`. Returns
    `(dx, dscale, dbias)`."""
    n, h, w, c = x.shape
    g, gs = num_groups, c // num_groups
    acc = _acc_dtype(x.dtype)
    xf = x.to(acc).reshape(n, h * w, g, gs)
    dyf = dy.to(acc).reshape(n, h * w, g, gs)
    m = mean.to(acc).reshape(n, 1, g, 1)
    r = rstd.to(acc).reshape(n, 1, g, 1)
    s = scale.to(acc).reshape(1, 1, g, gs)
    b = bias.to(acc).reshape(1, 1, g, gs)
    xhat = (xf - m) * r
    dyr = torch.where(xhat * s + b > 0.0, dyf, 0.0)
    db_c = dyr.sum(dim=1)                                    # [N, G, gs]
    ds_c = (dyr * xhat).sum(dim=1)
    a_g = (db_c * s[0]).sum(dim=-1)[:, None, :, None]        # [N, 1, G, 1]
    b_g = (ds_c * s[0]).sum(dim=-1)[:, None, :, None]
    dx = r * (dyr * s - (a_g + xhat * b_g) / float(h * w * gs))
    return (dx.reshape(n, h, w, c).to(x.dtype),
            ds_c.sum(dim=0).reshape(c).to(scale.dtype),
            db_c.sum(dim=0).reshape(c).to(bias.dtype))


def gate_flip_bounds(x, dy, scale, bias, mean, rstd, num_groups: int = 32,
                     near: float = 1e-5):
    """How far ReLU-gate flips can move a backward. Two correct
    implementations round the pre-activation `xhat * scale + bias`
    differently, so an element within `near` of 0 may be gated open in one
    and closed in the other. Each flip moves its channel's `db_c`/`ds_c` by
    `dy`/`dy * xhat`, and through the group sums every `dx` of its group.
    Returns, in the precision of the plain versions, `(near_zero [N,H,W,C]
    bool, dx_bound [N,H,W,C], dscale_bound [C], dbias_bound [C])`: the
    elements to leave out of a `dx` comparison, and the most the flips can
    move `dx` elsewhere and the parameter cotangents."""
    n, h, w, c = x.shape
    g, gs = num_groups, c // num_groups
    acc = _acc_dtype(x.dtype)
    xf = x.to(acc).reshape(n, h * w, g, gs)
    s = scale.to(acc).reshape(1, 1, g, gs)
    r = rstd.to(acc).reshape(n, 1, g, 1)
    xhat = (xf - mean.to(acc).reshape(n, 1, g, 1)) * r
    near_zero = (xhat * s + bias.to(acc).reshape(1, 1, g, gs)).abs() < near
    ady = torch.where(near_zero, dy.to(acc).reshape(xf.shape).abs(), 0.0)
    a_g = (ady * s.abs()).sum(dim=(1, 3), keepdim=True)
    b_g = (ady * xhat.abs() * s.abs()).sum(dim=(1, 3), keepdim=True)
    dx_bound = r * (a_g + xhat.abs() * b_g) / float(h * w * gs)
    return (near_zero.reshape(n, h, w, c), dx_bound.reshape(n, h, w, c),
            (ady * xhat.abs()).sum(dim=(0, 1)).reshape(c),
            ady.sum(dim=(0, 1)).reshape(c))


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           num_groups: int) -> None:
    _backend.require(x, "x", torch.float32, 4)
    _backend.require(scale, "scale", torch.float32, 1)
    _backend.require(bias, "bias", torch.float32, 1)
    c = x.shape[-1]
    if (c % num_groups or c % 4 or tuple(scale.shape) != (c,)
            or tuple(bias.shape) != (c,) or scale.device != x.device
            or bias.device != x.device):
        raise ValueError(f"GroupNorm shapes do not agree: x {tuple(x.shape)}, "
                         f"scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)}, {num_groups} groups (C must "
                         "be a multiple of 4 and of the group count)")
    if any(t.data_ptr() % 16 for t in (x, scale, bias)):
        raise ValueError("the GroupNorm kernels move 16 bytes a thread: x, "
                         "scale and bias must be 16-byte aligned")


def gn_relu_fwd_kernel(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, num_groups: int = 32,
                       eps: float = 1e-5):
    """The forward kernels on CUDA tensors: x `[N,H,W,C]` f32 ->
    `(y [N,H,W,C], mean [N,G], rstd [N,G])`."""
    _check(x, scale, bias, num_groups)
    n, h, w, c = x.shape
    lib = _build.library()
    tiles = lib.dp_gn_tiles(h * w)
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), dtype=x.dtype, device=x.device)
    rstd = torch.empty_like(mean)
    p1 = torch.empty((n, tiles, c), dtype=x.dtype, device=x.device)
    p2 = torch.empty_like(p1)
    _backend.count_launch("gn_relu_fwd")
    _build.check(lib.dp_gn_relu_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), p1.data_ptr(), p2.data_ptr(), n,
        h * w, c, num_groups, float(eps), _backend.stream_handle(x)),
        "gn_relu_fwd")
    return y, mean, rstd


def gn_relu_bwd_kernel(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, mean: torch.Tensor,
                       rstd: torch.Tensor, num_groups: int = 32,
                       params: bool = True):
    """The backward kernels on CUDA tensors -> `(dx, dscale, dbias)`;
    `dscale`/`dbias` are None unless `params`."""
    _check(x, scale, bias, num_groups)
    _backend.require(dy, "dy", torch.float32, 4)
    for t, name in ((mean, "mean"), (rstd, "rstd")):
        _backend.require(t, name, torch.float32, 2)
    n, h, w, c = x.shape
    if tuple(dy.shape) != tuple(x.shape) or dy.data_ptr() % 16 or \
            tuple(mean.shape) != (n, num_groups) or \
            tuple(rstd.shape) != (n, num_groups):
        raise ValueError(f"GroupNorm backward shapes do not agree: x "
                         f"{tuple(x.shape)}, dy {tuple(dy.shape)}, mean "
                         f"{tuple(mean.shape)}, rstd {tuple(rstd.shape)}")
    lib = _build.library()
    tiles = lib.dp_gn_tiles(h * w)
    dx = torch.empty_like(x)
    pdb = torch.empty((n, tiles, c), dtype=x.dtype, device=x.device)
    pds = torch.empty_like(pdb)
    dbc = torch.empty((n, c), dtype=x.dtype, device=x.device)
    dsc = torch.empty_like(dbc)
    ag = torch.empty_like(mean)
    bg = torch.empty_like(mean)
    dscale: Optional[torch.Tensor] = None
    dbias: Optional[torch.Tensor] = None
    if params:
        dscale = torch.empty_like(scale)
        dbias = torch.empty_like(bias)
    _backend.count_launch("gn_relu_bwd")
    _build.check(lib.dp_gn_relu_bwd(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), pdb.data_ptr(),
        pds.data_ptr(), dbc.data_ptr(), dsc.data_ptr(), ag.data_ptr(),
        bg.data_ptr(), dscale.data_ptr() if params else None,
        dbias.data_ptr() if params else None, n, h * w, c, num_groups,
        _backend.stream_handle(x)), "gn_relu_bwd")
    return dx, dscale, dbias


class GNRelu(torch.autograd.Function):
    """The forward kernels, and the backward kernels for the gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        y, mean, rstd = gn_relu_fwd_kernel(x, scale, bias, num_groups, eps)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        params = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dscale, dbias = gn_relu_bwd_kernel(
            x, dy.contiguous(), scale, bias, mean, rstd, ctx.num_groups,
            params=params)
        return dx, dscale, dbias, None, None


def gn_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(num_groups, eps)+ReLU on NHWC `x` with the `[C]` affine
    `scale`/`bias`; differentiable in all three. A CUDA tensor runs the
    kernels (float32 only); a CPU tensor runs the plain version."""
    if x.shape[-1] % num_groups:
        raise ValueError(f"C={x.shape[-1]} not divisible by {num_groups} "
                         "groups")
    if _backend.on_card(x):
        return GNRelu.apply(x.contiguous(), scale, bias, num_groups,
                            float(eps))
    return gn_relu_reference(x, scale, bias, num_groups, eps)
