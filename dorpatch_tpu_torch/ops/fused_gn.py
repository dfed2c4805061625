"""GroupNorm(G)+ReLU on NHWC tensors, with its backward.

ResNetV2-50 BiT runs 49 GroupNorm(32)+ReLU pairs per forward. On the card
hand-written kernels (`csrc/fused_gn.cu`) run both directions:

- the forward (kernels D/E of the JAX package) writes `y` and the `[N, G]`
  mean and rstd that the backward reads;
- the backward (kernels F/G) recomputes `xhat` and the ReLU gate from the
  saved statistics and writes `dx`, plus the parameter cotangents when they
  are asked for.

Both directions are bound by bytes: the forward must read x and write y,
the backward read x and dy and write dx, and a group's statistics need all
of its elements before any output. `gn_plan` picks one of two routes from
the shape, as the JAX package's `_fwd_plan`/`_bwd_plan` pick the whole-slab
or the tiled kernels:

- "one_pass" (kernels D `_fwd_kernel` and F `_bwd_kernel`): a block, or a
  thread-block cluster that splits the rows, stages a chunk of whole groups
  (`width` channels of one sample, all HW rows) in shared memory, reduces
  the group sums from there and writes the output, so each slab is read
  once and written once, in one launch. Every RN50 shape at 224 takes it,
  and at 480 px every forward.
- "split" (kernels E and G, the tiled pair): a statistics pass over
  thread-block clusters that adds its sums up itself (`split_plan` sizes
  the chunks and clusters), then the output from a second read of x (and
  dy): the forward's in the same launch, the backward's in a dx launch;
  for slabs whose chunk fits no cluster. RN50 at 480 px takes it for the
  backward of its 14400-row stage-1 slabs, 11 of the 49 calls.

`GNRelu` pairs them as a `torch.autograd.Function`; it saves only `x` and
the `[N, G]` statistics (and the affine parameters). `gn_relu_reference` and
`gn_relu_backward_reference` are the plain versions, which a CPU tensor
takes. Port of `dorpatch_tpu.ops.fused_gn`.

bf16 activations (the bf16 attack and the bf16 certify bank on RN50) take
the kernels' bf16 forms on either route: statistics and every
intermediate in float32, `y` and `dx` in `x.dtype`,
the parameter cotangents in the affine parameters' type; `gn_plan` reckons
a chunk's bytes with the element size.
`gn_preserve_dtype` is the other bf16 numerics the JAX package's plain
model code uses: float32 statistics, the normalize chain in `x.dtype`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from dorpatch_tpu_torch.ops import _backend, _build

#: threads of a one-pass block, and the most CTAs of its cluster (the
#: portable cluster size); `csrc/fused_gn.cu` kOneThreads, kMaxCluster
ONE_PASS_THREADS = 256
MAX_CLUSTER = 8
#: the narrowest row segment of a one-pass chunk (two 32-byte sectors), and
#: what a chunk is widened toward: rows of 256 bytes and at least 24 KB of
#: each staged slab ran fastest at every RN50 shape that has room for them
#: (`gn_bench.py --sweep`, PERF.md)
MIN_ROW_BYTES = 64
TARGET_ROW_BYTES = 256
MIN_STAGE_BYTES = 24 * 1024
#: the shared memory of an SM (228 KB, 1 KB of it reserved per block) split
#: between two blocks
TWO_PER_SM_BYTES = (233472 - 2 * 1024) // 2
#: the most dynamic shared memory a CTA should take, per (direction,
#: element size), as measured at the RN50 shapes: the forward runs fastest
#: with one wide chunk an SM; the float32 backward (twice the bytes a
#: chunk) with two CTAs an SM, its [3136, C] chunks of 16 channels split
#: over a cluster of four; the bf16 backward with one wide chunk an SM
#: again (`gn_bench.py --dtype bfloat16 --sweep`: two CTAs an SM took it
#: to clusters of eight and 1.4x the time)
PREFERRED_CTA_BYTES = {("fwd", 4): _build.MAX_SMEM_BYTES,
                       ("bwd", 4): TWO_PER_SM_BYTES,
                       ("fwd", 2): _build.MAX_SMEM_BYTES,
                       ("bwd", 2): _build.MAX_SMEM_BYTES}
#: the grid's limit on samples
MAX_GRID = 65535
#: the split route's statistics pass. The kernels take chunks of
#: at most SPLIT_MAX_WIDTH channels over clusters of at most
#: SPLIT_MAX_CLUSTER CTAs (`csrc/fused_gn.cu` kSplitMaxW, kSplitMaxCluster).
#: The plan takes chunks whose rows are MIN_ROW_BYTES to SPLIT_WIDTH
#: channels long backward, at least SPLIT_MIN_CTAS CTAs (about two on each
#: of the H100's 132 SMs), at most SPLIT_CTA_BYTES of x (and dy) and at
#: least SPLIT_MIN_ROWS rows a CTA: at RN50's 480 px stage-1 slabs those
#: backward plans came within 3% of the best tried (`gn_bench.py
#: --img-size 480 --sweep`, PERF.md). The forward (kernel E) starts from
#: the widest chunk of rows of at most FWD_SPLIT_ROW_BYTES, splits rows
#: over clusters of at most MAX_CLUSTER and narrows the chunk down to
#: FWD_SPLIT_MIN_WIDTH channels: its CTAs take a whole SM each and the card
#: holds only 7 clusters of 10 to 16 of them at once (15 of 7 or 8), so
#: larger clusters or narrower chunks ran in a second wave; these plans
#: were the fastest tried at the [4, 65536, 64] slab and within 3% of it
#: at the 480 stage-1 shapes (`gn_bench.py --split --sweep`, PERF.md)
SPLIT_MAX_WIDTH = 256
SPLIT_MAX_CLUSTER = 16
SPLIT_WIDTH = 64
FWD_SPLIT_ROW_BYTES = 512
FWD_SPLIT_MIN_WIDTH = 32
SPLIT_MIN_CTAS = 256
SPLIT_CTA_BYTES = 4 << 20
SPLIT_MIN_ROWS = 128


class GNPlan(NamedTuple):
    """How the kernels run one shape: `route` "one_pass" with chunks of
    `width` channels (whole groups), `cluster` CTAs a chunk and `smem`
    bytes of dynamic shared memory a CTA; or "split" (the other fields 0)."""
    route: str
    width: int
    cluster: int
    smem: int


class SplitPlan(NamedTuple):
    """How the split route's statistics pass runs one shape: a cluster of
    `cluster` CTAs takes `width` channels (whole groups) of one sample, its
    CTAs a share of the HW rows each."""
    width: int
    cluster: int


def piece_channels(itemsize: int) -> int:
    """Channels of a 16-byte piece: 4 float32, 8 bf16."""
    return 16 // itemsize


def one_pass_smem(hw: int, width: int, cluster: int, slabs: int,
                  itemsize: int = 4) -> int:
    """Dynamic shared memory of a one-pass CTA: its share of the chunk's
    rows of `slabs` slabs (1 forward, 2 backward) of `itemsize`-byte
    elements, the threads' float32 partial sums (two per channel of a
    piece), the float64 channel sums and the per-group values (the carve
    of `csrc/fused_gn.cu`, `dp_gn_onepass_smem` and `..._bf16`)."""
    rows = -(-hw // cluster)
    return (itemsize * rows * width * slabs
            + 8 * piece_channels(itemsize) * ONE_PASS_THREADS + 40 * width)


def one_pass_widths(c: int, num_groups: int, itemsize: int = 4):
    """The chunk widths a one-pass CTA takes, narrowest first: whole
    groups, a multiple of a 16-byte piece's channels, at most one piece
    column a thread."""
    cg = c // num_groups
    p = piece_channels(itemsize)
    return [k * cg for k in range(1, num_groups + 1)
            if num_groups % k == 0 and k * cg % p == 0
            and k * cg <= p * ONE_PASS_THREADS]


def one_pass_width(hw: int, c: int, num_groups: int, slabs: int,
                   budget: int, itemsize: int = 4) -> Optional[int]:
    """Channels of a one-pass chunk: the narrowest width whose rows are at
    least MIN_ROW_BYTES (the widest if none is), widened by whole groups
    while its rows are shorter than TARGET_ROW_BYTES or a staged slab
    holds less than MIN_STAGE_BYTES, as long as the wider chunk fits
    `budget` as one CTA; None when no width fits a thread's piece
    column."""
    widths = one_pass_widths(c, num_groups, itemsize)
    if not widths:
        return None
    wide = [w for w in widths if itemsize * w >= MIN_ROW_BYTES] \
        or widths[-1:]
    width = wide[0]
    for nxt in wide[1:]:
        if ((itemsize * width >= TARGET_ROW_BYTES
             and itemsize * hw * width >= MIN_STAGE_BYTES)
                or one_pass_smem(hw, nxt, 1, slabs, itemsize) > budget):
            break
        width = nxt
    return width


@functools.lru_cache(maxsize=256)
def gn_plan(direction: str, n: int, hw: int, c: int,
            num_groups: int = 32, itemsize: int = 4) -> GNPlan:
    """The route of one GroupNorm+ReLU call on the card, from its shape and
    element size (4 float32, 2 bf16): the one-pass route with chunks of
    `one_pass_width` channels and the fewest CTAs a chunk whose shared
    memory fits PREFERRED_CTA_BYTES, else the fewest that fit a block's
    limit; else the split route, where `split_widths` has a chunk; a shape
    neither takes raises. `direction` is "fwd" or "bwd"."""
    slabs = {"fwd": 1, "bwd": 2}[direction]
    p = piece_channels(itemsize)
    if c % num_groups or c % p:
        raise ValueError(f"C={c} must be a multiple of {p} and of the "
                         f"{num_groups} groups")
    if n > MAX_GRID:
        raise ValueError(f"GroupNorm kernels take at most {MAX_GRID} "
                         f"samples a call, got {n}")
    preferred = PREFERRED_CTA_BYTES[direction, itemsize]
    width = one_pass_width(hw, c, num_groups, slabs, preferred, itemsize)
    if width is not None:
        for budget in (preferred, _build.MAX_SMEM_BYTES):
            cl = 1
            while cl <= MAX_CLUSTER:
                smem = one_pass_smem(hw, width, cl, slabs, itemsize)
                if smem <= budget:
                    return GNPlan("one_pass", width, cl, smem)
                cl *= 2
    if split_widths(c, num_groups, itemsize):
        return GNPlan("split", 0, 0, 0)
    raise ValueError(f"no GroupNorm kernel route takes HW={hw}, C={c}: its "
                     f"chunk fits no cluster and its groups of "
                     f"{c // num_groups} channels no split-route chunk")


def split_widths(c: int, num_groups: int, itemsize: int = 4):
    """The chunk widths of the split route's statistics pass,
    narrowest first: whole groups, a multiple of a 16-byte piece's
    channels, at most SPLIT_MAX_WIDTH channels."""
    cg = c // num_groups
    p = piece_channels(itemsize)
    return [k * cg for k in range(1, num_groups + 1)
            if num_groups % k == 0 and k * cg % p == 0
            and k * cg <= SPLIT_MAX_WIDTH]


def split_target_ctas(direction: str, n: int, hw: int, c: int,
                      itemsize: int = 4) -> int:
    """The CTAs the split route's statistics pass aims for: at least
    SPLIT_MIN_CTAS, and enough that none reads more than SPLIT_CTA_BYTES of
    x (and, backward, dy)."""
    slabs = {"fwd": 1, "bwd": 2}[direction]
    return max(SPLIT_MIN_CTAS,
               -(-slabs * itemsize * n * hw * c // SPLIT_CTA_BYTES))


def split_limits(direction: str, itemsize: int = 4):
    """`(least, most, cluster)` of the split plan in `direction`: the least
    and the most bytes a row of a statistics chunk should take, and the
    largest cluster. Backward MIN_ROW_BYTES to SPLIT_WIDTH channels over
    up to SPLIT_MAX_CLUSTER CTAs; forward FWD_SPLIT_MIN_WIDTH channels to
    FWD_SPLIT_ROW_BYTES over up to MAX_CLUSTER."""
    if direction == "fwd":
        return (itemsize * FWD_SPLIT_MIN_WIDTH, FWD_SPLIT_ROW_BYTES,
                MAX_CLUSTER)
    return MIN_ROW_BYTES, itemsize * SPLIT_WIDTH, SPLIT_MAX_CLUSTER


@functools.lru_cache(maxsize=256)
def split_plan(direction: str, n: int, hw: int, c: int, num_groups: int = 32,
               itemsize: int = 4) -> SplitPlan:
    """The split route's statistics plan for `[n, hw, c]` in `direction`
    ("fwd" or "bwd"): the widest chunk whose rows are at most the most of
    `split_limits` (the narrowest chunk where a group is wider), then,
    while the pass has fewer CTAs than `split_target_ctas`, its rows split
    over a cluster twice as large (while each CTA keeps SPLIT_MIN_ROWS
    rows, up to the largest cluster of `split_limits`), else a narrower
    chunk whose rows are still the least of `split_limits` long. A shape
    with no width raises."""
    widths = split_widths(c, num_groups, itemsize)
    if not widths:
        raise ValueError(f"no split-route chunk of whole groups of "
                         f"{c // num_groups} channels is at most "
                         f"{SPLIT_MAX_WIDTH} channels and a multiple of "
                         f"{piece_channels(itemsize)}")
    least, most, largest = split_limits(direction, itemsize)
    wide = [w for w in widths if itemsize * w >= least] or widths[-1:]
    wide = [w for w in wide if itemsize * w <= most] or wide[:1]
    width, cl = wide[-1], 1
    target = split_target_ctas(direction, n, hw, c, itemsize)
    while n * (c // width) * cl < target:
        if cl < largest and -(-hw // (2 * cl)) >= SPLIT_MIN_ROWS:
            cl *= 2
        elif width != wide[0]:
            width = wide[wide.index(width) - 1]
        else:
            break
    return SplitPlan(width, cl)


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


def gn_preserve_dtype(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, num_groups: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with float32 statistics and the elementwise chain in
    `x.dtype` (no ReLU), as `dorpatch_tpu.ops.fused_gn.gn_preserve_dtype`:
    `(x - mean) * mul + bias` with mean, `mul = rstd * scale` and bias each
    rounded to `x.dtype`. The plain bf16 numerics of the JAX package's
    model code; the kernels normalize in float32 instead."""
    dt = x.dtype
    n, h, w, c = x.shape
    g, gs = num_groups, c // num_groups
    xg = x.reshape(n, h * w, g, gs)
    mean, rstd = gn_stats_reference(x, g, eps)
    mul = rstd[:, None, :, None] * scale.to(mean.dtype).reshape(1, 1, g, gs)
    y = (xg - mean[:, None, :, None].to(dt)) * mul.to(dt) \
        + bias.to(mean.dtype).reshape(1, 1, g, gs).to(dt)
    return y.reshape(n, h, w, c)


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
    _backend.require(x, "x", (torch.float32, torch.bfloat16), 4)
    _backend.require(scale, "scale", torch.float32, 1)
    _backend.require(bias, "bias", torch.float32, 1)
    c = x.shape[-1]
    if (c % num_groups or c % piece_channels(x.element_size())
            or tuple(scale.shape) != (c,)
            or tuple(bias.shape) != (c,) or scale.device != x.device
            or bias.device != x.device):
        raise ValueError(f"GroupNorm shapes do not agree: x {tuple(x.shape)}, "
                         f"scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)}, {num_groups} groups (C must "
                         "be a multiple of 4, 8 at bf16, and of the group "
                         "count)")
    if any(t.data_ptr() % 16 for t in (x, scale, bias)):
        raise ValueError("the GroupNorm kernels move 16 bytes a thread: x, "
                         "scale and bias must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _plan_of(direction: str, x: torch.Tensor, num_groups: int,
             plan: Optional[GNPlan]) -> GNPlan:
    """`plan`, or `gn_plan`'s for x at its element size; a split plan
    without a width takes `split_plan`'s chunk and cluster."""
    n, h, w, c = x.shape
    plan = plan or gn_plan(direction, n, h * w, c, num_groups,
                           x.element_size())
    if plan.route == "split" and not plan.width:
        plan = plan._replace(**split_plan(
            direction, n, h * w, c, num_groups, x.element_size())._asdict())
    return plan


def _entry(lib, direction: str, x: torch.Tensor):
    """The C entry point and launch-count name of x's type."""
    name = f"gn_relu_{direction}" + ("_bf16" if x.dtype == torch.bfloat16
                                     else "")
    return getattr(lib, "dp_" + name), name


def gn_relu_fwd_kernel(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, num_groups: int = 32,
                       eps: float = 1e-5, plan: Optional[GNPlan] = None):
    """The forward kernels on CUDA tensors: x `[N,H,W,C]` f32 or bf16,
    scale and bias f32 -> `(y [N,H,W,C] of x's type, mean [N,G] f32, rstd
    [N,G] f32)`. `plan` defaults to `gn_plan`'s (another is for measuring
    other chunks); a split plan's `width` and `cluster`, when not 0, are
    the statistics pass's chunk and cluster instead of `split_plan`'s."""
    _check(x, scale, bias, num_groups)
    n, h, w, c = x.shape
    plan = _plan_of("fwd", x, num_groups, plan)
    lib = _build.library()
    y = torch.empty_like(x)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    fn, name = _entry(lib, "fwd", x)
    _backend.count_launch(name, plan.route)
    _build.check(fn(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), n, h * w, c, num_groups,
        float(eps), int(plan.route == "split"), plan.width, plan.cluster,
        plan.smem,
        _backend.stream_handle(x)), name)
    return y, mean, rstd


def gn_relu_bwd_kernel(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, mean: torch.Tensor,
                       rstd: torch.Tensor, num_groups: int = 32,
                       params: bool = True, plan: Optional[GNPlan] = None):
    """The backward kernels on CUDA tensors -> `(dx, dscale, dbias)`: dx
    of x's type, `dscale`/`dbias` f32 and None unless `params`. `plan` as
    for the forward."""
    _check(x, scale, bias, num_groups)
    _backend.require(dy, "dy", x.dtype, 4)
    for t, name in ((mean, "mean"), (rstd, "rstd")):
        _backend.require(t, name, torch.float32, 2)
    n, h, w, c = x.shape
    if tuple(dy.shape) != tuple(x.shape) or dy.data_ptr() % 16 or \
            tuple(mean.shape) != (n, num_groups) or \
            tuple(rstd.shape) != (n, num_groups):
        raise ValueError(f"GroupNorm backward shapes do not agree: x "
                         f"{tuple(x.shape)}, dy {tuple(dy.shape)}, mean "
                         f"{tuple(mean.shape)}, rstd {tuple(rstd.shape)}")
    plan = _plan_of("bwd", x, num_groups, plan)
    split = plan.route == "split"
    lib = _build.library()
    dx = torch.empty_like(x)
    dbc = dsc = an = bn = None
    dscale: Optional[torch.Tensor] = None
    dbias: Optional[torch.Tensor] = None
    if split:
        an, bn = torch.empty_like(mean), torch.empty_like(mean)
    if params:
        dbc = torch.empty((n, c), dtype=torch.float32, device=x.device)
        dsc = torch.empty_like(dbc)
        dscale = torch.empty_like(scale)
        dbias = torch.empty_like(bias)
    fn, name = _entry(lib, "bwd", x)
    _backend.count_launch(name, plan.route)
    _build.check(fn(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), _ptr(dbc),
        _ptr(dsc), _ptr(an), _ptr(bn), _ptr(dscale), _ptr(dbias), n, h * w,
        c, num_groups, int(split), plan.width, plan.cluster, plan.smem,
        _backend.stream_handle(x)), name)
    return dx, dscale, dbias


class GNRelu(torch.autograd.Function):
    """The forward kernels, and the backward kernels for the gradient. The
    kernels take float32 affine parameters: bf16 ones are widened (exactly)
    for them, and their cotangents come back in the parameters' type."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        s32, b32 = scale.float().contiguous(), bias.float().contiguous()
        y, mean, rstd = gn_relu_fwd_kernel(x, s32, b32, num_groups, eps)
        ctx.save_for_backward(x, s32, b32, mean, rstd)
        ctx.num_groups = num_groups
        ctx.param_dtypes = (scale.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        params = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dscale, dbias = gn_relu_bwd_kernel(
            x, dy.contiguous(), scale, bias, mean, rstd, ctx.num_groups,
            params=params)
        if params:
            dscale = dscale.to(ctx.param_dtypes[0])
            dbias = dbias.to(ctx.param_dtypes[1])
        return dx, dscale, dbias, None, None


def gn_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(num_groups, eps)+ReLU on NHWC `x` with the `[C]` affine
    `scale`/`bias`; differentiable in all three. `x` float32 or bf16; the
    output and `dx` in `x.dtype`, the statistics in float32. A CUDA tensor
    runs the kernels; a CPU tensor runs the plain version."""
    if x.shape[-1] % num_groups:
        raise ValueError(f"C={x.shape[-1]} not divisible by {num_groups} "
                         "groups")
    if _backend.on_card(x):
        return GNRelu.apply(x.contiguous(), scale, bias, num_groups,
                            float(eps))
    return gn_relu_reference(x, scale, bias, num_groups, eps)
