"""The port's GroupNorm+ReLU (`dorpatch_tpu_torch.ops.fused_gn`) on the CPU:
the plain forward and backward against `dorpatch_tpu.ops.fused_gn` (the
Pallas kernels in interpret mode, whole-slab and HW-tiled, and the jnp
reference), and the dispatch rule. The CUDA kernels are held against these
plain versions on the card (`test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu.ops import fused_gn as jgn
from dorpatch_tpu_torch.gn_bench import rn50_gn_calls
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops import fused_gn as tgn

# float32 statistics and normalize in two frameworks, summed in their own
# orders
FWD_ATOL = 1e-5
# the backward's group sums, as tests/test_fused_gn.py holds the JAX kernel
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _case(seed, shape, groups=32):
    """x with a nonzero per-channel mean, the affine as the JAX tests draw
    it, and a cotangent."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + rng.normal(0, 0.5, c)).astype(np.float32)
    scale = (rng.uniform(0, 1, c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.uniform(0, 1, c) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(2, 4, 4, 64), (3, 7, 7, 128),
                                   (2, 2, 2, 256)])
@pytest.mark.parametrize("impl", ["interpret", "jnp"])
def test_plain_forward_matches_jax(shape, impl):
    x, scale, bias, _ = _case(sum(shape), shape)
    want = np.asarray(jgn.gn_relu(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), 32, impl=impl))
    got = tgn.gn_relu(_t(x), _t(scale), _t(bias), 32)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)
    np.testing.assert_array_equal(
        tgn.gn_relu_reference(_t(x), _t(scale), _t(bias)).numpy(),
        got.numpy())


def _jax_grads(x, scale, bias, dy, impl):
    def loss(a, s, b):
        return jnp.sum(jgn.gn_relu(a, s, b, 32, impl=impl) * jnp.asarray(dy))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))]


@pytest.mark.parametrize("shape", [(2, 4, 4, 64), (2, 3, 3, 128)])
def test_plain_backward_and_autograd_match_jax_kernel_grads(shape):
    """The written-out backward formula and autograd of the plain forward,
    both against `jax.grad` through the interpret kernel's custom VJP."""
    x, scale, bias, dy = _case(10 + shape[-1], shape)
    want = _jax_grads(x, scale, bias, dy, "interpret")
    mean, rstd = tgn.gn_stats_reference(_t(x), 32)
    formula = tgn.gn_relu_backward_reference(_t(x), _t(dy), _t(scale),
                                             _t(bias), mean, rstd, 32)
    xs, ss, bs = (_t(a).requires_grad_(True) for a in (x, scale, bias))
    auto = torch.autograd.grad(
        (tgn.gn_relu_reference(xs, ss, bs) * _t(dy)).sum(), (xs, ss, bs))
    for got in (formula, auto):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **BWD_TOL)


def test_plain_versions_match_the_jax_tiled_kernels():
    """A shape that the JAX package tiles (4 HW tiles of the two-pass
    forward and backward), in interpret mode."""
    shape = (2, 8, 8, 64)
    x, scale, bias, dy = _case(3, shape)
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    y, jmean, jrstd = jgn._pallas_fwd_tiled(jx, js, jb, 32, 1e-5, 4, True)
    mean, rstd = tgn.gn_stats_reference(_t(x), 32)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(
        tgn.gn_relu_reference(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(y), rtol=0, atol=FWD_ATOL)
    want = jgn._pallas_bwd_tiled(jx, jnp.asarray(dy), js, jb, jmean, jrstd,
                                 32, 4, True)
    got = tgn.gn_relu_backward_reference(_t(x), _t(dy), _t(scale), _t(bias),
                                         mean, rstd, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


def test_plain_bf16_versions_match_the_jax_tiled_kernels():
    """The function of the split route's bf16 kernels (E and G in bf16 on
    the card): the plain versions on bf16 x and dy with float32 affine
    parameters, against the JAX tiled kernels at bf16 in interpret mode (4
    HW tiles). The statistics of the same bf16 values as at float32; y
    (bf16 both) within the JAX tests' bf16 bar of the tiled forward (0.02),
    dx (bf16 both), dscale and dbias within their bar of the tiled
    backward (0.05)."""
    shape = (2, 8, 8, 64)
    x, scale, bias, dy = _case(3, shape)
    jx, jdy = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dy))
    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    tx, tdy = (_t(a).to(torch.bfloat16) for a in (x, dy))
    y, jmean, jrstd = jgn._pallas_fwd_tiled(jx, js, jb, 32, 1e-5, 4, True)
    assert y.dtype == jnp.bfloat16
    mean, rstd = tgn.gn_stats_reference(tx, 32)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0],
                               rtol=1e-5, atol=0)
    ty = tgn.gn_relu_reference(tx, _t(scale), _t(bias))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(y, np.float32), rtol=0, atol=0.02)
    want = jgn._pallas_bwd_tiled(jx, jdy, js, jb, jmean, jrstd, 32, 4, True)
    got = tgn.gn_relu_backward_reference(tx, tdy, _t(scale), _t(bias),
                                         mean, rstd, 32)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=0.05,
                                   rtol=0.05)


def test_float64_plain_versions_agree_with_float32():
    """The card checks hold the kernels against the plain versions in
    float64; those compute in float64 and agree with the float32 ones."""
    x, scale, bias, dy = _case(4, (2, 4, 4, 64))
    y32 = tgn.gn_relu_reference(_t(x), _t(scale), _t(bias))
    y64 = tgn.gn_relu_reference(_t(x).double(), _t(scale).double(),
                                _t(bias).double())
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), rtol=0,
                               atol=FWD_ATOL)
    m64, r64 = tgn.gn_stats_reference(_t(x).double(), 32)
    assert m64.dtype == torch.float64
    g64 = tgn.gn_relu_backward_reference(_t(x).double(), _t(dy).double(),
                                         _t(scale).double(),
                                         _t(bias).double(), m64, r64, 32)
    m32, r32 = tgn.gn_stats_reference(_t(x), 32)
    g32 = tgn.gn_relu_backward_reference(_t(x), _t(dy), _t(scale),
                                         _t(bias), m32, r32, 32)
    for a, b in zip(g32, g64):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), **BWD_TOL)


def test_gate_flip_bounds_cover_flipped_gates():
    """The bias enters the backward only through the ReLU gate, so a bias
    shifted by just under `near` flips every gate within `near` of 0 one way;
    the moves of dx (elsewhere), dscale and dbias stay inside the bounds the
    card checks allow for such flips."""
    near = 0.05
    x, scale, bias, dy = (_t(a).double() for a in _case(7, (2, 6, 6, 64)))
    mean, rstd = tgn.gn_stats_reference(x, 32)
    near_zero, dx_b, ds_b, db_b = tgn.gate_flip_bounds(x, dy, scale, bias,
                                                       mean, rstd, 32, near)
    assert 0 < int(near_zero.sum()) < near_zero.numel()
    base = tgn.gn_relu_backward_reference(x, dy, scale, bias, mean, rstd, 32)
    for shift in (0.999 * near, -0.999 * near):
        alt = tgn.gn_relu_backward_reference(x, dy, scale, bias + shift, mean,
                                             rstd, 32)
        moved = (alt[0] - base[0]).abs()
        assert moved.max() > 0
        assert (moved[~near_zero] <= dx_b[~near_zero] + 1e-12).all()
        assert ((alt[1] - base[1]).abs() <= ds_b + 1e-12).all()
        assert ((alt[2] - base[2]).abs() <= db_b + 1e-12).all()


def test_cpu_tensor_takes_the_plain_version_without_launching():
    x, scale, bias, _ = _case(5, (2, 4, 4, 64))
    _backend.reset_launch_counts()
    tgn.gn_relu(_t(x), _t(scale), _t(bias))
    counts = _backend.launch_counts()
    assert counts["gn_relu_fwd"] == counts["gn_relu_bwd"] == 0
    with pytest.raises(ValueError, match="not divisible"):
        tgn.gn_relu(torch.zeros(1, 2, 2, 48), torch.ones(48),
                    torch.zeros(48))


def test_kernel_wrappers_refuse_cpu_tensors():
    x, scale, bias, dy = (_t(a) for a in _case(6, (1, 2, 2, 64)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgn.gn_relu_fwd_kernel(x, scale, bias)
    mean, rstd = tgn.gn_stats_reference(x, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgn.gn_relu_bwd_kernel(x, dy, scale, bias, mean, rstd)


#: (HW, C) -> calls per forward of ResNetV2-50x1 at 224 px, from its layout
#: (3, 4, 6, 3 bottlenecks of widths 64-512, a 64-wide stem): in each
#: bottleneck norm1 on its input, norm2 after the 1x1 conv and norm3 after
#: the 3x3 conv (stride 2 in the first bottleneck of stages 2-4), and the
#: final norm
RN50_224_LAYOUT = {(3136, 64): 7, (3136, 256): 3, (3136, 128): 1,
                   (784, 128): 7, (784, 512): 4, (784, 256): 1,
                   (196, 256): 11, (196, 1024): 6, (196, 512): 1,
                   (49, 512): 5, (49, 2048): 3}


def test_rn50_gn_shape_table_matches_the_victim():
    """`gn_bench.rn50_gn_calls(224)`, the (HW, C) shapes and calls per
    forward that `gn_bench.py` and `chip_smoke.py` time, counted on the
    victim's module, is ResNetV2-50x1's layout at 224."""
    seen = rn50_gn_calls(224)
    assert seen == RN50_224_LAYOUT
    assert sum(seen.values()) == 49


def test_rn50_gn_shape_table_at_480_matches_the_victim():
    """`gn_bench.rn50_gn_calls(480)`, the table `gn_bench.py --img-size 480`
    times, is the layout at BiT's 480 px fine-tuning resolution: the stem
    and pool take 480 to 120, so the stages run at 14400, 3600, 900 and
    225 rows where 224 has 3136, 784, 196 and 49, at the same widths and
    calls."""
    rows = {3136: 14400, 784: 3600, 196: 900, 49: 225}
    assert rn50_gn_calls(480) == {(rows[hw], c): n
                                  for (hw, c), n in RN50_224_LAYOUT.items()}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hw,c", sorted(rn50_gn_calls(480)))
def test_rn50_480_shapes_take_split_backward_at_stage_1(hw, c, itemsize):
    """ResNetV2-50x1 at 480 px at the attack step's N = 128 (1 image x 128
    masks), in float32 and bf16: every forward takes the one-pass route
    (stage 1's 14400 rows over clusters of 8 CTAs); the backward of the
    three stage-1 shapes, 11 of the 49 calls, takes the split route (its
    one-group chunk of x and dy fits no cluster), every other backward the
    one-pass route. The plan does not depend on N."""
    fwd = tgn.gn_plan("fwd", 128, hw, c, 32, itemsize)
    bwd = tgn.gn_plan("bwd", 128, hw, c, 32, itemsize)
    assert fwd.route == "one_pass"
    if hw == 14400:
        assert fwd.cluster == tgn.MAX_CLUSTER
        assert bwd == tgn.GNPlan("split", 0, 0, 0)
    else:
        assert bwd.route == "one_pass"
    assert (fwd, bwd) == tuple(tgn.gn_plan(d, 1, hw, c, 32, itemsize)
                               for d in ("fwd", "bwd"))
    calls = rn50_gn_calls(480)
    assert sum(n for (h, _), n in calls.items() if h == 14400) == 11


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("hw,c", sorted(rn50_gn_calls(224)))
def test_every_rn50_shape_takes_the_one_pass_route(direction, hw, c):
    """Every RN50 GroupNorm at 224 runs in one pass: whole groups of 32,
    16-byte pieces, rows of at least 32 bytes, within a block's shared
    memory; the backward's CTA leaves room for two CTAs an SM."""
    from dorpatch_tpu_torch.ops import _build

    plan = tgn.gn_plan(direction, 256, hw, c)
    slabs = 1 if direction == "fwd" else 2
    assert plan.route == "one_pass"
    assert plan.width % (c // 32) == 0 and plan.width % 4 == 0
    assert c % plan.width == 0 and 4 * plan.width >= tgn.MIN_ROW_BYTES
    assert plan.smem == tgn.one_pass_smem(hw, plan.width, plan.cluster,
                                          slabs)
    assert plan.smem <= _build.MAX_SMEM_BYTES
    assert 1 <= plan.cluster <= tgn.MAX_CLUSTER
    if direction == "bwd":
        assert plan.smem <= tgn.TWO_PER_SM_BYTES
    # the plan does not depend on the batch
    assert tgn.gn_plan(direction, 3, hw, c) == plan


def test_one_pass_smem_counts_the_carve():
    """[3136, 256] with chunks of one group (8 channels): 3136 rows x 32
    bytes per slab, 256 threads x two float4 partials, 2 x 8 float64
    channel sums of the CTA and of the chunk, 2 x 8 float per-group
    values."""
    assert tgn.one_pass_smem(3136, 8, 1, 1) == 3136 * 32 + 8192 + 320
    assert tgn.one_pass_smem(3136, 8, 1, 2) == 2 * 3136 * 32 + 8192 + 320
    assert tgn.one_pass_smem(3136, 8, 2, 2) == 3136 * 32 + 8192 + 320
    assert tgn.one_pass_smem(3137, 8, 2, 1) == 1569 * 32 + 8192 + 320


@pytest.mark.parametrize("c,groups,width", [(64, 32, 16), (96, 32, 24),
                                            (2048, 32, 64), (8, 8, 8),
                                            (4, 1, 4)])
def test_one_pass_width_takes_whole_groups_of_at_least_64_bytes(c, groups,
                                                                 width):
    """C = 64 has 2 channels a group, so a chunk takes 8 groups; C = 96 has
    3, so chunks are multiples of 12 (16-byte pieces), 24 for 64 bytes;
    C = 8 and C = 4 have no 64-byte row and take all their channels. A tall
    slab keeps the narrowest width."""
    assert tgn.one_pass_width(4096, c, groups, 1,
                              tgn.TWO_PER_SM_BYTES) == width
    assert all(w % (c // groups) == 0 and w % 4 == 0
               for w in tgn.one_pass_widths(c, groups))


def test_a_short_slab_widens_its_chunk():
    """At 7x7 a group's slab is 12.5 KB: the chunk takes whole groups until
    its stage holds MIN_STAGE_BYTES; at 14x14 and 28x28 until its rows are
    TARGET_ROW_BYTES long."""
    plan = tgn.gn_plan("fwd", 256, 49, 2048)
    assert plan.width == 128 and plan.cluster == 1
    assert 4 * 49 * plan.width >= tgn.MIN_STAGE_BYTES
    for hw in (196, 784):
        plan = tgn.gn_plan("fwd", 256, hw, 256)
        assert 4 * plan.width == tgn.TARGET_ROW_BYTES


@pytest.mark.parametrize("hw,fwd,bwd", [(4096, 2, 8), (12544, 4, 8),
                                        (3136, 1, 4)])
def test_tall_chunks_split_their_rows_over_a_cluster(hw, fwd, bwd):
    assert tgn.gn_plan("fwd", 1, hw, 256).cluster == fwd
    assert tgn.gn_plan("bwd", 1, hw, 256).cluster == bwd


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_an_oversize_slab_takes_the_split_route(direction):
    """256*256 rows of one-group chunks exceed eight CTAs' shared memory;
    the split route takes them."""
    assert tgn.gn_plan(direction, 1, 256 * 256, 64) == \
        tgn.GNPlan("split", 0, 0, 0)


@pytest.mark.parametrize("n,hw,c", [(1, 65536, 32 * 264), (65536, 49, 64),
                                    (1, 49, 48), (1, 49, 66)])
def test_a_shape_no_route_takes_raises(n, hw, c):
    """Groups of 264 channels: too tall a chunk for any cluster and wider
    than a split-route chunk; too many samples for the grid; C not a
    multiple of the 32 groups or of 4."""
    for direction in ("fwd", "bwd"):
        with pytest.raises(ValueError):
            tgn.gn_plan(direction, n, hw, c)


SPLIT_PLAN_SHAPES = [(128, 14400, 64), (128, 14400, 128), (128, 14400, 256),
                     (4, 65536, 64), (1, 65536, 64), (2, 81, 64), (2, 25, 96),
                     (2, 64, 1024), (1, 49, 256), (65535, 49, 64)]


def _split_plan_keeps_its_limits(direction, n, hw, c, itemsize):
    plan = tgn.split_plan(direction, n, hw, c, 32, itemsize)
    cg, p = c // 32, 16 // itemsize
    w, cl = plan
    widths = tgn.split_widths(c, 32, itemsize)
    least, most, largest = tgn.split_limits(direction, itemsize)
    assert w % cg == 0 and w % p == 0 and c % w == 0
    assert w <= tgn.SPLIT_MAX_WIDTH and w in widths
    assert itemsize * w <= most or w == widths[0]
    if any(itemsize * v >= least for v in widths):
        assert itemsize * w >= least
    assert cl in (1, 2, 4, 8, 16) and cl <= largest <= tgn.SPLIT_MAX_CLUSTER
    assert cl == 1 or -(-hw // cl) >= tgn.SPLIT_MIN_ROWS
    slabs = {"fwd": 1, "bwd": 2}[direction]
    target = tgn.split_target_ctas(direction, n, hw, c, itemsize)
    assert target >= tgn.SPLIT_MIN_CTAS
    assert target * tgn.SPLIT_CTA_BYTES >= slabs * itemsize * n * hw * c
    if n * (c // w) * cl < target:
        narrower = [v for v in widths if v < w and itemsize * v >= least]
        assert not narrower
        assert cl == largest or -(-hw // (2 * cl)) < tgn.SPLIT_MIN_ROWS


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,hw,c", SPLIT_PLAN_SHAPES)
def test_bwd_split_plan_keeps_its_limits(n, hw, c, itemsize):
    """The backward split route's statistics plan: whole groups, 16-byte
    pieces, at most SPLIT_WIDTH channels (SPLIT_MAX_WIDTH where a group is
    wider) dividing C, rows of at least MIN_ROW_BYTES where C allows
    (`split_limits`);
    clusters a power of two up to SPLIT_MAX_CLUSTER whose CTAs keep
    SPLIT_MIN_ROWS rows; and fewer CTAs than `split_target_ctas` only
    where neither a larger cluster nor a narrower chunk is left."""
    _split_plan_keeps_its_limits("bwd", n, hw, c, itemsize)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,hw,c", SPLIT_PLAN_SHAPES)
def test_fwd_split_plan_keeps_its_limits(n, hw, c, itemsize):
    """The forward split route's plan (kernel E) keeps the backward's
    limits with its own (`split_limits`): rows of FWD_SPLIT_ROW_BYTES at
    most and FWD_SPLIT_MIN_WIDTH channels at least where C allows,
    clusters of at most MAX_CLUSTER (the portable size), its CTAs sized by
    the bytes of x alone."""
    assert tgn.split_limits("fwd", itemsize) == (
        itemsize * tgn.FWD_SPLIT_MIN_WIDTH, tgn.FWD_SPLIT_ROW_BYTES,
        tgn.MAX_CLUSTER)
    _split_plan_keeps_its_limits("fwd", n, hw, c, itemsize)


def test_fwd_split_plan_at_the_measured_shapes():
    """The [4, 65536, 64] slab takes chunks of 32 channels over 8 clusters
    of 8 in both types, one wave (the fastest plans of `gn_bench.py --split
    --sweep`); RN50's 480 px stage-1 shapes (which kernel D takes) the
    widest chunk of at most 512-byte rows over clusters of 2, as many CTAs
    as at least 256 and 4 MiB of x a CTA need. A channel count of no
    whole-group chunk raises."""
    assert tgn.split_plan("fwd", 4, 65536, 64) == tgn.SplitPlan(32, 8)
    assert tgn.split_plan("fwd", 4, 65536, 64, 32, 2) == tgn.SplitPlan(32, 8)
    for c, f32, bf16 in ((64, 64, 64), (128, 128, 128), (256, 128, 256)):
        assert tgn.split_plan("fwd", 128, 14400, c) == tgn.SplitPlan(f32, 2)
        assert tgn.split_plan("fwd", 128, 14400, c, 32, 2) == \
            tgn.SplitPlan(bf16, 2)
    with pytest.raises(ValueError):
        tgn.split_plan("fwd", 1, 49, 32 * 264)


def test_bwd_split_plan_at_the_measured_shapes():
    """RN50's 480 px stage-1 slabs take chunks of 64 channels over clusters
    that leave each CTA at most 4 MiB of x and dy (at least 256 CTAs): at
    float32 clusters of 2; at bf16 of 2 at C 64, of 1 at C 128 and 256. The [4, 65536, 64] slab fills the card
    with clusters of 16 and narrower chunks: 16 channels (64-byte rows) at
    float32, 32 at bf16. A channel count of no whole-group chunk of at most
    SPLIT_MAX_WIDTH channels raises."""
    for c, f32, bf16 in ((64, 2, 2), (128, 2, 1), (256, 2, 1)):
        assert tgn.split_plan("bwd", 128, 14400, c) == tgn.SplitPlan(64, f32)
        assert tgn.split_plan("bwd", 128, 14400, c, 32, 2) == \
            tgn.SplitPlan(64, bf16)
    assert tgn.split_plan("bwd", 4, 65536, 64) == tgn.SplitPlan(16, 16)
    assert tgn.split_plan("bwd", 4, 65536, 64, 32, 2) == tgn.SplitPlan(32, 16)
    with pytest.raises(ValueError):
        tgn.split_plan("bwd", 1, 49, 32 * 264)


def test_route_counts_reset_with_the_launch_counts():
    _backend.reset_launch_counts()
    _backend.count_launch("gn_relu_fwd", "one_pass")
    _backend.count_launch("gn_relu_bwd", "split")
    assert _backend.route_counts() == {"gn_relu_fwd/one_pass": 1,
                                       "gn_relu_bwd/split": 1}
    assert _backend.launch_counts()["gn_relu_fwd"] == 1
    _backend.reset_launch_counts()
    assert _backend.route_counts() == {}
    x, scale, bias, _ = _case(8, (2, 4, 4, 64))
    tgn.gn_relu(_t(x), _t(scale), _t(bias))
    assert _backend.route_counts() == {}
