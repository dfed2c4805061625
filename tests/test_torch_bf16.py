"""The port's bf16 paths on the CPU against `dorpatch_tpu`: the mixed-precision
attack (`AttackConfig.compute_dtype`, `--compute-dtype`) and the bf16 certify
bank (`DefenseConfig.compute_dtype`, `--certify-dtype`).

The plain bf16 versions of kernels A, C, D/F and H against the JAX functions
at the JAX tests' own tolerances, the bf16 model pieces (GroupNorm8,
GroupNormRelu, LayerNorm) with their float32 forms unchanged, the bank's
verdicts against `dorpatch_tpu.defense`, the bf16 attack step and the CLI.
The CUDA forms are held against these plain versions on the card
(`test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dorpatch_tpu import defense as jdef
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.config import DefenseConfig as JaxDefenseConfig
from dorpatch_tpu.ops import fused_gn as jgn
from dorpatch_tpu.ops.masked_fill import masked_fill as jax_masked_fill
from dorpatch_tpu.ops import masked_kv_attn as jkv
from dorpatch_tpu.ops import stem_fold as jsf
from dorpatch_tpu_torch import defense as tdef
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch import utils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import AttackConfig, DefenseConfig
from dorpatch_tpu_torch.gn_bench import rn50_gn_calls
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops import fused_gn as tgn
from dorpatch_tpu_torch.ops import masked_fill as tfill
from dorpatch_tpu_torch.ops import masked_kv_attn as tkv
from dorpatch_tpu_torch.ops import stem_fold as tsf

BF = torch.bfloat16


def _j16(a):
    """A float32 numpy array as a JAX bf16 array."""
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _t16(a):
    """A float32 numpy array as a torch bf16 tensor (the same rounding)."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(BF)


def _np(x):
    """A bf16 (or float32) array of either framework as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulp16(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


# ------------------------------------------------------------- kernel A


@pytest.mark.parametrize("b,size,s,k", [(2, 32, 16, 2), (1, 15, 7, 3),
                                        (2, 16, 40, 1)])
def test_fill_bf16_equals_jax_interpret_exactly(b, size, s, k):
    """Kernel A's plain version on bf16 images is an exact select in bf16,
    bit-equal to the JAX kernel in interpret mode on the same bf16 images."""
    rng = np.random.default_rng(size + s)
    universe = tmasks.dropout_universe(size, 1 if k == 1 else 2)
    rects = tmasks.pad_rects(
        universe[rng.choice(len(universe), s, replace=False)], k)
    imgs = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    want = jax_masked_fill(_j16(imgs), jnp.asarray(rects), 0.5,
                           use_pallas="interpret")
    _backend.reset_launch_counts()
    got = tfill.masked_fill(_t16(imgs), rects, 0.5)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert sum(_backend.launch_counts().values()) == 0
    np.testing.assert_array_equal(_np(got), _np(want))


# ------------------------------------------------------------ kernels D/F


def _gn_case(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + rng.normal(0, 0.5, c)).astype(np.float32)
    scale = (rng.uniform(0, 1, c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.uniform(0, 1, c) * 0.1).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, w


@pytest.mark.parametrize("shape", [(2, 6, 5, 64), (2, 4, 4, 256)])
def test_gn_relu_bf16_plain_matches_jax_interpret(shape):
    """D/F's plain versions at bf16 against `gn_relu(impl="interpret")` at
    bf16: output in bf16 within atol 0.02, the input cotangent bf16 within
    0.05 (`tests/test_fused_gn.py`'s bars), on float32 affine parameters."""
    x, scale, bias, w = _gn_case(sum(shape), shape)
    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    want = jgn.gn_relu(_j16(x), js, jb, 32, impl="interpret")
    got = tgn.gn_relu(_t16(x), torch.as_tensor(scale), torch.as_tensor(bias))
    assert got.dtype == BF
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=0.02)

    jw = jnp.asarray(w)
    jdx = jax.grad(lambda a: jnp.sum(
        jgn.gn_relu(a, js, jb, 32, impl="interpret").astype(jnp.float32)
        * jw))(_j16(x))
    xt = _t16(x).requires_grad_(True)
    (tdx,) = torch.autograd.grad(
        (tgn.gn_relu(xt, torch.as_tensor(scale), torch.as_tensor(bias))
         .float() * torch.as_tensor(w)).sum(), xt)
    assert tdx.dtype == BF and jdx.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=0, atol=0.05)


def test_gn_relu_bf16_backward_reference_matches_jax_kernel():
    """The plain backward written out (the kernels' formula) on bf16 x and
    dy against the JAX kernel's VJP: dx in bf16 within 0.05, the parameter
    cotangents in the parameters' type (bf16 here) within a bf16 ulp of
    their size."""
    shape = (2, 5, 5, 64)
    x, scale, bias, w = _gn_case(7, shape)
    xs, ss, bs = _j16(x), _j16(scale), _j16(bias)
    _, vjp = jax.vjp(lambda a, s, b: jgn.gn_relu(a, s, b, 32,
                                                 impl="interpret"),
                     xs, ss, bs)
    jdx, jds, jdb = vjp(_j16(w))
    xt, st, bt = _t16(x), _t16(scale), _t16(bias)
    mean, rstd = tgn.gn_stats_reference(xt, 32)
    tdx, tds, tdb = tgn.gn_relu_backward_reference(
        xt, _t16(w), st, bt, mean, rstd, 32)
    assert (tdx.dtype, tds.dtype, jds.dtype) == (BF, BF, jnp.bfloat16)
    np.testing.assert_allclose(_np(tdx), _np(jdx), rtol=0, atol=0.05)
    for got, want in ((tds, jds), (tdb, jdb)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7,
                                   atol=0.05)


@pytest.mark.parametrize("hw,c", sorted(rn50_gn_calls(224)))
def test_gn_plan_bf16_takes_the_one_pass_route_at_every_rn50_shape(hw, c):
    """Every bf16 GroupNorm of ResNetV2-50x1 at 224 takes the one-pass
    route at the attack step's N = 256 and at the bank's chunks (the split
    route has no bf16 form): chunks of whole groups in 16-byte pieces of 8
    values, a bf16 chunk reckoned at 2 bytes an element (rows of 64 bytes
    or more, twice the float32 chunk's channels), shared memory as the
    kernels carve it, and the backward on one wide CTA an SM."""
    for n in (256, 2 * 63, 8):
        for direction, slabs in (("fwd", 1), ("bwd", 2)):
            plan = tgn.gn_plan(direction, n, hw, c, 32, 2)
            f32 = tgn.gn_plan(direction, n, hw, c)
            assert plan.route == "one_pass"
            assert plan.width % 8 == 0 and plan.width % (c // 32) == 0
            assert 2 * plan.width >= tgn.MIN_ROW_BYTES
            assert plan.width >= 2 * f32.width or plan.width == c
            assert plan.smem == tgn.one_pass_smem(hw, plan.width,
                                                  plan.cluster, slabs, 2)
            assert plan.smem <= tgn.PREFERRED_CTA_BYTES[direction, 2]
    assert tgn.one_pass_smem(3136, 32, 2, 2, 2) == \
        1568 * 32 * 2 * 2 + 64 * 256 + 40 * 32


def test_gn_bf16_split_shape_plans_split_with_float32_scratch():
    """A bf16 slab whose chunk fits no cluster plans the split route (the
    bf16 forms of kernels E and G on the card), with no partial-sum scratch
    since the statistics passes add their sums up over clusters: the
    forward over chunks of 32 channels in both types over clusters of 8,
    the backward over chunks of 32 channels (64-byte rows; 16 at float32)
    over clusters of 16; a CPU tensor of that shape runs the plain version
    and launches nothing."""
    x = torch.zeros((1, 256, 256, 64), dtype=BF)
    for direction, w16, w32, cl in (("fwd", 32, 32, 8), ("bwd", 32, 16, 16)):
        assert tgn._plan_of(direction, x, 32, None) == \
            tgn.GNPlan("split", w16, cl, 0)
        assert tgn._plan_of(direction, x.float(), 32, None) == \
            tgn.GNPlan("split", w32, cl, 0)
    assert not hasattr(tgn, "split_scratch")
    xs, scale, bias, _ = _gn_case(4, (1, 256, 256, 64))
    _backend.reset_launch_counts()
    y = tgn.gn_relu(_t16(xs), torch.as_tensor(scale), torch.as_tensor(bias))
    assert y.dtype == BF and y.shape == x.shape
    assert not any(_backend.launch_counts().values())
    assert _backend.route_counts() == {}
    want = tgn.gn_relu_reference(_t16(xs), torch.as_tensor(scale),
                                 torch.as_tensor(bias))
    assert torch.equal(y, want)


@pytest.mark.parametrize("groups,eps", [(32, 1e-5), (8, 1e-6)])
def test_gn_preserve_dtype_matches_jax(groups, eps):
    """float32 statistics, the normalize chain in bf16: one bf16 ulp of the
    output apart at most (the two frameworks sum the statistics in their
    own orders)."""
    x, scale, bias, _ = _gn_case(3, (2, 5, 4, 64))
    want = jgn.gn_preserve_dtype(_j16(x), jnp.asarray(scale),
                                 jnp.asarray(bias), groups, eps)
    got = tgn.gn_preserve_dtype(_t16(x), torch.as_tensor(scale),
                                torch.as_tensor(bias), groups, eps)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    err = np.abs(_np(got) - _np(want))
    assert (err <= _ulp16(_np(want))).all(), err.max()


# ------------------------------------------------------------- kernel C


@pytest.mark.parametrize("k,s,pad", [(3, 1, ((1, 1), (1, 1))), (5, 2, "same"),
                                     (7, 2, "same")])
def test_stem_fold_bf16_plain_matches_jax(k, s, pad):
    """Kernel C's plain version on bf16 operands against the JAX fold on
    the same bf16 operands (both accumulate the delta in float32 and round
    it, then the sum, to bf16: within one ulp of the output and one of the
    delta), and against the float32 fold at `test_kernel_tier.py`'s bar
    (atol 0.5, rtol 0.1)."""
    img = 24
    if pad == "same":
        pad = (tsf.same_pads(img, k, s), tsf.same_pads(img, k, s))
    rects = tmasks.mask_sets(tmasks.geometry(img, 0.12))[0][:6]
    plan = tsf.plan_windows(rects, img, k, s, pad)
    jplan = jsf.plan_windows(rects, img, k, s, pad)
    h = (img + sum(pad[0]) - k) // s + 1
    rng = np.random.default_rng(k)
    kern = rng.normal(0, 0.3, (k, k, 3, 8)).astype(np.float32)
    clean = rng.standard_normal((2, h, h, 8)).astype(np.float32)
    u = rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32)
    want = jsf.fold_masked_stem(_j16(kern), _j16(clean), _j16(u), jplan,
                                (s, s), pad)
    got = tsf.fold_masked_stem(_t16(kern), _t16(clean), _t16(u), plan,
                               (s, s), pad)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    delta = _np(want) - _np(_t16(clean))[:, None]
    err = np.abs(_np(got) - _np(want))
    assert (err <= _ulp16(_np(want)) + _ulp16(delta)).all(), err.max()
    ref32 = jsf.fold_masked_stem(jnp.asarray(kern), jnp.asarray(clean),
                                 jnp.asarray(u), jplan, (s, s), pad)
    np.testing.assert_allclose(_np(got), np.asarray(ref32), atol=0.5,
                               rtol=0.1)


def test_stem_family_bf16_runs_the_cast_victim_and_reads_f32_margins():
    """The stem engine's bf16 families: phase 1 on the engine's bf16 copy
    of the victim (made once, shared by every family), float32 margins,
    predictions equal to the bf16 full forwards wherever both margins are
    clear of the bf16 rounding; the victim itself stays float32."""
    from dorpatch_tpu_torch.models import get_model

    victim = get_model("cifar10", "resnet18", "/nonexistent", 16,
                       device="cpu")
    singles, _ = tmasks.mask_sets(tmasks.geometry(16, 0.12))
    fam = victim.incremental.build_family(singles, len(singles), 64, 0.5,
                                          compute_dtype="bfloat16")
    assert fam.engine is victim.incremental.at(BF)
    assert fam.engine.module is victim.incremental.build_family(
        singles, len(singles), 64, 0.5, "bfloat16").engine.module
    assert next(fam.engine.module.parameters()).dtype == BF
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    p, m = fam.phase1(x)
    assert m.dtype == torch.float32 and p.shape == (2, len(singles))
    xm = tfill.masked_fill(x.to(BF), singles, 0.5).reshape(-1, 16, 16, 3)
    pf, mf = utils.preds_margins(victim.apply.at(BF)(xm))
    sure = torch.minimum(m.reshape(-1), mf) > 0.25
    assert torch.equal(p.reshape(-1)[sure], pf[sure])
    assert next(victim.model.parameters()).dtype == torch.float32


# ------------------------------------------------------------- kernel H


@pytest.mark.parametrize("shape,seed,scaled", [
    ((2, 3, 4, 2, 8, 9), 3, False), ((1, 2, 4, 1, 128, 17), 5, False),
    ((2, 3, 17, 4, 64, 65), 7, True)])
def test_masked_kv_attention_bf16_plain_within_jax_bar(shape, seed, scaled):
    """H's plain version on bf16 q/k/v against the JAX float32 reference on
    the float32 inputs: within 0.06 (`test_kernel_tier.py`'s bar, at its
    two shapes and unscaled queries, and at a token engine's head width
    with its queries scaled by 1/sqrt(f)); and against the JAX kernel
    (interpret mode) on the same bf16 inputs, which also computes in
    float32 and rounds the output once: one bf16 ulp."""
    b, c, s, h, f, t = shape
    rng = np.random.default_rng(seed)
    q, kd, vd = (rng.standard_normal((b, c, s, h, f)).astype(np.float32)
                 for _ in range(3))
    if scaled:
        q = q / np.float32(np.sqrt(f))
    kc, vc = (rng.standard_normal((b, t, h, f)).astype(np.float32)
              for _ in range(2))
    cb = np.where(rng.uniform(size=(b, c, t)) < 0.2, -1e9, 0.0)
    db = np.where(rng.uniform(size=(b, c, s)) < 0.25, -1e9, 0.0)
    db[:, :, 0] = 0.0
    args = [a.astype(np.float32) for a in (q, kd, vd, kc, vc, cb, db)]
    ref = np.asarray(jkv.masked_kv_attention_reference(
        *(jnp.asarray(a) for a in args)))
    got = tkv.masked_kv_attention(*(_t16(a) for a in args))
    assert got.dtype == BF
    assert float(np.abs(_np(got) - ref).max()) <= 0.06
    jk = jkv.masked_kv_attention(*(_j16(a) for a in args), interpret=True)
    err = np.abs(_np(got) - _np(jk))
    assert (err <= _ulp16(_np(jk))).all(), err.max()


@pytest.mark.parametrize("shape,seed", [((1, 2, 99, 2, 64, 197), 9),
                                        ((2, 3, 17, 2, 32, 65), 11)])
def test_masked_kv_attention_bf16_plain_within_jax_bar_at_engine_shapes(
        shape, seed):
    """H's plain version on bf16 inputs at the ViT-B/16 pair audit's S 99
    and T 197, and at `cifar_vit`'s head width 32, queries scaled: within
    0.06 of the JAX float32 reference, and of the JAX kernel (interpret
    mode) on the same bf16 inputs within one bf16 ulp plus what float32
    rounding of the T+S-term weighted sums, taken in other orders, can
    move an output: (T+S) 2^-24 max|v| (at S 99 an output of 5e-7 left by
    cancellation sits 5.6e-8 from the JAX kernel's, 15 of its ulps)."""
    b, c, s, h, f, t = shape
    rng = np.random.default_rng(seed)
    q, kd, vd = (rng.standard_normal((b, c, s, h, f)).astype(np.float32)
                 for _ in range(3))
    q = q / np.float32(np.sqrt(f))
    kc, vc = (rng.standard_normal((b, t, h, f)).astype(np.float32)
              for _ in range(2))
    cb = np.where(rng.uniform(size=(b, c, t)) < 0.2, -1e9, 0.0)
    db = np.where(rng.uniform(size=(b, c, s)) < 0.25, -1e9, 0.0)
    db[:, :, 0] = 0.0
    args = [a.astype(np.float32) for a in (q, kd, vd, kc, vc, cb, db)]
    ref = np.asarray(jkv.masked_kv_attention_reference(
        *(jnp.asarray(a) for a in args)))
    t16 = [_t16(a) for a in args]
    got = tkv.masked_kv_attention(*t16)
    assert got.dtype == BF
    assert float(np.abs(_np(got) - ref).max()) <= 0.06
    jk = jkv.masked_kv_attention(*(_j16(a) for a in args), interpret=True)
    vmax = max(float(t16[2].float().abs().max()),
               float(t16[4].float().abs().max()))
    err = np.abs(_np(got) - _np(jk))
    assert (err <= _ulp16(_np(jk)) + (t + s) * 2.0 ** -24 * vmax).all(), \
        err.max()


@pytest.mark.parametrize("b,c,s,h,t,f", [
    (2, 36, 50, 12, 197, 64), (2, 64, 99, 12, 197, 64), (3, 4, 17, 4, 65, 32),
    (2, 13, 1, 3, 197, 64), (2, 64, 196, 12, 197, 64), (1, 3, 20, 2, 257, 64),
    (1, 1, 1, 1, 1, 32), (2, 64, 170, 12, 785, 64), (1, 3, 20, 2, 1000, 64)])
def test_masked_kv_attention_bf16_plan_keeps_its_limits(b, c, s, h, t, f):
    """H-bf16's plan: a block's shared memory is the carve of its clean
    group and its dirty slots (two where it has two phases or more, else
    one), with their entries' float32 biases padded to 32-key steps, and
    fits a block; a phase gives each warp one 16-row item where
    ceil(S/16) <= 8; at most 8 warps and C entries; at ViT-B/16's phase-1
    and pair-audit chunks two blocks fit an SM."""
    plan = tkv.bf16_plan(b, c, s, h, t, f, 132)
    g, e, warps, clean, smem = plan
    tiles = -(-s // tkv.ITEM_ROWS)
    slots = min(tkv.MAX_SLOTS, -(-g // e))
    assert 1 <= e <= g <= c
    assert smem == tkv.bf16_smem(t, s, f, e, slots, clean) <= 232448
    assert smem == (2 * f * (2 * t * clean + 2 * slots * e * s)
                    + 4 * slots * e * (-(-t // 32) * 32 + -(-s // 32) * 32))
    # the clean group is staged wherever one entry's carve with it fits
    assert clean == (tkv.bf16_smem(t, s, f, 1, 1) <= 232448)
    assert 1 <= warps <= tkv.MAX_WARPS
    if tiles <= tkv.MAX_WARPS:
        assert warps == e * tiles and e <= tkv.MAX_WARPS // tiles
    else:
        assert e == 1 and warps == tkv.MAX_WARPS
    if (t, f) == (197, 64) and s in (50, 99):
        assert 2 * (smem + 1024) <= tkv.SM_SMEM_BYTES


def test_masked_kv_attention_bf16_plan_at_the_vit_shapes():
    """On 132 SMs: the pair audit (C 64, S 99) six entries a block, one a
    phase on 7 warps, 264 blocks (two an SM); phase 1 (C 36, S 50) four
    entries a block in phases of two on 8 warps. A clean group too long
    for a block's shared memory is read from device memory (ViT-B/16 at
    448 px: T 785); a dirty group too long for it raises."""
    assert tkv.bf16_plan(2, 64, 99, 12, 197, 64, 132) == \
        tkv.Bf16Plan(6, 1, 7, 1, 103936)
    assert tkv.bf16_plan(2, 36, 50, 12, 197, 64, 132) == \
        tkv.Bf16Plan(4, 2, 8, 1, 106240)
    assert tkv.bf16_plan(2, 64, 170, 12, 785, 64, 132).clean == 0
    with pytest.raises(ValueError):
        tkv.bf16_plan(1, 1, 1000, 1, 1000, 64, 132)


# --------------------------------------------------------- model pieces


# The model pieces at bf16 against the JAX modules: torch rounds each
# elementwise op of the normalize chain to bf16, XLA's CPU backend fuses
# parts of the chain in float32 and rounds less often; each is a few bf16
# ulps of the chain's largest intermediate from the exact result. Held to
# the JAX package's bar for a bf16 normalization (atol 0.02,
# `tests/test_fused_gn.py`).
NORM_ATOL = 0.02


def test_group_norm8_bf16_matches_jax_and_f32_is_unchanged():
    from dorpatch_tpu.models.small import GroupNorm8 as JaxGroupNorm8
    from dorpatch_tpu_torch.models.small import GroupNorm8

    x, scale, bias, _ = _gn_case(11, (2, 4, 4, 64))
    mod = GroupNorm8(64)
    with torch.no_grad():
        mod.weight.copy_(torch.as_tensor(scale))
        mod.bias.copy_(torch.as_tensor(bias))
    # the bf16 bank's cast: the parameters in bf16 too
    params = {"params": {"scale": _j16(scale), "bias": _j16(bias)}}
    want = JaxGroupNorm8().apply(params, _j16(x))
    got = utils.cast_module(mod, BF)(_t16(x))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    err = np.abs(_np(got) - _np(want))
    assert err.max() <= NORM_ATOL, err.max()
    # float32: the flax formula as before, bit for bit
    xt = torch.as_tensor(x)
    xg = xt.reshape(2, 16, 8, 8)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    f32 = (xg - mean) * (torch.rsqrt(var + 1e-6) * mod.weight.reshape(
        1, 1, 8, 8)) + mod.bias.reshape(1, 1, 8, 8)
    assert torch.equal(mod(xt), f32.reshape(xt.shape))


def test_layer_norm_bf16_matches_jax_and_f32_is_unchanged():
    from dorpatch_tpu.models.vit import LayerNormDT
    from dorpatch_tpu_torch.models.vit import LayerNorm, layer_norm

    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 5, 64)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    mod = LayerNorm(64)
    with torch.no_grad():
        mod.weight.copy_(torch.as_tensor(scale))
        mod.bias.copy_(torch.as_tensor(bias))
    params = {"params": {"scale": jnp.asarray(scale).astype(jnp.bfloat16),
                         "bias": jnp.asarray(bias).astype(jnp.bfloat16)}}
    want = LayerNormDT().apply(params, _j16(x))
    got = utils.cast_module(mod, BF)(_t16(x))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    # each of the chain's four roundings is at most half an ulp of a value
    # no larger than the token's largest output: four ulps of it apart
    err = np.abs(_np(got) - _np(want))
    row = np.abs(_np(want)).max(axis=-1, keepdims=True)
    assert (err <= 4 * _ulp16(row)).all(), err.max()
    xt = torch.as_tensor(x)
    assert torch.equal(mod(xt), layer_norm(xt, mod.weight, mod.bias, 1e-6))


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_resnetv2_group_norm_relu_bf16_numerics(impl):
    """RN50's GroupNormRelu at bf16 keeps the JAX package's two numerics
    apart: "auto" (the kernels' semantics, `gn_relu_reference` on the CPU)
    against JAX `gn_relu(impl="interpret")`, "plain" against JAX's flax
    route (`gn_preserve_dtype` + ReLU); float32 is unchanged in both."""
    from dorpatch_tpu_torch.models.resnetv2 import GroupNormRelu

    x, scale, bias, _ = _gn_case(13, (2, 5, 5, 64))
    mod = GroupNormRelu(64)
    mod.impl = impl
    with torch.no_grad():
        mod.weight.copy_(torch.as_tensor(scale))
        mod.bias.copy_(torch.as_tensor(bias))
    s16, b16 = _j16(scale), _j16(bias)
    if impl == "auto":
        want = jgn.gn_relu(_j16(x), s16, b16, 32, impl="interpret")
    else:
        want = jax.nn.relu(jgn.gn_preserve_dtype(_j16(x), s16, b16, 32,
                                                 1e-5))
    got = utils.cast_module(mod, BF)(_t16(x))
    assert got.dtype == BF
    err = np.abs(_np(got) - _np(want))
    assert err.max() <= NORM_ATOL, err.max()
    xt = torch.as_tensor(x)
    assert torch.equal(mod(xt), tgn.gn_relu_reference(
        xt, mod.weight, mod.bias, 32, 1e-5))


# ------------------------------------------------------ the bf16 bank

IMG, CLASSES = 32, 3


def _jax_trigger(params, x):
    """The weightless 3-class trigger detector of `tests/test_defense.py`
    over `geometry(32, 0.1)`."""
    t1 = x[:, 4:8, 4:8, :].mean(axis=(1, 2, 3)) > 0.8
    t2 = x[:, 24:28, 24:28, :].mean(axis=(1, 2, 3)) > 0.8
    t3 = x[:, 4:8, 24:28, :].mean(axis=(1, 2, 3)) < 0.2
    return jax.nn.one_hot(jnp.where(t1 | t2, 1, jnp.where(t3, 2, 0)), CLASSES)


def _torch_trigger(x):
    t1 = x[:, 4:8, 4:8, :].mean(dim=(1, 2, 3)) > 0.8
    t2 = x[:, 24:28, 24:28, :].mean(dim=(1, 2, 3)) > 0.8
    t3 = x[:, 4:8, 24:28, :].mean(dim=(1, 2, 3)) < 0.2
    cls = torch.where(t1 | t2, 1, torch.where(t3, 2, 0))
    return F.one_hot(cls, CLASSES).float()


def _trigger_batch():
    """One image per verdict class: certified; disagreement recovered;
    unanimous but a double mask kills the certificate; disagreement whose
    minority row is broken."""
    imgs = np.full((4, IMG, IMG, 3), 0.5, np.float32)
    imgs[1, 4:8, 4:8] = 1.0
    imgs[2, 4:8, 4:8] = 1.0
    imgs[2, 24:28, 24:28] = 1.0
    imgs[3, 4:8, 4:8] = 1.0
    imgs[3, 4:8, 24:28] = 0.0
    return imgs


@pytest.mark.parametrize("prune", ["off", "exact"])
@pytest.mark.parametrize("margin", [float("inf"), 0.5])
def test_bf16_bank_verdict_parity_all_classes(prune, margin):
    """After `test_defense.py`'s bf16 bank tests: at margin inf every image
    escalates and the float32 exhaustive sweep decides; at 0.5 the one-hot
    margins of 1 escalate nothing and the bf16 tables decide. Either way the
    verdicts are the JAX float32 bank's, and the records (tables and
    forwards) the JAX bf16 bank's."""
    x = _trigger_batch()
    spec = jmasks.geometry(IMG, 0.1)
    jcfg = dict(ratios=(0.1,), prune=prune)
    want = jdef.PatchCleanser(_jax_trigger, spec, JaxDefenseConfig(**jcfg)) \
        .robust_predict(None, jnp.asarray(x), CLASSES)
    assert [(w.prediction, w.certification) for w in want] == \
        [(0, True), (0, False), (1, False), (1, False)]
    jb16 = jdef.PatchCleanser(
        _jax_trigger, spec, JaxDefenseConfig(
            **jcfg, compute_dtype="bfloat16", incremental_margin=margin)) \
        .robust_predict(None, jnp.asarray(x), CLASSES)
    pc = tdef.PatchCleanser(
        _torch_trigger, tmasks.geometry(IMG, 0.1),
        DefenseConfig(ratios=(0.1,), prune=prune, compute_dtype="bfloat16",
                      incremental_margin=margin), device="cpu")
    got = pc.robust_predict(torch.as_tensor(x), CLASSES)
    for g, w, j in zip(got, want, jb16):
        assert (g.prediction, g.certification) == \
            (w.prediction, w.certification)
        assert g.forwards == j.forwards
        np.testing.assert_array_equal(g.preds_1, j.preds_1)
        np.testing.assert_array_equal(g.preds_2, j.preds_2)
    if prune == "exact":
        escalated = sum(r.forwards > pc.num_forwards_exhaustive for r in got)
        assert escalated == (4 if margin == float("inf") else 0)


def test_bf16_bank_tracks_the_escalation_margin():
    """One-hot logits put every evaluated entry at margin 1.0."""
    pc = tdef.PatchCleanser(
        _torch_trigger, tmasks.geometry(IMG, 0.1),
        DefenseConfig(ratios=(0.1,), compute_dtype="bfloat16",
                      incremental_margin=float("inf")), device="cpu")
    pc.robust_predict(torch.as_tensor(_trigger_batch()), CLASSES)
    assert pc.last_min_margin.shape == (4,)
    np.testing.assert_allclose(pc.last_min_margin, 1.0, atol=1e-3)


@pytest.mark.parametrize("bad", ["fp8", "float16"])
def test_bf16_bank_and_attack_reject_unknown_dtypes(bad):
    with pytest.raises(ValueError, match="legal: float32, bfloat16"):
        tdef.PatchCleanser(_torch_trigger, tmasks.geometry(IMG, 0.1),
                           DefenseConfig(ratios=(0.1,), compute_dtype=bad),
                           device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        DorPatch(_tiny_model, 4, AttackConfig(compute_dtype=bad))


def test_bf16_bank_on_the_cifar_victim_keeps_verdicts_and_the_oracle():
    """The bf16 bank on the CIFAR ResNet-18 (stem engine, bf16 stem fold and
    full forwards): every image's verdict equals the float32 exhaustive
    sweep's (a random victim's margins escalate it), and the bank's tables
    come from the cast copy while the escalation uses the float32 victim."""
    from dorpatch_tpu_torch.models import get_model

    victim = get_model("cifar10", "resnet18", "/nonexistent", 16,
                       device="cpu")
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(4))
    spec = tmasks.geometry(16, 0.12)
    cfg = DefenseConfig(ratios=(0.12,), compute_dtype="bfloat16")
    pc = tdef.PatchCleanser(victim.apply, spec, cfg,
                            incremental_engine=victim.incremental,
                            device="cpu")
    assert pc.resolved_incremental() == "stem"
    got = pc.robust_predict(x, victim.num_classes)
    want = tdef.PatchCleanser(victim.apply, spec, DefenseConfig(
        ratios=(0.12,)), device="cpu").robust_predict(x, victim.num_classes,
                                                       prune="off")
    assert [(g.prediction, g.certification) for g in got] == \
        [(w.prediction, w.certification) for w in want]
    esc = pc.last_min_margin < cfg.incremental_margin
    for g, w, e in zip(got, want, esc):
        if e:
            np.testing.assert_array_equal(g.preds_1, w.preds_1)
            assert g.forwards > pc.num_forwards_exhaustive


# ---------------------------------------------------- the bf16 attack


def _tiny_model(x):
    """`tests/test_attack.py`'s cheap model: class scores from pooled pixel
    statistics."""
    s = x.mean(dim=(1, 2))
    return torch.stack([s[:, 0], s[:, 1], s[:, 2], s.sum(-1) / 3.0],
                       dim=-1) * 10


def _two_steps(apply_fn, dtype, num_classes=4, size=16):
    cfg = AttackConfig(sampling_size=4, dropout=1, dropout_sizes=(0.06,),
                       basic_unit=4, compute_dtype=dtype)
    atk = DorPatch(apply_fn, num_classes, cfg)
    gen = torch.Generator().manual_seed(12)
    x = torch.rand((1, size, size, 3),
                   generator=torch.Generator().manual_seed(11))
    universe = torch.as_tensor(tmasks.dropout_universe(size, 1, (0.06,)))
    state = atk._init_state(gen, x, torch.zeros((1,), dtype=torch.long),
                            False, universe.shape[0])
    init = state.adv_pattern.clone()
    lv = torch.zeros((1, size, size))
    idx = torch.arange(4)
    fail = torch.zeros(4, dtype=torch.bool)
    for _ in range(2):
        state = atk._step(state, x, lv, universe, 1, idx, fail)
    return init, state


@pytest.mark.parametrize("victim", ["tiny", "cifar_resnet18"])
def test_bf16_attack_keeps_f32_carry_and_tracks_f32(victim):
    """After `tests/test_attack.py::test_bfloat16_compute_keeps_f32_carry`:
    two stage-1 steps at bf16 keep the patch, the losses and the carry in
    float32 and finite, and the first steps move the pattern the way the
    float32 steps do on more than 90% of its values; on the CIFAR
    ResNet-18 the bf16 steps run its once-cast copy."""
    if victim == "tiny":
        apply_fn, classes = _tiny_model, 4
    else:
        from dorpatch_tpu_torch.models import get_model

        v = get_model("cifar10", "resnet18", "/nonexistent", 16,
                      device="cpu")
        apply_fn, classes = v.apply, v.num_classes
    init16, s16 = _two_steps(apply_fn, "bfloat16", classes)
    init32, s32 = _two_steps(apply_fn, "float32", classes)
    for f in ("adv_pattern", "adv_mask", "best_pattern", "loss_best", "lr",
              "metrics", "coeff_struct"):
        assert getattr(s16, f).dtype == torch.float32, f
    assert torch.isfinite(s16.metrics).all()
    d16 = torch.sign(s16.adv_pattern - init16)
    d32 = torch.sign(s32.adv_pattern - init32)
    assert float((d16 == d32).float().mean()) > 0.9
    if victim != "tiny":
        atk = DorPatch(apply_fn, classes, AttackConfig(
            compute_dtype="bfloat16"))
        assert atk._fwd is apply_fn.at(BF)
        assert next(atk._fwd.model.parameters()).dtype == BF
        assert next(apply_fn.model.parameters()).dtype == torch.float32


# ------------------------------------------------------------------ CLI


def test_cli_dtype_flags_match_the_jax_package():
    from dorpatch_tpu import cli as jcli

    for argv, want in (([], ("float32", "float32")),
                       (["--compute-dtype", "bfloat16"],
                        ("bfloat16", "float32")),
                       (["--certify-dtype", "bfloat16"],
                        ("float32", "bfloat16")),
                       (["--compute-dtype", "bfloat16", "--certify-dtype",
                         "bfloat16"], ("bfloat16", "bfloat16"))):
        cfg = config_from_args(build_parser().parse_args(argv))
        jcfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
        assert (cfg.attack.compute_dtype, cfg.defense.compute_dtype) == want
        assert (jcfg.attack.compute_dtype, jcfg.defense.compute_dtype) == want
    for flag in ("--compute-dtype", "--certify-dtype"):
        with pytest.raises(SystemExit):
            build_parser().parse_args([flag, "float16"])
