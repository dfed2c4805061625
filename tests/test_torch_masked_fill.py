"""The port's masked fill (kernels A and B on the card) on the CPU: its
plain version against `dorpatch_tpu.ops.masked_fill`, forward and
backward, plus the wrapper's dispatch and argument checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.ops.masked_fill import masked_fill as jax_masked_fill
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops import masked_fill as tfill

# backward: summation order over the mask axis differs between the two
# frameworks (sequential grid steps vs a vectorized reduction)
BWD_TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, b=2, size=16, s=9, k=2):
    rng = np.random.default_rng(seed)
    universe = jmasks.pad_rects(jmasks.dropout_universe(size, 2), k)
    rects = universe[rng.choice(len(universe), s, replace=False)]
    imgs = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    return imgs, rects.astype(np.int32)


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3)])
def test_forward_equals_jax_exactly(mode, seed, k):
    imgs, rects = _case(seed, k=k)
    want = np.asarray(jax_masked_fill(jnp.asarray(imgs), jnp.asarray(rects),
                                      0.5, use_pallas=mode))
    got = tfill.masked_fill(torch.as_tensor(imgs), torch.as_tensor(rects), 0.5)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_backward_matches_jax_grad_through_interpret():
    """d/dimgs of sum(fill(imgs) * w) with a positive cotangent w: the image
    cotangent sum_s w[b, s] * keep[s]."""
    imgs, rects = _case(2, s=12)
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 1, (2, 12, 16, 16, 3)).astype(np.float32)

    def jloss(x):
        out = jax_masked_fill(x, jnp.asarray(rects), 0.5,
                              use_pallas="interpret")
        return jnp.sum(out * jnp.asarray(w))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(imgs)))
    x = torch.as_tensor(imgs).requires_grad_(True)
    out = tfill.masked_fill(x, torch.as_tensor(rects), 0.5)
    (got,) = torch.autograd.grad((out * torch.as_tensor(w)).sum(), x)
    np.testing.assert_allclose(got.numpy(), want, **BWD_TOL)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    imgs, rects = _case(4)
    _backend.reset_launch_counts()
    out = tfill.masked_fill(torch.as_tensor(imgs), rects, 0.25)
    ref = tfill.masked_fill_reference(torch.as_tensor(imgs),
                                      torch.as_tensor(rects), 0.25)
    assert torch.equal(out, ref)
    assert _backend.launch_counts() == {"masked_fill_fwd": 0,
                                        "masked_fill_bwd": 0, "stem_fold": 0,
                                        "gn_relu_fwd": 0, "gn_relu_bwd": 0,
                                        "masked_kv_attn": 0,
                                        "masked_fill_fwd_bf16": 0,
                                        "stem_fold_bf16": 0,
                                        "gn_relu_fwd_bf16": 0,
                                        "gn_relu_bwd_bf16": 0,
                                        "masked_kv_attn_bf16": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers only take CUDA tensors: no silent plain path."""
    imgs, rects = _case(5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfill.masked_fill_fwd_kernel(torch.as_tensor(imgs),
                                     torch.as_tensor(rects), 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfill.masked_fill_bwd_kernel(torch.as_tensor(rects),
                                     torch.zeros(2, 9, 16, 16, 3))


# -- the kernels' launch plans and grids (Python, which the C entries
#    launch as given; the kernels run only on the card) --

#: (images, size, masks): the attack step, the sweep's chunk and the pair
#: audit's chunk at the CIFAR path's and the 224 paths' shapes
MAIN_SHAPES = [(b, size, s) for b, size in ((8, 32), (2, 224))
               for s in (128, 126, 63)]


@pytest.mark.parametrize("b,size,s", MAIN_SHAPES + [(3, 15, 7), (1, 16, 1),
                                                    (1, 32, 128),
                                                    (2, 32, 300)])
def test_fwd_plan_covers_every_lane_and_mask_once(b, size, s):
    """Kernel A's grid (tiles x mask groups x images) holds every lane of
    every [b, s] slab exactly once, within the kernel's limits; the main
    paths' shapes get FWD_GROUPS mask groups, and evict-first stores
    exactly when the output outgrows the L2."""
    h = w = size
    plan = tfill.fwd_plan(b, s, h, w, 3)
    gx, gy, gz = tfill.fwd_grid(plan, b, s, h, w, 3)
    nl = h * w * 3 // plan.vec
    tile = tfill.THREADS * tfill.LANES
    assert (gx - 1) * tile < nl <= gx * tile
    assert (gy - 1) * plan.group < s <= gy * plan.group
    assert gz == b and gy <= 65535
    assert 1 <= plan.group <= tfill.MAX_GROUP
    assert plan.vec == (4 if (w * 3) % 4 == 0 else 1)
    assert plan.stream == (4 * b * s * h * w * 3 > tfill.L2_BYTES)
    if (b, size, s) in MAIN_SHAPES:
        assert gy == tfill.FWD_GROUPS
        assert plan.stream == (size == 224)


@pytest.mark.parametrize("b,size,s", MAIN_SHAPES + [(3, 15, 7)])
def test_bwd_plan_covers_every_lane_once(b, size, s):
    plan = tfill.bwd_plan(b, s, size, size, 3)
    gx, gy = tfill.bwd_grid(plan, b, size, size, 3)
    nl = size * size * 3 // plan.vec
    assert (gx - 1) * plan.cols < nl <= gx * plan.cols and gy == b
    assert tfill.THREADS % plan.cols == 0
    if (b, size, s) in MAIN_SHAPES:
        assert gx * gy >= 2 * tfill.MIN_BLOCKS


def test_plans_take_the_scalar_route_when_unaligned():
    assert tfill.fwd_plan(2, 8, 32, 32, 3, aligned=False).vec == 1
    assert tfill.bwd_plan(2, 8, 32, 32, 3, aligned=False).vec == 1
    assert tfill.lane_width(15, 3, True) == 1       # a row of 45 floats
    assert tfill.lane_width(4, 1, True) == 4


#: (images, size, masks): the bf16 bank's phase-1 and pair-audit chunks at
#: the CIFAR, 224 and 480 paths' shapes
BANK_SHAPES = [(b, size, s) for b, size in ((8, 32), (2, 224), (1, 480))
               for s in (36, 63)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,size,s", BANK_SHAPES + [(3, 15, 7), (1, 16, 1),
                                                    (2, 32, 126)])
def test_bf16_fwd_plan_covers_every_lane_and_mask_once(b, size, s, aligned):
    """Kernel A's bf16 form: its grid (tiles of 256 x `lanes` lanes x mask
    groups x images) holds every lane of every [b, s] slab exactly once,
    within the kernel's limits, on the 16-byte route (8 values a lane) and
    the scalar route (unaligned buffers, or rows of W*C not a multiple of
    8); evict-first stores exactly when the output outgrows the L2."""
    h = w = size
    plan = tfill.fwd_plan(b, s, h, w, 3, aligned, itemsize=2)
    gx, gy, gz = tfill.fwd_grid(plan, b, s, h, w, 3)
    assert plan.vec == (8 if aligned and (w * 3) % 8 == 0 else 1)
    assert 1 <= plan.lanes <= tfill.MAX_LANES16
    assert 1 <= plan.group <= tfill.MAX_GROUP16
    nl = h * w * 3 // plan.vec
    # every (tile, thread, lane slot) of the kernel's indexing, once
    lane = (np.arange(gx)[:, None, None] * tfill.THREADS * plan.lanes
            + np.arange(plan.lanes)[None, :, None] * tfill.THREADS
            + np.arange(tfill.THREADS)[None, None, :]).ravel()
    live = lane[lane < nl]
    assert np.array_equal(np.sort(live), np.arange(nl))
    masks = (np.arange(gy)[:, None] * plan.group
             + np.arange(plan.group)[None, :]).ravel()
    assert np.array_equal(np.sort(masks[masks < s]), np.arange(s))
    assert (gy - 1) * plan.group < s and gz == b and gy <= 65535
    assert plan.stream == (2 * b * s * h * w * 3 > tfill.L2_BYTES)
    assert (plan.lanes, plan.group) == (tfill.BF16_LANES,
                                        min(s, tfill.BF16_GROUP))
