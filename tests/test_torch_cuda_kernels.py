"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
nvcc and skips without them. On a GPU host (no jax needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch.gn_bench import rn50_gn_calls
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops import fused_gn as fgn
from dorpatch_tpu_torch.ops import masked_fill as mf
from dorpatch_tpu_torch.ops import stem_fold as sf

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, seed, b, size, s, k):
    """Images and S masks of K rectangles from the dropout universe:
    singles for K=1, pairs padded with empty rectangles for K=2 and 3, and
    K/2 pairs side by side (as with --dual) for K=4 and 8."""
    rng = np.random.default_rng(seed)
    universe = tmasks.dropout_universe(size, 1 if k == 1 else 2)
    draws = k // 2 if k in (4, 8) else 1
    rects = np.concatenate(
        [universe[rng.choice(len(universe), s, replace=False)]
         for _ in range(draws)], axis=1)
    rects = tmasks.pad_rects(rects, k)
    imgs = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    return (torch.as_tensor(imgs, device=dev),
            torch.as_tensor(rects, device=dev))


# (images, size, masks, K): the CIFAR attack step, odd slabs of the scalar
# route (15 and 13 px: rows of 45 and 39 floats), more masks than a block's
# group or B's rectangle tile, one mask, the 224 attack step, K = 4 (--dual)
# and K = 8 (kMaxRects)
FILL_CASES = [(8, 32, 128, 2), (3, 15, 7, 3), (2, 32, 300, 2), (1, 16, 1, 1),
              (2, 224, 128, 2), (8, 32, 128, 4), (2, 32, 64, 8),
              (2, 13, 40, 2)]


@pytest.mark.parametrize("b,size,s,k", FILL_CASES)
def test_fill_forward_equals_plain_exactly(dev, b, size, s, k):
    imgs, rects = _case(dev, 0, b, size, s, k)
    got = mf.masked_fill_fwd_kernel(imgs, rects, 0.5)
    want = mf.masked_fill_reference(imgs, rects, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("vec", [4, 1])
def test_fill_forward_every_plan_equals_plain(dev, vec):
    """A group that does not divide S, one that exceeds it, and both store
    policies, on both routes, at an image of more than one tile."""
    imgs, rects = _case(dev, 4, 3, 48, 37, 2)
    want = mf.masked_fill_reference(imgs, rects, 0.5)
    for group in (1, 5, 32):
        for stream in (False, True):
            plan = mf.FwdPlan(vec, group, stream)
            got = mf._fwd_launch(imgs, rects, 0.5, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan


def _fill_grad64(imgs, rects, g):
    x = imgs.double().requires_grad_(True)
    (want,) = torch.autograd.grad(mf.masked_fill_reference(x, rects, 0.5), x,
                                  g.double())
    return want.float()


@pytest.mark.parametrize("b,size,s,k", [(8, 32, 128, 2), (3, 15, 200, 3),
                                        (2, 224, 128, 2), (8, 32, 128, 4),
                                        (2, 32, 64, 8)])
def test_fill_backward_matches_float64_autograd(dev, b, size, s, k):
    """Within rtol 1e-5 / atol 1e-6 of float64 autograd of the plain
    version (the kernel sums in float64), and bit-equal on a repeat."""
    imgs, rects = _case(dev, 1, b, size, s, k)
    g = torch.randn((b, s, size, size, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    want = _fill_grad64(imgs, rects, g)
    got = mf.masked_fill_bwd_kernel(rects, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(mf.masked_fill_bwd_kernel(rects, g), got)


@pytest.mark.parametrize("vec", [4, 1])
def test_fill_backward_every_plan_matches_float64_autograd(dev, vec):
    imgs, rects = _case(dev, 5, 3, 32, 200, 2)
    g = torch.randn((3, 200, 32, 32, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    want = _fill_grad64(imgs, rects, g)
    for cols in (1, 4, 8, 32, 256):
        got = mf._bwd_launch(rects, g, mf.BwdPlan(vec, cols))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_fill_launches_refuse_what_the_buffers_or_grid_do_not_admit(dev):
    """16-byte lanes on a buffer off 16-byte alignment are refused before
    the launch; the C entries launch the wrapper's grid as given and refuse
    one that misses a lane or a mask, or covers one twice."""
    from dorpatch_tpu_torch.ops import _build

    imgs, rects = _case(dev, 6, 2, 32, 40, 2)
    g = torch.randn((2, 40, 32, 32, 3), device=dev)
    off = torch.empty(imgs.numel() + 1, device=dev)[1:].view(imgs.shape)
    off.copy_(imgs)
    with pytest.raises(ValueError, match="16-byte aligned: False"):
        mf._fwd_launch(off, rects, 0.5, mf.FwdPlan(4, 8, False))
    with pytest.raises(ValueError, match="rows of 13x3"):
        mf._fwd_launch(imgs[:, :13, :13].contiguous(), rects, 0.5,
                       mf.FwdPlan(4, 8, False))
    assert torch.equal(mf._fwd_launch(off, rects, 0.5, None),
                       mf.masked_fill_reference(imgs, rects, 0.5))
    lib = _build.library()
    plan = mf.fwd_plan(2, 40, 32, 32, 3)
    tiles, groups, _ = mf.fwd_grid(plan, 2, 40, 32, 32, 3)
    out = torch.empty((2, 40, 32, 32, 3), device=dev)
    for t, gr in ((tiles - 1, groups), (tiles + 1, groups),
                  (tiles, groups - 1), (tiles, groups + 1), (tiles, groups)):
        rc = lib.dp_masked_fill_fwd(
            imgs.data_ptr(), rects.data_ptr(), out.data_ptr(), 2, 40, 2, 32,
            32, 3, 0.5, 1, plan.group, 0, t, gr,
            _backend.stream_handle(imgs))
        assert (rc == 0) == ((t, gr) == (tiles, groups))
    bplan = mf.bwd_plan(2, 40, 32, 32, 3)
    blocks, _ = mf.bwd_grid(bplan, 2, 32, 32, 3)
    dx = torch.empty_like(imgs)
    for nb in (blocks - 1, blocks + 1, blocks):
        rc = lib.dp_masked_fill_bwd(
            g.data_ptr(), rects.data_ptr(), dx.data_ptr(), 2, 40, 2, 32, 32,
            3, 1, bplan.cols, nb, _backend.stream_handle(g))
        assert (rc == 0) == (nb == blocks)
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["resnet18", "resnetv2"])
def test_attack_repeats_bit_for_bit_under_configure_numerics(dev, arch):
    """Ten calls of the victim's input gradient on one masked batch are
    bit-equal, and two 3-step runs of the attack from one seed, at the
    victim's main path's size and batch, give bit-equal patches."""
    from dorpatch_tpu_torch import data, repeat, utils
    from dorpatch_tpu_torch.models import get_model

    utils.configure_numerics()
    spec = repeat.VICTIMS[arch]
    victim = get_model(spec.dataset, arch, "/nonexistent", spec.img_size,
                       device=dev)
    x_np, _ = next(data.synthetic_batches(spec.dataset, spec.batch,
                                          spec.img_size, repeat.SEED))
    x = torch.as_tensor(x_np, device=dev)
    grads = repeat.victim_repeat(victim, x, arch, repeat.TRIALS)
    assert grads["logits_differing"] == grads["input_grad_differing"] == 0
    a, b = (repeat.attack_steps(victim, x, 3) for _ in range(2))
    for (mask_a, pattern_a, _), (mask_b, pattern_b, _) in zip(a, b):
        assert torch.equal(mask_a, mask_b)
        assert torch.equal(pattern_a, pattern_b)


def test_autograd_function_pairs_the_kernels_and_counts(dev):
    imgs, rects = _case(dev, 3, 2, 32, 16, 2)
    _backend.reset_launch_counts()
    x = imgs.clone().requires_grad_(True)
    out = mf.masked_fill(x, rects, 0.5)
    w = torch.rand_like(out)
    (gx,) = torch.autograd.grad((out * w).sum(), x)
    assert _backend.launch_counts()["masked_fill_fwd"] == 1
    assert _backend.launch_counts()["masked_fill_bwd"] == 1
    xr = imgs.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(
        (mf.masked_fill_reference(xr, rects, 0.5) * w).sum(), xr)
    torch.testing.assert_close(gx, gr, rtol=1e-5, atol=1e-5)


# (img, k, stride, cout, ratio, masks): the CIFAR 3x3/1 and RN50 7x7/2
# stems; N = 1, 5 and 13 masks, taken from the start of the family (top
# left) or, for a negative count, from its end, whose windows are clamped at
# the bottom and right edges; cout 36 takes the kernel's one-quad path; the
# RN50 stem at 480 px (240 x 240 outputs, the widest staged window rows)
STEM_CASES = [(32, 3, 1, 64, 0.12, 5), (32, 3, 1, 64, 0.015, 5),
              (64, 7, 2, 64, 0.06, 5), (32, 3, 1, 64, 0.12, 1),
              (32, 3, 1, 64, 0.12, -13), (224, 7, 2, 64, 0.12, 13),
              (224, 7, 2, 64, 0.12, -1), (224, 7, 2, 64, 0.06, -13),
              (32, 3, 1, 36, 0.06, -5), (480, 7, 2, 64, 0.12, 12),
              (480, 7, 2, 64, 0.015, -5)]


@pytest.mark.parametrize("img,k,s,cout,ratio,masks", STEM_CASES)
def test_stem_fold_kernel_matches_plain(dev, img, k, s, cout, ratio, masks):
    rng = np.random.default_rng(img + k)
    pads = ((1, 1), (1, 1)) if k == 3 else \
        (sf.same_pads(img, k, s), sf.same_pads(img, k, s))
    h_out = (img + sum(pads[0]) - k) // s + 1
    kern = torch.as_tensor(rng.normal(0, 0.3, (k, k, 3, cout)),
                           dtype=torch.float32, device=dev)
    clean = torch.as_tensor(rng.normal(0, 1, (4, h_out, h_out, cout)),
                            dtype=torch.float32, device=dev)
    u = torch.as_tensor(rng.uniform(-1, 1, (4, img, img, 3)),
                        dtype=torch.float32, device=dev)
    singles, _ = tmasks.mask_sets(tmasks.geometry(img, ratio))
    plan = sf.plan_windows(singles, img, k, s, pads)
    plan = plan[:masks] if masks > 0 else plan[masks:]
    oh, ow, geo, occ = sf._uniform_plan(plan, h_out, h_out, k, s)
    args = (kern, clean, sf.pad_for_kernel(u, pads, s),
            torch.as_tensor(geo, device=dev), torch.as_tensor(occ, device=dev),
            oh, ow, s)
    got = sf.fold_masked_stem_kernel(*args)
    want = sf.fold_masked_stem(kern, clean, u, plan, (s, s), pads)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (4, abs(masks), h_out, h_out, cout)
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(sf.fold_masked_stem_kernel(*args), got)


def test_stem_engine_on_card_matches_cpu_plain(dev):
    from dorpatch_tpu_torch.models import get_model

    cpu = get_model("cifar10", "resnet18", "/nonexistent", 32, device="cpu")
    gpu = get_model("cifar10", "resnet18", "/nonexistent", 32, device=dev)
    singles, _ = tmasks.mask_sets(tmasks.geometry(32, 0.06))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    p_cpu, m_cpu = cpu.incremental.build_family(singles, 36, 64, 0.5) \
        .phase1(x)
    _backend.reset_launch_counts()
    p_gpu, m_gpu = gpu.incremental.build_family(singles, 36, 64, 0.5) \
        .phase1(x.to(dev))
    assert _backend.launch_counts()["stem_fold"] == 12   # 36 masks / 3
    torch.testing.assert_close(m_gpu.cpu(), m_cpu, rtol=0, atol=1e-3)
    sure = torch.minimum(m_gpu.cpu(), m_cpu) > 1e-3
    assert torch.equal(p_gpu.cpu()[sure], p_cpu[sure])


def _trigger(x):
    """Weightless 3-class detector (the CPU defense tests' trigger stub):
    its tables cover all four verdict classes on `_trigger_batch`."""
    t1 = x[:, 4:8, 4:8, :].mean(dim=(1, 2, 3)) > 0.8
    t2 = x[:, 24:28, 24:28, :].mean(dim=(1, 2, 3)) > 0.8
    t3 = x[:, 4:8, 24:28, :].mean(dim=(1, 2, 3)) < 0.2
    cls = torch.where(t1 | t2, 1, torch.where(t3, 2, 0))
    return torch.nn.functional.one_hot(cls, 3).float()


def test_pruned_certification_on_card_equals_cpu(dev):
    """The pruned schedule (phase 1 and the pair audit through kernel A, the
    minority rows through `_rows`) gives the CPU's records on the card."""
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser

    x = np.full((4, 32, 32, 3), 0.5, np.float32)
    x[1, 4:8, 4:8] = 1.0
    x[2, 4:8, 4:8] = 1.0
    x[2, 24:28, 24:28] = 1.0
    x[3, 4:8, 4:8] = 1.0
    x[3, 4:8, 24:28] = 0.0
    spec = tmasks.geometry(32, 0.1)
    cfg = DefenseConfig(ratios=(0.1,))
    want = PatchCleanser(_trigger, spec, cfg, device="cpu").robust_predict(
        torch.as_tensor(x), 3, bucket_sizes=(1, 8))
    _backend.reset_launch_counts()
    got = PatchCleanser(_trigger, spec, cfg, device=dev).robust_predict(
        torch.as_tensor(x, device=dev), 3, bucket_sizes=(1, 8))
    assert _backend.launch_counts()["masked_fill_fwd"] > 0
    for g, w in zip(got, want):
        assert (g.prediction, g.certification, g.forwards) == \
            (w.prediction, w.certification, w.forwards)
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        np.testing.assert_array_equal(g.preds_2, w.preds_2)
    assert [(r.prediction, r.certification) for r in got] == \
        [(0, True), (0, False), (1, False), (1, False)]


@pytest.mark.parametrize("prune", ["exact", "consensus"])
def test_n_patch2_and_consensus_certification_on_card_equal_cpu(dev, prune):
    """The n_patch=2 exhaustive sweep (kernel A filling 3 rectangles a mask,
    630 + 22680 masks) and the consensus schedule give the CPU's records on
    the card."""
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser

    x = np.full((4, 32, 32, 3), 0.5, np.float32)
    x[1, 4:8, 4:8] = 1.0
    x[2, 4:8, 4:8] = 1.0
    x[2, 24:28, 24:28] = 1.0
    x[3, 4:8, 24:28] = 0.0
    for n_patch in (1, 2):
        spec = tmasks.geometry(32, 0.1, n_patch)
        cfg = DefenseConfig(ratios=(0.1,), n_patch=n_patch, prune=prune)
        want = PatchCleanser(_trigger, spec, cfg, device="cpu") \
            .robust_predict(torch.as_tensor(x), 3, bucket_sizes=(1, 8))
        _backend.reset_launch_counts()
        got = PatchCleanser(_trigger, spec, cfg, device=dev).robust_predict(
            torch.as_tensor(x, device=dev), 3, bucket_sizes=(1, 8))
        assert _backend.launch_counts()["masked_fill_fwd"] > 0
        for g, w in zip(got, want):
            assert (g.prediction, g.certification, g.forwards) == \
                (w.prediction, w.certification, w.forwards)
            np.testing.assert_array_equal(g.preds_1, w.preds_1)
            np.testing.assert_array_equal(g.preds_2, w.preds_2)


def test_mixer_engine_on_card_matches_cpu(dev):
    """The ResMLP mixer engine's programs (gathers and batched matmuls on
    cuBLAS, no kernel of its own) on the card against the CPU: margins
    within 1e-4, predictions equal wherever both margins exceed it."""
    from dorpatch_tpu_torch.models import get_model

    victim = get_model("cifar10", "cifar_resmlp", "/nonexistent", 32,
                       device="cpu")
    singles, doubles = tmasks.mask_sets(tmasks.geometry(32, 0.12))
    rects = np.concatenate([tmasks.pad_rects(singles, 2), doubles])
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    sets = torch.as_tensor(tmasks.second_round_table_indices(36)[[3, 20]])
    cpu = victim.incremental.build_family(rects, 36, 64, 0.5)
    want = [cpu.phase1(x), cpu.pairs(x), cpu.rows(x, sets)]
    victim.model.to(dev)
    card = victim.incremental.build_family(rects, 36, 64, 0.5)
    got = [card.phase1(x.to(dev)), card.pairs(x.to(dev)),
           card.rows(x.to(dev), sets.to(dev))]
    for (gp, gm), (wp, wm) in zip(got, want):
        gp, gm = gp.cpu().numpy(), gm.cpu().numpy()
        np.testing.assert_allclose(gm, wm.numpy(), atol=1e-4, rtol=0)
        sure = np.minimum(gm, wm.numpy()) > 1e-4
        np.testing.assert_array_equal(gp[sure], wp.numpy()[sure])


# GroupNorm+ReLU: f32 kernels against the float64 plain versions. Forward
# and per-element dx within 1e-5 (f32 rounding of a few flops per element;
# the group statistics are summed in float64); the parameter cotangents sum
# N*HW terms per channel in f32 partials, hence atol 1e-3. Gate flips near a
# pre-activation of 0 are allowed for by `gate_flip_bounds`.
# The 11 (HW, C) shapes of ResNetV2-50x1 at 224 at N = 2 (one-pass route),
# odd shapes (C = 96: cg = 3, chunks of 24 channels), chunks split over
# clusters (64*64 rows: 2 CTAs forward, 8 backward; 112*112: 4 and 8;
# 160*160 and RN50's 120*120 at 480 px: 8 forward), and slabs whose chunk
# fits no cluster (160*160 and 120*120 backward, 256*256: the split route)
GN_SHAPES = [(8, 28, 28, 128), (16, 7, 7, 2048), (3, 9, 9, 64), (2, 5, 5, 96),
             (4, 56, 56, 256), (2, 56, 56, 64), (2, 56, 56, 128),
             (2, 28, 28, 512), (2, 28, 28, 256), (2, 14, 14, 256),
             (2, 14, 14, 1024), (2, 14, 14, 512), (2, 7, 7, 512),
             (2, 64, 64, 256), (1, 112, 112, 64), (1, 160, 160, 64),
             (1, 256, 256, 64), (1, 120, 120, 256)]
#: (HW, C) of the 49 GroupNorm+ReLU calls of ResNetV2-50x1 at 224
RN50_GN = set(rn50_gn_calls(224))


def _gn_case(dev, seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    arrays = (rng.standard_normal(shape) + rng.normal(0, 0.5, c),
              1 + rng.normal(0, 0.2, c), rng.normal(0, 0.3, c),
              rng.standard_normal(shape))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


def _gn_route(direction, shape):
    n, h, w, c = shape
    route = fgn.gn_plan(direction, n, h * w, c).route
    if (h * w, c) in RN50_GN:
        assert route == "one_pass"
    if h * w == 256 * 256:
        assert route == "split"
    return route


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_forward_matches_float64_plain(dev, shape):
    x, s, b, _ = _gn_case(dev, 0, shape)
    route = _gn_route("fwd", shape)
    _backend.reset_launch_counts()
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    torch.cuda.synchronize()
    assert _backend.route_counts() == {f"gn_relu_fwd/{route}": 1}
    m64, r64 = fgn.gn_stats_reference(x.double(), 32)
    torch.testing.assert_close(mean.double(), m64, rtol=0, atol=1e-6)
    torch.testing.assert_close(rstd.double(), r64, rtol=1e-5, atol=0)
    want = fgn.gn_relu_reference(x.double(), s.double(), b.double())
    torch.testing.assert_close(y.double(), want, rtol=1e-5, atol=1e-5)
    again = fgn.gn_relu_fwd_kernel(x, s, b)
    assert all(torch.equal(p, q) for p, q in zip(again, (y, mean, rstd)))


def _check_gn_backward(x, dy, s, b, mean, rstd, got):
    dx, ds, db = got
    args = [t.double() for t in (x, dy, s, b)]
    m64, r64 = fgn.gn_stats_reference(args[0], 32)
    wdx, wds, wdb = fgn.gn_relu_backward_reference(*args, m64, r64, 32)
    near, dx_b, ds_b, db_b = fgn.gate_flip_bounds(*args, m64, r64, 32)
    keep = ~near
    err = (dx.double() - wdx).abs()[keep]
    assert (err <= 1e-5 + 1e-5 * wdx.abs()[keep] + dx_b[keep]).all()
    assert ((ds.double() - wds).abs() <= 1e-3 + 1e-5 * wds.abs() + ds_b).all()
    assert ((db.double() - wdb).abs() <= 1e-3 + 1e-5 * wdb.abs() + db_b).all()


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_backward_matches_float64_plain(dev, shape):
    x, s, b, dy = _gn_case(dev, 1, shape)
    route = _gn_route("bwd", shape)
    _, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    _backend.reset_launch_counts()
    dx, ds, db = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd)
    torch.cuda.synchronize()
    assert _backend.route_counts() == {f"gn_relu_bwd/{route}": 1}
    _check_gn_backward(x, dy, s, b, mean, rstd, (dx, ds, db))
    again = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd)
    assert all(torch.equal(p, q) for p, q in zip(again, (dx, ds, db)))
    dx_only = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, params=False)
    assert dx_only[1] is None and dx_only[2] is None
    assert torch.equal(dx_only[0], dx)


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_gn_one_pass_cluster_sizes_match_float64_plain(dev, cluster):
    """The largest RN50 chunk, its rows split over 1, 2 and 4 CTAs of a
    cluster: each plan within tolerance of float64 and bit-repeatable."""
    shape = (2, 56, 56, 256)
    x, s, b, dy = _gn_case(dev, 4, shape)
    hw, c = 56 * 56, 256
    width = 8                                          # one group
    plans = [fgn.GNPlan("one_pass", width, cluster,
                        fgn.one_pass_smem(hw, width, cluster, slabs))
             for slabs in (1, 2)]
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b, plan=plans[0])
    torch.cuda.synchronize()
    want = fgn.gn_relu_reference(x.double(), s.double(), b.double())
    torch.testing.assert_close(y.double(), want, rtol=1e-5, atol=1e-5)
    got = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=plans[1])
    torch.cuda.synchronize()
    _check_gn_backward(x, dy, s, b, mean, rstd, got)
    again = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=plans[1])
    assert all(torch.equal(p, q) for p, q in zip(again, got))


def test_gn_shared_memory_formula_matches_the_kernels(dev):
    from dorpatch_tpu_torch.ops import _build

    lib = _build.library()
    for hw, c in sorted(RN50_GN) + [(4096, 256), (12544, 64)]:
        for direction, slabs in (("fwd", 1), ("bwd", 2)):
            p = fgn.gn_plan(direction, 2, hw, c)
            assert p.route == "one_pass"
            assert lib.dp_gn_onepass_smem(hw, p.width, p.cluster, slabs) \
                == p.smem
    # a plan whose shared memory is short of the carve is refused
    x, s, b, _ = _gn_case(dev, 5, (1, 7, 7, 64))
    p = fgn.gn_plan("fwd", 1, 49, 64)
    with pytest.raises(RuntimeError, match="gn_relu_fwd"):
        fgn.gn_relu_fwd_kernel(x, s, b, plan=p._replace(smem=p.smem - 16))


def test_gn_autograd_function_pairs_the_kernels_and_counts(dev):
    x, s, b, dy = _gn_case(dev, 2, (2, 8, 8, 64))
    leaves = [t.clone().requires_grad_(True) for t in (x, s, b)]
    _backend.reset_launch_counts()
    got = torch.autograd.grad((fgn.gn_relu(*leaves) * dy).sum(), leaves)
    counts = _backend.launch_counts()
    assert (counts["gn_relu_fwd"], counts["gn_relu_bwd"]) == (1, 1)
    assert _backend.route_counts() == {"gn_relu_fwd/one_pass": 1,
                                       "gn_relu_bwd/one_pass": 1}
    ref = [t.clone().requires_grad_(True) for t in (x, s, b)]
    want = torch.autograd.grad(
        (fgn.gn_relu_reference(*ref) * dy).sum(), ref)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    # frozen affine (the victim's case): the Function still returns dx
    xr = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((fgn.gn_relu(xr, s, b) * dy).sum(), xr)
    torch.testing.assert_close(gx, got[0], rtol=0, atol=0)


def test_resnetv2_victim_on_card_matches_cpu(dev):
    """The full-depth ResNetV2-50x1 from the same seed on the card (49 GN
    forward launches per forward) and on the CPU."""
    from dorpatch_tpu_torch.models import get_model

    cpu = get_model("imagenet", "resnetv2", "/nonexistent", 64, device="cpu")
    gpu = get_model("imagenet", "resnetv2", "/nonexistent", 64, device=dev)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    _backend.reset_launch_counts()
    with torch.no_grad():
        got = gpu.apply(x.to(dev)).cpu()
        want = cpu.apply(x)
    assert _backend.launch_counts()["gn_relu_fwd"] == 49
    assert _backend.route_counts() == {"gn_relu_fwd/one_pass": 49}
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


# Kernel H against the float64 plain version: float32 rounding of the
# 64-term logits, the exp-sum over T+S keys and the weighted sum.
# (B, C, S, H, f, T): S of 1, 7, 50 and 99 (one to seven 16-row tiles,
# ragged last tiles); C = 37, 13 and 5, which no entry group divides; T and
# S off the 32-key tiles; f = 32 (`cifar_vit`) and 64 (ViT-B/16); T = 257
# (f 64) and 401 (f 32), whose split clean group does not fit a block's
# shared memory, so the kernel reads it from device memory
KV_SHAPES = [(2, 3, 4, 2, 32, 9), (2, 36, 50, 12, 64, 197),
             (1, 5, 99, 12, 64, 197), (3, 4, 17, 4, 32, 65),
             (2, 13, 1, 3, 64, 197), (2, 9, 7, 2, 32, 65),
             (1, 37, 50, 12, 64, 197), (2, 64, 99, 12, 64, 197),
             (1, 3, 99, 2, 32, 200), (1, 3, 20, 2, 64, 257),
             (1, 2, 9, 2, 32, 401)]


def _kv_case(dev, seed, b, c, s, h, f, t, scale=None):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=dev)

    q, kd, vd = (normal(b, c, s, h, f) for _ in range(3))
    kc, vc = (normal(b, t, h, f) for _ in range(2))
    cb = np.where(rng.uniform(size=(b, c, t)) < 0.2, -1e9, 0.0)
    db = np.where(rng.uniform(size=(b, c, s)) < 0.25, -1e9, 0.0)
    db[:, :, 0] = 0.0
    return (q * (scale or 1 / np.sqrt(f)), kd, vd, kc, vc,
            torch.as_tensor(cb, dtype=torch.float32, device=dev),
            torch.as_tensor(db, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("shape", KV_SHAPES)
def test_masked_kv_attention_kernel_matches_float64_plain(dev, shape):
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    args = _kv_case(dev, 0, *shape)
    _backend.reset_launch_counts()
    got = mka.masked_kv_attention(*args)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["masked_kv_attn"] == 1
    want = mka.masked_kv_attention_reference(*(a.double() for a in args))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(mka.masked_kv_attention_kernel(*args), got)


def _kv_check(args):
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    got = mka.masked_kv_attention_kernel(*args)
    torch.cuda.synchronize()
    want = mka.masked_kv_attention_reference(*(a.double() for a in args))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(mka.masked_kv_attention_kernel(*args), got)
    return got


def test_masked_kv_attention_kernel_only_dirty_slot_zero_live(dev):
    """Entries whose clean keys are all stale and whose dirty slots are all
    duplicates but slot 0: every row attends to slot 0 alone, after whole
    64-key tiles of masked keys."""
    args = list(_kv_case(dev, 1, 2, 6, 50, 4, 64, 197))
    args[5][:, ::2] = -1e9
    args[6][:, ::2, 1:] = -1e9
    got = _kv_check(args)
    want = args[2][:, ::2, :1].expand(-1, -1, 50, -1, -1)
    torch.testing.assert_close(got[:, ::2], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [32, 64])
def test_masked_kv_attention_kernel_large_logits(dev, f):
    """The largest logits near 30 (queries scaled by 6/sqrt(f) instead of
    1/sqrt(f)), where the softmax is sharp: the 3xTF32 products have to keep
    float32 accuracy."""
    args = _kv_case(dev, 2, 2, 12, 50, 4, f, 197, scale=6 / np.sqrt(f))
    logits = torch.einsum("bcshf,bthf->bchst", args[0], args[3]).abs()
    assert 25 < float(logits.max()) < 45
    _kv_check(args)


@pytest.mark.parametrize("f", [32, 64])
def test_masked_kv_attention_kernel_as_accurate_as_float32(dev, f):
    """Logits near 30 on average (queries scaled by 37.6/sqrt(f)): there the
    float32 plain version itself is 1e-5 away from float64 and more, so the
    kernel is held to be no further from float64 than it."""
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    args = _kv_case(dev, 3, 2, 12, 50, 4, f, 197, scale=37.6 / np.sqrt(f))
    logits = torch.einsum("bcshf,bthf->bchst", args[0], args[3]).abs()
    assert 20 < float(logits.mean()) < 40
    want = mka.masked_kv_attention_reference(*(a.double() for a in args))
    got = mka.masked_kv_attention_kernel(*args)
    plain = mka.masked_kv_attention_reference(*args)
    torch.cuda.synchronize()
    assert (float((got.double() - want).abs().max())
            <= float((plain.double() - want).abs().max()))


# ------------------------------------------------------------- bf16 forms
#
# Each bf16 kernel against its plain version in bf16 (the same function on
# the same bf16 inputs), with tolerances in bf16 ulps: `_ulp16(x)` is the
# spacing of bf16 numbers at |x| (8 significant bits: 2^(e-7)).


def _ulp16(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("b,size,s,k", [(8, 32, 128, 2), (2, 224, 63, 2),
                                        (3, 15, 7, 3)])
def test_fill_forward_bf16_equals_plain_exactly(dev, b, size, s, k):
    """Kernel A's bf16 form: an exact select at the bank's two image sizes
    (16-byte lanes of 8 values) and at a 15 px slab (the scalar route)."""
    imgs, rects = _case(dev, 7, b, size, s, k)
    imgs = imgs.bfloat16()
    _backend.reset_launch_counts()
    got = mf.masked_fill(imgs, rects, 0.5)
    torch.cuda.synchronize()
    counts = _backend.launch_counts()
    assert (counts["masked_fill_fwd_bf16"], counts["masked_fill_fwd"]) == \
        (1, 0)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mf.masked_fill_reference(imgs, rects, 0.5))


@pytest.mark.parametrize("vec", [8, 1])
def test_fill_forward_bf16_every_plan_equals_plain(dev, vec):
    imgs, rects = _case(dev, 8, 3, 48, 37, 2)
    imgs = imgs.bfloat16()
    want = mf.masked_fill_reference(imgs, rects, 0.5)
    for group in (1, 5, 32):
        for stream in (False, True):
            plan = mf.FwdPlan(vec, group, stream)
            got = mf._fwd_launch(imgs, rects, 0.5, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan
    with pytest.raises(ValueError, match="elements a lane"):
        mf._fwd_launch(imgs, rects, 0.5, mf.FwdPlan(4, 8, False))


@pytest.mark.parametrize("img,k,s,cout,ratio,masks",
                         [(32, 3, 1, 64, 0.12, 3), (224, 7, 2, 64, 0.12, 12),
                          (224, 7, 2, 64, 0.06, -13),
                          (480, 7, 2, 64, 0.12, 12),
                          (480, 7, 2, 64, 0.015, -5)])
def test_stem_fold_kernel_bf16_matches_plain(dev, img, k, s, cout, ratio,
                                             masks):
    """Kernel C's bf16 form against the plain fold on the same bf16
    operands: both accumulate in float32 and round the delta, then the sum,
    to bf16, so they differ by the summation order alone: within one ulp of
    the output and one of the delta."""
    rng = np.random.default_rng(img + k + 1)
    pads = ((1, 1), (1, 1)) if k == 3 else \
        (sf.same_pads(img, k, s), sf.same_pads(img, k, s))
    h_out = (img + sum(pads[0]) - k) // s + 1

    def bf(a):
        return torch.as_tensor(a, dtype=torch.bfloat16, device=dev)

    kern = bf(rng.normal(0, 0.3, (k, k, 3, cout)))
    clean = bf(rng.normal(0, 1, (4, h_out, h_out, cout)))
    u = bf(rng.uniform(-1, 1, (4, img, img, 3)))
    singles, _ = tmasks.mask_sets(tmasks.geometry(img, ratio))
    plan = sf.plan_windows(singles, img, k, s, pads)
    plan = plan[:masks] if masks > 0 else plan[masks:]
    oh, ow, geo, occ = sf._uniform_plan(plan, h_out, h_out, k, s)
    args = (kern, clean, sf.pad_for_kernel(u, pads, s),
            torch.as_tensor(geo, device=dev), bf(occ), oh, ow, s)
    _backend.reset_launch_counts()
    got = sf.fold_masked_stem_kernel(*args)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["stem_fold_bf16"] == 1
    assert _backend.launch_counts()["stem_fold"] == 0
    want = sf.fold_masked_stem(kern, clean, u, plan, (s, s), pads)
    assert got.dtype == want.dtype == torch.bfloat16
    delta = want.float() - clean[:, None].float()
    err = (got.float() - want.float()).abs()
    assert (err <= _ulp16(want) + _ulp16(delta)).all(), float(err.max())
    assert torch.equal(sf.fold_masked_stem_kernel(*args), got)


def _gn_case16(dev, seed, shape):
    x, s, b, dy = _gn_case(dev, seed, shape)
    return x.bfloat16(), s, b, dy.bfloat16()


def _check_gn_bf16(x, s, b, dy, y, mean, rstd, dx, ds, db):
    """The bf16 kernels' outputs against the plain versions on the same bf16
    inputs (statistics and arithmetic in float32, y and dx rounded once):
    the statistics within 1e-5, y within one bf16 ulp and 1e-5, dx away
    from ReLU gates within that and the gate-flip bound, the float32
    parameter cotangents as in the float32 tests."""
    assert (y.dtype, dx.dtype, mean.dtype, ds.dtype) == \
        (torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
    m32, r32 = fgn.gn_stats_reference(x, 32)
    torch.testing.assert_close(mean, m32, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, r32, rtol=1e-5, atol=0)
    want = fgn.gn_relu_reference(x, s, b)
    err = (y.float() - want.float()).abs()
    assert (err <= _ulp16(want) + 1e-5).all(), float(err.max())
    wdx, wds, wdb = fgn.gn_relu_backward_reference(x, dy, s, b, mean, rstd)
    near, dx_b, ds_b, db_b = fgn.gate_flip_bounds(x, dy, s, b, mean, rstd)
    keep = ~near
    err = (dx.float() - wdx.float()).abs()[keep]
    assert (err <= _ulp16(wdx)[keep] + 1e-5 + dx_b[keep]).all(), \
        float(err.max())
    assert ((ds - wds).abs() <= 1e-3 + 1e-5 * wds.abs() + ds_b).all()
    assert ((db - wdb).abs() <= 1e-3 + 1e-5 * wdb.abs() + db_b).all()


@pytest.mark.parametrize("shape", [(8, 28, 28, 128), (16, 7, 7, 2048),
                                   (2, 56, 56, 256), (2, 56, 56, 64)])
def test_gn_bf16_kernels_match_plain_bf16(dev, shape):
    """Kernels D and F in bf16 against the plain versions on the same bf16
    inputs (statistics and arithmetic in float32, y and dx rounded once):
    within one bf16 ulp and 1e-5 (float32 statistics summed in another
    order); dx away from ReLU gates within 1e-5 of a flip, the parameter
    cotangents (float32) as in the float32 tests. Both repeat bit for
    bit."""
    x, s, b, dy = _gn_case16(dev, 6, shape)
    n, h, w, c = shape
    for d in ("fwd", "bwd"):
        assert fgn.gn_plan(d, n, h * w, c, 32, 2).route == "one_pass"
    _backend.reset_launch_counts()
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    dx, ds, db = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd)
    torch.cuda.synchronize()
    assert _backend.route_counts() == {"gn_relu_fwd_bf16/one_pass": 1,
                                       "gn_relu_bwd_bf16/one_pass": 1}
    _check_gn_bf16(x, s, b, dy, y, mean, rstd, dx, ds, db)
    assert all(torch.equal(p, q) for p, q in
               zip(fgn.gn_relu_fwd_kernel(x, s, b), (y, mean, rstd)))
    assert all(torch.equal(p, q) for p, q in zip(
        fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd), (dx, ds, db)))


def test_gn_bf16_autograd_and_shared_memory(dev):
    """`gn_relu` on bf16 x with bf16 affine parameters: the bf16 kernels'
    launch counts, cotangents in the parameters' type, and the bf16 shared
    memory formula against the kernels' own."""
    from dorpatch_tpu_torch.ops import _build

    x, s, b, dy = _gn_case16(dev, 7, (2, 8, 8, 64))
    leaves = [x.clone().requires_grad_(True),
              s.bfloat16().requires_grad_(True),
              b.bfloat16().requires_grad_(True)]
    _backend.reset_launch_counts()
    got = torch.autograd.grad((fgn.gn_relu(*leaves).float() * dy.float())
                              .sum(), leaves)
    counts = _backend.launch_counts()
    assert (counts["gn_relu_fwd_bf16"], counts["gn_relu_bwd_bf16"],
            counts["gn_relu_fwd"], counts["gn_relu_bwd"]) == (1, 1, 0, 0)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    lib = _build.library()
    for hw, c in sorted(RN50_GN):
        for direction, slabs in (("fwd", 1), ("bwd", 2)):
            p = fgn.gn_plan(direction, 2, hw, c, 32, 2)
            assert lib.dp_gn_onepass_smem_bf16(hw, p.width, p.cluster,
                                               slabs) == p.smem


# Kernels E and G in bf16 (the split route): slabs whose chunk fits no
# cluster (256*256 rows both ways; RN50's 480 px stage-1 slab [N, 14400, 256],
# split backward only), and the split route forced on smaller slabs: a piece
# of 8 channels over groups of 3 (C = 96), a ragged last tile (HW = 81) and
# more piece columns than one statistics block (C = 1024).
GN_SPLIT16_SHAPES = [((1, 256, 256, 64), False), ((2, 120, 120, 256), False),
                     ((2, 5, 5, 96), True), ((3, 9, 9, 64), True),
                     ((2, 8, 8, 1024), True)]
SPLIT = fgn.GNPlan("split", 0, 0, 0)


@pytest.mark.parametrize("shape,forced", GN_SPLIT16_SHAPES)
def test_gn_bf16_split_kernels_match_plain_bf16(dev, shape, forced):
    """Kernels E and G in bf16 against the plain bf16 versions, as D and F
    are held; both repeat bit for bit, and each launch counts under its
    route."""
    x, s, b, dy = _gn_case16(dev, 8, shape)
    n, h, w, c = shape
    plans = {d: SPLIT if forced else fgn.gn_plan(d, n, h * w, c, 32, 2)
             for d in ("fwd", "bwd")}
    assert plans["bwd"].route == "split"
    _backend.reset_launch_counts()
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b, plan=plans["fwd"])
    dx, ds, db = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd,
                                        plan=plans["bwd"])
    torch.cuda.synchronize()
    assert _backend.route_counts() == {
        f"gn_relu_fwd_bf16/{plans['fwd'].route}": 1,
        "gn_relu_bwd_bf16/split": 1}
    _check_gn_bf16(x, s, b, dy, y, mean, rstd, dx, ds, db)
    assert all(torch.equal(p, q) for p, q in zip(
        fgn.gn_relu_fwd_kernel(x, s, b, plan=plans["fwd"]), (y, mean, rstd)))
    assert all(torch.equal(p, q) for p, q in zip(
        fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=plans["bwd"]),
        (dx, ds, db)))
    dx_only = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, params=False,
                                     plan=plans["bwd"])
    assert dx_only[1] is None and torch.equal(dx_only[0], dx)


@pytest.mark.parametrize("shape", [(2, 5, 5, 96), (2, 56, 56, 64)])
def test_gn_bf16_split_and_one_pass_routes_agree(dev, shape):
    """The two routes compute one function: normalize in float32 and round
    once. Their statistics are summed in other orders, so y and dx may
    differ by one bf16 ulp and 1e-5 (dx away from gate flips)."""
    x, s, b, dy = _gn_case16(dev, 9, shape)
    n, h, w, c = shape
    one = {d: fgn.gn_plan(d, n, h * w, c, 32, 2) for d in ("fwd", "bwd")}
    assert one["fwd"].route == one["bwd"].route == "one_pass"
    y1, m1, r1 = fgn.gn_relu_fwd_kernel(x, s, b, plan=one["fwd"])
    y2, m2, r2 = fgn.gn_relu_fwd_kernel(x, s, b, plan=SPLIT)
    torch.testing.assert_close(m2, m1, rtol=0, atol=1e-5)
    torch.testing.assert_close(r2, r1, rtol=1e-5, atol=0)
    err = (y2.float() - y1.float()).abs()
    assert (err <= _ulp16(y1) + 1e-5).all(), float(err.max())
    dx1, _, _ = fgn.gn_relu_bwd_kernel(x, dy, s, b, m1, r1, params=False,
                                       plan=one["bwd"])
    dx2, _, _ = fgn.gn_relu_bwd_kernel(x, dy, s, b, m1, r1, params=False,
                                       plan=SPLIT)
    torch.cuda.synchronize()
    near = fgn.gate_flip_bounds(x, dy, s, b, m1, r1)[0]
    err = (dx2.float() - dx1.float()).abs()[~near]
    assert (err <= _ulp16(dx1)[~near] + 1e-5).all(), float(err.max())


def test_gn_split_scratch_matches_the_kernels_tiles(dev):
    """The split route has no partial-sum scratch: its statistics passes
    add their sums up over clusters. Every plan `fused_gn.split_plan` gives
    at the split route's shapes (both directions, both types) lies within
    the C entries' own limits and launches; a chunk that splits a group,
    one wider than kSplitMaxW, one that does not divide C and a cluster
    above kSplitMaxCluster are refused by the C entry. The C entry that
    counts kernel E's co-resident clusters (`gn_bench.py --split`) answers
    for every cluster size the kernels take and refuses a larger one."""
    from dorpatch_tpu_torch.ops import _build

    assert "dp_gn_tiles" not in _build.SIGNATURES
    lib = _build.library()
    for bf16 in (0, 1):
        held = [lib.dp_gn_fwd_split_clusters(cl, bf16)
                for cl in range(1, fgn.SPLIT_MAX_CLUSTER + 1)]
        assert held[0] >= 1 and all(h >= 1 for h in held)
        assert lib.dp_gn_fwd_split_clusters(fgn.SPLIT_MAX_CLUSTER + 1,
                                            bf16) < 0
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.empty((), dtype=dtype).element_size()
        for n, hw, c in ((128, 14400, 64), (128, 14400, 256),
                         (4, 65536, 64), (1, 225, 96), (3, 49, 1024)):
            for d in ("fwd", "bwd"):
                w, cl = fgn.split_plan(d, n, hw, c, 32, isz)
                assert w <= fgn.SPLIT_MAX_WIDTH and w % (c // 32) == 0
                assert c % w == 0 and w % fgn.piece_channels(isz) == 0
                assert 1 <= cl <= min(fgn.SPLIT_MAX_CLUSTER, hw)
        x, s, b, dy = _gn_case(dev, 15, (1, 8, 8, 512))
        x, dy = x.to(dtype), dy.to(dtype)
        _, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
        for width, cluster in ((16, 1), (256, 16), (64, 8)):
            plan = fgn.GNPlan("split", width, cluster, 0)
            fgn.gn_relu_fwd_kernel(x, s, b, plan=plan)
            fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=plan)
        torch.cuda.synchronize()
        for width, cluster in ((12, 1), (512, 1), (48, 1), (16, 32)):
            plan = fgn.GNPlan("split", width, cluster, 0)
            with pytest.raises(RuntimeError, match="gn_relu_fwd"):
                fgn.gn_relu_fwd_kernel(x, s, b, plan=plan)
            with pytest.raises(RuntimeError, match="gn_relu_bwd"):
                fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=plan)


def _check_gn_forward(x, s, b, y, mean, rstd):
    """A forward's outputs under the GroupNorm gates: float32 against the
    float64 plain version (mean atol 1e-6, rstd rtol 1e-5, y 1e-5); bf16
    against the plain bf16 version on the same inputs (statistics within
    1e-5, y within one bf16 ulp and 1e-5) and against float64 within the
    float32 gates plus half a bf16 ulp (its one rounding)."""
    assert (y.dtype, mean.dtype, rstd.dtype) == (x.dtype, torch.float32,
                                                 torch.float32)
    x64, s64, b64 = x.double(), s.double(), b.double()
    m64, r64 = fgn.gn_stats_reference(x64, 32)
    torch.testing.assert_close(mean.double(), m64, rtol=0, atol=1e-6)
    torch.testing.assert_close(rstd.double(), r64, rtol=1e-5, atol=0)
    want = fgn.gn_relu_reference(x64, s64, b64)
    half = 0.5 * _ulp16(want).double() if x.dtype == torch.bfloat16 else 0.0
    err = (y.double() - want).abs()
    assert (err <= 1e-5 + 1e-5 * want.abs() + half).all(), float(err.max())
    if x.dtype == torch.bfloat16:
        m32, r32 = fgn.gn_stats_reference(x, 32)
        torch.testing.assert_close(mean, m32, rtol=0, atol=1e-5)
        torch.testing.assert_close(rstd, r32, rtol=1e-5, atol=0)
        want = fgn.gn_relu_reference(x, s, b)
        err = (y.float() - want.float()).abs()
        assert (err <= _ulp16(want) + 1e-5).all(), float(err.max())


def _e_case(dev, dtype, seed, shape):
    x, s, b, _ = _gn_case(dev, seed, shape)
    return x.to(dtype), s, b


# Kernel E (the forward split route) in both types: the [4, 65536, 64]
# split slab on its own plan; RN50's three 480 px stage-1 shapes forced to
# the split route with the plans of the attack step's N = 128, on N = 3;
# HW that no cluster share divides (15*15 over 16 CTAs: the last has no
# row; 127*127 over 16, 8 and 2), groups of 3 channels (C = 96) and more
# piece columns than a block (C = 1024); (width, cluster) or None for the
# plan of the shape itself.
GN_E_CASES = [((4, 256, 256, 64), None),
              ((3, 120, 120, 64), ("fwd", 128, 14400, 64)),
              ((3, 120, 120, 128), ("fwd", 128, 14400, 128)),
              ((3, 120, 120, 256), ("fwd", 128, 14400, 256)),
              ((2, 15, 15, 64), (16, 16)), ((1, 127, 127, 64), (16, 16)),
              ((2, 127, 127, 256), (64, 8)), ((1, 127, 127, 96), (24, 2)),
              ((2, 8, 8, 1024), None), ((5, 9, 9, 256), (256, 1))]


def _e_plan(shape, split, isz):
    n, h, w, c = shape
    if split is None:
        return fgn.GNPlan("split", *fgn.split_plan("fwd", n, h * w, c, 32,
                                                   isz), 0)
    if split[0] == "fwd":
        return fgn.GNPlan("split", *fgn.split_plan(*split, 32, isz), 0)
    return fgn.GNPlan("split", *split, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,split", GN_E_CASES)
def test_gn_split_forward_matches_plain(dev, dtype, shape, split):
    """Kernel E's statistics over a cluster and its y: under the GroupNorm
    gates (`_check_gn_forward`) and bit-equal on a repeat; each launch
    counts under the split route."""
    x, s, b = _e_case(dev, dtype, 16, shape)
    plan = _e_plan(shape, split, x.element_size())
    kind = "_bf16" if dtype == torch.bfloat16 else ""
    _backend.reset_launch_counts()
    got = fgn.gn_relu_fwd_kernel(x, s, b, plan=plan)
    torch.cuda.synchronize()
    assert _backend.route_counts() == {f"gn_relu_fwd{kind}/split": 1}
    _check_gn_forward(x, s, b, *got)
    again = fgn.gn_relu_fwd_kernel(x, s, b, plan=plan)
    assert all(torch.equal(p, q) for p, q in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_split_forward_every_sweep_plan_matches_plain(dev, dtype):
    """Every plan `gn_bench.py --split --sweep` tries for the forward split
    route (rows of 64 bytes or more over clusters of 1 to 16), at a shape
    of several chunks: each within the GroupNorm gates."""
    from dorpatch_tpu_torch.gn_bench import _sweep_plans

    shape = (2, 40, 40, 256)
    x, s, b = _e_case(dev, dtype, 17, shape)
    isz = x.element_size()
    plans = [p for d, p in _sweep_plans(fgn, 2, 1600, 256, isz, True)
             if d == "fwd" and p.route == "split"]
    assert len(plans) >= 19
    for plan in plans:
        got = fgn.gn_relu_fwd_kernel(x, s, b, plan=plan)
        torch.cuda.synchronize()
        _check_gn_forward(x, s, b, *got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 56, 56, 64), (3, 28, 28, 256),
                                   (1, 7, 7, 96), (2, 120, 120, 64)])
def test_gn_split_and_one_pass_forward_agree(dev, dtype, shape):
    """Kernels D and E compute one function from statistics summed in
    other orders: mean within 1e-6 (bf16 1e-5), rstd within 1e-5, y within
    1e-5 (bf16: one ulp and 1e-5) of each other."""
    x, s, b = _e_case(dev, dtype, 18, shape)
    n, h, w, c = shape
    one = fgn.gn_plan("fwd", n, h * w, c, 32, x.element_size())
    assert one.route == "one_pass"
    y1, m1, r1 = fgn.gn_relu_fwd_kernel(x, s, b, plan=one)
    y2, m2, r2 = fgn.gn_relu_fwd_kernel(x, s, b, plan=SPLIT)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(m2, m1, rtol=0, atol=1e-5 if bf16 else 1e-6)
    torch.testing.assert_close(r2, r1, rtol=1e-5, atol=0)
    err = (y2.float() - y1.float()).abs()
    tol = (_ulp16(y1) if bf16 else 1e-5 * y1.abs()) + 1e-5
    assert (err <= tol).all(), float(err.max())


def test_gn_split_forward_refuses_a_plan_it_does_not_take(dev):
    """A chunk that splits a group, one wider than kSplitMaxW, one that does
    not divide C, a cluster above 16 and one above the rows are refused by
    the kernels' own check."""
    x, s, b = _e_case(dev, torch.float32, 19, (1, 3, 3, 512))
    for width, cluster in ((12, 1), (512, 1), (48, 1), (16, 32), (16, 10)):
        with pytest.raises(RuntimeError, match="gn_relu_fwd"):
            fgn.gn_relu_fwd_kernel(x, s, b,
                                   plan=fgn.GNPlan("split", width, cluster, 0))


# Kernel G (the backward split route) in both types, at its default plans
# (`fused_gn.split_plan`) and at forced ones, (width, cluster): HW off
# the dx pass's row blocks (81, 225, 14400), cg 2 (C 64) and cg 8 (C 256),
# N 1 and 128, the [4, 65536, 64] slab (chunks of 16 or 32 channels over
# clusters of 16), one CTA and no cluster, and a cluster of 16 over few rows.
GN_G_CASES = [((1, 9, 9, 64), None), ((3, 9, 9, 256), (32, 2)),
              ((128, 15, 15, 64), None), ((2, 120, 120, 256), None),
              ((1, 120, 120, 64), (64, 1)), ((4, 256, 256, 64), None),
              ((2, 7, 7, 256), (256, 16))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,split", GN_G_CASES)
def test_gn_split_backward_matches_plain(dev, dtype, shape, split):
    """The statistics pass with its combine over a cluster, and the dx
    pass: float32 against the float64 plain version, bf16 against the plain
    bf16 version (as `_check_gn_backward` and `_check_gn_bf16` hold them);
    bit-equal on a repeat; without the parameter cotangents the same dx."""
    bf16 = dtype == torch.bfloat16
    x, s, b, dy = (_gn_case16 if bf16 else _gn_case)(dev, 12, shape)
    plan = fgn.GNPlan("split", *(split or (0, 0)), 0)
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    _backend.reset_launch_counts()
    got = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=plan)
    torch.cuda.synchronize()
    kind = "_bf16" if bf16 else ""
    assert _backend.route_counts() == {f"gn_relu_bwd{kind}/split": 1}
    if bf16:
        _check_gn_bf16(x, s, b, dy, y, mean, rstd, *got)
    else:
        _check_gn_backward(x, dy, s, b, mean, rstd, got)
    again = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=plan)
    assert all(torch.equal(p, q) for p, q in zip(again, got))
    dx_only = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, params=False,
                                     plan=plan)
    assert dx_only[1] is None and dx_only[2] is None
    assert torch.equal(dx_only[0], got[0])


@pytest.mark.parametrize("shape", [(2, 56, 56, 64), (3, 28, 28, 256),
                                   (1, 7, 7, 96)])
def test_gn_split_and_one_pass_backward_agree(dev, shape):
    """Kernels F and G in float32 compute one dx formula (the group sums
    divided by the count once, in float64) from sums taken in other
    orders: within 1e-5 of each other away from gate flips, and the
    parameter cotangents within 1e-3."""
    x, s, b, dy = _gn_case(dev, 13, shape)
    n, h, w, c = shape
    one = fgn.gn_plan("bwd", n, h * w, c)
    assert one.route == "one_pass"
    _, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    dx1, ds1, db1 = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd, plan=one)
    dx2, ds2, db2 = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd,
                                           plan=SPLIT)
    torch.cuda.synchronize()
    near = fgn.gate_flip_bounds(x, dy, s, b, mean, rstd)[0]
    torch.testing.assert_close(dx2[~near], dx1[~near], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ds2, ds1, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(db2, db1, rtol=1e-5, atol=1e-3)


def test_gn_split_backward_refuses_a_plan_it_does_not_take(dev):
    """A chunk that splits a group, one wider than kSplitMaxW and a
    cluster above 16 are refused by the kernels' own check."""
    x, s, b, dy = _gn_case(dev, 14, (1, 8, 8, 512))
    _, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    for width, cluster in ((12, 1), (512, 1), (16, 32)):
        with pytest.raises(RuntimeError, match="gn_relu_bwd"):
            fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd,
                                   plan=fgn.GNPlan("split", width, cluster, 0))


def test_resnetv2_bf16_victim_on_card_matches_cpu(dev):
    """The full-depth ResNetV2-50x1's once-cast bf16 copy on the card (49
    launches of kernel D's bf16 form a forward) against the same bf16 copy
    on the CPU, which runs the kernels' numerics in plain PyTorch; bf16
    convolutions sum in other orders on the two, so the logits are held to
    the bf16-against-float32 drift measured on the CPU, and the argmax to
    agree wherever the CPU's top-2 margin exceeds twice that drift."""
    from dorpatch_tpu_torch import utils
    from dorpatch_tpu_torch.models import get_model

    cpu = get_model("imagenet", "resnetv2", "/nonexistent", 64, device="cpu")
    gpu = get_model("imagenet", "resnetv2", "/nonexistent", 64, device=dev)
    x = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want32 = cpu.apply(x)
        want = cpu.apply.at(torch.bfloat16)(x)
        _backend.reset_launch_counts()
        got = gpu.apply.at(torch.bfloat16)(x.to(dev)).cpu()
    assert _backend.route_counts() == {"gn_relu_fwd_bf16/one_pass": 49}
    drift = float((want - want32).abs().max())
    assert float((got - want).abs().max()) <= drift
    p, m = utils.preds_margins(want)
    sure = m > 2 * drift
    assert torch.equal(got.argmax(-1)[sure], p[sure].long())


def _kv_check16(args):
    """Kernel H's bf16 form against the plain version on the same bf16
    inputs (float32 logits and softmax, output rounded once): the kernel
    also rounds the weights to bf16 for P.V, which moves an output by at
    most 2^-8 of the largest |v| of its row's keys; plus one ulp of the
    output for the two roundings."""
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    got = mka.masked_kv_attention_kernel(*args)
    torch.cuda.synchronize()
    want = mka.masked_kv_attention_reference(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    vmax = max(float(args[2].float().abs().max()),
               float(args[4].float().abs().max()))
    err = (got.float() - want.float()).abs()
    assert (err <= _ulp16(want) + 2.0 ** -8 * vmax).all(), float(err.max())
    assert torch.equal(mka.masked_kv_attention_kernel(*args), got)
    return got, want


@pytest.mark.parametrize("shape", [(2, 36, 50, 12, 64, 197),
                                   (2, 64, 99, 12, 64, 197),
                                   (3, 4, 17, 4, 32, 65),
                                   (1, 3, 20, 2, 64, 257),
                                   (2, 13, 1, 3, 64, 197),
                                   (1, 3, 20, 2, 64, 1000)])
def test_masked_kv_attention_bf16_matches_plain(dev, shape):
    """The ViT-B/16 bank's phase-1 and pair-audit chunks, `cifar_vit`'s
    head width, a long clean group (T 257), one dirty row an entry, and a
    clean group too long to stage (T 1000: read from device memory);
    within the JAX package's bar of 0.06 of the float32 plain version on
    the float32 inputs as well. Each launch counts under its shape class."""
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    args32 = _kv_case(dev, 9, *shape)
    args = tuple(a.bfloat16() for a in args32)
    _backend.reset_launch_counts()
    got = mka.masked_kv_attention(*args)
    counts = _backend.launch_counts()
    assert (counts["masked_kv_attn_bf16"], counts["masked_kv_attn"]) == (1, 0)
    assert _backend.route_counts() == {f"masked_kv_attn_bf16/S{shape[2]}": 1}
    got, _ = _kv_check16(args)
    want32 = mka.masked_kv_attention_reference(*args32)
    assert float((got.float() - want32).abs().max()) <= 0.06


def test_masked_kv_attention_bf16_only_dirty_slot_zero_live(dev):
    args = list(_kv_case(dev, 10, 2, 6, 50, 4, 64, 197))
    args[5][:, ::2] = -1e9
    args[6][:, ::2, 1:] = -1e9
    args = tuple(a.bfloat16() for a in args)
    got, _ = _kv_check16(args)
    want = args[2][:, ::2, :1].expand(-1, -1, 50, -1, -1)
    assert torch.equal(got[:, ::2], want)


# Kernel H's bf16 form at forced block plans, (entries G, per phase E,
# warps, clean group staged): G not dividing C, phases of E entries through
# both dirty slots and back, fewer warps than a phase's items; S 1, 17, 50
# and 99 (ragged 16-row items), T off the 32-key steps; the clean group
# read from device memory.
KV16_PLANS = [((2, 13, 17, 3, 64, 70), (5, 2, 3, 1)),
              ((1, 9, 1, 2, 32, 33), (4, 3, 2, 1)),
              ((2, 7, 99, 2, 64, 197), (3, 1, 7, 1)),
              ((1, 11, 50, 2, 64, 197), (11, 2, 5, 1)),
              ((1, 6, 50, 4, 32, 65), (6, 2, 8, 1)),
              ((2, 7, 99, 2, 64, 197), (3, 1, 7, 0)),
              ((1, 9, 17, 2, 32, 65), (4, 2, 4, 0))]


@pytest.mark.parametrize("shape,plan", KV16_PLANS)
def test_masked_kv_attention_bf16_every_plan_matches_plain(dev, shape, plan):
    """Every plan runs each 16-row item the same way, so its output equals
    the default plan's bit for bit, and the plain bf16 version's within the
    bf16 tolerance."""
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    b, c, s, h, f, t = shape
    g, e, warps, clean = plan
    slots = min(mka.MAX_SLOTS, -(-min(g, c) // e))
    forced = mka.Bf16Plan(g, e, warps, clean,
                          mka.bf16_smem(t, s, f, e, slots, clean))
    args = tuple(a.bfloat16() for a in _kv_case(dev, 11, *shape))
    got = mka.masked_kv_attention_kernel(*args, plan=forced)
    got_default, _ = _kv_check16(args)
    assert torch.equal(got, got_default)
    assert torch.equal(mka.masked_kv_attention_kernel(*args, plan=forced),
                       got)


def test_masked_kv_attention_bf16_carve_matches_the_kernel(dev):
    """`bf16_smem` counts the kernel's own carve, and a plan short of it is
    refused by the kernel's check."""
    from dorpatch_tpu_torch.ops import _build
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    lib = _build.library()
    for t, s, f, e, slots, clean in ((197, 99, 64, 1, 2, 1),
                                     (197, 50, 64, 2, 2, 1),
                                     (65, 17, 32, 4, 1, 1),
                                     (33, 1, 32, 8, 2, 1),
                                     (1000, 20, 64, 1, 2, 0)):
        assert lib.dp_masked_kv_attn_bf16_smem(t, s, f, e, slots, clean) == \
            mka.bf16_smem(t, s, f, e, slots, clean)
    args = tuple(a.bfloat16() for a in _kv_case(dev, 12, 1, 4, 17, 2, 64, 70))
    plan = mka.bf16_plan(1, 4, 17, 2, 70, 64, 132)
    with pytest.raises(RuntimeError, match="masked_kv_attn_bf16"):
        mka.masked_kv_attention_kernel(*args,
                                       plan=plan._replace(smem=plan.smem - 16))


def test_bf16_bank_on_card_equals_cpu(dev):
    """The bf16 certify bank (kernel A's bf16 form in phase 1 and the pair
    audit) on the trigger detector gives the CPU's bf16 records and the
    float32 bank's verdicts; its one-hot margins of 1 escalate nothing."""
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser

    x = np.full((4, 32, 32, 3), 0.5, np.float32)
    x[1, 4:8, 4:8] = 1.0
    x[2, 4:8, 4:8] = 1.0
    x[2, 24:28, 24:28] = 1.0
    x[3, 4:8, 4:8] = 1.0
    x[3, 4:8, 24:28] = 0.0
    spec = tmasks.geometry(32, 0.1)
    cfg = DefenseConfig(ratios=(0.1,), compute_dtype="bfloat16")
    want = PatchCleanser(_trigger, spec, cfg, device="cpu").robust_predict(
        torch.as_tensor(x), 3, bucket_sizes=(1, 8))
    _backend.reset_launch_counts()
    pc = PatchCleanser(_trigger, spec, cfg, device=dev)
    got = pc.robust_predict(torch.as_tensor(x, device=dev), 3,
                            bucket_sizes=(1, 8))
    counts = _backend.launch_counts()
    assert counts["masked_fill_fwd_bf16"] > 0
    assert counts["masked_fill_fwd"] == 0
    np.testing.assert_allclose(pc.last_min_margin, 1.0)
    for g, w in zip(got, want):
        assert (g.prediction, g.certification, g.forwards) == \
            (w.prediction, w.certification, w.forwards)
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        np.testing.assert_array_equal(g.preds_2, w.preds_2)
    assert [(r.prediction, r.certification) for r in got] == \
        [(0, True), (0, False), (1, False), (1, False)]


# -- kernel C's bf16 form on the tensor cores: its launch plans, channel
#    passes and shared-memory carve --


def _stem16_case(dev, img, k, s, cout, ratio, masks, b=2):
    rng = np.random.default_rng(img + k + cout)
    pads = ((1, 1), (1, 1)) if k == 3 else \
        (sf.same_pads(img, k, s), sf.same_pads(img, k, s))
    h_out = (img + sum(pads[0]) - k) // s + 1

    def bf(a):
        return torch.as_tensor(a, dtype=torch.bfloat16, device=dev)

    kern = bf(rng.normal(0, 0.3, (k, k, 3, cout)))
    clean = bf(rng.normal(0, 1, (b, h_out, h_out, cout)))
    u = bf(rng.uniform(-1, 1, (b, img, img, 3)))
    singles, _ = tmasks.mask_sets(tmasks.geometry(img, ratio))
    plan = sf.plan_windows(singles, img, k, s, pads)
    plan = plan[:masks] if masks > 0 else plan[masks:]
    oh, ow, geo, occ = sf._uniform_plan(plan, h_out, h_out, k, s)
    args = (kern, clean, sf.pad_for_kernel(u, pads, s),
            torch.as_tensor(geo, device=dev), bf(occ), oh, ow, s)
    want = sf.fold_masked_stem(kern, clean, u, plan, (s, s), pads)
    return args, want


@pytest.mark.parametrize("img,k,s,cout,ratio,masks",
                         [(224, 7, 2, 64, 0.12, 12), (32, 3, 1, 72, 0.12, 3),
                          (64, 7, 2, 128, 0.06, -5), (32, 3, 1, 8, 0.06, 4)])
def test_stem_fold_kernel_bf16_every_plan_equals_default(dev, img, k, s, cout,
                                                         ratio, masks):
    """Kernel C's bf16 form under every launch plan `stem_bench.py
    --sweep` tries (copy lanes, mask groups, m-tiles, store policies): the same
    bits as the default plan, which holds the plain
    version within one ulp of the output and one of the delta; channels
    in two passes of 64 and 8 (72: an odd n-tile) or 64 and 64 (128), and
    one n-tile (8)."""
    args, want = _stem16_case(dev, img, k, s, cout, ratio, masks)
    got = sf.fold_masked_stem_kernel(*args)
    torch.cuda.synchronize()
    delta = want.float() - args[1][:, None].float()
    err = (got.float() - want.float()).abs()
    assert (err <= _ulp16(want) + _ulp16(delta)).all(), float(err.max())
    n = args[4].shape[0]
    for lanes in (1, 2, 4):
        for group in sorted({1, 2, 4, n}):
            for mtiles in (1, 2):
                for stream in (False, True):
                    plan = sf.Bf16FoldPlan(lanes, min(group, n), mtiles,
                                           stream)
                    other = sf.fold_masked_stem_kernel(*args, plan=plan)
                    torch.cuda.synchronize()
                    assert torch.equal(other, got), plan
    for bad in (sf.Bf16FoldPlan(5, 1, 1, False),
                sf.Bf16FoldPlan(1, 1, 3, False)):
        with pytest.raises(ValueError, match="lanes"):
            sf.fold_masked_stem_kernel(*args, plan=bad)


def test_stem_fold_bf16_smem_formula_matches_the_kernel(dev):
    from dorpatch_tpu_torch.ops import _build

    lib = _build.library()
    for cin, ow, c, k, s in ((3, 16, 64, 3, 1), (3, 54, 64, 7, 2),
                             (3, 112, 64, 7, 2), (3, 5, 72, 7, 2),
                             (3, 240, 128, 7, 2), (4, 1, 8, 3, 1)):
        for mtiles in (1, 2):
            assert lib.dp_stem_fold_bf16_smem(cin, ow, c, k, s, mtiles) == \
                sf.bf16_smem(cin, ow, c, k, s, mtiles)


@pytest.mark.parametrize("s", [1, 36, 63, 126])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_fill_forward_bf16_every_sweep_plan_equals_plain(dev, s, k):
    """Kernel A's bf16 form bit-equal to its plain version under every plan
    `fill_bench.py --dtype bfloat16 --sweep` tries (1, 2, 4 or 8 lanes a
    thread; 1, 2, 4, 8, 16, 32 or all S masks a block, up to 64; both
    store policies) and its default plan, at an image of several tiles;
    the scalar route (a 15 px image) under its own plans."""
    imgs, rects = _case(dev, 11 + s + k, 2, 48, s, k)
    imgs = imgs.bfloat16()
    want = mf.masked_fill_reference(imgs, rects, 0.5)
    assert torch.equal(mf.masked_fill_fwd_kernel(imgs, rects, 0.5), want)
    small, rects15 = _case(dev, 12 + s + k, 2, 15, s, k)
    small = small.bfloat16()
    want15 = mf.masked_fill_reference(small, rects15, 0.5)
    for lanes in (1, 2, 4, 8):
        for group in sorted({g for g in (1, 2, 4, 8, 16, 32, s)
                             if g <= min(s, mf.MAX_GROUP16)}):
            for stream in (False, True):
                plan = mf.FwdPlan(8, group, stream, lanes)
                got = mf._fwd_launch(imgs, rects, 0.5, plan)
                torch.cuda.synchronize()
                assert torch.equal(got, want), plan
                got = mf._fwd_launch(small, rects15, 0.5,
                                     plan._replace(vec=1))
                torch.cuda.synchronize()
                assert torch.equal(got, want15), plan


@pytest.mark.parametrize("arch", ["cifar_resnet18", "cifar_vit"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """One victim-training step (`train.train_step`, batch 32) on the card
    against the same step on the CPU, from one init, batch and augment
    draws: loss within rtol 1e-5, accuracy equal; the updated weights
    within rtol 1e-5, atol 1e-6 where the element's gradient is at least
    1e-3 of its tensor's largest; elsewhere within twice the step's rate
    (Adam's first step is lr * g / (|g| + eps): a gradient at rounding
    level takes a full step of either sign on either device)."""
    from dorpatch_tpu_torch import data as tdata
    from dorpatch_tpu_torch import train, utils
    from dorpatch_tpu_torch.models import registry

    utils.configure_numerics()
    cfg = train.TrainConfig(arch=arch)
    lr = cfg.lr
    imgs, labels = tdata.procedural_arrays("cifar10", 4, 32, seed=3)
    x = torch.as_tensor(train.quantize(imgs[:32]))
    y = torch.as_tensor(labels[:32])
    off, flip = train.draw_augment(utils.generator(0, torch.device("cpu")),
                                   32)
    out = {}
    for d in (torch.device("cpu"), dev):
        model = registry.build_bare_model(arch, 10, 32, seed=0).to(d)
        opt = train.make_optimizer(cfg, model)
        loss, acc = train.train_step(model, opt, lr, x.to(d), y.to(d),
                                     off.to(d), flip.to(d),
                                     cfg.label_smoothing)
        sq = {n: opt.state[p]["exp_avg_sq"].cpu()
              for n, p in model.named_parameters()}
        out[d.type] = (float(loss), float(acc),
                       {k: v.cpu() for k, v in model.state_dict().items()},
                       sq)
    (l0, a0, w0, sq), (l1, a1, w1, _) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-5 * l0 and a1 == a0
    for k, want in w0.items():
        r = sq[k].sqrt()
        sure = r >= 1e-3 * r.max()
        torch.testing.assert_close(w1[k][sure], want[sure], rtol=1e-5,
                                   atol=1e-6)
        assert float((w1[k] - want).abs().max()) <= 2 * lr, k


@pytest.mark.parametrize("arch", ["cifar_resnet18", "cifar_vit"])
def test_training_repeats_bit_for_bit_on_card(dev, arch):
    """Two 10-step runs of `train.train_victim` on the card from one seed
    (batch 128, the JAX defaults otherwise): every weight bit-equal."""
    from dorpatch_tpu_torch import train

    cfg = train.TrainConfig(arch=arch, n_per_class_train=128,
                            n_per_class_test=2, epochs=1)
    runs = [train.train_victim(cfg, device="cuda", log=lambda *a: None)
            for _ in range(2)]
    assert runs[0][1]["steps"] == 10
    assert runs[0][1]["test_acc"] == runs[1][1]["test_acc"]
    for (k, a), (_, b) in zip(runs[0][0].state_dict().items(),
                              runs[1][0].state_dict().items()):
        assert torch.equal(a, b), k
