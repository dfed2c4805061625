"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
nvcc and skips without them. On a GPU host (no jax needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch.gn_bench import RN50_GN_CALLS
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
    rng = np.random.default_rng(seed)
    universe = tmasks.pad_rects(
        tmasks.dropout_universe(size, 1 if k == 1 else 2), k)
    rects = universe[rng.choice(len(universe), s, replace=False)]
    imgs = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    return (torch.as_tensor(imgs, device=dev),
            torch.as_tensor(rects, device=dev))


@pytest.mark.parametrize("b,size,s,k", [(8, 32, 128, 2), (3, 15, 7, 3),
                                        (2, 32, 300, 2), (1, 16, 1, 1)])
def test_fill_forward_equals_plain_exactly(dev, b, size, s, k):
    imgs, rects = _case(dev, 0, b, size, s, k)
    got = mf.masked_fill_fwd_kernel(imgs, rects, 0.5)
    want = mf.masked_fill_reference(imgs, rects, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,size,s,k", [(8, 32, 128, 2), (3, 15, 200, 3)])
def test_fill_backward_matches_float64_autograd(dev, b, size, s, k):
    imgs, rects = _case(dev, 1, b, size, s, k)
    g = torch.randn((b, s, size, size, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    x = imgs.double().requires_grad_(True)
    (want,) = torch.autograd.grad(mf.masked_fill_reference(x, rects, 0.5), x,
                                  g.double())
    got = mf.masked_fill_bwd_kernel(rects, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-6)


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
# the bottom and right edges; cout 36 takes the kernel's one-quad path
STEM_CASES = [(32, 3, 1, 64, 0.12, 5), (32, 3, 1, 64, 0.015, 5),
              (64, 7, 2, 64, 0.06, 5), (32, 3, 1, 64, 0.12, 1),
              (32, 3, 1, 64, 0.12, -13), (224, 7, 2, 64, 0.12, 13),
              (224, 7, 2, 64, 0.12, -1), (224, 7, 2, 64, 0.06, -13),
              (32, 3, 1, 36, 0.06, -5)]


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


# GroupNorm+ReLU: f32 kernels against the float64 plain versions. Forward
# and per-element dx within 1e-5 (f32 rounding of a few flops per element;
# the group statistics are summed in float64); the parameter cotangents sum
# N*HW terms per channel in f32 partials, hence atol 1e-3. Gate flips near a
# pre-activation of 0 are allowed for by `gate_flip_bounds`.
# The 11 (HW, C) shapes of ResNetV2-50x1 at 224 at N = 2 (one-pass route),
# odd shapes (C = 96: cg = 3, chunks of 24 channels), chunks split over
# clusters (64*64 rows: 2 CTAs forward, 8 backward; 112*112: 4 and 8;
# 160*160: 8 forward), and slabs whose chunk fits no cluster (160*160
# backward, 256*256: the split route)
GN_SHAPES = [(8, 28, 28, 128), (16, 7, 7, 2048), (3, 9, 9, 64), (2, 5, 5, 96),
             (4, 56, 56, 256), (2, 56, 56, 64), (2, 56, 56, 128),
             (2, 28, 28, 512), (2, 28, 28, 256), (2, 14, 14, 256),
             (2, 14, 14, 1024), (2, 14, 14, 512), (2, 7, 7, 512),
             (2, 64, 64, 256), (1, 112, 112, 64), (1, 160, 160, 64),
             (1, 256, 256, 64)]
#: (HW, C) of the 49 GroupNorm+ReLU calls of ResNetV2-50x1 at 224
RN50_GN = set(RN50_GN_CALLS)


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
