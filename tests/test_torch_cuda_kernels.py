"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA GPU and
nvcc and skips without them. On a GPU host (no jax needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch.ops import _backend
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


@pytest.mark.parametrize("img,k,s,cout,ratio", [(32, 3, 1, 64, 0.12),
                                                (32, 3, 1, 64, 0.015),
                                                (64, 7, 2, 64, 0.06)])
def test_stem_fold_kernel_matches_plain(dev, img, k, s, cout, ratio):
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
    plan = sf.plan_windows(singles, img, k, s, pads)[:5]
    oh, ow, geo, occ = sf._uniform_plan(plan, h_out, h_out, k, s)
    got = sf.fold_masked_stem_kernel(
        kern, clean, sf.pad_for_kernel(u, pads, s),
        torch.as_tensor(geo, device=dev), torch.as_tensor(occ, device=dev),
        oh, ow, s)
    want = sf.fold_masked_stem(kern, clean, u, plan, (s, s), pads)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


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
