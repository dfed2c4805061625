"""The port's masked-stem fold (kernel C on the card) on the CPU: window
plans and the plain fold against `dorpatch_tpu.ops.stem_fold`, and the
folded first round against the JAX engine and against full masked
forwards."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.models.registry import incremental_engine as j_engine
from dorpatch_tpu.models.small import CifarResNet18 as JaxCifarResNet18
from dorpatch_tpu.ops import stem_fold as jsf
from dorpatch_tpu_torch.models.convert import from_flax_params
from dorpatch_tpu_torch.models.registry import incremental_engine as t_engine
from dorpatch_tpu_torch.models.small import CifarResNet18
from dorpatch_tpu_torch.ops import stem_fold as tsf

# the fold's delta conv sums k*k*Cin products in the order (dr, dc, Cin) in
# both packages, but each framework's matmul rounds on its own
FOLD_ATOL = 1e-5

CASES = [  # (img, k, stride, pads, cout, ratio)
    (16, 3, 1, ((1, 1), (1, 1)), 64, 0.12),
    (32, 7, 2, (jsf.same_pads(32, 7, 2), jsf.same_pads(32, 7, 2)), 8, 0.06),
]


def _plan_pair(img, k, s, pads, ratio):
    singles, _ = jmasks.mask_sets(jmasks.geometry(img, ratio))
    return (jsf.plan_windows(singles, img, k, s, pads),
            tsf.plan_windows(singles, img, k, s, pads))


@pytest.mark.parametrize("img,k,s,pads,cout,ratio", CASES)
def test_window_plans_equal_jax(img, k, s, pads, cout, ratio):
    assert tsf.same_pads(img, k, s) == jsf.same_pads(img, k, s)
    jplan, tplan = _plan_pair(img, k, s, pads, ratio)
    assert len(jplan) == len(tplan)
    for jw, tw in zip(jplan, tplan):
        assert tuple(jw[:8]) == tuple(tw[:8])
        np.testing.assert_array_equal(jw.occ, tw.occ)
    h_out = (img + pads[0][0] + pads[0][1] - k) // s + 1
    ju = jsf._uniform_plan(jplan, h_out, h_out, k, s)
    tu = tsf._uniform_plan(tplan, h_out, h_out, k, s)
    assert ju[:2] == tu[:2]
    np.testing.assert_array_equal(ju[2], tu[2])
    np.testing.assert_array_equal(ju[3], tu[3])


@pytest.mark.parametrize("img,k,s,pads,cout,ratio", CASES)
def test_plain_fold_matches_jax_xla_fold(img, k, s, pads, cout, ratio):
    rng = np.random.default_rng(img + k)
    h_out = (img + pads[0][0] + pads[0][1] - k) // s + 1
    kern = rng.normal(0, 0.3, (k, k, 3, cout)).astype(np.float32)
    clean = rng.normal(0, 1, (2, h_out, h_out, cout)).astype(np.float32)
    u = rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32)
    jplan, tplan = _plan_pair(img, k, s, pads, ratio)
    # every fourth mask: corners, edges and the interior, at a third of the
    # JAX fold's compile time
    jplan, tplan = jplan[::4], tplan[::4]
    want = np.asarray(jsf.fold_masked_stem(
        jnp.asarray(kern), jnp.asarray(clean), jnp.asarray(u), jplan, (s, s),
        pads))
    got = tsf.fold_masked_stem(torch.as_tensor(kern), torch.as_tensor(clean),
                               torch.as_tensor(u), tplan, (s, s), pads)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FOLD_ATOL)


def test_plain_fold_at_480_matches_jax_xla_fold():
    """ResNetV2's 7x7/2 SAME stem at BiT's 480 px fine-tuning resolution
    (240 x 240 outputs): the window plan of the 0.12 radius and the plain
    fold of a narrow stem (8 channels) on 2 images, at four masks (the two
    corners of the first row, the interior, the last corner), against the
    JAX package's."""
    img, k, s, ratio, cout = 480, 7, 2, 0.12, 8
    pads = (jsf.same_pads(img, k, s), jsf.same_pads(img, k, s))
    assert tsf.same_pads(img, k, s) == pads[0]
    h_out = (img + sum(pads[0]) - k) // s + 1
    assert h_out == 240
    jplan, tplan = _plan_pair(img, k, s, pads, ratio)
    assert len(jplan) == len(tplan) == 36
    pick = [0, 5, 14, 35]
    for i in pick:
        assert tuple(jplan[i][:8]) == tuple(tplan[i][:8])
        np.testing.assert_array_equal(jplan[i].occ, tplan[i].occ)
    rng = np.random.default_rng(480)
    kern = rng.normal(0, 0.3, (k, k, 3, cout)).astype(np.float32)
    clean = rng.normal(0, 1, (2, h_out, h_out, cout)).astype(np.float32)
    u = rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32)
    want = np.asarray(jsf.fold_masked_stem(
        jnp.asarray(kern), jnp.asarray(clean), jnp.asarray(u),
        [jplan[i] for i in pick], (s, s), pads))
    got = tsf.fold_masked_stem(torch.as_tensor(kern), torch.as_tensor(clean),
                               torch.as_tensor(u), [tplan[i] for i in pick],
                               (s, s), pads)
    assert got.shape == want.shape == (2, len(pick), h_out, h_out, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FOLD_ATOL)


def _synced_shallow(seed=0, img=16):
    fnet = JaxCifarResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1))
    params = jax.jit(fnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, img, img, 3)))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tnet = CifarResNet18(10, (1, 1, 1, 1))
    tnet.load_state_dict(from_flax_params(params_np))
    return fnet, params, tnet.eval().requires_grad_(False)


def test_stem_engine_phase1_matches_jax_and_full_forwards():
    img, ratio = 16, 0.12
    fnet, params, tnet = _synced_shallow(img=img)
    singles, _ = jmasks.mask_sets(jmasks.geometry(img, ratio))
    x = np.random.default_rng(1).uniform(0, 1, (2, img, img, 3)) \
        .astype(np.float32)
    # one fold-and-trunk chunk: the JAX program compiles one trunk, not
    # twelve (the port's chunking runs in test_torch_defense)
    jfam = j_engine("cifar_resnet18", fnet, img).build_family(
        singles, len(singles), 2048, 0.5, use_pallas="off")
    jp, jm = map(np.asarray, jfam.phase1(params, jnp.asarray(x)))
    tfam = t_engine("cifar_resnet18", tnet, img).build_family(
        singles, len(singles), 2048, 0.5)
    tp, tm = (t.numpy() for t in tfam.phase1(torch.as_tensor(x)))
    assert tp.shape == jp.shape == (2, len(singles))
    np.testing.assert_allclose(tm, jm, atol=1e-4)
    sure = np.minimum(tm, jm) > 1e-3
    np.testing.assert_array_equal(tp[sure], jp[sure])
    # the fold is the masked-image forward, rearranged
    from dorpatch_tpu_torch.defense import masked_predictions
    from dorpatch_tpu_torch.models.registry import normalize

    full_p, full_m = masked_predictions(
        lambda z: tnet(normalize(z)), torch.as_tensor(x),
        torch.as_tensor(singles), 64, 0.5, with_margins=True)
    np.testing.assert_allclose(tm, full_m.numpy(), atol=1e-4)
    sure = np.minimum(tm, full_m.numpy()) > 1e-3
    np.testing.assert_array_equal(tp[sure], full_p.numpy()[sure])


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsf.fold_masked_stem_kernel(z(3, 3, 3, 64), z(1, 8, 8, 64),
                                    z(1, 10, 10, 3), z(1, 4, dtype=torch.int32),
                                    z(1, 5, 5), 3, 3, 1)


# -- kernel C's bf16 form: its plan and its padded taps (Python, which the
#    kernel's launch and carve follow; the kernel runs only on the card) --

#: (img, k, stride, pads): the CIFAR 3x3/1 stem and RN50's 7x7/2 SAME stem
#: at 224 and at 480 px
STEMS = [(32, 3, 1, ((1, 1), (1, 1))),
         (224, 7, 2, (tsf.same_pads(224, 7, 2), tsf.same_pads(224, 7, 2))),
         (480, 7, 2, (tsf.same_pads(480, 7, 2), tsf.same_pads(480, 7, 2)))]


@pytest.mark.parametrize("img,k,s,pads", STEMS)
def test_bf16_plan_fits_every_chunk_the_engine_takes(img, k, s, pads):
    """At each stem, for every chunk size (1 to all 36 first-round masks
    of the 0.12 radius) and every chunk of it: the taps padded to the MMA
    depth, a block's shared memory within MAX_SMEM_BYTES, delta blocks
    that cover every window pixel of every (image, mask) once and copy
    blocks every 16-byte chunk of every clean map for every mask once (2
    images, 64 channels), and evict-first stores exactly when the output
    outgrows the L2."""
    from dorpatch_tpu_torch.ops import _build

    b, c = 2, 64
    h_out = (img + sum(pads[0]) - k) // s + 1
    singles, _ = jmasks.mask_sets(jmasks.geometry(img, 0.12))
    plan = tsf.plan_windows(singles, img, k, s, pads)
    kpad = tsf.mma_taps(k, 3)
    assert kpad % tsf.MMA_K == 0 and 0 <= kpad - k * k * 3 < tsf.MMA_K
    assert kpad == (32 if k == 3 else 160)
    for cnt in range(1, len(plan) + 1):
        for off in range(0, len(plan), cnt):
            part = plan[off:off + cnt]
            n = len(part)
            oh, ow, _, _ = tsf._uniform_plan(part, h_out, h_out, k, s)
            p = tsf.bf16_plan(b, n, h_out, h_out, c, oh, ow)
            assert 1 <= p.lanes <= tsf.MAX_COPY_LANES and 1 <= p.group <= n
            assert p.mtiles == (2 if oh * ow >= tsf.MTILES2_PIX else 1)
            for mtiles in range(1, tsf.MAX_MTILES + 1):
                assert tsf.bf16_smem(3, ow, c, k, s, mtiles) \
                    <= _build.MAX_SMEM_BYTES
            delta, copy = tsf.bf16_items(p, b, n, h_out, h_out, c, oh, ow)
            pix = p.mtiles * tsf.TILE_PIX
            assert delta * pix >= b * n * oh * ow > (delta - b * n) * pix
            tile = tsf.THREADS * p.lanes
            chunks = h_out * h_out * c // 8
            groups = -(-n // p.group)
            tiles = copy // (b * groups)
            assert copy == b * groups * tiles
            assert (tiles - 1) * tile < chunks <= tiles * tile
            assert (groups - 1) * p.group < n <= groups * p.group
            assert p.stream == (2 * b * n * h_out * h_out * c
                                > tsf.L2_BYTES)


@pytest.mark.parametrize("img,k,s,pads", STEMS[:2])
def test_plain_bf16_fold_with_padded_taps_equals_unpadded(img, k, s, pads):
    """The plain bf16 fold with the taps zero-padded to the MMA depth
    (flattened in the order (dr, dc, Cin) as kernel C's bf16 form lays
    them out) equals the unpadded fold bit for bit: the padded products
    are exact zeros."""
    rng = np.random.default_rng(img)
    h_out = (img + sum(pads[0]) - k) // s + 1

    def bf(a):
        return torch.as_tensor(a, dtype=torch.bfloat16)

    kern = bf(rng.normal(0, 0.3, (k, k, 3, 16)))
    clean = bf(rng.normal(0, 1, (2, h_out, h_out, 16)))
    u = bf(rng.uniform(-1, 1, (2, img, img, 3)))
    singles, _ = jmasks.mask_sets(jmasks.geometry(img, 0.12))
    plan = tsf.plan_windows(singles, img, k, s, pads)[::7]
    want = tsf.fold_masked_stem(kern, clean, u, plan, (s, s), pads)
    got = tsf.fold_masked_stem(kern, clean, u, plan, (s, s), pads,
                               kpad=tsf.mma_taps(k, 3))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert not torch.equal(want, clean[:, None].expand_as(want))
