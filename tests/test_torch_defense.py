"""The port's PatchCleanser against `dorpatch_tpu.defense`: verdict logic on
random tables, the pruned scheduler, and whole certifications (verdicts,
first-round tables and per-image forward counts) on a weightless trigger
detector covering all four verdict classes and on a shallow full-width
CIFAR ResNet-18 with shared weights."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dorpatch_tpu import defense as jdef
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.config import DefenseConfig as JaxDefenseConfig
from dorpatch_tpu.models.registry import incremental_engine as j_engine
from dorpatch_tpu.models.small import CifarResNet18 as JaxCifarResNet18
from dorpatch_tpu_torch import defense as tdef
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch.config import DefenseConfig
from dorpatch_tpu_torch.models.convert import from_flax_params
from dorpatch_tpu_torch.models.registry import incremental_engine as t_engine
from dorpatch_tpu_torch.models.registry import normalize
from dorpatch_tpu_torch.models.small import CifarResNet18


def _random_tables(seed, b=3, m=9, c=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, c)
    p1 = np.full((b, m), base)
    p2 = np.full((b, m * (m - 1) // 2), base)
    flip = rng.random(p1.shape) < 0.3
    p1[flip] = rng.integers(0, c, flip.sum())
    flip2 = rng.random(p2.shape) < 0.3
    p2[flip2] = rng.integers(0, c, flip2.sum())
    return p1.astype(np.int32), p2.astype(np.int32), m, c


@pytest.mark.parametrize("seed", range(8))
def test_verdicts_match_jax_on_random_tables(seed):
    p1, p2, m, c = _random_tables(seed)
    want_p, want_c = map(np.asarray, jdef.double_masking_verdict(
        jnp.asarray(p1), jnp.asarray(p2), m, c))
    got_p, got_c = jdef.double_masking_verdict_np(p1, p2, m, c)
    np.testing.assert_array_equal(got_p, want_p)
    tp, tc = tdef.double_masking_verdict_np(p1, p2, m, c)
    np.testing.assert_array_equal(tp, want_p)
    np.testing.assert_array_equal(tc, want_c)
    tp, tc = tdef.double_masking_verdict(torch.as_tensor(p1),
                                         torch.as_tensor(p2), m, c)
    np.testing.assert_array_equal(tp.numpy(), want_p)
    np.testing.assert_array_equal(tc.numpy(), want_c)
    maj, una = tdef.host_round1(p1, c)
    jmaj, juna = jdef.host_round1(p1, c)
    np.testing.assert_array_equal(maj, jmaj)
    np.testing.assert_array_equal(una, juna)
    got = tdef.schedule_round2(p1, maj, una, m, p2.shape[1], "exact")
    want = jdef.schedule_round2(p1, jmaj, juna, m, p2.shape[1], "exact")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("n,chunk", [(666, 64), (630, 64), (36, 64),
                                     (2520, 126), (7, 3), (0, 8)])
def test_plan_chunks_equals_jax(n, chunk):
    assert tdef.plan_chunks(n, chunk) == jdef.plan_chunks(n, chunk)


# ---------- whole certifications ----------

IMG, CLASSES = 32, 3


def _jax_trigger(params, x):
    """Weightless 3-class trigger detector over `geometry(32, 0.1)`: each 4x4
    trigger sits where every mask either fully covers it or misses it."""
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
    """[0] gray: unanimous, certified; [1] one bright trigger: disagreement
    recovered by the minority row; [2] two bright triggers: unanimous, a
    double mask kills the certificate; [3] bright + dark: disagreement, the
    minority row is broken, the majority stands."""
    imgs = np.full((4, IMG, IMG, 3), 0.5, np.float32)
    imgs[1, 4:8, 4:8] = 1.0
    imgs[2, 4:8, 4:8] = 1.0
    imgs[2, 24:28, 24:28] = 1.0
    imgs[3, 4:8, 4:8] = 1.0
    imgs[3, 4:8, 24:28] = 0.0
    return imgs


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.prediction == w.prediction
        assert g.certification == w.certification
        assert g.forwards == w.forwards
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        np.testing.assert_array_equal(g.preds_2, w.preds_2)


@pytest.mark.parametrize("prune", ["off", "exact"])
@pytest.mark.parametrize("bucket_sizes", [None, (1, 8)])
def test_trigger_detector_all_verdict_classes_match_jax(prune, bucket_sizes):
    spec = jmasks.geometry(IMG, 0.1)
    x = _trigger_batch()
    jpc = jdef.PatchCleanser(_jax_trigger, spec,
                             JaxDefenseConfig(ratios=(0.1,), prune=prune))
    want = jpc.robust_predict(None, jnp.asarray(x), CLASSES,
                              bucket_sizes=bucket_sizes)
    tpc = tdef.PatchCleanser(_torch_trigger, tmasks.geometry(IMG, 0.1),
                             DefenseConfig(ratios=(0.1,), prune=prune),
                             device="cpu")
    got = tpc.robust_predict(torch.as_tensor(x), CLASSES,
                             bucket_sizes=bucket_sizes)
    _assert_records_equal(got, want)
    # the batch covers all four verdict classes
    assert [(r.prediction, r.certification) for r in got] == \
        [(0, True), (0, False), (1, False), (1, False)]
    if prune == "exact":
        assert [r.forwards for r in got][1] < 36 + 630
    tpc.collect(got)
    assert tpc.result.predictions_1.shape == (4, 36)
    tpc.reset()
    assert tpc.result is None


def _synced_shallow(img):
    """Shallow full-width CIFAR ResNet-18 in both packages with the same
    (perturbed) weights."""
    fnet = JaxCifarResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1))
    params = jax.jit(fnet.init)(jax.random.PRNGKey(11),
                                jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        if "scale" in str(path[-1]):
            return leaf + rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        if "bias" in str(path[-1]):
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        return leaf

    params_np = jax.tree_util.tree_map_with_path(perturb, params)
    tnet = CifarResNet18(10, (1, 1, 1, 1))
    tnet.load_state_dict(from_flax_params(params_np))
    tnet = tnet.eval().requires_grad_(False)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    return fnet, params, tnet


@pytest.fixture(scope="module")
def shallow_bank():
    """The port's certifier on the shallow ResNet and the JAX package's
    pruned records for the same images and weights. One JAX run is the
    reference for every port mode: the pruned verdicts, tables and forward
    counts do not depend on how phase 1 is computed, and the exhaustive
    verdicts equal the pruned ones by construction (the stem fold's own
    first round is held against the JAX engine in test_torch_stem_fold)."""
    # 11 px keeps the masked forwards affordable on one core; the mask family
    # is still the full 36 + 630
    img, ratio = 11, 0.12
    fnet, params, tnet = _synced_shallow(img)
    # image 0 disagrees in round 1 and a minority row recovers its label
    # (5 minority masks: the rows path), image 1 is unanimous (the pair
    # audit)
    x = np.random.default_rng(7).uniform(0, 1, (2, img, img, 3)) \
        .astype(np.float32)
    x[1, 1:4, 1:4] = 1.0

    def japply(p, z):
        return fnet.apply(p, (z - 0.5) / 0.5)

    jpc = jdef.PatchCleanser(japply, jmasks.geometry(img, ratio),
                             JaxDefenseConfig(ratios=(ratio,)),
                             incremental_engine=j_engine("cifar_resnet18",
                                                         fnet, img))
    want = jpc.robust_predict(params, jnp.asarray(x), 10, prune="exact",
                              incremental="off")
    tpc = tdef.PatchCleanser(lambda z: tnet(normalize(z)),
                             tmasks.geometry(img, ratio),
                             DefenseConfig(ratios=(ratio,)),
                             incremental_engine=t_engine("cifar_resnet18",
                                                         tnet, img),
                             device="cpu")
    return jpc, tpc, x, want


@pytest.mark.parametrize("prune,incremental", [("off", "off"),
                                               ("exact", "stem"),
                                               ("exact", "off")])
def test_shallow_resnet_certification_matches_jax(shallow_bank, prune,
                                                  incremental):
    jpc, tpc, x, want = shallow_bank
    got = tpc.robust_predict(torch.as_tensor(x), 10, prune=prune,
                             incremental=incremental)
    assert tpc.resolved_incremental(incremental, prune) == \
        jpc.resolved_incremental(incremental, prune)
    assert [r.forwards for r in want] == [36 + 5 * 36, 36 + 630]
    assert [(r.prediction, r.certification) for r in want] == \
        [(1, False), (6, True)]
    for g, w in zip(got, want):
        assert (g.prediction, g.certification) == \
            (w.prediction, w.certification)
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        read = w.preds_2 != jdef.UNEVALUATED
        np.testing.assert_array_equal(g.preds_2[read], w.preds_2[read])
        if prune == "exact":
            assert g.forwards == w.forwards
            np.testing.assert_array_equal(g.preds_2, w.preds_2)
        else:
            assert g.forwards == 666


def test_auto_resolves_to_stem_and_rejects_unknown_modes(shallow_bank):
    _, tpc, _, _ = shallow_bank
    assert tpc.resolved_incremental("auto") == "stem"
    assert tpc.resolved_incremental("auto", prune="off") == "off"
    with pytest.raises(ValueError):
        tpc.resolved_incremental("token")
    with pytest.raises(ValueError):
        tpc.resolved_prune("consensus")


def test_build_defenses_bank_matches_jax():
    bank = tdef.build_defenses(lambda z: torch.zeros(z.shape[0], 2), 224,
                               device="cpu")
    jbank = jdef.build_defenses(lambda p, z: jnp.zeros((z.shape[0], 2)), 224)
    assert [d.spec for d in bank] == [tuple(d.spec) for d in jbank]
    assert [d.num_forwards_exhaustive for d in bank] == [666] * 4
