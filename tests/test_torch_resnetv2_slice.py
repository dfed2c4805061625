"""The ResNetV2 slice on the CPU, on a shallow full-width ResNetV2 (layers
(1, 1)) with the same weights in both packages: one attack step's loss and
gradients with the sample draw injected, the 7x7/2 stem-fold first round,
the pruned certification's verdicts, tables and forward counts, and
`run_experiment` with `--base_arch resnetv2`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import defense as jdef
from dorpatch_tpu import losses as jlosses
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.attack import DorPatch as JaxDorPatch
from dorpatch_tpu.config import AttackConfig as JaxAttackConfig
from dorpatch_tpu.config import DefenseConfig as JaxDefenseConfig
from dorpatch_tpu.models.registry import incremental_engine as j_engine
from dorpatch_tpu.models.resnetv2 import ResNetV2 as JaxResNetV2
from dorpatch_tpu_torch import defense as tdef
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch import utils as tutils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import AttackConfig, DefenseConfig
from dorpatch_tpu_torch.defense import masked_predictions
from dorpatch_tpu_torch.models import registry
from dorpatch_tpu_torch.models.convert import from_flax_resnetv2
from dorpatch_tpu_torch.models.registry import incremental_engine as t_engine
from dorpatch_tpu_torch.models.registry import normalize
from dorpatch_tpu_torch.models.resnetv2 import ResNetV2
from dorpatch_tpu_torch.pipeline import run_experiment

NAME = "resnetv2_50x1_bit_distilled"
LAYERS = (1, 1)


def _synced(img, seed, classes=10, stem=64):
    """Shallow ResNetV2 in both packages (full width, or a narrower stem of
    `stem` channels) with the same flax-init weights, GroupNorm affines
    perturbed so they are exercised and the head scaled up so that masks
    move the random victim's predictions."""
    fnet = JaxResNetV2(num_classes=classes, layers=LAYERS, stem_features=stem)
    params = jax.jit(fnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(path[-1])
        if "scale" in name:
            return leaf + rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        if "bias" in name:
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        if str(path[-2]) == "['head']":
            return leaf * 30
        return leaf

    params_np = jax.tree_util.tree_map_with_path(perturb, params)
    tnet = ResNetV2(classes, LAYERS, stem_features=stem)
    tnet.load_state_dict(from_flax_resnetv2(params_np))
    tnet = tnet.eval().requires_grad_(False)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)

    def japply(p, z):
        return fnet.apply(p, (z - 0.5) / 0.5)

    return fnet, params, japply, tnet, (lambda z: tnet(normalize(z)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("stage", [0, 1])
def test_step_loss_and_gradients_match_jax(stage):
    img = 16
    _, params, japply, _, tapply = _synced(img, 2)
    rng = np.random.default_rng(30 + stage)
    base = dict(sampling_size=4, dropout=1, basic_unit=4)
    jcfg, tcfg = JaxAttackConfig(**base), AttackConfig(**base)
    universe = jmasks.dropout_universe(img, 1, (0.06, 0.12))
    idx = np.asarray([1, 7, 33, 50])
    x, mask, pattern = (rng.uniform(0, 1, (2, img, img, c))
                        .astype(np.float32) for c in (3, 1, 3))
    y = np.asarray([3, 5])
    lvx = np.asarray(jnp.mean(jlosses.local_variance(jnp.asarray(x))[0], -1))

    jatk = JaxDorPatch(japply, params, 10, jcfg, remat=False)
    jstate = jatk._init_state(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(y), False, universe.shape[0])
    (jtotal, _), (jg_mask, jg_pat) = jax.jit(jax.value_and_grad(
        jatk._loss_and_aux, argnums=(0, 1), has_aux=True),
        static_argnums=6)(
        jnp.asarray(mask), jnp.asarray(pattern), jnp.asarray(x),
        jnp.asarray(lvx), jnp.asarray(universe[idx]), jstate, stage)

    tatk = DorPatch(tapply, 10, tcfg)
    state = tatk._init_state(tutils.generator(0, torch.device("cpu")), _t(x),
                             _t(y), False, universe.shape[0])
    m = _t(mask).requires_grad_(True)
    p = _t(pattern).requires_grad_(True)
    ttotal, _ = tatk._loss_and_aux(m, p, _t(x), _t(lvx), _t(universe[idx]),
                                   state, stage)
    tg_mask, tg_pat = torch.autograd.grad(ttotal, (m, p))
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal),
                               rtol=1e-4)
    np.testing.assert_allclose(tg_pat.numpy(), np.asarray(jg_pat),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tg_mask.numpy(), np.asarray(jg_mask),
                               rtol=1e-3, atol=1e-5)
    assert np.abs(np.asarray(jg_pat)).max() > 0


def test_step_loss_and_gradients_at_480_match_jax():
    """One stage-0 attack step at BiT's 480 px fine-tuning resolution on the
    shallow ResNetV2 with a 32-channel stem (stage 1 at 120 x 120 = 14400
    rows, the slabs whose GroupNorm backward takes the split route on the
    card): the loss and its gradients with respect to the patch's mask and
    pattern, the attack's input gradient, against the JAX package with the
    same two double-mask samples of the dropout=2 universe; the
    tolerances of the step test above."""
    img = 480
    _, params, japply, _, tapply = _synced(img, 3, stem=32)
    rng = np.random.default_rng(480)
    base = dict(sampling_size=2, dropout=2)
    jcfg, tcfg = JaxAttackConfig(**base), AttackConfig(**base)
    universe = jmasks.dropout_universe(img, 2)
    np.testing.assert_array_equal(tmasks.dropout_universe(img, 2), universe)
    idx = np.asarray([17, 2000])
    x, mask, pattern = (rng.uniform(0, 1, (1, img, img, c))
                        .astype(np.float32) for c in (3, 1, 3))
    y = np.asarray([4])
    lvx = np.asarray(jnp.mean(jlosses.local_variance(jnp.asarray(x))[0], -1))

    jatk = JaxDorPatch(japply, params, 10, jcfg, remat=False)
    jstate = jatk._init_state(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(y), False, universe.shape[0])
    (jtotal, _), (jg_mask, jg_pat) = jax.jit(jax.value_and_grad(
        jatk._loss_and_aux, argnums=(0, 1), has_aux=True),
        static_argnums=6)(
        jnp.asarray(mask), jnp.asarray(pattern), jnp.asarray(x),
        jnp.asarray(lvx), jnp.asarray(universe[idx]), jstate, 0)

    tatk = DorPatch(tapply, 10, tcfg)
    state = tatk._init_state(tutils.generator(0, torch.device("cpu")), _t(x),
                             _t(y), False, universe.shape[0])
    m = _t(mask).requires_grad_(True)
    p = _t(pattern).requires_grad_(True)
    ttotal, _ = tatk._loss_and_aux(m, p, _t(x), _t(lvx), _t(universe[idx]),
                                   state, 0)
    tg_mask, tg_pat = torch.autograd.grad(ttotal, (m, p))
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal),
                               rtol=1e-4)
    np.testing.assert_allclose(tg_pat.numpy(), np.asarray(jg_pat),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tg_mask.numpy(), np.asarray(jg_mask),
                               rtol=1e-3, atol=1e-5)
    assert np.abs(np.asarray(jg_pat)).max() > 0


def test_stem_fold_first_round_matches_jax_and_full_forwards():
    """The 7x7/2 SAME stem fold: the port's plain fold and trunk against the
    JAX engine's XLA fold, and against full masked forwards."""
    img, ratio = 24, 0.12
    fnet, params, _, tnet, tapply = _synced(img, 4)
    singles, _ = jmasks.mask_sets(jmasks.geometry(img, ratio))
    x = np.random.default_rng(5).uniform(0, 1, (2, img, img, 3)) \
        .astype(np.float32)
    jfam = j_engine(NAME, fnet, img).build_family(
        singles, len(singles), 2048, 0.5, use_pallas="off")
    jp, jm = map(np.asarray, jfam.phase1(params, jnp.asarray(x)))
    teng = t_engine(NAME, tnet, img)
    assert (teng.kernel_hw, teng.strides) == (7, (2, 2))
    # the port's own chunking by the stem's inflation, several chunks
    tp, tm = (t.numpy() for t in teng.build_family(
        singles, len(singles), 64, 0.5).phase1(torch.as_tensor(x)))
    assert tp.shape == jp.shape == (2, len(singles))
    np.testing.assert_allclose(tm, jm, atol=1e-4)
    sure = np.minimum(tm, jm) > 1e-3
    np.testing.assert_array_equal(tp[sure], jp[sure])
    full_p, full_m = masked_predictions(
        tapply, torch.as_tensor(x), torch.as_tensor(singles), 64, 0.5,
        with_margins=True)
    np.testing.assert_allclose(tm, full_m.numpy(), atol=1e-4)
    sure = np.minimum(tm, full_m.numpy()) > 1e-3
    np.testing.assert_array_equal(tp[sure], full_p.numpy()[sure])
    assert len(set(tp.ravel().tolist())) > 1   # the masks move predictions


@pytest.fixture(scope="module")
def shallow_bank():
    """The port's certifier on the shallow ResNetV2 and the JAX package's
    pruned records for the same images and weights (full masked forwards;
    the stem-fold first round is held above)."""
    img, ratio = 11, 0.12
    fnet, params, japply, tnet, tapply = _synced(img, 6)
    x = np.random.default_rng(8).uniform(0, 1, (3, img, img, 3)) \
        .astype(np.float32)
    jpc = jdef.PatchCleanser(japply, jmasks.geometry(img, ratio),
                             JaxDefenseConfig(ratios=(ratio,)),
                             incremental_engine=j_engine(NAME, fnet, img))
    want = jpc.robust_predict(params, jnp.asarray(x), 10, prune="exact",
                              incremental="off")
    tpc = tdef.PatchCleanser(tapply, tmasks.geometry(img, ratio),
                             DefenseConfig(ratios=(ratio,)),
                             incremental_engine=t_engine(NAME, tnet, img),
                             device="cpu")
    return tpc, x, want


@pytest.mark.parametrize("incremental", ["stem", "off"])
def test_pruned_certification_matches_jax(shallow_bank, incremental):
    tpc, x, want = shallow_bank
    got = tpc.robust_predict(torch.as_tensor(x), 10, prune="exact",
                             incremental=incremental)
    assert tpc.resolved_incremental("auto") == "stem"
    for g, w in zip(got, want):
        assert (g.prediction, g.certification, g.forwards) == \
            (w.prediction, w.certification, w.forwards)
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        np.testing.assert_array_equal(g.preds_2, w.preds_2)
    # a nontrivial table: some image's first round is not unanimous
    assert any(len(set(w.preds_1.tolist())) > 1 for w in want)


def test_run_experiment_resnetv2_on_cpu(tmp_path, monkeypatch):
    """`--base_arch resnetv2` through the command line and `run_experiment`
    on the CPU (the factory builds the shallow ResNetV2): attack, L2
    projection and the four-radius pruned stem-fold certification."""
    built = []

    def shallow(n):
        built.append(n)
        return ResNetV2(n, LAYERS)

    _, init_weights = registry._FAMILIES[NAME]
    monkeypatch.setitem(registry._FAMILIES, NAME, (shallow, init_weights))
    args = build_parser().parse_args([
        "--device", "cpu", "--synthetic", "--dataset", "cifar10",
        "--img-size", "16", "-b", "2", "--sampling-size", "4",
        "--dropout", "1", "--max-iterations", "2", "--num-batches", "1",
        "--model_dir", str(tmp_path / "models"),
        "--results-root", str(tmp_path / "results")])
    cfg = config_from_args(args)
    assert cfg.base_arch == "resnetv2"
    m = run_experiment(cfg, verbose=False)
    assert built == [10]
    assert m["evaluated_images"] == 2
    assert len(m["acc_pc"]) == len(m["certified_asr_pc"]) == 4
    assert 0 < m["forwards"] <= m["forwards_exhaustive"] == 2 * 4 * 666
    assert len(m["attack_seconds"]) == len(m["certify_seconds"]) == 1
