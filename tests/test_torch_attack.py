"""The port's DorPatch optimizer against `dorpatch_tpu.losses` and
`dorpatch_tpu.attack`: the losses, one step's loss and gradients with the
sample draw injected, the signed update, the failure sweep, and the
distribution of the failure-biased Gumbel top-k draw."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import losses as jlosses
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.attack import DorPatch as JaxDorPatch
from dorpatch_tpu.attack import majority_incorrect_label as j_majority
from dorpatch_tpu.attack import patch_selection as j_patch_selection
from dorpatch_tpu.config import AttackConfig as JaxAttackConfig
from dorpatch_tpu.models.small import CifarResNet18 as JaxCifarResNet18
from dorpatch_tpu_torch import losses as tlosses
from dorpatch_tpu_torch import utils as tutils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.attack import majority_incorrect_label
from dorpatch_tpu_torch.attack import patch_selection
from dorpatch_tpu_torch.config import AttackConfig
from dorpatch_tpu_torch.models.convert import from_flax_params
from dorpatch_tpu_torch.models.registry import normalize
from dorpatch_tpu_torch.models.small import CifarResNet18

IMG = 16


def _rand(rng, *shape):
    return rng.uniform(0, 1, size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    x, mask, pattern = (_rand(rng, 2, IMG, IMG, c) for c in (3, 1, 3))
    np.testing.assert_allclose(
        tlosses.l2_project(_t(mask), _t(pattern), _t(x), 2.0).numpy(),
        np.asarray(jlosses.l2_project(jnp.asarray(mask), jnp.asarray(pattern),
                                      jnp.asarray(x), 2.0)), rtol=1e-5)
    np.testing.assert_allclose(
        tlosses.window_sum(_t(mask), 4).numpy(),
        np.asarray(jlosses.window_sum(jnp.asarray(mask), 4)), rtol=1e-5)
    np.testing.assert_allclose(
        tlosses.group_lasso(_t(mask), 4).numpy(),
        np.asarray(jlosses.group_lasso(jnp.asarray(mask), 4)), rtol=1e-5)
    np.testing.assert_allclose(
        tlosses.density_loss(_t(mask), 2).numpy(),
        np.asarray(jlosses.density_loss(jnp.asarray(mask), 2)), rtol=1e-4)
    for got, want in zip(tlosses.local_variance(_t(x)),
                         jlosses.local_variance(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    lvx = np.asarray(jnp.mean(jlosses.local_variance(jnp.asarray(x))[0], -1))
    np.testing.assert_allclose(
        tlosses.structural_loss(_t(x), _t(lvx)).numpy(),
        np.asarray(jlosses.structural_loss(jnp.asarray(x), jnp.asarray(lvx))),
        rtol=1e-4)
    logits = _rand(rng, 6, 10) * 8
    y = rng.integers(0, 10, 6)
    targ = rng.random(6) < 0.5
    np.testing.assert_allclose(
        tlosses.cw_margin_switchable(_t(logits), _t(y), 10, _t(targ),
                                     0.1).numpy(),
        np.asarray(jlosses.cw_margin_switchable(
            jnp.asarray(logits), jnp.asarray(y), 10, jnp.asarray(targ), 0.1)),
        rtol=1e-5)
    np.testing.assert_allclose(
        tlosses.cw_margin(_t(logits), _t(y), 10, True).numpy(),
        np.asarray(jlosses.cw_margin(jnp.asarray(logits), jnp.asarray(y), 10,
                                     True)), rtol=1e-5)


def test_one_sided_tv_gradients_match_jax():
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, IMG, IMG, 3)
    lvx = np.asarray(jnp.mean(jlosses.local_variance(jnp.asarray(x))[0], -1))
    want = np.asarray(jax.grad(lambda z: jnp.sum(jlosses.structural_loss(
        z, jnp.asarray(lvx))))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tlosses.structural_loss(xt, _t(lvx)).sum(),
                                 xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_patch_selection_and_majority_label_match_jax():
    rng = np.random.default_rng(9)
    mask = _rand(rng, 2, IMG, IMG, 1)
    np.testing.assert_array_equal(
        patch_selection(_t(mask), 0.15, 4).numpy(),
        np.asarray(j_patch_selection(jnp.asarray(mask), 0.15, 4)))
    np.testing.assert_array_equal(
        patch_selection(_t(mask[:, :15, :15]), 0.2, 4).numpy(),
        np.asarray(j_patch_selection(jnp.asarray(mask[:, :15, :15]), 0.2, 4)))
    preds = rng.integers(0, 4, (3, 9))
    y = np.asarray([0, 1, 2])
    preds[2] = 2          # no misclassified sample: keeps its label
    got = majority_incorrect_label(_t(preds), _t(y), 4)
    want = j_majority(jnp.asarray(preds), jnp.asarray(y), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def synced():
    """Shallow full-width CIFAR ResNet-18 in both packages, same weights."""
    fnet = JaxCifarResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1))
    params = jax.jit(fnet.init)(jax.random.PRNGKey(3),
                                jnp.zeros((1, IMG, IMG, 3)))
    tnet = CifarResNet18(10, (1, 1, 1, 1))
    tnet.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    tnet = tnet.eval().requires_grad_(False)

    def japply(p, z):
        return fnet.apply(p, (z - 0.5) / 0.5)

    # one JAX attack for every test, so its jitted sweep compiles once
    jsweep = JaxDorPatch(japply, params, 10, _cfgs(sampling_size=16)[0])
    return japply, params, (lambda z: tnet(normalize(z))), jsweep


def _cfgs(**kw):
    base = dict(sampling_size=4, dropout=1, basic_unit=4, structured=1e-3,
                density=1e-3)
    base.update(kw)
    return JaxAttackConfig(**base), AttackConfig(**base)


@pytest.mark.parametrize("stage", [0, 1])
def test_step_loss_gradients_and_update_match_jax(synced, stage):
    """Same weights, same injected EOT draw: the loss and the gradients
    agree, and the port's step applies the signed update of JAX's
    gradients."""
    japply, params, tapply, _ = synced
    rng = np.random.default_rng(10 + stage)
    jcfg, tcfg = _cfgs()
    universe = jmasks.dropout_universe(IMG, 1, (0.06, 0.12))
    idx = np.asarray([0, 5, 40, 60])
    x, mask, pattern = (_rand(rng, 2, IMG, IMG, c) for c in (3, 1, 3))
    y = np.asarray([1, 2])
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
    xt, lvt = _t(x), _t(lvx)
    state = tatk._init_state(tutils.generator(0, torch.device("cpu")), xt,
                             _t(y), False, universe.shape[0])
    state = state.replace(adv_mask=_t(mask), adv_pattern=_t(pattern))
    m = state.adv_mask.clone().requires_grad_(True)
    p = state.adv_pattern.clone().requires_grad_(True)
    ttotal, _ = tatk._loss_and_aux(m, p, xt, lvt, _t(universe[idx]), state,
                                   stage)
    tg_mask, tg_pat = torch.autograd.grad(ttotal, (m, p))
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal),
                               rtol=1e-4)
    np.testing.assert_allclose(tg_pat.numpy(), np.asarray(jg_pat),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tg_mask.numpy(), np.asarray(jg_mask),
                               rtol=1e-3, atol=1e-5)

    new = tatk._step(state, xt, lvt, _t(universe), stage, idx=_t(idx),
                     from_fail=torch.zeros(4, dtype=torch.bool))
    jg = np.asarray(jg_pat)
    sure = np.abs(jg) > 1e-6 * np.abs(jg).max()
    want = np.clip(pattern - tcfg.lr * np.sign(jg), 0, 1)
    np.testing.assert_allclose(new.adv_pattern.numpy()[sure], want[sure],
                               rtol=0, atol=1e-7)
    if stage == 0:
        jm = np.asarray(jg_mask)
        sure = np.abs(jm) > 1e-6 * np.abs(jm).max()
        want = np.clip(mask - tcfg.lr * np.sign(jm), 0, 1)
        np.testing.assert_allclose(new.adv_mask.numpy()[sure], want[sure],
                                   rtol=0, atol=1e-7)
    else:
        assert torch.equal(new.adv_mask, state.adv_mask)
    assert int(new.step) == 1
    assert new.failed.shape == (universe.shape[0],)


@pytest.mark.parametrize("targeted", [False, True])
def test_sweep_failures_match_jax(synced, targeted):
    _, _, tapply, jsweep = synced
    rng = np.random.default_rng(21)   # a draw whose sweep is nontrivial
    _, tcfg = _cfgs(sampling_size=16)
    universe = jmasks.dropout_universe(IMG, 1, (0.06, 0.12))
    x, mask, pattern = (_rand(rng, 2, IMG, IMG, c) for c in (3, 1, 3))
    with torch.no_grad():
        y = tapply(_t(x)).argmax(-1).numpy()
    tg = np.asarray([targeted, False])
    want = np.asarray(jsweep.sweep_failures(
        jnp.asarray(mask), jnp.asarray(pattern), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tg), jnp.asarray(universe)))
    got = DorPatch(tapply, 10, tcfg).sweep_failures(
        _t(mask), _t(pattern), _t(x), _t(y), _t(tg), _t(universe))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(universe)


def test_sample_indices_distribution_matches_jax():
    """Both draws: the uniform half without replacement from the universe,
    the failure half without replacement from the failure set, the failure
    half only from `failure_sampling_start` on. Inclusion frequencies agree
    with each other and with the exact probabilities."""
    n, s, draws = 20, 8, 3000
    failed = np.zeros(n, bool)
    failed[:6] = True
    jcfg, tcfg = _cfgs(sampling_size=s, failure_sampling_start=5)
    jatk = JaxDorPatch(lambda p, z: z, None, 10, jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    jidx, jff = map(np.asarray, jax.jit(jax.vmap(
        lambda k: jatk._sample_indices(k, jnp.asarray(failed),
                                       jnp.asarray(10))))(keys))
    tatk = DorPatch(lambda z: z, 10, tcfg)
    gen = tutils.generator(0, torch.device("cpu"))
    tf = _t(failed)
    out = [tatk._sample_indices(gen, tf, torch.tensor(10))
           for _ in range(draws)]
    tidx = np.stack([o[0].numpy() for o in out])
    tff = np.stack([o[1].numpy() for o in out])
    early_idx, early_ff = tatk._sample_indices(gen, tf, torch.tensor(4))
    assert not early_ff.any() and len(set(early_idx.tolist())) == s

    for idx, ff in ((jidx, jff), (tidx, tff)):
        assert (ff.sum(1) == 4).all()                 # min(n_failed, s // 2)
        assert failed[idx[ff]].all()                  # from the failure set
        for row, frow in zip(idx, ff):
            assert len(set(row[frow])) == frow.sum()  # without replacement
            assert len(set(row[~frow])) == (~frow).sum()
    # inclusion frequency of each index in the failure half (4 of 6) and in
    # the uniform half (4 of 20)
    for idx, ff in ((jidx, jff), (tidx, tff)):
        fail_freq = np.bincount(idx[ff], minlength=n)[:6] / draws
        uni_freq = np.bincount(idx[~ff], minlength=n) / draws
        np.testing.assert_allclose(fail_freq, 4 / 6, atol=0.04)
        np.testing.assert_allclose(uni_freq, 4 / 20, atol=0.04)
