"""Remat in the port (`--remat`, `--remat-policy`, `models/remat.py`):
the resolution rule of `dorpatch_tpu.attack.DorPatch._grad_fwd`, loss and
both gradients bit-equal with remat on and off under every policy on each
victim family in float32 and bf16, fewer activations kept with it on, a
4-iteration attack with remat on against the JAX `DorPatch` with
`remat=True`, and the flags and config keys against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import cli as jcli
from dorpatch_tpu import losses as jlosses
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.attack import DorPatch as JaxDorPatch
from dorpatch_tpu.config import AttackConfig as JaxAttackConfig
from dorpatch_tpu.config import config_from_dict as jax_from_dict
from dorpatch_tpu.config import config_to_dict as jax_to_dict
from dorpatch_tpu.models.small import CifarResNet18 as JaxCifarResNet18
from dorpatch_tpu_torch import utils as tutils
from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import (AttackConfig, config_from_dict,
                                       config_to_dict)
from dorpatch_tpu_torch.models import remat, resmlp, resnetv2, small, vit
from dorpatch_tpu_torch.models.convert import from_flax_params
from dorpatch_tpu_torch.models.registry import VictimForward, normalize

IMG = 16
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ resolution rule


def test_remat_policy_resolution():
    """`remat=None` follows the config ("auto" keys off the masked-batch
    size against `remat_threshold`); True/False force; bad config strings
    are refused (`tests/test_attack.py::test_remat_policy_resolution`)."""
    def apply_fn(x):
        return x.mean(dim=(1, 2))

    cfg = AttackConfig(remat="auto", remat_threshold=16)
    atk = DorPatch(apply_fn, 3, cfg)
    assert atk._grad_fwd(16) is atk._fwd
    assert atk._grad_fwd(17) is not atk._fwd
    on = DorPatch(apply_fn, 3, dataclasses.replace(cfg, remat="on"))
    assert on._grad_fwd(1) is not on._fwd
    off = DorPatch(apply_fn, 3, dataclasses.replace(cfg, remat="off"))
    assert off._grad_fwd(10**6) is off._fwd
    forced = DorPatch(apply_fn, 3, cfg, remat=False)
    assert forced._grad_fwd(10**6) is forced._fwd
    assert DorPatch(apply_fn, 3, AttackConfig(remat="off"),
                    remat=True)._grad_fwd(1) is not forced._fwd
    for bad in ({"remat": "maybe"}, {"remat_policy": "attn"}):
        with pytest.raises(ValueError):
            DorPatch(apply_fn, 3, dataclasses.replace(cfg, **bad))


def test_default_threshold_keeps_every_earlier_path_plain():
    """"auto" at the port's default threshold leaves the largest masked
    batch of the paths run before remat (batch 8 x 128 samples) plain."""
    atk = DorPatch(lambda x: x, 10, AttackConfig())
    assert AttackConfig().remat == "auto"
    assert atk._grad_fwd(8 * 128) is atk._fwd
    assert atk._grad_fwd(8 * 128 + 1) is not atk._fwd


def test_block_is_plain_without_grad_or_switch():
    calls = []

    def fn(x):
        calls.append(torch.is_grad_enabled())
        return x * 2

    x = torch.ones(3, requires_grad=True)
    with remat.enabled("full"), torch.no_grad():
        assert torch.equal(remat.block(fn, x), x.detach() * 2)
    assert remat.active_policy() is None
    assert torch.equal(remat.block(fn, x), x * 2)
    with pytest.raises(ValueError):
        with remat.enabled("attn"):
            pass


# --------------------------------------------- bit-equal on and off


def _victims():
    gen = lambda: tutils.generator(3, CPU)  # noqa: E731
    cifar = small.CifarResNet18(10, (1, 1, 1, 1))
    small.init_weights(cifar, gen())
    rn = resnetv2.ResNetV2(10, layers=(1, 1))
    resnetv2.init_weights(rn, gen())
    vt = vit.ViT(10, patch_size=4, dim=32, depth=2, num_heads=2,
                 img_size=IMG)
    vit.init_weights(vt, gen())
    rm = resmlp.ResMLP(10, patch_size=4, dim=32, depth=2, img_size=IMG)
    resmlp.init_weights(rm, gen())
    return {"cifar_resnet18": cifar, "resnetv2": rn, "vit": vt,
            "resmlp": rm}


VICTIMS = _victims()
for _m in VICTIMS.values():
    _m.eval().requires_grad_(False)


def _grads(apply_fn, dtype, use_remat, policy, stage=1):
    """Loss and both gradients of one EOT step's loss."""
    cfg = AttackConfig(sampling_size=4, dropout=1, basic_unit=4,
                       compute_dtype=dtype, remat_policy=policy)
    atk = DorPatch(apply_fn, 10, cfg, remat=use_remat)
    rng = np.random.default_rng(5)
    x, mask, pattern = (_t(rng.uniform(0, 1, (2, IMG, IMG, c))
                           .astype(np.float32)) for c in (3, 1, 3))
    universe = _t(jmasks.dropout_universe(IMG, 1, (0.06, 0.12)))
    state = atk._init_state(tutils.generator(0, CPU), x,
                            torch.tensor([1, 2]), False, universe.shape[0])
    lvx = torch.zeros(2, IMG, IMG)
    m = mask.clone().requires_grad_(True)
    p = pattern.clone().requires_grad_(True)
    with torch.enable_grad():
        total, _ = atk._loss_and_aux(m, p, x, lvx,
                                     universe[torch.tensor([0, 5, 9, 30])],
                                     state, stage)
        g_mask, g_pattern = torch.autograd.grad(total, (m, p))
    return total.detach(), g_mask, g_pattern


@pytest.mark.parametrize("policy", remat.POLICIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(VICTIMS))
def test_loss_and_gradients_bit_equal_on_and_off(family, dtype, policy):
    """Remat changes what the backward keeps, not the arithmetic
    (`tests/test_attack.py::test_remat_on_off_same_results`): loss and
    both gradients are bit-equal (`torch.equal`)."""
    apply_fn = VictimForward(VICTIMS[family])
    off = _grads(apply_fn, dtype, False, policy, stage=0)
    on = _grads(apply_fn, dtype, True, policy, stage=0)
    assert torch.isfinite(off[0]) and off[2].abs().sum() > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", remat.POLICIES)
def test_remat_keeps_fewer_activations(policy):
    """The tensors the backward keeps outside the checkpoint regions (the
    block inputs, the stem and head) are fewer bytes with remat on; "conv"
    keeps ResNetV2's std-conv outputs inside them, "dots" its (absent)
    matmul outputs."""
    model = VICTIMS["resnetv2"]
    x = torch.rand(4, IMG, IMG, 3, requires_grad=True)

    def saved_bytes(on):
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if on:
                with remat.enabled(policy):
                    out = model(normalize(x))
            else:
                out = model(normalize(x))
        out.sum().backward()
        return sum(nbytes)

    assert saved_bytes(True) < saved_bytes(False) / 2


# ------------------------------------- the attack against the JAX package


@pytest.fixture(scope="module")
def synced():
    """Shallow full-width CIFAR ResNet-18 in both packages, same weights."""
    fnet = JaxCifarResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1))
    params = jax.jit(fnet.init)(jax.random.PRNGKey(3),
                                jnp.zeros((1, IMG, IMG, 3)))
    tnet = small.CifarResNet18(10, (1, 1, 1, 1))
    tnet.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    tnet.eval().requires_grad_(False)

    def japply(p, z):
        return fnet.apply(p, (z - 0.5) / 0.5)

    return japply, params, tnet


@pytest.mark.parametrize("stage", [0, 1])
def test_four_iterations_with_remat_match_jax(synced, stage):
    """Four steps with remat on in both packages (the port per block under
    "full", the JAX package's `jax.checkpoint` of the whole forward), the
    same EOT draws injected: at every iteration the loss and gradients
    agree within `tests/test_torch_attack.py`'s tolerance and the port
    applies the signed update of JAX's gradients."""
    japply, params, tnet = synced
    rng = np.random.default_rng(30 + stage)
    base = dict(sampling_size=4, dropout=1, basic_unit=4)
    jcfg = JaxAttackConfig(remat="on", **base)
    tcfg = AttackConfig(remat="on", **base)
    universe = jmasks.dropout_universe(IMG, 1, (0.06, 0.12))
    x = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    y = np.asarray([1, 2])
    lvx = np.asarray(jnp.mean(jlosses.local_variance(jnp.asarray(x))[0], -1))
    jatk = JaxDorPatch(japply, params, 10, jcfg, remat=True)
    tatk = DorPatch(VictimForward(tnet), 10, tcfg, remat=True)
    assert tatk._grad_fwd(8) is not tatk._fwd
    jgrad = jax.jit(jax.value_and_grad(jatk._loss_and_aux, argnums=(0, 1),
                                       has_aux=True), static_argnums=6)
    xt, lvt = _t(x), _t(lvx)
    state = tatk._init_state(tutils.generator(0, CPU), xt, _t(y), False,
                             universe.shape[0])
    jstate = jatk._init_state(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(y), False, universe.shape[0])
    for it in range(4):
        idx = rng.choice(universe.shape[0], 4, replace=False)
        mask = state.adv_mask.numpy()
        pattern = state.adv_pattern.numpy()
        # teacher-forced: the JAX loss reads the port's adapted carry
        jstate = jstate._replace(**{
            f: jnp.asarray(getattr(state, f).numpy())
            for f in ("coeff_gl", "coeff_struct", "coeff_density", "y",
                      "targeted")})
        (jtotal, _), (jg_mask, jg_pat) = jgrad(
            jnp.asarray(mask), jnp.asarray(pattern), jnp.asarray(x),
            jnp.asarray(lvx), jnp.asarray(universe[idx]), jstate, stage)
        m = state.adv_mask.clone().requires_grad_(True)
        p = state.adv_pattern.clone().requires_grad_(True)
        with torch.enable_grad():
            ttotal, _ = tatk._loss_and_aux(m, p, xt, lvt, _t(universe[idx]),
                                           state, stage)
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
        lr = state.lr.numpy()[:, None, None, None]
        want = np.clip(pattern - lr * np.sign(jg), 0, 1)
        np.testing.assert_allclose(new.adv_pattern.numpy()[sure], want[sure],
                                   rtol=0, atol=1e-7)
        assert int(new.step) == it + 1
        state = new


# ------------------------------------------------ flags and config keys


@pytest.mark.parametrize("argv", [
    [], ["--remat", "on"], ["--remat", "off"], ["--remat", "auto"],
    ["--remat-policy", "conv"], ["--remat", "on", "--remat-policy", "dots"],
    ["--sanitize"]])
def test_flags_match_jax_cli(argv):
    args = argv + ["--results-root", "/r"]
    cfg = config_from_args(build_parser().parse_args(args))
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(args))
    assert cfg.attack.remat == jcfg.attack.remat
    assert cfg.attack.remat_policy == jcfg.attack.remat_policy
    assert cfg.sanitize == jcfg.sanitize


def test_flags_refuse_what_the_jax_cli_refuses():
    for parser in (build_parser(), jcli.build_parser()):
        for argv in (["--remat", "maybe"], ["--remat-policy", "attn"]):
            with pytest.raises(SystemExit):
                parser.parse_args(argv)


def test_config_keys_round_trip_as_in_jax():
    """`remat`, `remat_threshold`, `remat_policy` and `sanitize` read back
    as the JAX package reads them; the port's own threshold default
    differs from the JAX package's 512 on purpose (its v5e calibration)."""
    d = {"sanitize": True, "attack": {"remat": "on", "remat_threshold": 512,
                                      "remat_policy": "conv"}}
    got, want = config_to_dict(config_from_dict(d)), jax_to_dict(
        jax_from_dict(d))
    assert got["sanitize"] is want["sanitize"] is True
    for key in ("remat", "remat_threshold", "remat_policy"):
        assert got["attack"][key] == want["attack"][key]
    assert config_from_dict(config_to_dict(config_from_dict(d))) == \
        config_from_dict(d)
    assert AttackConfig().remat_threshold == 1024
    assert JaxAttackConfig().remat_threshold == 512
