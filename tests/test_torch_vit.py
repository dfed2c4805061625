"""The port's ViT family (`dorpatch_tpu_torch.models.vit`) against
`dorpatch_tpu.models.vit` on the CPU, with the same weights in both
packages: token coverage and the engine's lookup tables, the victim's
logits in "full" and "cache" modes (weights carried by `from_flax_vit` and
by the JAX package's `export_vit` loaded with `strict=True`), and the token
engine's three programs against `TokenViTFamily` with the einsum attention
("off") and the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.models import convert as jconvert
from dorpatch_tpu.models import vit as jvit
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch.models import registry
from dorpatch_tpu_torch.models import vit as tvit
from dorpatch_tpu_torch.models.convert import from_flax_vit

# float32 through a few transformer blocks in two frameworks
LOGIT_ATOL = 1e-4
#: a narrow ViT (2 layers, D 32, 2 heads) and the JAX package's cifar_vit
NARROW = dict(patch_size=4, dim=32, depth=2, num_heads=2)
CONFIGS = {"narrow": NARROW,
           "cifar_vit": {k: v for k, v in jvit.CIFAR_VIT.items()
                         if k != "img_size"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The narrow models run thousands of small ops: one intra-op thread
    keeps them from contending with the other test processes' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rects(img, ratio):
    """The certifier's combined `[singles; pairs]` rectangle table."""
    singles, doubles = jmasks.mask_sets(jmasks.geometry(img, ratio))
    k = max(singles.shape[1], doubles.shape[1])
    return (np.concatenate([jmasks.pad_rects(singles, k),
                            jmasks.pad_rects(doubles, k)]), len(singles))


def synced_vit(cfg, img, seed, classes=10, head_scale=4.0):
    """The same ViT in both packages: flax init with the LayerNorm affines,
    cls token and position embedding perturbed so that every carried
    parameter is exercised, and the head scaled so that masks move the
    random victim's predictions. Returns (flax module, params, port
    module)."""
    fnet = jvit.ViT(num_classes=classes, img_size=(img, img), **cfg)
    params = jax.jit(fnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] == "scale":
            return leaf + rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        if keys[-1] == "cls_token" or (keys[-1] == "bias"
                                       and "norm" in keys[-2]):
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        if keys[-1] == "pos_embed":
            return leaf * 10
        if keys[-2] == "head":
            return leaf * head_scale
        return leaf

    params_np = jax.tree_util.tree_map_with_path(perturb, params)
    tnet = tvit.ViT(classes, img_size=img, **cfg)
    tnet.load_state_dict(from_flax_vit(params_np))
    tnet = tnet.eval().requires_grad_(False)
    return fnet, jax.tree_util.tree_map(jnp.asarray, params_np), tnet


def _images(seed, b, img):
    return np.random.default_rng(seed).uniform(0, 1, (b, img, img, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("img,patch,ratio", [(32, 4, 0.12), (32, 4, 0.015),
                                             (224, 16, 0.12)])
def test_token_coverage_and_tables_match_jax(img, patch, ratio):
    spec = jmasks.geometry(img, ratio)
    rects, m = _rects(img, ratio)
    np.testing.assert_array_equal(
        tmasks.rect_token_coverage(rects, img, patch),
        jmasks.rect_token_coverage(rects, img, patch))
    np.testing.assert_array_equal(
        tmasks.token_coverage(tmasks.geometry(img, ratio), patch),
        jmasks.token_coverage(spec, patch))
    for part in (rects[:m], rects[m:]):
        got = tvit.build_tables(part, img, patch)
        want = jvit._build_tables(part, img, patch)
        for name in got._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)))
    with pytest.raises(ValueError, match="does not divide"):
        tmasks.token_coverage(tmasks.geometry(img, ratio), patch + 1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vit_logits_and_cache_match_flax(name):
    img = 32
    fnet, params, tnet = synced_vit(CONFIGS[name], img, 1)
    x = _images(2, 2, img)
    want = np.asarray(fnet.apply(params, jnp.asarray(x)))
    want_cache = fnet.apply(params, jnp.asarray(x), "cache")
    # the JAX package's own timm-named export, loaded strictly
    sd = jconvert.export_vit(jax.tree_util.tree_map(np.asarray, params))
    strict = tvit.ViT(10, img_size=img, **CONFIGS[name])
    strict.load_state_dict({k: torch.as_tensor(np.array(v))
                            for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        for net in (tnet, strict.eval()):
            got = net(torch.as_tensor(x)).numpy()
            np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
            cache = net(torch.as_tensor(x), "cache")
            assert len(cache) == len(want_cache) == CONFIGS[name]["depth"]
            for a, w in zip(cache, want_cache):
                np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                           atol=LOGIT_ATOL, rtol=0)
    assert len(set(np.argmax(want, -1).tolist())) > 1 or want.std() > 0
    with pytest.raises(ValueError, match="mode"):
        tnet(torch.as_tensor(x), "stem")


def test_registry_builds_both_vits_and_their_engines():
    """`--base_arch vit` and `cifar_vit` resolve to the JAX package's names;
    the engine is the token one, and None where the patch does not divide
    the image (as the JAX registry has it)."""
    assert registry.resolve_arch("vit") == "vit_base_patch16_224"
    assert registry.resolve_arch("cifar_vit") == "cifar_vit"
    victim = registry.get_model("cifar10", "cifar_vit", "/nonexistent", 32,
                                device="cpu")
    assert isinstance(victim.incremental, tvit.TokenPrunedViT)
    assert victim.incremental.kind == "token"
    assert tuple(victim.model.pos_embed.shape) == (1, 65, 128)
    assert float(victim.model.cls_token.abs().max()) == 0.0
    std = float(victim.model.pos_embed.std())
    assert 0.015 < std < 0.025
    w = victim.model.blocks[0].mlp.fc1.weight
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
    assert float(victim.model.head.bias.abs().max()) == 0.0
    odd = registry.get_model("cifar10", "cifar_vit", "/nonexistent", 30,
                             device="cpu")
    assert odd.incremental is None


@pytest.fixture(scope="module")
def engines():
    """The narrow ViT's token engine in both packages on a 0.12-radius
    table at 32 px."""
    img, ratio = 32, 0.12
    fnet, params, tnet = synced_vit(NARROW, img, 3)
    rects, m = _rects(img, ratio)
    norm = registry.normalize
    jeng = jvit.TokenPrunedViT(fnet, img, normalize=lambda z: (z - 0.5) / 0.5)
    teng = tvit.TokenPrunedViT(tnet, img, normalize=norm)
    tfam = teng.build_family(rects, m, 64, 0.5)
    x = _images(4, 2, img)
    return jeng, params, rects, m, tfam, x


def _agree(tp, tm, jp, jm):
    np.testing.assert_allclose(tm, jm, atol=1e-4, rtol=0)
    sure = np.minimum(tm, jm) > 1e-3
    np.testing.assert_array_equal(tp[sure], jp[sure])
    return sure


@pytest.mark.parametrize("use_pallas", ["off", "interpret"])
@pytest.mark.parametrize("program", ["phase1", "pairs", "rows"])
def test_token_engine_matches_jax(engines, program, use_pallas):
    jeng, params, rects, m, tfam, x = engines
    jfam = jeng.build_family(rects, m, 64, 0.5, use_pallas=use_pallas)
    if program == "rows":
        sets = jmasks.second_round_table_indices(m)[[3, 7, 20, 35]]
        xg = x[[0, 1, 0, 1]]
        jp, jm = map(np.asarray, jax.jit(jfam.rows)(
            params, jnp.asarray(xg), jnp.asarray(sets, dtype=jnp.int32)))
        tp, tm = (t.numpy() for t in tfam.rows(torch.as_tensor(xg),
                                               torch.as_tensor(sets)))
    else:
        jp, jm = map(np.asarray, jax.jit(getattr(jfam, program))(
            params, jnp.asarray(x)))
        tp, tm = (t.numpy() for t in getattr(tfam, program)(
            torch.as_tensor(x)))
    assert tp.shape == jp.shape and tp.dtype == np.int32
    sure = _agree(tp, tm, jp, jm)
    assert sure.mean() > 0.9
    assert len(set(tp.ravel().tolist())) > 1   # the masks move predictions


def test_token_engine_forward_equivalents_match_jax(engines):
    jeng, _, rects, m, tfam, _ = engines
    jfam = jeng.build_family(rects, m, 64, 0.5, use_pallas="off")
    np.testing.assert_array_equal(tfam.fe, jfam.fe)
    assert (tfam.fe_first, tfam.fe_pairs, tfam.cache_fe) == \
        (jfam.fe_first, jfam.fe_pairs, jfam.cache_fe)
    assert 0 < tfam.fe.min() and tfam.fe.max() < 1
