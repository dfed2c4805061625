"""The port's ResNetV2-50x1 BiT against `dorpatch_tpu.models.resnetv2`: a
timm-named state_dict carried into the flax model by
`dorpatch_tpu.models.convert.convert_resnetv2` and loaded as it is into the
port, the `from_flax_resnetv2` round trip, the stem/trunk split, the SAME
pads and the zero-padded stem pool, the JAX model's interpret GN kernels,
and the victim factory on a timm checkpoint."""

import os

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from dorpatch_tpu.models import resnetv2 as jrv2
from dorpatch_tpu.models.convert import convert_resnetv2
from dorpatch_tpu_torch.models import registry as treg
from dorpatch_tpu_torch.models import resnetv2 as trv2
from dorpatch_tpu_torch.models.convert import from_flax_resnetv2
from dorpatch_tpu_torch.ops.stem_fold import same_pads

# float32 through std-convs and GroupNorms in two frameworks
LOGIT_ATOL = 1e-4


def _timm_state_dict(model: torch.nn.Module, seed: int):
    """Random values under the port's (timm's) keys: convs unit normal
    (standardized anyway), the head lecun-scaled, GroupNorm affines near
    (1, 0)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k == "head.fc.weight":
            a = rng.normal(0, 1 / np.sqrt(shape[1]), shape)
        elif k.endswith("conv.weight") or ".conv" in k:
            a = rng.normal(0, 1, shape)
        elif k.endswith("weight"):
            a = 1 + rng.normal(0, 0.2, shape)
        else:
            a = rng.normal(0, 0.2, shape)
        sd[k] = a.astype(np.float32)
    return sd


def _pair(layers, seed, classes=10, gn_impl="auto"):
    """The flax model with `convert_resnetv2` params and the port model
    with the same timm state_dict loaded."""
    tnet = trv2.ResNetV2(classes, layers)
    sd = _timm_state_dict(tnet, seed)
    tnet.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    fnet = jrv2.ResNetV2(num_classes=classes, layers=layers, gn_impl=gn_impl)
    params = jax.tree_util.tree_map(jnp.asarray, convert_resnetv2(sd, layers))
    return fnet, params, tnet.eval().requires_grad_(False)


def _images(seed, n, img):
    return np.random.default_rng(seed).uniform(-1, 1, (n, img, img, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("img", [32, 45])
def test_logits_match_flax_shallow(img):
    fnet, params, tnet = _pair((1, 1), 1)
    x = _images(2, 2, img)
    want = np.asarray(fnet.apply(params, jnp.asarray(x)))
    want_stem = np.asarray(fnet.apply(params, jnp.asarray(x), "stem"))
    with torch.no_grad():
        got = tnet(torch.as_tensor(x)).numpy()
        stem = tnet(torch.as_tensor(x), "stem").numpy()
    np.testing.assert_allclose(stem, want_stem, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_logits_match_jax_interpret_gn_kernels():
    """The JAX model with every GroupNorm+ReLU through the Pallas kernel in
    interpret mode."""
    fnet, params, tnet = _pair((1, 1), 3, gn_impl="interpret")
    x = _images(4, 2, 16)
    want = np.asarray(fnet.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_from_flax_params_round_trip():
    """flax init -> `from_flax_resnetv2` fills exactly the port's
    state_dict, and `convert_resnetv2` of it gives the flax tree back."""
    layers = (1, 2)
    fnet = jrv2.ResNetV2(num_classes=7, layers=layers)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(fnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    sd = from_flax_resnetv2(params)
    tnet = trv2.ResNetV2(7, layers)
    assert set(sd) == set(tnet.state_dict())
    tnet.load_state_dict(sd)
    back = convert_resnetv2({k: v.numpy() for k, v in sd.items()}, layers)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_full_equals_trunk_of_stem():
    tnet = trv2.ResNetV2(10, (1, 1))
    trv2.init_weights(tnet, torch.Generator().manual_seed(0))
    x = torch.as_tensor(_images(5, 2, 24))
    with torch.no_grad():
        full = tnet(x)
        split = tnet(tnet(x, "stem"), "trunk")
    assert torch.equal(full, split)
    with pytest.raises(ValueError):
        tnet(x, "bogus")
    with pytest.raises(ValueError):
        tnet.set_gn_impl("pallas")


@pytest.mark.parametrize("size,k,s,cin,want_pads", [(224, 7, 2, 3, (2, 3)),
                                                    (56, 3, 2, 8, (0, 1)),
                                                    (56, 1, 2, 8, (0, 0)),
                                                    (56, 3, 1, 8, (1, 1))])
def test_same_pads_and_std_conv_match_flax(size, k, s, cin, want_pads):
    """TF SAME is asymmetric at a stride of 2: (2, 3) for the 7x7/2 stem at
    224 and (0, 1) for a 3x3/2 conv at 56; the port's StdConv equals the
    flax StdConv there."""
    assert same_pads(size, k, s) == want_pads
    rng = np.random.default_rng(size + k)
    w = rng.normal(0, 1, (8, cin, k, k)).astype(np.float32)
    x = rng.uniform(-1, 1, (1, size, size, cin)).astype(np.float32)
    conv = trv2.StdConv(cin, 8, k, s)
    conv.weight.data = torch.as_tensor(w)
    with torch.no_grad():
        got = conv(torch.as_tensor(x)).numpy()
    fconv = jrv2.StdConv(8, (k, k), (s, s))
    want = np.asarray(fconv.apply(
        {"params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}},
        jnp.asarray(x)))
    assert got.shape == want.shape == (1, -(-size // s), -(-size // s), 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_stem_pool_pads_with_zeros():
    """All-negative stem activations: the zero pad (not -inf) wins at the
    border windows, as in the JAX module."""
    x = -np.random.default_rng(6).uniform(0.1, 1, (2, 12, 12, 4)) \
        .astype(np.float32)
    got = trv2.stem_pool(torch.as_tensor(x)).numpy()
    want = np.asarray(nn.max_pool(
        jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0))), (3, 3),
        strides=(2, 2), padding="VALID"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 6, 6, 4)
    assert (got[:, 0] == 0).all() and (got[:, :, 0] == 0).all()
    assert (got[:, 1:, 1:] < 0).all()


def test_get_model_loads_timm_checkpoint_like_jax(tmp_path):
    """Both factories load the same timm-named `.pth` of the full-depth
    (3, 4, 6, 3) ResNetV2-50x1 and give the same logits at a small image
    size; `--base_arch resnetv2` resolves as in the JAX package."""
    from dorpatch_tpu.models.registry import checkpoint_path as jpath
    from dorpatch_tpu.models.registry import get_model as jget
    from dorpatch_tpu.models.registry import resolve_arch as jresolve

    name = treg.resolve_arch("resnetv2")
    assert name == jresolve("resnetv2") == "resnetv2_50x1_bit_distilled"
    img = 32
    sd = _timm_state_dict(trv2.resnetv2_50x1(1000), 7)
    path = treg.checkpoint_path(str(tmp_path), "imagenet", name)
    assert path == jpath(str(tmp_path), "imagenet", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {"module." + k: torch.as_tensor(v)
                               for k, v in sd.items()}}, path)
    jv = jget("imagenet", "resnetv2", str(tmp_path), img)
    tv = treg.get_model("imagenet", "resnetv2", str(tmp_path), img,
                        device="cpu")
    assert tv.from_checkpoint and jv.from_checkpoint and tv.name == name
    assert tv.incremental.kernel_hw == 7 and tv.incremental.strides == (2, 2)
    assert tv.incremental.pads == (same_pads(img, 7, 2),) * 2
    x = np.random.default_rng(8).uniform(0, 1, (2, img, img, 3)) \
        .astype(np.float32)
    want = np.asarray(jv.apply(jv.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tv.apply(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert not any(p.requires_grad for p in tv.model.parameters())
    assert treg.resolve_arch("resmlp") == "resmlp_24_distilled_224"
    with pytest.raises(ValueError, match="unknown architecture"):
        treg.resolve_arch("mlp_mixer")
