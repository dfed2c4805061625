"""The port's CIFAR ResNet-18 against `dorpatch_tpu.models.small` with
weights carried by `from_flax_params`, and the victim factory against
`dorpatch_tpu.models.registry` on a checkpoint in the export format."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu.models.small import CifarResNet18 as JaxCifarResNet18
from dorpatch_tpu_torch.models import registry as treg
from dorpatch_tpu_torch.models.convert import from_flax_params
from dorpatch_tpu_torch.models.small import CifarResNet18

# float32 through a few conv/GroupNorm layers in two frameworks
LOGIT_ATOL = 1e-4


def _perturbed_params(fnet, seed, img):
    """flax init plus random GroupNorm scales/biases and head bias, so the
    carried-over affine parameters are exercised too."""
    params = jax.jit(fnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = str(path[-1])
        if "scale" in name:
            return leaf + rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        if "bias" in name:
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.mark.parametrize("img", [32])
def test_logits_match_flax_full_and_stem_trunk(img):
    fnet = JaxCifarResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1))
    params_np = _perturbed_params(fnet, 3, img)
    tnet = CifarResNet18(10, (1, 1, 1, 1))
    tnet.load_state_dict(from_flax_params(params_np))
    tnet.eval()
    x = np.random.default_rng(4).uniform(-1, 1, (2, img, img, 3)) \
        .astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    want = np.asarray(fnet.apply(params, jnp.asarray(x)))
    want_stem = np.asarray(fnet.apply(params, jnp.asarray(x), "stem"))
    with torch.no_grad():
        got = tnet(torch.as_tensor(x)).numpy()
        stem = tnet(torch.as_tensor(x), "stem")
        got_split = tnet(stem, "trunk").numpy()
    np.testing.assert_allclose(stem.numpy(), want_stem, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_split, want, rtol=0, atol=LOGIT_ATOL)
    with pytest.raises(ValueError):
        tnet(torch.as_tensor(x), "bogus")


def test_state_dict_keys_match_the_export_format():
    """`from_flax_params` of the full-depth tree fills exactly the port's
    state_dict, and so does the JAX package's `.pth` export."""
    from dorpatch_tpu.models.convert import export_cifar_resnet18

    fnet = JaxCifarResNet18(num_classes=10)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(fnet.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 16, 16, 3))))
    tnet = CifarResNet18(10)
    sd = from_flax_params(params)
    assert set(sd) == set(tnet.state_dict())
    exported = export_cifar_resnet18(params)
    assert set(exported) == set(sd)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


def test_get_model_loads_export_checkpoint_like_jax(tmp_path):
    """Both factories load the same `.pth` (the train.py export format) and
    give the same logits; without a checkpoint the port initializes from its
    seed, deterministically."""
    from dorpatch_tpu.models.convert import export_cifar_resnet18
    from dorpatch_tpu.models.registry import checkpoint_path as jpath
    from dorpatch_tpu.models.registry import get_model as jget

    img = 16
    fnet = JaxCifarResNet18(num_classes=10)
    params_np = _perturbed_params(fnet, 5, img)
    path = treg.checkpoint_path(str(tmp_path), "cifar10", "cifar_resnet18")
    assert path == jpath(str(tmp_path), "cifar10", "cifar_resnet18")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in
                               export_cifar_resnet18(params_np).items()}},
               path)
    jv = jget("cifar10", "resnet18", str(tmp_path), img)
    tv = treg.get_model("cifar10", "resnet18", str(tmp_path), img,
                        device="cpu")
    assert tv.from_checkpoint and jv.from_checkpoint
    assert tv.name == jv.name == treg.resolve_arch("cifar_resnet18")
    x = np.random.default_rng(6).uniform(0, 1, (2, img, img, 3)) \
        .astype(np.float32)
    want = np.asarray(jv.apply(jv.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tv.apply(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert not any(p.requires_grad for p in tv.model.parameters())

    a = treg.get_model("cifar10", "resnet18", str(tmp_path / "none"), img,
                       seed=7, device="cpu")
    b = treg.get_model("cifar10", "resnet18", str(tmp_path / "none"), img,
                       seed=7, device="cpu")
    assert not a.from_checkpoint
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(ValueError, match="unknown architecture"):
        treg.resolve_arch("resmlp")
