"""The port's masked fill (kernels A and B on the card) on the CPU: its
plain version against `dorpatch_tpu.ops.masked_fill`, forward and
backward, plus the wrapper's dispatch and argument checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.ops.masked_fill import masked_fill as jax_masked_fill
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops import masked_fill as tfill

# backward: summation order over the mask axis differs between the two
# frameworks (sequential grid steps vs a vectorized reduction)
BWD_TOL = dict(rtol=1e-5, atol=1e-6)


def _case(seed, b=2, size=16, s=9, k=2):
    rng = np.random.default_rng(seed)
    universe = jmasks.pad_rects(jmasks.dropout_universe(size, 2), k)
    rects = universe[rng.choice(len(universe), s, replace=False)]
    imgs = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    return imgs, rects.astype(np.int32)


@pytest.mark.parametrize("mode", ["interpret", "off"])
@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3)])
def test_forward_equals_jax_exactly(mode, seed, k):
    imgs, rects = _case(seed, k=k)
    want = np.asarray(jax_masked_fill(jnp.asarray(imgs), jnp.asarray(rects),
                                      0.5, use_pallas=mode))
    got = tfill.masked_fill(torch.as_tensor(imgs), torch.as_tensor(rects), 0.5)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_backward_matches_jax_grad_through_interpret():
    """d/dimgs of sum(fill(imgs) * w) with a positive cotangent w: the image
    cotangent sum_s w[b, s] * keep[s]."""
    imgs, rects = _case(2, s=12)
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 1, (2, 12, 16, 16, 3)).astype(np.float32)

    def jloss(x):
        out = jax_masked_fill(x, jnp.asarray(rects), 0.5,
                              use_pallas="interpret")
        return jnp.sum(out * jnp.asarray(w))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(imgs)))
    x = torch.as_tensor(imgs).requires_grad_(True)
    out = tfill.masked_fill(x, torch.as_tensor(rects), 0.5)
    (got,) = torch.autograd.grad((out * torch.as_tensor(w)).sum(), x)
    np.testing.assert_allclose(got.numpy(), want, **BWD_TOL)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    imgs, rects = _case(4)
    _backend.reset_launch_counts()
    out = tfill.masked_fill(torch.as_tensor(imgs), rects, 0.25)
    ref = tfill.masked_fill_reference(torch.as_tensor(imgs),
                                      torch.as_tensor(rects), 0.25)
    assert torch.equal(out, ref)
    assert _backend.launch_counts() == {"masked_fill_fwd": 0,
                                        "masked_fill_bwd": 0, "stem_fold": 0,
                                        "gn_relu_fwd": 0, "gn_relu_bwd": 0,
                                        "masked_kv_attn": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers only take CUDA tensors: no silent plain path."""
    imgs, rects = _case(5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfill.masked_fill_fwd_kernel(torch.as_tensor(imgs),
                                     torch.as_tensor(rects), 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfill.masked_fill_bwd_kernel(torch.as_tensor(rects),
                                     torch.zeros(2, 9, 16, 16, 3))
