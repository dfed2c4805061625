"""The port's GroupNorm+ReLU (`dorpatch_tpu_torch.ops.fused_gn`) on the CPU:
the plain forward and backward against `dorpatch_tpu.ops.fused_gn` (the
Pallas kernels in interpret mode, whole-slab and HW-tiled, and the jnp
reference), and the dispatch rule. The CUDA kernels are held against these
plain versions on the card (`test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu.ops import fused_gn as jgn
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops import fused_gn as tgn

# float32 statistics and normalize in two frameworks, summed in their own
# orders
FWD_ATOL = 1e-5
# the backward's group sums, as tests/test_fused_gn.py holds the JAX kernel
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _case(seed, shape, groups=32):
    """x with a nonzero per-channel mean, the affine as the JAX tests draw
    it, and a cotangent."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) + rng.normal(0, 0.5, c)).astype(np.float32)
    scale = (rng.uniform(0, 1, c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.uniform(0, 1, c) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(2, 4, 4, 64), (3, 7, 7, 128),
                                   (2, 2, 2, 256)])
@pytest.mark.parametrize("impl", ["interpret", "jnp"])
def test_plain_forward_matches_jax(shape, impl):
    x, scale, bias, _ = _case(sum(shape), shape)
    want = np.asarray(jgn.gn_relu(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), 32, impl=impl))
    got = tgn.gn_relu(_t(x), _t(scale), _t(bias), 32)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)
    np.testing.assert_array_equal(
        tgn.gn_relu_reference(_t(x), _t(scale), _t(bias)).numpy(),
        got.numpy())


def _jax_grads(x, scale, bias, dy, impl):
    def loss(a, s, b):
        return jnp.sum(jgn.gn_relu(a, s, b, 32, impl=impl) * jnp.asarray(dy))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))]


@pytest.mark.parametrize("shape", [(2, 4, 4, 64), (2, 3, 3, 128)])
def test_plain_backward_and_autograd_match_jax_kernel_grads(shape):
    """The written-out backward formula and autograd of the plain forward,
    both against `jax.grad` through the interpret kernel's custom VJP."""
    x, scale, bias, dy = _case(10 + shape[-1], shape)
    want = _jax_grads(x, scale, bias, dy, "interpret")
    mean, rstd = tgn.gn_stats_reference(_t(x), 32)
    formula = tgn.gn_relu_backward_reference(_t(x), _t(dy), _t(scale),
                                             _t(bias), mean, rstd, 32)
    xs, ss, bs = (_t(a).requires_grad_(True) for a in (x, scale, bias))
    auto = torch.autograd.grad(
        (tgn.gn_relu_reference(xs, ss, bs) * _t(dy)).sum(), (xs, ss, bs))
    for got in (formula, auto):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **BWD_TOL)


def test_plain_versions_match_the_jax_tiled_kernels():
    """A shape that the JAX package tiles (4 HW tiles of the two-pass
    forward and backward), in interpret mode."""
    shape = (2, 8, 8, 64)
    x, scale, bias, dy = _case(3, shape)
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    y, jmean, jrstd = jgn._pallas_fwd_tiled(jx, js, jb, 32, 1e-5, 4, True)
    mean, rstd = tgn.gn_stats_reference(_t(x), 32)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(
        tgn.gn_relu_reference(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(y), rtol=0, atol=FWD_ATOL)
    want = jgn._pallas_bwd_tiled(jx, jnp.asarray(dy), js, jb, jmean, jrstd,
                                 32, 4, True)
    got = tgn.gn_relu_backward_reference(_t(x), _t(dy), _t(scale), _t(bias),
                                         mean, rstd, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


def test_float64_plain_versions_agree_with_float32():
    """The card checks hold the kernels against the plain versions in
    float64; those compute in float64 and agree with the float32 ones."""
    x, scale, bias, dy = _case(4, (2, 4, 4, 64))
    y32 = tgn.gn_relu_reference(_t(x), _t(scale), _t(bias))
    y64 = tgn.gn_relu_reference(_t(x).double(), _t(scale).double(),
                                _t(bias).double())
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), rtol=0,
                               atol=FWD_ATOL)
    m64, r64 = tgn.gn_stats_reference(_t(x).double(), 32)
    assert m64.dtype == torch.float64
    g64 = tgn.gn_relu_backward_reference(_t(x).double(), _t(dy).double(),
                                         _t(scale).double(),
                                         _t(bias).double(), m64, r64, 32)
    m32, r32 = tgn.gn_stats_reference(_t(x), 32)
    g32 = tgn.gn_relu_backward_reference(_t(x), _t(dy), _t(scale),
                                         _t(bias), m32, r32, 32)
    for a, b in zip(g32, g64):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), **BWD_TOL)


def test_gate_flip_bounds_cover_flipped_gates():
    """The bias enters the backward only through the ReLU gate, so a bias
    shifted by just under `near` flips every gate within `near` of 0 one way;
    the moves of dx (elsewhere), dscale and dbias stay inside the bounds the
    card checks allow for such flips."""
    near = 0.05
    x, scale, bias, dy = (_t(a).double() for a in _case(7, (2, 6, 6, 64)))
    mean, rstd = tgn.gn_stats_reference(x, 32)
    near_zero, dx_b, ds_b, db_b = tgn.gate_flip_bounds(x, dy, scale, bias,
                                                       mean, rstd, 32, near)
    assert 0 < int(near_zero.sum()) < near_zero.numel()
    base = tgn.gn_relu_backward_reference(x, dy, scale, bias, mean, rstd, 32)
    for shift in (0.999 * near, -0.999 * near):
        alt = tgn.gn_relu_backward_reference(x, dy, scale, bias + shift, mean,
                                             rstd, 32)
        moved = (alt[0] - base[0]).abs()
        assert moved.max() > 0
        assert (moved[~near_zero] <= dx_b[~near_zero] + 1e-12).all()
        assert ((alt[1] - base[1]).abs() <= ds_b + 1e-12).all()
        assert ((alt[2] - base[2]).abs() <= db_b + 1e-12).all()


def test_cpu_tensor_takes_the_plain_version_without_launching():
    x, scale, bias, _ = _case(5, (2, 4, 4, 64))
    _backend.reset_launch_counts()
    tgn.gn_relu(_t(x), _t(scale), _t(bias))
    counts = _backend.launch_counts()
    assert counts["gn_relu_fwd"] == counts["gn_relu_bwd"] == 0
    with pytest.raises(ValueError, match="not divisible"):
        tgn.gn_relu(torch.zeros(1, 2, 2, 48), torch.ones(48),
                    torch.zeros(48))


def test_kernel_wrappers_refuse_cpu_tensors():
    x, scale, bias, dy = (_t(a) for a in _case(6, (1, 2, 2, 64)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgn.gn_relu_fwd_kernel(x, scale, bias)
    mean, rstd = tgn.gn_stats_reference(x, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgn.gn_relu_bwd_kernel(x, dy, scale, bias, mean, rstd)
