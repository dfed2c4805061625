"""The port's masked-KV attention (`dorpatch_tpu_torch.ops.masked_kv_attn`)
on the CPU: the plain version against `dorpatch_tpu.ops.masked_kv_attn`'s
einsum reference and its Pallas kernel in interpret mode, and the dispatch
rule. Kernel H is held against this plain version on the card
(`test_torch_cuda_kernels.py`, `chip_smoke.py`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dorpatch_tpu.ops import masked_kv_attn as jattn
from dorpatch_tpu_torch.ops import _backend
from dorpatch_tpu_torch.ops import masked_kv_attn as tattn

# float32 softmax over two groups, reassociated; as tests/test_kernel_tier.py
# holds the Pallas kernel against the einsum composition
TOL = dict(atol=2e-6, rtol=2e-6)


def _case(seed, b, c, s, h, f, t):
    """Inputs from a numpy seed with -1e9 patterns: stale clean columns and
    duplicate dirty slots, dirty slot 0 always live (as the engine keeps
    it)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, kd, vd = (normal(b, c, s, h, f) for _ in range(3))
    kc, vc = (normal(b, t, h, f) for _ in range(2))
    clean_bias = np.where(rng.uniform(size=(b, c, t)) < 0.2, -1e9,
                          0.0).astype(np.float32)
    dirty_bias = np.where(rng.uniform(size=(b, c, s)) < 0.25, -1e9,
                          0.0).astype(np.float32)
    dirty_bias[:, :, 0] = 0.0
    q = (q / np.sqrt(f)).astype(np.float32)
    return q, kd, vd, kc, vc, clean_bias, dirty_bias


SHAPES = [(2, 3, 4, 2, 8, 9), (2, 4, 17, 4, 64, 65)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference_and_pallas(shape):
    args = _case(0, *shape)
    got = tattn.masked_kv_attention_reference(
        *(torch.from_numpy(a) for a in args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jattn.masked_kv_attention_reference(*jargs))
    pallas = np.asarray(jattn.masked_kv_attention(*jargs, interpret=True))
    assert got.shape == shape[:5]
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_masked_keys_get_no_weight():
    """A -1e9 key contributes nothing: changing its value leaves the output
    as it is, and a row whose only live keys are one clean and one dirty
    key averages their values by their softmax weights."""
    b, c, s, h, f, t = 1, 2, 3, 1, 4, 5
    q, kd, vd, kc, vc, cb, db = (torch.from_numpy(a) for a in
                                 _case(1, b, c, s, h, f, t))
    cb[:] = -1e9
    cb[..., 2] = 0.0
    db[:] = -1e9
    db[..., 0] = 0.0
    out = tattn.masked_kv_attention_reference(q, kd, vd, kc, vc, cb, db)
    vc2, vd2 = vc.clone(), vd.clone()
    vc2[:, 0] += 100.0
    vd2[:, :, 1:] += 100.0
    torch.testing.assert_close(
        tattn.masked_kv_attention_reference(q, kd, vd2, kc, vc2, cb, db),
        out)
    lc = torch.einsum("bcshf,bhf->bchs", q, kc[:, 2])
    ld = torch.einsum("bcshf,bchf->bchs", q, kd[:, :, 0])
    w = torch.softmax(torch.stack([lc, ld], dim=-1), dim=-1)
    want = (w[..., 0, None] * vc[:, None, None, 2].permute(0, 1, 2, 3, 4)
            .reshape(b, 1, 1, h, f).expand(b, c, s, h, f).permute(0, 1, 3, 2, 4)
            .reshape(b, c, h, s, f)
            + w[..., 1, None] * vd[:, :, 0][:, :, :, None, :]
            .expand(b, c, h, s, f))
    torch.testing.assert_close(out, want.permute(0, 1, 3, 2, 4),
                               atol=1e-6, rtol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args = [torch.from_numpy(a) for a in _case(2, *SHAPES[0])]
    _backend.reset_launch_counts()
    got = tattn.masked_kv_attention(*args)
    assert _backend.launch_counts()["masked_kv_attn"] == 0
    torch.testing.assert_close(
        got, tattn.masked_kv_attention_reference(*args), atol=0, rtol=0)


def test_kernel_entry_refuses_cpu_tensors_and_bad_shapes():
    args = [torch.from_numpy(a) for a in _case(3, *SHAPES[0])]
    with pytest.raises(ValueError, match="CUDA"):
        tattn.masked_kv_attention_kernel(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.masked_kv_attention(*(a.to("meta") for a in args))
