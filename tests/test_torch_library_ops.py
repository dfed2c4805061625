"""The kernels as `torch.library` ops (`dorpatch_torch::`, `ops/_library.py`):
`torch.library.opcheck` of every op on the CPU at small float32 and bf16
shapes (schema, fake kernel, autograd registration, AOT dispatch); the
fake kernels' metadata equal to the plain versions' outputs; the CPU
kernel the plain version (no launch counted); the wrappers' autograd
through the ops equal to autograd of the plain versions; the kernel
entries refusing CPU tensors; and the profiler's transitions waiting for
the kernels' op calls (`observe.timing.KernelGate`).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from dorpatch_tpu_torch import ops  # noqa: E402
from dorpatch_tpu_torch.ops import _library  # noqa: E402
from dorpatch_tpu_torch.ops import fused_gn as gn  # noqa: E402
from dorpatch_tpu_torch.ops import masked_fill as mf  # noqa: E402
from dorpatch_tpu_torch.ops import masked_kv_attn as kv  # noqa: E402
from dorpatch_tpu_torch.ops import stem_fold as sf  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)


def _gen():
    return torch.Generator().manual_seed(0)


def _rects():
    return torch.tensor([[[0, 4, 0, 4]], [[2, 6, 1, 3]], [[0, 0, 0, 0]]],
                        dtype=torch.int32)


def cases(dtype):
    """(op, args) of every op at a small shape of `dtype` (kernel B and
    its float64 form at float32: no bf16 cotangent reaches the fill)."""
    g = _gen()
    imgs = torch.rand(2, 8, 8, 3, generator=g).to(dtype)
    x = torch.randn(2, 4, 4, 64, generator=g).to(dtype)
    sc, bi = torch.randn(64, generator=g), torch.randn(64, generator=g)
    _, mean, rstd = mf_free_stats(x, sc, bi)
    dy = torch.randn(x.shape, generator=g).to(dtype)
    q = torch.randn(2, 3, 2, 2, 32, generator=g).to(dtype)
    kc = torch.randn(2, 5, 2, 32, generator=g).to(dtype)
    attn = (q, q.clone(), q.clone(), kc, kc.clone(),
            torch.zeros(2, 3, 5).to(dtype), torch.zeros(2, 3, 2).to(dtype))
    kern = torch.randn(3, 3, 3, 64, generator=g).to(dtype)
    clean = torch.randn(2, 8, 8, 64, generator=g).to(dtype)
    up = torch.randn(2, 11, 11, 3, generator=g).to(dtype)
    geo = torch.tensor([[0, 0, 0, 0], [2, 3, 2, 3]], dtype=torch.int32)
    occ = (torch.rand(2, 6, 6, generator=g) > 0.5).to(dtype)
    out = [
        (mf.masked_fill_fwd_op, (imgs, _rects(), 0.5)),
        (mf.masked_fill_fwd_op, (imgs, _rects(), 0.5, True)),
        (gn.gn_relu_fwd_op, (x, sc, bi, 32, 1e-5)),
        (gn.gn_relu_bwd_op, (x, dy, sc, bi, mean, rstd, 32, True)),
        (gn.gn_relu_bwd_op, (x, dy, sc, bi, mean, rstd, 32, False)),
        (kv.masked_kv_attn_op, attn),
        (kv.masked_kv_attn_op, attn + (True,)),
        (sf.stem_fold_op, (kern, clean, up, geo, occ, 4, 4, 1)),
    ]
    if dtype == torch.float32:
        gg = torch.randn(2, 3, 8, 8, 3, generator=g)
        out += [(mf.masked_fill_bwd_op, (_rects(), gg)),
                (mf.masked_fill_bwd_op, (_rects(), gg, 4, 1))]
    return out


def mf_free_stats(x, sc, bi):
    return gn.gn_relu_fwd_op(x, sc, bi, 32, 1e-5)


def _ids(dtype):
    return [f"{op._schema.name.split('::')[1]}-{i}"
            for i, (op, _) in enumerate(cases(dtype))]


def test_every_kernel_entry_is_an_op():
    names = [name for name, _ in _library.ops()]
    assert names == ["masked_fill_fwd", "masked_fill_bwd", "stem_fold",
                     "gn_relu_fwd", "gn_relu_bwd", "masked_kv_attn"]
    for _, op in _library.ops():
        assert op.namespace == "dorpatch_torch"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_opcheck(dtype):
    for op, args in cases(dtype):
        torch.library.opcheck(op, args)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fake_metadata_equals_the_plain_versions(dtype):
    """Each fake output's shape, dtype, strides and memory format are the
    CPU kernel's (the plain version's) — kernel B's float64 form and the
    GroupNorm statistics included."""
    for op, args in cases(dtype):
        real = op(*args)
        mode = FakeTensorMode()
        with mode:
            fargs = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                          else a for a in args)
            fake = op(*fargs)
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert len(real) == len(fake)
        for r, f in zip(real, fake):
            assert (tuple(r.shape), r.dtype, r.stride()) == (
                tuple(f.shape), f.dtype, f.stride()), op


def test_cpu_kernels_are_the_plain_versions_and_count_nothing():
    ops.reset_launch_counts()
    imgs = torch.rand(2, 8, 8, 3, generator=_gen())
    got = mf.masked_fill_fwd_op(imgs, _rects(), 0.5)
    assert torch.equal(got, mf.masked_fill_reference(imgs, _rects(), 0.5))
    x = torch.randn(2, 4, 4, 64, generator=_gen())
    sc, bi = torch.ones(64), torch.zeros(64)
    y, mean, rstd = gn.gn_relu_fwd_op(x, sc, bi, 32, 1e-5)
    assert torch.equal(y, gn.gn_relu_reference(x, sc, bi, 32))
    m, r = gn.gn_stats_reference(x, 32)
    assert torch.equal(mean, m) and torch.equal(rstd, r)
    b64 = mf.masked_fill_bwd_op(_rects(), torch.ones(2, 3, 8, 8, 3), 4, 1)
    assert b64.dtype == torch.float64 and b64[0].abs().sum() == 0
    assert b64[3].abs().sum() == 0 and b64[1:3].abs().sum() > 0
    assert all(v == 0 for v in ops.launch_counts().values())


def test_fill_gradient_through_the_ops_equals_autograd_of_the_plain():
    """The image cotangent of `masked_fill` (kernel B's op on the CPU) is
    bit-equal to autograd of the plain fill."""
    imgs = torch.rand(2, 8, 8, 3, generator=_gen())
    g = torch.randn(2, 3, 8, 8, 3, generator=_gen())
    x1 = imgs.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(mf.masked_fill(x1, _rects(), 0.5), x1, g)
    x2 = imgs.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        mf.masked_fill_reference(x2, _rects(), 0.5), x2, g)
    assert torch.equal(got, want)


def test_gn_gradient_through_the_ops_matches_autograd_of_the_plain():
    x = torch.randn(2, 4, 4, 64, generator=_gen(), dtype=torch.float64)
    sc = torch.randn(64, generator=_gen(), dtype=torch.float64)
    bi = torch.randn(64, generator=_gen(), dtype=torch.float64)
    dy = torch.randn(x.shape, generator=_gen(), dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (x, sc, bi)]
    got = torch.autograd.grad(gn.gn_relu(*leaves, 32), leaves, dy)
    leaves = [t.clone().requires_grad_(True) for t in (x, sc, bi)]
    want = torch.autograd.grad(gn.gn_relu_reference(*leaves, 32), leaves, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_stem_fold_uniform_plain_equals_the_natural_plain():
    """The stem fold's CPU kernel (the family-uniform windows) equals the
    plain fold over each mask's natural window."""
    from dorpatch_tpu_torch import masks as masks_lib

    size, k, s, pads = 16, 3, 1, ((1, 1), (1, 1))
    spec = masks_lib.geometry(size, 0.12)
    singles, _ = masks_lib.mask_sets(spec)
    plan = sf.plan_windows(singles, size, k, s, pads)
    g = _gen()
    kern = torch.randn(k, k, 3, 8, generator=g)
    clean = torch.randn(2, size, size, 8, generator=g)
    u = torch.randn(2, size, size, 3, generator=g)
    want = sf.fold_masked_stem(kern, clean, u, plan, (s, s), pads)
    oh, ow, geo, occ = sf._uniform_plan(plan, size, size, k, s)
    got = sf.fold_stem(kern, clean, sf.pad_for_kernel(u, pads, s),
                       torch.as_tensor(geo), torch.as_tensor(occ), oh, ow, s)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_kernel_entries_refuse_cpu_tensors():
    imgs = torch.rand(1, 8, 8, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mf.masked_fill_fwd_kernel(imgs, _rects(), 0.5)
    x = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gn.gn_relu_fwd_kernel(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="unsupported device"):
        mf.masked_fill(imgs.to("meta"), _rects(), 0.5)


def test_profiler_transition_waits_for_kernel_op_calls():
    """A profiler start or stop (`KERNEL_GATE.transition()`) waits for the
    kernel op calls in flight on other threads and holds new ones back
    until it is done; the wrappers call their ops inside the gate."""
    from dorpatch_tpu_torch.observe.timing import KERNEL_GATE, KernelGate

    gate, log = KernelGate(), []

    def call(i):
        with gate:
            log.append(("in", i))
            time.sleep(0.1)
            log.append(("out", i))

    first = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in first:
        t.start()
    time.sleep(0.03)
    with gate.transition():
        log.append(("transition", 0))
        late = threading.Thread(target=call, args=(3,))
        late.start()
        time.sleep(0.05)
        log.append(("transition", 1))
    for t in first + [late]:
        t.join()
    i = log.index(("transition", 0))
    assert sorted(log[:i]) == sorted([("in", k) for k in range(3)]
                                     + [("out", k) for k in range(3)])
    assert log[i:] == [("transition", 0), ("transition", 1), ("in", 3),
                       ("out", 3)]

    imgs = torch.rand(2, 8, 8, 3, generator=_gen())
    done = []
    with KERNEL_GATE.transition():
        t = threading.Thread(target=lambda: done.append(
            mf.masked_fill(imgs, _rects(), 0.5)))
        t.start()
        t.join(0.2)
        assert not done     # the wrapper's op call waits at the gate
    t.join()
    assert torch.equal(done[0], mf.masked_fill_reference(imgs, _rects(),
                                                         0.5))
