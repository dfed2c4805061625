"""Masked-stem fold: occlusion masks applied in post-stem activation space.

The conv victims' stem conv is linear and bias-free, so

    stem(norm(img * m + fill * (1-m)))
      = stem(norm(img)) + stem(norm_scale * (fill - img) * occ)

with `occ = 1 - m` supported only on the mask's rectangles. The first
certification round computes the clean stem activation once per image and,
per mask, only the delta: a small conv over the mask window's receptive
field, added into a broadcast of the clean cache. The masked-image tensor
never exists.

- `fold_masked_stem` is the plain version: per mask, its natural window
  (`plan_windows`), a VALID delta conv as the k*k chain of strided-slice
  matmuls (`_delta_conv`, summed in the order dr, dc, Cin), scattered into
  the clean cache.
- `fold_masked_stem_kernel` launches kernel C (`csrc/stem_fold.cu`) over the
  family-uniform window plan (`_uniform_plan`): outputs in an enlarged
  window but outside a mask's true region see only occ = 0 input, so their
  delta is exactly zero. Its bf16 form runs the delta on the bf16 tensor
  cores with the taps zero-padded to the MMA depth (`mma_taps`), in delta
  blocks beside copy blocks whose shape `bf16_plan` chooses.

The window plans are host numpy, as in `dorpatch_tpu.ops.stem_fold`.

bf16 (the bf16 certify bank): `StemFoldFamily(..., compute_dtype=
"bfloat16")` runs a once-cast bf16 copy of the victim and casts the images
at its boundary, so the stem kernel, the clean cache, the fill delta and
the occlusion windows are bf16 operands; the delta accumulates in float32
and is added to clean in bf16 (kernel C's bf16 form on the card); the
margins are read out in float32.
"""

from __future__ import annotations

import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dorpatch_tpu_torch import utils
from dorpatch_tpu_torch.ops import _backend, _build, _library


#: kernel C's bf16 form (`stem_fold_tc`): the depth of one
#: mma.m16n8k16, the window pixels of one m-tile of each of a delta block's
#: 8 warps, the most m-tiles a warp takes, the channels of one accumulator
#: pass, and the most 16-byte chunks a thread of a copy block holds
MMA_K = 16
TILE_PIX = 128
MAX_MTILES = 2
WARPS = 8
SLICE = 64
MAX_COPY_LANES = 4
MAX_CIN = 4
THREADS = 256
#: its default plan: 16-byte chunks a copy thread, masks a copy block, and
#: two m-tiles a warp for windows of at least MTILES2_PIX pixels
#: (`stem_bench.py --sweep`, `PERF.md` §6 PR 10)
BF16_LANES = 2
BF16_GROUP = 4
MTILES2_PIX = 1024
#: the card's L2 (H100: 50 MB): a larger output is stored evict-first
L2_BYTES = 50 * 2**20


class Bf16FoldPlan(NamedTuple):
    """Kernel C's bf16 launch: `lanes` 16-byte chunks of clean a thread of
    a copy block holds, `group` masks a copy block writes them to,
    `mtiles` 16-pixel m-tiles each warp of a delta block computes (a block
    of `mtiles * TILE_PIX` window pixels), `stream` evict-first stores."""

    lanes: int
    group: int
    mtiles: int
    stream: bool


def mma_taps(k: int, cin: int) -> int:
    """The taps `k * k * cin` zero-padded to a multiple of the MMA depth
    (27 -> 32 at the CIFAR stem, 147 -> 160 at RN50's)."""
    return -(-k * k * cin // MMA_K) * MMA_K


def bf16_smem(cin: int, ow: int, c: int, k: int, s: int,
              mtiles: int) -> int:
    """Shared memory of one block of the bf16 form
    (`dp_stem_fold_bf16_smem`): the stem kernel `[kpad, c + 8]` bf16, the
    tap offsets `[kpad]` int32, the window rows a delta block stages (its
    `pix = mtiles * TILE_PIX` pixels span at most `(ow + pix - 2) // ow + 1`
    output rows) and the warps' staged deltas `[8, 16, 72]` bf16."""
    kpad = mma_taps(k, cin)
    iw = ow * s + k - 1
    rows = (ow + mtiles * TILE_PIX - 2) // ow * s + k
    return (2 * kpad * (c + 8) + 4 * kpad + -(-2 * rows * iw * cin // 16) * 16
            + 2 * WARPS * 16 * (SLICE + 8))


def bf16_items(plan: Bf16FoldPlan, b: int, n: int, h: int, w: int, c: int,
               oh: int, ow: int) -> Tuple[int, int]:
    """(delta blocks, copy blocks) of one bf16 launch: a delta block is
    `mtiles * TILE_PIX` pixels of one mask's window on one image, a copy
    block a tile of `lanes * THREADS` 16-byte chunks of one image's clean
    map for a group of masks."""
    tiles = -(-(h * w * c // 8) // (THREADS * plan.lanes))
    pix = plan.mtiles * TILE_PIX
    return b * n * -(-oh * ow // pix), b * -(-n // plan.group) * tiles


def bf16_plan(b: int, n: int, h: int, w: int, c: int, oh: int,
              ow: int) -> Bf16FoldPlan:
    """The bf16 form's launch for `[B, N, h, w, c]` outputs and `[oh, ow]`
    windows: BF16_LANES chunks a copy thread, BF16_GROUP masks a copy
    block, two m-tiles a warp for windows of MTILES2_PIX pixels or more
    (one below, so that a small window still splits over several delta
    blocks); evict-first stores when the output outgrows the L2."""
    return Bf16FoldPlan(BF16_LANES, min(BF16_GROUP, n),
                        2 if oh * ow >= MTILES2_PIX else 1,
                        2 * b * n * h * w * c > L2_BYTES)


class _Window(NamedTuple):
    """Static per-mask fold geometry, all in PADDED input coordinates."""

    o0: int      # affected output rows [o0, o1)
    o1: int
    oc0: int     # affected output cols [oc0, oc1)
    oc1: int
    i0: int      # input window rows [i0, i1) feeding those outputs
    i1: int
    ic0: int
    ic1: int
    occ: np.ndarray  # [i1-i0, ic1-ic0, 1] f32 union occlusion indicator


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF/XLA 'SAME' padding split for one spatial axis (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _axis_window(r0: int, r1: int, pad_lo: int, k: int, s: int,
                 out_size: int) -> Tuple[int, int, int, int]:
    """Outputs [o0, o1) whose receptive field meets input rows [r0, r1),
    plus the padded-coordinate input window [i0, i1) producing them."""
    a0, a1 = r0 + pad_lo, r1 + pad_lo
    o0 = max(0, -(-(a0 - k + 1) // s))
    o1 = min(out_size, (a1 - 1) // s + 1)
    return o0, o1, o0 * s, (o1 - 1) * s + k


def plan_windows(rects: np.ndarray, img_size: int, k: int, s: int,
                 pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> List[_Window]:
    """Per mask of a rectangle table `[N, K, 4]` (empty rows ignored): the
    union bounding box's affected output region, its input window, and the
    occlusion indicator restricted to that window."""
    (pr0, pr1), (pc0, pc1) = pads
    h_out = (img_size + pr0 + pr1 - k) // s + 1
    w_out = (img_size + pc0 + pc1 - k) // s + 1
    rects = np.asarray(rects, np.int64)
    if rects.ndim == 2:
        rects = rects[:, None, :]
    plan: List[_Window] = []
    for n in range(rects.shape[0]):
        live = [r for r in rects[n] if r[1] > r[0] and r[3] > r[2]]
        if not live:
            raise ValueError(f"mask {n} has no non-empty rectangle")
        r0 = min(int(r[0]) for r in live)
        r1 = max(int(r[1]) for r in live)
        c0 = min(int(r[2]) for r in live)
        c1 = max(int(r[3]) for r in live)
        o0, o1, i0, i1 = _axis_window(r0, r1, pr0, k, s, h_out)
        oc0, oc1, ic0, ic1 = _axis_window(c0, c1, pc0, k, s, w_out)
        occ = np.zeros((i1 - i0, ic1 - ic0, 1), np.float32)
        for rr0, rr1, cc0, cc1 in live:
            occ[max(rr0 + pr0 - i0, 0):max(rr1 + pr0 - i0, 0),
                max(cc0 + pc0 - ic0, 0):max(cc1 + pc0 - ic0, 0)] = 1.0
        plan.append(_Window(o0, o1, oc0, oc1, i0, i1, ic0, ic1, occ))
    return plan


def _uniform_plan(plan: Sequence[_Window], h_out: int, w_out: int,
                  k: int, s: int):
    """Family-uniform kernel geometry: every mask's output window enlarged
    to the family max `[OH, OW]` (start clamped in range), the occlusion
    indicator laid out in absolute coordinates of the enlarged input window
    `[IH, IW]` (`IH = OH*s + k - 1`). Returns `(OH, OW, geo [N, 4] int32 rows
    (o0, oc0, i0, ic0), occ [N, IH, IW] f32)`."""
    oh = max(w.o1 - w.o0 for w in plan)
    ow = max(w.oc1 - w.oc0 for w in plan)
    ih, iw = oh * s + k - 1, ow * s + k - 1
    geo = np.zeros((len(plan), 4), np.int32)
    occ = np.zeros((len(plan), ih, iw), np.float32)
    for n, w in enumerate(plan):
        o0 = min(w.o0, h_out - oh)
        oc0 = min(w.oc0, w_out - ow)
        i0, ic0 = o0 * s, oc0 * s
        geo[n] = (o0, oc0, i0, ic0)
        occ[n, w.i0 - i0:w.i1 - i0, w.ic0 - ic0:w.ic1 - ic0] = w.occ[:, :, 0]
    return oh, ow, geo, occ


def _delta_conv(win: torch.Tensor, kernel: torch.Tensor, s: int,
                kpad: int = 0) -> torch.Tensor:
    """VALID conv `[B, IH, IW, Cin] x [k, k, Cin, Cout] -> [B, OH, OW, Cout]`
    (stride s) as the k*k chain of strided-slice matmuls, summed in the
    order dr, dc, then Cin inside each product. With `kpad` (at least
    k*k*Cin), the same sum over the taps flattened in the order (dr, dc,
    Cin) and zero-padded to `kpad`, as kernel C's bf16 form lays out its
    operands (`mma_taps`): the window's im2col columns and the kernel's
    rows, Cin taps a product, the padded taps last."""
    k = int(kernel.shape[0])
    b, ih, iw, cin = win.shape
    oh, ow = (ih - k) // s + 1, (iw - k) // s + 1
    acc = torch.zeros((b, oh * ow, kernel.shape[-1]), dtype=torch.float32,
                      device=win.device)
    # bf16 operands widen exactly: their products and sums are float32
    win, kernel = win.float(), kernel.float()
    slices = [win[:, dr:dr + (oh - 1) * s + 1:s, dc:dc + (ow - 1) * s + 1:s]
              for dr in range(k) for dc in range(k)]
    if kpad:
        taps = k * k * cin
        cols = F.pad(torch.cat(slices, dim=-1).reshape(b, oh * ow, taps),
                     (0, kpad - taps))
        kmat = F.pad(kernel.reshape(taps, -1), (0, 0, 0, kpad - taps))
        for g0 in range(0, kpad, cin):
            acc = acc + torch.matmul(cols[:, :, g0:g0 + cin].contiguous(),
                                     kmat[g0:g0 + cin])
        return acc.reshape(b, oh, ow, -1)
    for i, cols in enumerate(slices):
        acc = acc + torch.matmul(cols.reshape(b, oh * ow, cin),
                                 kernel[i // k, i % k])
    return acc.reshape(b, oh, ow, -1)


def _pad_nhwc(u: torch.Tensor, pads) -> torch.Tensor:
    (pr0, pr1), (pc0, pc1) = pads
    return F.pad(u, (0, 0, pc0, pc1, pr0, pr1))


@_backend.sanitized("stem_fold")
def fold_masked_stem(kernel: torch.Tensor, clean: torch.Tensor,
                     u: torch.Tensor, plan: Sequence[_Window],
                     strides: Tuple[int, int], pads,
                     kpad: int = 0) -> torch.Tensor:
    """The plain version. `[B, h, w, c]` clean stem cache, `[B, H, W, C]`
    fill delta `u = norm_scale * (fill - img)` and HWIO stem `kernel` ->
    `[B, N, h, w, c]` masked stem activations, in clean's type; the delta
    accumulates in float32 and is rounded to that type before the add.
    `kpad`: the taps zero-padded to it (`_delta_conv`)."""
    up = _pad_nhwc(u, pads)
    out = clean[:, None].repeat(1, len(plan), 1, 1, 1)
    for n, w in enumerate(plan):
        occ = torch.as_tensor(w.occ, dtype=up.dtype, device=up.device)
        win = up[:, w.i0:w.i1, w.ic0:w.ic1, :] * occ
        d = _delta_conv(win, kernel, int(strides[0]), kpad)
        out[:, n, w.o0:w.o1, w.oc0:w.oc1, :] += d.to(out.dtype)
    return out


def fold_masked_stem_uniform(kernel: torch.Tensor, clean: torch.Tensor,
                             up: torch.Tensor, geo: torch.Tensor,
                             occ: torch.Tensor, oh: int, ow: int,
                             s: int) -> torch.Tensor:
    """The plain version over kernel C's operands (the family-uniform
    windows of `_uniform_plan`, `up` padded by `pad_for_kernel`): per mask,
    the VALID delta conv of its enlarged window (`_delta_conv`), added into
    a broadcast of clean. An output of the enlarged window outside the
    mask's true region sees only occ = 0 input: its delta is exactly
    zero."""
    n, ih, iw = occ.shape
    out = clean[:, None].repeat(1, n, 1, 1, 1)
    for i, (o0, oc0, i0, ic0) in enumerate(geo.tolist()):
        win = up[:, i0:i0 + ih, ic0:ic0 + iw, :] * occ[i, :, :, None]
        d = _delta_conv(win, kernel, int(s))
        out[:, i, o0:o0 + oh, oc0:oc0 + ow, :] += d.to(out.dtype)
    return out


def _fold_fake(kernel, clean, up, geo, occ, oh, ow, s, mesh=False):
    b, h, w, c = clean.shape
    return clean.new_empty((b, occ.shape[0], h, w, c))


#: kernel C: HWIO kernel, clean `[B,h,w,c]`, up, geo `[N,4]` int32, occ
#: `[N,IH,IW]` (f32, or all bf16) -> `[B,N,h,w,c]` of clean's type; `mesh`
#: counts the launch as the sharded form's
stem_fold_op = _library.define(
    "stem_fold(Tensor kernel, Tensor clean, Tensor up, Tensor geo, "
    "Tensor occ, int oh, int ow, int s, bool mesh=False) -> Tensor",
    lambda kernel, clean, up, geo, occ, oh, ow, s, mesh=False:
    fold_masked_stem_uniform(kernel, clean, up, geo, occ, oh, ow, s),
    lambda kernel, clean, up, geo, occ, oh, ow, s, mesh=False: _fold_launch(
        kernel, clean, up, geo, occ, oh, ow, s, None,
        "_mesh" if mesh else ""),
    _fold_fake)


@_backend.sanitized("stem_fold")
def fold_stem(kernel: torch.Tensor, clean: torch.Tensor, up: torch.Tensor,
              geo: torch.Tensor, occ: torch.Tensor, oh: int, ow: int,
              s: int) -> torch.Tensor:
    """The fold over kernel C's operands (`fold_masked_stem_kernel`'s),
    through the op `dorpatch_torch::stem_fold`: kernel C (or its bf16
    form) on CUDA tensors, `fold_masked_stem_uniform` on CPU tensors."""
    _backend.on_card(clean)
    return _library.call(stem_fold_op, kernel, clean, up, geo, occ, oh, ow, s)


def fold_masked_stem_kernel(kernel: torch.Tensor, clean: torch.Tensor,
                            up: torch.Tensor, geo: torch.Tensor,
                            occ: torch.Tensor, oh: int, ow: int, s: int,
                            plan: Optional[Bf16FoldPlan] = None
                            ) -> torch.Tensor:
    """Kernel C on CUDA tensors: `fold_stem`, refusing CPU tensors. `up` is
    the fill delta padded by the stem's pads plus `s - 1` rows/cols
    (`pad_for_kernel`); `geo`/`occ` come from `_uniform_plan`. kernel,
    clean, up and occ all float32, or all bf16 (the bf16 form: the delta on
    the bf16 tensor cores, float32 accumulation, launched with `plan`, by
    default `bf16_plan`). Returns `[B, N, h, w, c]` of clean's type. A
    `plan` other than the default is for measuring: it launches without
    the op."""
    _backend.require_card(clean, "clean")
    if plan is not None:
        return _fold_launch(kernel, clean, up, geo, occ, oh, ow, s, plan, "")
    return fold_stem(kernel, clean, up, geo, occ, oh, ow, s)


@_backend.sanitized("stem_fold_mesh")
def fold_masked_stem_sharded(kernel: torch.Tensor, clean: torch.Tensor,
                             up: torch.Tensor, geo: torch.Tensor,
                             occ: torch.Tensor, oh: int, ow: int, s: int,
                             mesh) -> torch.Tensor:
    """Kernel C (or its bf16 form) on a mesh rank's shard, the JAX
    package's `fold_masked_stem_sharded`: `clean` and `up` hold the images
    of the rank's data block (each rank computes its own block's clean
    stem), `geo`/`occ` the windows of its mask block; the stem kernel is
    replicated. No collective: an entry is one image under one mask, and
    the family gathers its tables after the trunk. Counted as
    "stem_fold_mesh" ("stem_fold_bf16_mesh"); CPU tensors run the plain
    version."""
    if mesh is None:
        raise ValueError("fold_masked_stem_sharded needs a mesh")
    _backend.on_card(clean)
    return _library.call(stem_fold_op, kernel, clean, up, geo, occ, oh, ow,
                         s, True)


def _fold_launch(kernel, clean, up, geo, occ, oh, ow, s, plan,
                 suffix: str) -> torch.Tensor:
    bf16 = clean.dtype == torch.bfloat16
    dt = torch.bfloat16 if bf16 else torch.float32
    for t, name, tt, nd in ((kernel, "kernel", dt, 4), (clean, "clean", dt, 4),
                            (up, "up", dt, 4), (geo, "geo", torch.int32, 2),
                            (occ, "occ", dt, 3)):
        _backend.require(t, name, tt, nd)
    k = int(kernel.shape[0])
    b, h, w, c = clean.shape
    _, hp, wp, cin = up.shape
    n, ih, iw = occ.shape
    if (tuple(kernel.shape) != (k, k, cin, c) or c % (8 if bf16 else 4)
            or (ih, iw) != (oh * s + k - 1, ow * s + k - 1)
            or tuple(geo.shape) != (n, 4) or up.shape[0] != b):
        raise ValueError(
            f"stem fold shapes do not agree: kernel {tuple(kernel.shape)}, "
            f"clean {tuple(clean.shape)}, up {tuple(up.shape)}, "
            f"geo {tuple(geo.shape)}, occ {tuple(occ.shape)}, OH/OW {oh}/{ow}")
    if plan is not None and not bf16:
        raise ValueError("a launch plan is for kernel C's bf16 form only")
    if bf16 and cin > MAX_CIN:
        raise ValueError(f"kernel C's bf16 form stages at most {MAX_CIN} "
                         f"input channels, not {cin}")
    out = torch.empty((b, n, h, w, c), dtype=clean.dtype, device=clean.device)
    if any(t.data_ptr() % 16 for t in (kernel, clean, out)):
        raise ValueError("stem fold reads kernel and clean and writes its "
                         "output 16 bytes at a time: they must be 16-byte "
                         "aligned")
    lib = _build.library()
    if bf16:
        plan = plan or bf16_plan(b, n, h, w, c, oh, ow)
        if not (1 <= plan.lanes <= MAX_COPY_LANES and plan.group >= 1
                and 1 <= plan.mtiles <= MAX_MTILES):
            raise ValueError(f"kernel C's bf16 form takes 1-{MAX_COPY_LANES} "
                             f"lanes, a group of at least 1 and 1-"
                             f"{MAX_MTILES} m-tiles: {plan}")
        smem = lib.dp_stem_fold_bf16_smem(cin, ow, c, k, s, plan.mtiles)
    else:
        smem = lib.dp_stem_fold_smem(cin, ow, c, k, s)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"kernel C stages a {k}x{k}x{cin}x{c} stem kernel and "
                         f"the window rows of {ow} outputs in {smem} bytes of "
                         f"shared memory, more than a block's "
                         f"{_build.MAX_SMEM_BYTES}")
    stream = _backend.stream_handle(clean)
    if bf16:
        _backend.count_launch("stem_fold_bf16" + suffix)
        _build.check(lib.dp_stem_fold_bf16(
            geo.data_ptr(), up.data_ptr(), occ.data_ptr(), clean.data_ptr(),
            kernel.data_ptr(), out.data_ptr(), b, n, hp, wp, cin, ih, iw, oh,
            ow, h, w, c, k, s, plan.lanes, plan.group, plan.mtiles,
            int(plan.stream), stream), "stem_fold_bf16")
        return out
    _backend.count_launch("stem_fold" + suffix)
    _build.check(lib.dp_stem_fold(
        geo.data_ptr(), up.data_ptr(), occ.data_ptr(), clean.data_ptr(),
        kernel.data_ptr(), out.data_ptr(), b, n, hp, wp, cin, ih, iw, oh, ow,
        h, w, c, k, s, stream), "stem_fold")
    return out


def pad_for_kernel(u: torch.Tensor, pads, s: int) -> torch.Tensor:
    """The fill delta padded for kernel C: the stem's pads plus `s - 1`
    zero rows/cols that keep the clamped uniform windows in bounds."""
    (pr0, pr1), (pc0, pc1) = pads
    return _pad_nhwc(u, ((pr0, pr1 + s - 1), (pc0, pc1 + s - 1))).contiguous()


#: every live family, for `drop_plans`
_FAMILIES: "weakref.WeakSet[StemFoldFamily]" = weakref.WeakSet()


def drop_plans() -> None:
    """Forget every family's cached device plans; the next call rebuilds
    them. A trace on fake tensors (the program auditor's `trace_program`)
    drops them before and after it, so that it neither reads a plan of
    real tensors nor leaves one of fake tensors behind."""
    for family in list(_FAMILIES):
        family._kernel_plans.clear()


class StemFoldFamily:
    """One mask family's stem-folded first round: `phase1(imgs)` ->
    `(preds [B, M], margins [B, M] float32)`, the `apply_masks` +
    full-forward table up to conv summation order, at `compute_dtype`
    ("float32" or "bfloat16": a once-cast copy of the victim, the images
    cast at the boundary). On a `mesh` each rank folds and runs the trunk
    on its `[B/d, M/m]` block (`fold_masked_stem_sharded` on the card) and
    the tables are gathered after it."""

    def __init__(self, engine: "StemFoldEngine", rects: np.ndarray,
                 num_singles: int, chunk_size: int, fill: float,
                 compute_dtype: str = "float32", mesh=None):
        self.mesh = mesh
        self.dtype = utils.compute_dtype(compute_dtype)
        self.engine = engine.at(self.dtype)
        self.num_singles = int(num_singles)
        self.chunk_size = max(1, int(chunk_size))
        self.fill = float(fill)
        self.plan = plan_windows(rects[:num_singles], engine.img_size,
                                 engine.kernel_hw, engine.strides[0],
                                 engine.pads)
        self._kernel_plans = {}   # (offset, count, device) -> device plan
        _FAMILIES.add(self)

    def _kernel_plan(self, off: int, cnt: int, h: int, w: int,
                     device: torch.device):
        key = (off, cnt, str(device))
        plan = self._kernel_plans.get(key)
        if plan is None:
            eng = self.engine
            oh, ow, geo, occ = _uniform_plan(
                self.plan[off:off + cnt], h, w, eng.kernel_hw, eng.strides[0])
            plan = (oh, ow, torch.as_tensor(geo, device=device),
                    torch.as_tensor(occ, dtype=self.dtype, device=device))
            self._kernel_plans[key] = plan
        return plan

    @torch.no_grad()
    def phase1(self, imgs: torch.Tensor):
        if self.mesh is None:
            return self._phase1(imgs, 0, len(self.plan))
        return tuple(self.mesh.tables(
            int(imgs.shape[0]), len(self.plan),
            lambda rows, cols: self._phase1(imgs[rows], cols.start,
                                            cols.stop),
            (torch.int32, torch.float32), "stem_fold"))

    def _phase1(self, imgs: torch.Tensor, lo: int, hi: int):
        """The `[B, hi - lo]` tables of masks `lo:hi` of the family."""
        eng = self.engine
        imgs = imgs.to(self.dtype)      # the program boundary
        b, h, w, ci = imgs.shape
        n = hi - lo
        clean = eng.module(eng.normalize(imgs), "stem")      # [B, h', w', c']
        u = eng.norm_scale * (self.fill - imgs)
        kernel = eng.kernel_fn(eng.module).contiguous()      # HWIO
        # fold and trunk per mask chunk, so the live folded-stem tensor stays
        # within the chunk_size memory contract: a stem map is
        # (h'*w'*c')/(H*W*C) times an input image (about 21x for the CIFAR
        # 3x3/1 64-channel stem), and the chunk shrinks by that inflation
        inflation = float(np.prod(clean.shape[1:])) / float(h * w * ci)
        c = max(1, min(n, int(self.chunk_size / max(1.0, inflation))))
        s = int(eng.strides[0])
        up = pad_for_kernel(u, eng.pads, s)
        preds, margins = [], []
        for off in range(lo, hi, c):
            cnt = min(c, hi - off)
            oh, ow, geo, occ = self._kernel_plan(
                off, cnt, clean.shape[1], clean.shape[2], imgs.device)
            if self.mesh is None:
                folded = fold_stem(kernel, clean.contiguous(), up, geo, occ,
                                   oh, ow, s)
            else:
                folded = fold_masked_stem_sharded(
                    kernel, clean.contiguous(), up, geo, occ, oh, ow, s,
                    self.mesh)
            logits = eng.module(folded.reshape((-1,) + folded.shape[2:]),
                                "trunk")
            p, m = utils.preds_margins(logits)
            preds.append(p.reshape(b, cnt))
            margins.append(m.reshape(b, cnt))
        return torch.cat(preds, dim=1), torch.cat(margins, dim=1)


class StemFoldEngine:
    """Masked-stem incremental inference for one conv victim.

    `module(x, "stem")` must give the bias-free linear stem conv output and
    `module(x, "trunk")` must finish the forward from it;
    `kernel_fn(module)` returns its effective HWIO stem kernel."""

    kind = "stem"

    def __init__(self, module, img_size: int, kernel_fn: Callable,
                 kernel_hw: int, strides: Tuple[int, int], pads,
                 normalize: Optional[Callable] = None,
                 norm_scale: float = 2.0):
        self.module = module
        self.img_size = int(img_size)
        self.kernel_fn = kernel_fn
        self.kernel_hw = int(kernel_hw)
        self.strides = tuple(strides)
        self.pads = (tuple(pads[0]), tuple(pads[1]))
        self.normalize = normalize or (lambda x: (x - 0.5) / 0.5)
        self.norm_scale = float(norm_scale)
        self._casts = {}

    def at(self, dtype: torch.dtype) -> "StemFoldEngine":
        """This engine on a `dtype` copy of its module (`utils.cast_module`,
        made at the first call and kept); itself at float32."""
        if dtype == torch.float32:
            return self
        return utils.cached_cast(self._casts, dtype, lambda: StemFoldEngine(
            utils.cast_module(self.module, dtype), self.img_size,
            self.kernel_fn, self.kernel_hw, self.strides, self.pads,
            self.normalize, self.norm_scale))

    def build_family(self, rects: np.ndarray, num_singles: int,
                     chunk_size: int, fill: float,
                     compute_dtype: str = "float32",
                     mesh=None) -> StemFoldFamily:
        return StemFoldFamily(self, rects, num_singles, chunk_size, fill,
                              compute_dtype, mesh)
