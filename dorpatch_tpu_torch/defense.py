"""PatchCleanser double-masking certification.

Port of `dorpatch_tpu.defense` for one device. The masked forwards run on
the victim's device; the decision logic reads the `[B, 36]` / `[B, 630]`
prediction tables.

Dispatch and materialization are separate calls, as in the JAX package,
so the serving worker (`serve/service.py`) launches every radius's work
before it reads any result: `predict_tables` (the exhaustive tables, no
host sync), `begin_pruned` -> `_PrunedPending.schedule()` (the pruned
path's one designed sync) -> `finalize()`, and `materialize_verdicts`
(the host read of either). `robust_predict` is these calls in a row.
Every program is wrapped by `observe.timed_first_call` under the JAX
package's name (`defense.phase1.r0.03`, `defense.rows.bf16.r0.12`, ...):
its first call is recorded as a `compile` event and its input signatures
are counted against `recompile_budget` (`pruned_trace_counts`,
`warm_pruned`), the shape budget a serving process arms.

Masking twice equals double masking (`mask_j(mask_i(x)) ==
mask_{(i,j)}(x)`), so every second-round prediction is an entry of the
630-pair table (its diagonal is the one-masked prediction) and the
exhaustive procedure (`prune="off"`) needs 36 + 630 forwards per image and
radius.

Pruned two-phase schedule (`prune="exact"`, the default): phase 1 computes
the 36-mask first-round table; the host reads it (the one designed sync)
and schedules only the second-round entries the verdict reads: minority
rows for disagreeing images, the 630-pair audit for unanimous ones. Both
worklists dispatch in `data.bucket_plan` buckets. Verdicts equal the
exhaustive path's by construction; `PatchCleanserRecord.forwards` counts
each image's evaluated entries. `prune="consensus"` also stops every
first-round-unanimous image after the first round (36 forwards): its
certificate then asserts round-1 consensus only, weaker than the pair
audit's. A disagreeing image takes the same recovery as under "exact".

`n_patch=2` families (pairs as the first round, basic-major triples as the
second; 630 + 22680 masks at the 6x6 grid) are certified by the exhaustive
sweep alone, as the JAX package certifies them: any requested `prune`
resolves to "off" (one line on stderr per certifier says so), and with it
`incremental` and the bf16 bank's programs. Their verdict reads a
`[630, 630]` second-round grid that points past the 22680-entry table;
those entries read `OUT_OF_TABLE`, as the JAX verdict's gather fills them.

`incremental="stem"` (what "auto" resolves to for conv victims) computes the
first round through the masked-stem fold (`ops.stem_fold`); phase 2 keeps
full masked forwards.

`incremental="token"` runs all three programs (phase 1, the pair audit and
the second-round rows) through the ViT token engine (`models.vit`), which
returns top-2 logit margins beside its predictions; `"mixer"` does the same
through the ResMLP dirty-row engine (`models.resmlp`). `"token-exact"` and
`"mixer-exact"` (what "auto" resolves to for ViT and ResMLP victims) add the
escalation: every image whose evaluated entries include a margin below
`DefenseConfig.incremental_margin` is re-certified through the exhaustive
sweep, so its record is the exhaustive path's (under "consensus" with the
round-1 certificate re-derived from the sweep's first-round table).
`PatchCleanserRecord.forward_equivalents` credits an engine entry at its
fraction of a full forward.

bf16 certify bank (`DefenseConfig.compute_dtype="bfloat16"`, CLI
`--certify-dtype`): phase 1, the pair audits, the rows and the engines'
families run on the victim's once-cast bf16 copy (`utils.forward_at`), the
images cast at each program's boundary (kernel A's bf16 form fills them),
and every program returns its top-2 margins, read out in float32. Every
image whose evaluated margins come within `incremental_margin` of the
argmax boundary re-certifies through the float32 exhaustive sweep on the
original victim (`_escalate`, the "token-exact" law), so bf16 never weakens
a verdict. The exhaustive `_predict` never runs in bf16: it is the oracle.

Meshed certifiers (`mesh=`, `parallel/`) run the same schedule sharded:
phase 1, the pair audits and the escalations' sweeps split every chunk of
the table over the ranks (`masked_predictions(mesh=)`: the sharded fill,
kernel A on the rank's `[B/d, S/m]` block), the engines' families run
their rank's blocks (kernels C and H in their sharded forms), and every
table is gathered back onto every rank, so the host logic and the records
are the single-process ones. Phase 2 plans each data shard's worklist over
its own images (`_schedule_mesh`, as `dorpatch_tpu.defense`): the waves come
from `data.shard_bucket_plan` over a dense power-of-two row ladder, each
one `[D * bucket]` call whose rows of shard d are its own entries, padded
with an owned row; padding is left out of every table read and forward
count. Escalations bucket on that row ladder. Program names carry `.mesh`.

Tie-breaking (as in the JAX package): the majority label on count ties is
the smallest label with the maximal count; among several recovering
minority masks the one with the largest mask index wins.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dorpatch_tpu_torch import data as data_lib
from dorpatch_tpu_torch import masks as masks_lib
from dorpatch_tpu_torch import observe, utils
from dorpatch_tpu_torch.config import DefenseConfig
from dorpatch_tpu_torch.ops.masked_fill import masked_fill, \
    sharded_masked_fill

PRUNE_MODES = ("off", "exact", "consensus")
INCREMENTAL_MODES = ("auto", "token", "token-exact", "mixer", "mixer-exact",
                     "stem", "off")
#: the engine kinds whose programs return margins and take combined-table
#: index rows, and whose "-exact" modes escalate
MARGIN_KINDS = ("token", "mixer")

#: `preds_2` entries the pruned path never evaluated (provably unread).
UNEVALUATED = -1
#: what the verdict reads at a second-round grid index past the table (the
#: n_patch=2 family): int32's least value, the JAX gather's fill
OUT_OF_TABLE = -2 ** 31


class PatchCleanserRecord(NamedTuple):
    """Per-image verdict. `preds_2` holds `UNEVALUATED` where the pruned
    schedule proved the verdict never reads an entry; `forwards` counts the
    masked-table entries this image evaluated (bucket padding excluded);
    `forward_equivalents` is their cost in full forwards (a token-pruned
    entry counts its fraction of one, the clean cache included; equal to
    `forwards` on the other paths)."""

    prediction: int
    certification: bool
    preds_1: np.ndarray  # [M] one-masked predictions
    preds_2: np.ndarray  # [P] double-masked predictions
    forwards: int = -1
    forward_equivalents: float = -1.0


class PatchCleanserResult:
    """Batch aggregation of records."""

    def __init__(self, records: Sequence[PatchCleanserRecord]):
        self.predictions = np.stack([r.prediction for r in records])
        self.certifications = np.stack([r.certification for r in records])
        self.predictions_1 = np.stack([r.preds_1 for r in records])
        self.predictions_2 = [r.preds_2 for r in records]


def plan_chunks(n: int, chunk_size: int, mask_axis: int = 1):
    """Split an n-long mask axis into (n_chunks, chunk): chunk <= chunk_size,
    the fewest chunks, equalized so the last one is nearly full."""
    m = mask_axis if chunk_size >= mask_axis else 1
    quantum = (chunk_size // m) * m
    n_chunks = -(-n // quantum) if n else 0
    chunk = m * -(-n // (m * n_chunks)) if n_chunks else chunk_size
    return n_chunks, chunk


@torch.no_grad()
def masked_predictions(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                       imgs: torch.Tensor, rects: torch.Tensor,
                       chunk_size: int, fill: float = 0.5,
                       with_margins: bool = False,
                       dtype: Optional[torch.dtype] = None, mesh=None):
    """Predictions under every mask in `rects`: `[B,H,W,C] x [N,K,4] ->
    [B,N]` int32 (plus the `[B,N]` float32 top-2 margins with
    `with_margins`). The mask axis runs in chunks of at most `chunk_size`
    (a live-memory bound of `B * chunk_size` masked images); each chunk is
    one fused `masked_fill` (kernel A on the card) and one batched
    forward. `dtype` casts the images before the fill (the bf16 bank). On
    a `mesh` the chunks are sized to the mask axis and each rank fills and
    forwards its block of every chunk (`sharded_masked_fill`; a chunk the
    mesh does not divide runs whole on rank 0); the tables are gathered
    with one `all_reduce`."""
    if dtype is not None:
        imgs = imgs.to(dtype)
    n = int(rects.shape[0])
    n_chunks, chunk = plan_chunks(
        n, chunk_size, 1 if mesh is None else mesh.shape["mask"])
    batch = imgs.shape[0]
    if mesh is not None:
        return _mesh_predictions(apply_fn, imgs, rects, n_chunks, chunk,
                                 fill, with_margins, mesh)
    preds, margins = [], []
    for i in range(n_chunks):
        part = rects[i * chunk:(i + 1) * chunk]
        xm = masked_fill(imgs, part, fill)
        logits = apply_fn(xm.reshape((-1,) + tuple(imgs.shape[1:])))
        p, m = utils.preds_margins(logits)
        preds.append(p.reshape(batch, -1))
        margins.append(m.reshape(batch, -1))
    if not preds:
        empty = torch.zeros((batch, 0), dtype=torch.int32, device=imgs.device)
        return (empty, empty.float()) if with_margins else empty
    if with_margins:
        return torch.cat(preds, dim=1), torch.cat(margins, dim=1)
    return torch.cat(preds, dim=1)


def _mesh_predictions(apply_fn, imgs, rects, n_chunks, chunk, fill,
                      with_margins, mesh):
    """`masked_predictions` on a mesh: this rank's block of every chunk
    into a zero `[2, B, N]` float64 buffer (predictions, margins), then one
    `all_reduce`."""
    batch, n = int(imgs.shape[0]), int(rects.shape[0])
    buf = torch.zeros((2, batch, n), dtype=torch.float64, device=imgs.device)
    for i in range(n_chunks):
        lo = i * chunk
        part = rects[lo:lo + chunk]
        rows, cols = mesh.block(batch, int(part.shape[0]), "fill")
        if rows.stop == rows.start or cols.stop == cols.start:
            continue
        if mesh.divides(batch, int(part.shape[0])):
            xm = sharded_masked_fill(imgs, part, fill, mesh)
        else:
            xm = masked_fill(imgs, part, fill)
        p, m = utils.preds_margins(apply_fn(
            xm.reshape((-1,) + tuple(imgs.shape[1:]))))
        at = (rows, slice(lo + cols.start, lo + cols.stop))
        buf[0][at] = p.reshape(rows.stop - rows.start, -1).double()
        buf[1][at] = m.reshape(rows.stop - rows.start, -1).double()
    mesh.all_reduce(buf)
    preds = buf[0].to(torch.int32)
    return (preds, buf[1].float()) if with_margins else preds


def _second_round_index_grid(num_masks: int) -> np.ndarray:
    """`grid[i, j]` = index into the pair table for {i, j} (diagonal -> 0,
    patched separately since mask_i(mask_i(x)) == mask_i(x))."""
    grid = masks_lib.second_round_table_indices(num_masks) - num_masks
    grid[np.eye(num_masks, dtype=bool)] = 0
    return grid


def double_masking_verdict(preds_1: torch.Tensor, preds_2: torch.Tensor,
                           num_masks: int, num_classes: int):
    """The two-round PatchCleanser decision and certificate on tensors.
    preds_1 `[B, M]`, preds_2 `[B, C(M,2)]` -> (pred `[B]`, certified `[B]`).

    Round 1: unanimous one-masked predictions give the label, certified iff
    every double-masked prediction agrees. Round 2: otherwise a minority
    one-masked image whose own second-round row unanimously keeps its label
    wins; else the majority stands. Never certified on disagreement."""
    dev = preds_1.device
    grid_np = _second_round_index_grid(num_masks)
    grid = torch.as_tensor(grid_np, device=dev, dtype=torch.long)
    counts = utils.one_hot(preds_1, num_classes).sum(dim=1)
    majority = torch.argmax(counts, dim=-1).to(preds_1.dtype)
    unanimous = (preds_1 == preds_1[:, :1]).all(dim=1)
    certified = unanimous & (preds_2 == majority[:, None]).all(dim=1)
    p = int(preds_2.shape[1])
    second = preds_2[:, grid.clamp(max=max(p - 1, 0))]          # [B, M, M]
    if int(grid_np.max()) >= p:       # on the host: no device sync
        second = torch.where(grid < p, second,
                             torch.full_like(second, OUT_OF_TABLE))
    eye = torch.eye(num_masks, dtype=torch.bool, device=dev)[None]
    second = torch.where(eye, preds_1[:, :, None], second)
    is_minority = preds_1 != majority[:, None]
    recovers = is_minority & (second == preds_1[:, :, None]).all(dim=2)
    any_recovery = recovers.any(dim=1)
    ar = torch.arange(num_masks, device=dev)[None]
    idx = torch.argmax(torch.where(recovers, ar, -1), dim=1)
    recovered = preds_1.gather(1, idx[:, None])[:, 0]
    pred = torch.where(unanimous, majority,
                       torch.where(any_recovery, recovered, majority))
    return pred, certified


def _majority_np(preds_1: np.ndarray, num_classes: int) -> np.ndarray:
    """Per-image majority label of the `[B, M]` first-round table (smallest
    label on count ties)."""
    b = preds_1.shape[0]
    counts = np.zeros((b, num_classes), np.int64)
    np.add.at(counts, (np.arange(b)[:, None], preds_1), 1)
    return counts.argmax(axis=-1).astype(preds_1.dtype)


def double_masking_verdict_np(preds_1: np.ndarray, preds_2: np.ndarray,
                              num_masks: int, num_classes: int):
    """The numpy twin of `double_masking_verdict`."""
    preds_1 = np.asarray(preds_1)
    preds_2 = np.asarray(preds_2)
    grid = _second_round_index_grid(num_masks)
    b = preds_1.shape[0]
    majority = _majority_np(preds_1, num_classes)
    unanimous = (preds_1 == preds_1[:, :1]).all(axis=1)
    certified = unanimous & (preds_2 == majority[:, None]).all(axis=1)
    p = preds_2.shape[1]
    second = preds_2[:, np.minimum(grid, max(p - 1, 0))]
    if grid.max() >= p:
        second = np.where(grid < p, second,
                          np.asarray(OUT_OF_TABLE, second.dtype))
    eye = np.eye(num_masks, dtype=bool)[None]
    second = np.where(eye, preds_1[:, :, None], second)
    is_minority = preds_1 != majority[:, None]
    recovers = is_minority & (second == preds_1[:, :, None]).all(axis=2)
    any_recovery = recovers.any(axis=1)
    idx = np.where(recovers, np.arange(num_masks)[None], -1).argmax(axis=1)
    recovered = preds_1[np.arange(b), idx]
    pred = np.where(unanimous, majority,
                    np.where(any_recovery, recovered, majority))
    return pred, certified


# ------------------------------------------------------- pruned scheduling


def host_round1(preds_1: np.ndarray, num_classes: int):
    """(majority `[B]`, unanimous `[B]`) of the first-round label table."""
    p1 = np.asarray(preds_1)
    return _majority_np(p1, num_classes), (p1 == p1[:, :1]).all(axis=1)


def schedule_round2(p1: np.ndarray, majority: np.ndarray,
                    unanimous: np.ndarray, num_singles: int, num_pairs: int,
                    mode: str):
    """Per image, the second-round entries the verdict reads:
    `(need_pairs [B] bool, row_list)`, `row_list` the ragged worklist of
    `(image, minority-mask)` rows. A disagreeing image needs only its
    minority rows, unless they would cost at least the whole pair table
    (k*M >= P); a unanimous image needs the pair audit ("exact") or
    nothing ("consensus")."""
    minority = p1 != majority[:, None]
    k = minority.sum(axis=1)
    rows_cheaper = (~unanimous) & (k * num_singles < num_pairs)
    need_pairs = (~unanimous) & ~rows_cheaper
    if mode == "exact":
        need_pairs = need_pairs | unanimous
    row_list = [(int(b), int(i))
                for b in np.nonzero(rows_cheaper)[0]
                for i in np.nonzero(minority[b])[0]]
    return need_pairs, row_list


class _PrunedPending:
    """One pruned certification batch, made by `PatchCleanser.begin_pruned`:
    phase 1 is launched at construction (nothing read back), `schedule()`
    reads the `[B, M]` first-round table (the one designed host sync) and
    launches phase 2, `finalize()` runs `schedule()`, assembles the records
    and, under the "-exact" modes and in the bf16 bank, escalates. The
    split lets the serving worker launch phase 1 for every radius before
    any sync."""

    def __init__(self, pc: "PatchCleanser", imgs: torch.Tensor, n: int,
                 num_classes: int, bucket_sizes, mode: str,
                 incremental: str = "off"):
        self.pc = pc
        self.imgs = imgs           # possibly bucket-padded
        self.n = n                 # real image count
        self.num_classes = num_classes
        self.bucket_sizes = bucket_sizes
        self.mode = mode
        self.incr = incremental
        # the margin engines' programs (token, mixer) return margins and
        # take combined-table index rows
        self.rowsets = incremental.split("-")[0] in MARGIN_KINDS
        # margins are read from the margin engines and from every program
        # of the bf16 bank; the f32 stem fold is exact and its margins are
        # not read
        self.margins_on = self.rowsets or pc._bf16
        self.t1_margins = None
        if incremental != "off":
            self.t1, self.t1_margins = pc._phase1_incr(imgs)
        elif pc._bf16:
            self.t1, self.t1_margins = pc._phase1(imgs)
        else:
            self.t1 = pc._phase1(imgs)
        self.min_margin = None
        self._scheduled = False
        # phase-2 chunks: (prediction table, [(table_row, image[, mask])])
        self.pair_chunks = []
        self.row_chunks = []

    def schedule(self) -> "_PrunedPending":
        """Read the first-round table, plan and launch phase 2. Idempotent;
        returns the pending."""
        if self._scheduled:
            return self
        self._scheduled = True
        pc = self.pc
        self.p1 = self.t1.cpu().numpy()[:self.n]
        self.majority, self.unanimous = host_round1(self.p1, self.num_classes)
        need_pairs, self.row_list = schedule_round2(
            self.p1, self.majority, self.unanimous, pc.num_first,
            pc.num_second, self.mode)
        self.pair_idx = np.nonzero(need_pairs)[0]
        dev = self.imgs.device
        pairs_prog = pc._pairs_incr if self.rowsets else pc._pairs
        if pc.mesh is not None:
            return self._schedule_mesh(pairs_prog)
        if self.pair_idx.size:
            bs = (self.bucket_sizes if self.bucket_sizes is not None
                  else data_lib.batch_buckets(int(self.imgs.shape[0])))
            for off, cnt, bucket in data_lib.bucket_plan(
                    int(self.pair_idx.size), bs):
                sel = torch.as_tensor(self.pair_idx[off:off + cnt], device=dev)
                xu = data_lib.pad_to_bucket(self.imgs[sel], bucket)
                mapping = [(pos, int(self.pair_idx[off + pos]))
                           for pos in range(cnt)]
                self.pair_chunks.append((pairs_prog(xu), mapping))
        for off, w, wb in data_lib.bucket_plan(len(self.row_list),
                                               pc.row_bucket_sizes):
            chunk = self.row_list[off:off + w]
            img_idx = [b for b, _ in chunk] + [chunk[-1][0]] * (wb - w)
            mask_idx = [i for _, i in chunk] + [chunk[-1][1]] * (wb - w)
            xg = self.imgs[torch.as_tensor(img_idx, device=dev)]
            if self.rowsets:
                # the engine's rows take each entry's row of combined-table
                # indices
                t = pc._rows_incr(xg, torch.as_tensor(
                    pc._np_grid_full[mask_idx], device=dev))
            else:
                t = pc._rows(xg, torch.as_tensor(mask_idx, device=dev))
            self.row_chunks.append(
                (t, [(pos, b, i) for pos, (b, i) in enumerate(chunk)]))
        return self

    def _schedule_mesh(self, pairs_prog) -> "_PrunedPending":
        """Shard-local phase 2 on a mesh (`dorpatch_tpu.defense`'s
        `_schedule_mesh`). Data shard s owns the contiguous images
        `np.array_split(arange(n), D)[s]` (the rows its ranks fill) and
        plans its own worklist of pair audits and minority rows; each wave
        of `data.shard_bucket_plan` over the row ladder is one `[D *
        bucket]` call whose rows `[s * bucket, (s + 1) * bucket)` are shard
        s's entries, the free slots filled with an owned row (its first
        scheduled entry, else its first image, else image 0): forwards
        whose outputs no mapping reads. Wave shapes never depend on the
        batch or the verdict mix, and padding is in no table read or
        forward count."""
        pc = self.pc
        n, d = self.n, pc.mesh.shape["data"]
        dev = self.imgs.device
        blocks = np.array_split(np.arange(n), d)
        lo = [int(b[0]) if b.size else n for b in blocks]
        hi = [int(b[-1]) + 1 if b.size else n for b in blocks]
        if self.pair_idx.size:
            per = [self.pair_idx[(self.pair_idx >= lo[s])
                                 & (self.pair_idx < hi[s])]
                   for s in range(d)]
            for off, counts, bucket in data_lib.shard_bucket_plan(
                    [p.size for p in per], pc.row_bucket_sizes):
                idx = np.zeros((d, bucket), np.int64)
                mapping = []
                for s in range(d):
                    sel = per[s][off:off + counts[s]]
                    idx[s, :] = (int(sel[0]) if sel.size
                                 else int(per[s][0]) if per[s].size
                                 else lo[s] if lo[s] < n else 0)
                    idx[s, :sel.size] = sel
                    mapping += [(s * bucket + j, int(b))
                                for j, b in enumerate(sel)]
                xu = self.imgs[torch.as_tensor(idx.reshape(-1), device=dev)]
                self.pair_chunks.append((pairs_prog(xu), mapping))
        per_rows = [[e for e in self.row_list if lo[s] <= e[0] < hi[s]]
                    for s in range(d)]
        for off, counts, w in data_lib.shard_bucket_plan(
                [len(r) for r in per_rows], pc.row_bucket_sizes):
            img_idx = np.zeros((d, w), np.int64)
            mask_idx = np.zeros((d, w), np.int64)
            mapping = []
            for s in range(d):
                sel = per_rows[s][off:off + counts[s]]
                img_idx[s, :], mask_idx[s, :] = (
                    sel[0] if sel else per_rows[s][0] if per_rows[s]
                    else ((lo[s] if lo[s] < n else 0), 0))
                for j, (b, i) in enumerate(sel):
                    img_idx[s, j], mask_idx[s, j] = b, i
                    mapping.append((s * w + j, b, i))
            xg = self.imgs[torch.as_tensor(img_idx.reshape(-1), device=dev)]
            flat = mask_idx.reshape(-1)
            if self.rowsets:
                t = pc._rows_incr(xg, torch.as_tensor(pc._np_grid_full[flat],
                                                      device=dev))
            else:
                t = pc._rows(xg, torch.as_tensor(flat, device=dev))
            self.row_chunks.append((t, mapping))
        return self

    def finalize(self) -> List[PatchCleanserRecord]:
        self.schedule()
        pc = self.pc
        m, p = pc.num_first, pc.num_second
        p1, majority, unanimous = self.p1, self.majority, self.unanimous

        def split(t):
            """(preds, margins or None) of one phase-2 chunk, on the host."""
            if isinstance(t, tuple):
                return t[0].cpu().numpy(), t[1].cpu().numpy()
            return t.cpu().numpy(), None

        pair_tables, pair_margins = {}, {}
        for t, mapping in self.pair_chunks:
            tbl, mg = split(t)
            for pos, b in mapping:
                pair_tables[b] = tbl[pos]
                if mg is not None:
                    pair_margins[b] = mg[pos]
        rows, row_margins = {}, {}     # image -> {mask i -> [M] row}
        for t, mapping in self.row_chunks:
            tbl, mg = split(t)
            for pos, b, i in mapping:
                rows.setdefault(b, {})[i] = tbl[pos]
                if mg is not None:
                    row_margins.setdefault(b, {})[i] = mg[pos]
        if self.incr == "off":
            # full masked forwards, also where an engine family was built
            fe_first, fe_pairs = float(m), float(p)
            fe_rows = np.full((m,), float(m))
        else:
            fe_first, fe_pairs, fe_rows = pc._fe_first, pc._fe_pairs, \
                pc._fe_rows
        # per image, the smallest top-2 margin over its evaluated engine
        # entries (+inf without margins)
        min_margin = np.full((self.n,), np.inf)
        if self.margins_on:
            min_margin[:] = self.t1_margins.cpu().numpy()[:self.n].min(axis=1)
        grid = pc._np_grid
        records: List[PatchCleanserRecord] = []
        for b in range(self.n):
            mj = int(majority[b])
            if b in pair_margins:
                min_margin[b] = min(min_margin[b], pair_margins[b].min())
            if unanimous[b]:
                if b in pair_tables:   # "exact": the certificate audit
                    p2 = pair_tables[b]
                    cert = bool((p2 == mj).all())
                    fwd, fe = m + p, fe_first + fe_pairs
                else:                  # "consensus": round-1 certificate
                    p2 = np.full((p,), UNEVALUATED, p1.dtype)
                    cert, fwd, fe = True, m, fe_first
                records.append(
                    PatchCleanserRecord(mj, cert, p1[b], p2, fwd, fe))
                continue
            # disagreement: the certificate died in round 1; only the
            # minority rows' recovery check remains
            minority = np.nonzero(p1[b] != mj)[0]
            if b in pair_tables:       # k*M >= P: the full table was cheaper
                p2 = pair_tables[b]
                second = p2[grid]
                second[np.eye(m, dtype=bool)] = p1[b]
                brows = {int(i): second[i] for i in minority}
                fwd, fe = m + p, fe_first + fe_pairs
            else:
                p2 = np.full((p,), UNEVALUATED, p1.dtype)
                brows = {}
                for i in minority:
                    row = rows[b][int(i)].copy()
                    # the diagonal re-evaluates mask_i alone; pin it to the
                    # phase-1 prediction, as double_masking_verdict reads it
                    row[i] = p1[b, i]
                    brows[int(i)] = row
                    off = np.arange(m) != i
                    p2[grid[i][off]] = row[off]
                    if b in row_margins:
                        # the pinned diagonal reads the phase-1 entry
                        min_margin[b] = min(
                            min_margin[b], row_margins[b][int(i)][off].min())
                fwd = m + m * len(minority)
                fe = fe_first + float(sum(fe_rows[i] for i in minority))
            recovered = [i for i, row in brows.items()
                         if (row == p1[b, i]).all()]
            pred = int(p1[b, max(recovered)]) if recovered else mj
            records.append(
                PatchCleanserRecord(pred, False, p1[b], p2, fwd, fe))
        self.min_margin = min_margin
        if self.incr.endswith("-exact") or pc._bf16:
            records = self._escalate(records, min_margin)
        return records

    def _escalate(self, records, min_margin) -> List[PatchCleanserRecord]:
        """For the "-exact" modes and every bf16 bank: re-certify every
        image whose evaluated entries came within `incremental_margin` of
        the argmax boundary through the float32 exhaustive sweep on the
        original victim (bucketed); its record becomes the exhaustive
        path's, its cost the entries already spent plus the full M + P
        sweep. Under "consensus" the certificate is re-derived from the
        sweep's first-round table (round-1 unanimity), so the record is
        the one the float32 consensus bank gives; the prediction needs no
        fixup (the majority on unanimity, and the same full-table
        recovery otherwise)."""
        pc = self.pc
        esc = np.nonzero(min_margin < pc.config.incremental_margin)[0]
        if not esc.size:
            return records
        m, p = pc.num_first, pc.num_second
        if pc.mesh is not None:
            # meshed certifiers bucket escalations on the row ladder
            bs = pc.row_bucket_sizes
        else:
            bs = (self.bucket_sizes if self.bucket_sizes is not None
                  else data_lib.batch_buckets(int(self.imgs.shape[0])))
        dev = self.imgs.device
        for off, cnt, bucket in data_lib.bucket_plan(int(esc.size), bs):
            xe = data_lib.pad_to_bucket(
                self.imgs[torch.as_tensor(esc[off:off + cnt], device=dev)],
                bucket)
            pred, cert, p1, p2 = (t.cpu().numpy() for t in
                                  pc._predict(xe, self.num_classes))
            if self.mode == "consensus":
                cert = (p1 == p1[:, :1]).all(axis=1)
            for pos in range(cnt):
                b = int(esc[off + pos])
                old = records[b]
                records[b] = PatchCleanserRecord(
                    int(pred[pos]), bool(cert[pos]), p1[pos], p2[pos],
                    old.forwards + m + p, old.forward_equivalents + m + p)
        return records


def materialize_verdicts(entry):
    """Host-materialize one certifier's batch answer, the device-to-host
    read the serving layer's `marshal_response` delegates to. `entry` is
    either the exhaustive `predict_tables` 4-tuple or a `_PrunedPending`;
    returns `(pred [n], certified [n], forwards [n], forward_equivalents
    [n])` as numpy arrays (forwards counts evaluated table entries,
    forward_equivalents their cost in full forwards)."""
    if isinstance(entry, _PrunedPending):
        recs = entry.finalize()
        return (np.asarray([r.prediction for r in recs]),
                np.asarray([r.certification for r in recs]),
                np.asarray([r.forwards for r in recs]),
                np.asarray([r.forward_equivalents for r in recs]))
    pred, certified, p1, p2 = entry
    exhaustive = int(p1.shape[1]) + int(p2.shape[1])
    pred, certified = pred.cpu().numpy(), certified.cpu().numpy()
    full = np.full((pred.shape[0],), exhaustive)
    return pred, certified, full, full.astype(np.float64)


@dataclasses.dataclass
class PatchCleanser:
    """One certifier per mask family: `robust_predict` over image batches
    on `device`; `collect` aggregates records. `recompile_budget` is the
    input signatures each program may run (one per image bucket; the row
    programs one per row bucket), enforced only under an armed guard
    (`observe.set_recompile_guard`). `mesh` (`parallel.Mesh`) shards the
    programs over its ranks, on the mesh's device."""

    apply_fn: Callable[[torch.Tensor], torch.Tensor]
    spec: masks_lib.MaskSpec
    config: DefenseConfig = dataclasses.field(default_factory=DefenseConfig)
    incremental_engine: Any = None
    device: Any = "cuda"
    result: Any = None
    recompile_budget: Any = None
    mesh: Any = None
    #: per-image smallest evaluated top-2 margin of the last pruned
    #: `robust_predict` (+inf where no margins were read)
    last_min_margin: Any = dataclasses.field(default=None, init=False,
                                             repr=False)

    def __post_init__(self):
        dtype = utils.compute_dtype(self.config.compute_dtype)
        self.device = (self.mesh.device if self.mesh is not None
                       else utils.resolve_device(self.device))
        self._downgrade_said = False
        # the bf16 bank's programs run on the once-cast victim; `_predict`
        # (the escalation's oracle) keeps `apply_fn`
        self._bf16 = dtype == torch.bfloat16
        self._dtype = dtype
        self._capply = utils.forward_at(self.apply_fn, dtype)
        singles, doubles = masks_lib.mask_sets(self.spec)
        self._num_singles = singles.shape[0]
        self._num_doubles = doubles.shape[0]
        k = max(singles.shape[1], doubles.shape[1])
        rects = np.concatenate([masks_lib.pad_rects(singles, k),
                                masks_lib.pad_rects(doubles, k)], axis=0)
        self._rects = torch.as_tensor(rects, dtype=torch.int32,
                                      device=self.device)
        self._incr_family = None
        # the JAX package's program names: the bf16 bank and the meshed
        # bank are program sets of their own (`defense.phase1.bf16.r0.03`,
        # `defense.phase1.bf16.mesh.r0.03`)
        r = self.spec.patch_ratio
        self._prog_tag = (".bf16" if self._bf16 else "") + (
            ".mesh" if self.mesh is not None else "")
        self._predict = observe.timed_first_call(
            self._exhaustive, f"defense.predict.r{r}",
            recompile_budget=self.recompile_budget)
        self._phase1 = self._pairs = self._rows = None
        self._phase1_incr = self._pairs_incr = self._rows_incr = None
        if self.spec.n_patch == 1:
            self._build_pruned(rects)

    def _build_pruned(self, rects: np.ndarray) -> None:
        """The pruned path's tables, the engine family and the forward
        equivalents (n_patch=1 families; n_patch=2 ones run exhaustive)."""
        m = self._num_singles
        self._grid_full = torch.as_tensor(
            masks_lib.second_round_table_indices(m), dtype=torch.long,
            device=self.device)
        self._np_grid = _second_round_index_grid(m)
        self._np_grid_full = masks_lib.second_round_table_indices(m)
        cap = max(1, int(self.config.chunk_size))
        self.row_bucket_sizes = data_lib.batch_buckets(cap)
        if self.mesh is not None:
            # each shard plans its own (about D times shorter) worklist and
            # the pair audits dispatch at these rungs too: a dense
            # power-of-two ladder bounds the padding at 2x
            self.row_bucket_sizes = tuple(sorted(
                {1, cap} | {2 ** k for k in range(1, cap.bit_length())
                            if 2 ** k < cap}))
        r, tag, rb = self.spec.patch_ratio, self._prog_tag, \
            self.recompile_budget
        row_rb = len(self.row_bucket_sizes) if rb is not None else None
        pair_rb = row_rb if self.mesh is not None else rb
        self._phase1 = observe.timed_first_call(
            self._phase1_tables, f"defense.phase1{tag}.r{r}",
            recompile_budget=rb)
        self._pairs = observe.timed_first_call(
            self._pairs_tables, f"defense.pairs{tag}.r{r}",
            recompile_budget=pair_rb)
        self._rows = observe.timed_first_call(
            self._rows_tables, f"defense.rows{tag}.r{r}",
            recompile_budget=row_rb)
        if (self.incremental_engine is not None
                and self.config.incremental != "off"):
            fam = self._incr_family = self.incremental_engine.build_family(
                rects, m, self.config.chunk_size, self.config.mask_fill,
                compute_dtype=self.config.compute_dtype, mesh=self.mesh)
            kind = self.incremental_engine.kind
            self._phase1_incr = observe.timed_first_call(
                fam.phase1, f"defense.phase1.{kind}{tag}.r{r}",
                recompile_budget=rb)
            if kind in MARGIN_KINDS:
                self._pairs_incr = observe.timed_first_call(
                    fam.pairs, f"defense.pairs.{kind}{tag}.r{r}",
                    recompile_budget=pair_rb)
                self._rows_incr = observe.timed_first_call(
                    fam.rows, f"defense.rows.{kind}{tag}.r{r}",
                    recompile_budget=row_rb)
        # forward equivalents per combined-table mask: 1 without a margin
        # engine, its dirty-token fraction with one; `cache_fe` charges each
        # call's clean cache once per image (phase 1, each pair-audit image,
        # each gathered row entry)
        fe_combined = np.ones((rects.shape[0],), np.float64)
        cache_fe = 0.0
        if self._incr_family is not None and \
                self.incremental_engine.kind in MARGIN_KINDS:
            fe_combined = np.asarray(self._incr_family.fe, np.float64)
            cache_fe = float(self._incr_family.cache_fe)
        self._fe_rows = fe_combined[self._np_grid_full].sum(axis=1) + cache_fe
        self._fe_first = float(fe_combined[:m].sum()) + cache_fe
        self._fe_pairs = float(fe_combined[m:].sum()) + cache_fe

    @property
    def num_first(self) -> int:
        return int(self._num_singles)

    @property
    def num_second(self) -> int:
        return int(self._num_doubles)

    @property
    def num_forwards_exhaustive(self) -> int:
        return self.num_first + self.num_second

    # ---- the programs ----

    def _sweep(self, imgs, rects, with_margins=False):
        """A program of the pruned path: at the bank's dtype, with margins
        whenever bf16."""
        return masked_predictions(
            self._capply, imgs, rects, self.config.chunk_size,
            self.config.mask_fill, with_margins or self._bf16,
            self._dtype if self._bf16 else None, self.mesh)

    def _exhaustive(self, imgs: torch.Tensor, num_classes: int):
        """The exhaustive 666-entry sweep and verdict, always float32 on
        the original victim: (pred, certified, preds_1, preds_2)
        tensors (`_predict`, its timed wrapper)."""
        preds = masked_predictions(self.apply_fn, imgs, self._rects,
                                   self.config.chunk_size,
                                   self.config.mask_fill, mesh=self.mesh)
        p1, p2 = preds[:, :self._num_singles], preds[:, self._num_singles:]
        pred, certified = double_masking_verdict(p1, p2, self._num_singles,
                                                 num_classes)
        return pred, certified, p1, p2

    # `_phase1`, `_pairs`, `_rows` (and the engine family's
    # `_phase1_incr`, `_pairs_incr`, `_rows_incr`) are these, wrapped by
    # `observe.timed_first_call` in `_build_pruned`

    def _phase1_tables(self, imgs, with_margins=False):
        return self._sweep(imgs, self._rects[:self._num_singles],
                           with_margins)

    def _pairs_tables(self, imgs):
        return self._sweep(imgs, self._rects[self._num_singles:])

    @torch.no_grad()
    def _rows_tables(self, imgs_g: torch.Tensor, mask_idx: torch.Tensor):
        """`[W,H,W,C]` gathered images x `[W]` first-round mask ids ->
        `[W, M]` second-round rows (and their `[W, M]` margins in the bf16
        bank). The M second masks run in groups of G columns (G the largest
        divisor of M with G*W <= chunk_size), each group one forward of
        `[G*W]` images occluded by a rasterize-and-lerp of per-entry
        rectangle sets (entry w's column j is {mask_idx[w], j}). On a mesh
        each rank runs its `[W/d, M/m]` block and the rows are gathered.
        """
        if self._bf16:
            imgs_g = imgs_g.to(self._dtype)     # the program boundary
        idx_tab = self._grid_full[mask_idx.long()]            # [W, M]
        if self.mesh is None:
            return self._rows_block(imgs_g, idx_tab)
        def run(rows, cols):
            out = self._rows_block(imgs_g[rows], idx_tab[rows][:, cols])
            return out if self._bf16 else (out,)

        got = self.mesh.tables(
            int(idx_tab.shape[0]), int(idx_tab.shape[1]), run,
            (torch.int32, torch.float32)[:2 if self._bf16 else 1], "rows")
        return tuple(got) if self._bf16 else got[0]

    def _rows_block(self, imgs_g: torch.Tensor, idx_tab: torch.Tensor):
        """The rows program's `[W, M']` block of combined-table index rows
        `idx_tab`, in column groups as `_rows_tables` says."""
        m = int(idx_tab.shape[1])
        w_sz = int(imgs_g.shape[0])
        cap = max(1, int(self.config.chunk_size) // max(1, w_sz))
        g = max(d for d in range(1, m + 1)
                if m % d == 0 and d <= cap) if cap > 1 else 1
        cols = idx_tab.t().reshape(m // g, g, w_sz)
        fill = self.config.mask_fill
        out, margins = [], []
        for grp in cols:
            rects = self._rects[grp.reshape(-1)]               # [G*W, K, 4]
            mk = masks_lib.rasterize(rects, self.spec.img_size)[..., None]
            mk = mk.to(imgs_g.dtype)
            xm = imgs_g.repeat(g, 1, 1, 1) * mk + fill * (1.0 - mk)
            logits = self._capply(xm)
            if self._bf16:
                p, mg = utils.preds_margins(logits)
                margins.append(mg.reshape(g, w_sz))
            else:
                p = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(p.reshape(g, w_sz))
        preds = torch.cat(out, dim=0).t()                      # [W, M]
        if self._bf16:
            return preds, torch.cat(margins, dim=0).t()
        return preds

    # ---- modes ----

    def resolved_prune(self, prune: Optional[str] = None) -> str:
        """explicit arg > config; "off" for every n_patch != 1 family (its
        verdict reads the whole combined table), said once on stderr."""
        mode = self.config.prune if prune is None else prune
        if mode not in PRUNE_MODES:
            raise ValueError(f"prune={mode!r} (legal: {', '.join(PRUNE_MODES)})")
        if self.spec.n_patch != 1:
            if mode != "off" and not self._downgrade_said:
                self._downgrade_said = True
                observe.log(f"defense: prune={mode!r} runs as 'off' for the "
                            f"n_patch={self.spec.n_patch} mask family at "
                            f"ratio {self.spec.patch_ratio} (the exhaustive "
                            "sweep)", file=sys.stderr)
            return "off"
        return mode

    def resolved_incremental(self, incremental: Optional[str] = None,
                             prune: Optional[str] = None) -> str:
        """explicit arg > config; "auto" -> the engine's kind, with
        "-exact" for the margin engines ("token-exact", "mixer-exact").
        "off" without an engine or when the pruned path is off."""
        mode = (self.config.incremental if incremental is None
                else incremental)
        if mode not in INCREMENTAL_MODES:
            raise ValueError(f"incremental={mode!r} "
                             f"(legal: {', '.join(INCREMENTAL_MODES)})")
        if self._incr_family is None or self.resolved_prune(prune) == "off":
            return "off"
        kind = self.incremental_engine.kind
        if mode == "auto":
            return f"{kind}-exact" if kind in MARGIN_KINDS else kind
        if mode != "off" and mode.split("-")[0] != kind:
            raise ValueError(f"incremental={mode!r} but this victim family's "
                             f"engine is {kind!r}")
        return mode

    def pruned_programs(self, incremental: Optional[str] = None):
        """`[(name, program, input_kind)]` of the three programs the
        resolved pruned(+incremental) path runs: "imgs" (`[B,H,W,C]`),
        "rows" (gathered `[W,H,W,C]`, `[W]` first-mask ids) or "rows_sets"
        (gathered `[W,H,W,C]`, `[W,M]` combined-table index rows, the
        margin engines' rows)."""
        r, tag = self.spec.patch_ratio, self._prog_tag
        mode = self.resolved_incremental(incremental)
        kind = mode.split("-")[0]
        if kind in MARGIN_KINDS:
            return [
                (f"defense.phase1.{kind}{tag}.r{r}", self._phase1_incr,
                 "imgs"),
                (f"defense.pairs.{kind}{tag}.r{r}", self._pairs_incr, "imgs"),
                (f"defense.rows.{kind}{tag}.r{r}", self._rows_incr,
                 "rows_sets"),
            ]
        if mode == "stem":
            return [
                (f"defense.phase1.stem{tag}.r{r}", self._phase1_incr, "imgs"),
                (f"defense.pairs{tag}.r{r}", self._pairs, "imgs"),
                (f"defense.rows{tag}.r{r}", self._rows, "rows"),
            ]
        return [
            (f"defense.phase1{tag}.r{r}", self._phase1, "imgs"),
            (f"defense.pairs{tag}.r{r}", self._pairs, "imgs"),
            (f"defense.rows{tag}.r{r}", self._rows, "rows"),
        ]

    def pruned_trace_counts(self) -> dict:
        """Input signatures run so far by each program of the resolved
        pruned path (and, where it escalates, by the exhaustive
        program): the serving layer's zero-recompile bookkeeping."""
        out = {name: int(fn._cache_size())
               for name, fn, _ in self.pruned_programs()}
        if self.resolved_incremental().endswith("-exact") or self._bf16:
            out[f"defense.predict.r{self.spec.patch_ratio}"] = \
                int(self._predict._cache_size())
        return out

    @torch.no_grad()
    def warm_pruned(self, bucket_sizes: Sequence[int],
                    num_classes: Optional[int] = None) -> None:
        """Run every program the resolved pruned path can run at serving
        time, at every shape it can run it: phase 1 and the pair audit per
        image bucket, the rows program per row bucket and, where the path
        escalates ("-exact", the bf16 bank; pass `num_classes`), the
        exhaustive program per image bucket. Warm inputs are made the way
        live ones are (dtype, device, index types), so they share live
        traffic's signatures."""
        size = self.spec.img_size
        mode = self.resolved_incremental()
        (_, phase1, _), (_, pairs, _), (_, rows, rows_kind) = \
            self.pruned_programs()
        esc_on = mode.endswith("-exact") or self._bf16
        if esc_on and num_classes is None:
            raise ValueError(
                f"warm_pruned needs num_classes under "
                f"{mode if mode.endswith('-exact') else 'bfloat16'} "
                "(the escalation program's argument)")

        def run(prog, *args):
            out = prog(*args)
            (out[0] if isinstance(out, tuple) else out).cpu()

        def full(b):
            return torch.full((int(b), size, size, 3), 0.5,
                              dtype=torch.float32, device=self.device)

        for b in bucket_sizes:
            imgs = full(b)
            run(phase1, imgs)
            run(pairs, imgs)
            if esc_on:
                run(self._predict, imgs, int(num_classes))
        for w in self.row_bucket_sizes:
            imgs_g = full(w)
            if rows_kind == "rows_sets":
                run(rows, imgs_g, torch.as_tensor(
                    self._np_grid_full[[0] * int(w)], device=self.device))
            else:
                run(rows, imgs_g, torch.as_tensor([0] * int(w),
                                                  device=self.device))

    def begin_pruned(self, imgs: torch.Tensor, num_classes: int,
                     n: Optional[int] = None,
                     bucket_sizes: Optional[Sequence[int]] = None,
                     prune: Optional[str] = None,
                     incremental: Optional[str] = None) -> _PrunedPending:
        """Launch phase 1 of the pruned certification (no host sync).
        `imgs` may already be bucket-padded (pass the real count as `n`,
        the serving worker's contract); otherwise it is padded here when
        `bucket_sizes` is given. Call `.schedule()` then `.finalize()` on
        the returned pending, or `materialize_verdicts` on it."""
        mode = self.resolved_prune(prune)
        if mode == "off":
            raise ValueError("begin_pruned needs prune='exact'|'consensus'")
        incr = self.resolved_incremental(incremental, prune)
        total = int(imgs.shape[0])
        n = total if n is None else int(n)
        if bucket_sizes is not None and n and total == n:
            imgs = data_lib.pad_to_bucket(
                imgs, data_lib.bucket_batch(n, bucket_sizes))
        return _PrunedPending(self, imgs, n, num_classes, bucket_sizes,
                              mode, incr)

    def predict_tables(self, imgs: torch.Tensor, num_classes: int):
        """The exhaustive sweep's tables on the device, `(pred [B],
        certified [B], preds_1 [B,M], preds_2 [B,P])`, nothing read back:
        the serving worker launches every certifier before it reads any;
        `materialize_verdicts` reads them."""
        return self._predict(imgs, num_classes)

    # ---- entry points ----

    @torch.no_grad()
    def robust_predict(self, imgs: torch.Tensor, num_classes: int,
                       bucket_sizes: Optional[Sequence[int]] = None,
                       prune: Optional[str] = None,
                       incremental: Optional[str] = None
                       ) -> List[PatchCleanserRecord]:
        """Robust prediction and certificate per image of `imgs` `[B,H,W,C]`.
        `bucket_sizes` rounds a ragged batch up to a bucket (padding repeats
        the first image; padded rows never reach the records). `prune`
        overrides the config: "off" = the exhaustive sweep, "exact" = the
        pruned schedule with identical verdicts, "consensus" = "exact" with
        unanimous images stopped after the first round."""
        imgs = imgs.to(self.device)
        n = int(imgs.shape[0])
        mode = self.resolved_prune(prune)
        if n and mode != "off":
            pending = self.begin_pruned(imgs, num_classes,
                                        bucket_sizes=bucket_sizes,
                                        prune=mode, incremental=incremental)
            records = pending.schedule().finalize()
            self.last_min_margin = pending.min_margin
            return records
        if bucket_sizes is not None and n:
            imgs = data_lib.pad_to_bucket(
                imgs, data_lib.bucket_batch(n, bucket_sizes))
        pred, certified, p1, p2 = (t.cpu().numpy() for t in
                                   self.predict_tables(imgs, num_classes))
        full = self.num_forwards_exhaustive
        return [PatchCleanserRecord(int(pred[b]), bool(certified[b]), p1[b],
                                    p2[b], full, float(full))
                for b in range(n)]

    def reset(self):
        self.result = None

    def collect(self, records: Sequence[PatchCleanserRecord]):
        self.result = PatchCleanserResult(records)


def build_defenses(apply_fn, img_size: int,
                   config: DefenseConfig = DefenseConfig(),
                   incremental=None, device="cuda",
                   recompile_budget=None, mesh=None) -> List[PatchCleanser]:
    """The 4-radius defense bank, one certifier per ratio of the config;
    sharded over `mesh` when one is given."""
    return [PatchCleanser(apply_fn,
                          masks_lib.geometry(img_size, r, config.n_patch,
                                             config.num_mask_per_axis),
                          config, incremental_engine=incremental,
                          device=device, recompile_budget=recompile_budget,
                          mesh=mesh)
            for r in config.ratios]
