"""PatchCleanser double-masking certification.

Port of `dorpatch_tpu.defense` for one device. The masked forwards run on
the victim's device; the decision logic reads the `[B, 36]` / `[B, 630]`
prediction tables.

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
each image's evaluated entries.

`incremental="stem"` (what "auto" resolves to for conv victims) computes the
first round through the masked-stem fold (`ops.stem_fold`); phase 2 keeps
full masked forwards.

`incremental="token"` runs all three programs (phase 1, the pair audit and
the second-round rows) through the ViT token engine (`models.vit`), which
returns top-2 logit margins beside its predictions. `"token-exact"` (what
"auto" resolves to for ViT victims) adds the escalation: every image whose
evaluated entries include a margin below `DefenseConfig.incremental_margin`
is re-certified through the exhaustive sweep, so its record is the
exhaustive path's. `PatchCleanserRecord.forward_equivalents` credits a
token-pruned entry at its fraction of a full forward.

Tie-breaking (as in the JAX package): the majority label on count ties is
the smallest label with the maximal count; among several recovering
minority masks the one with the largest mask index wins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dorpatch_tpu_torch import data as data_lib
from dorpatch_tpu_torch import masks as masks_lib
from dorpatch_tpu_torch import utils
from dorpatch_tpu_torch.config import DefenseConfig
from dorpatch_tpu_torch.ops.masked_fill import masked_fill

PRUNE_MODES = ("off", "exact")
INCREMENTAL_MODES = ("auto", "token", "token-exact", "stem", "off")

#: `preds_2` entries the pruned path never evaluated (provably unread).
UNEVALUATED = -1


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
                       with_margins: bool = False):
    """Predictions under every mask in `rects`: `[B,H,W,C] x [N,K,4] ->
    [B,N]` int32 (plus the `[B,N]` top-2 margins with `with_margins`).
    The mask axis runs in chunks of at most `chunk_size` (a live-memory
    bound of `B * chunk_size` masked images); each chunk is one fused
    `masked_fill` (kernel A on the card) and one batched forward."""
    n = int(rects.shape[0])
    n_chunks, chunk = plan_chunks(n, chunk_size)
    batch = imgs.shape[0]
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
    grid = torch.as_tensor(_second_round_index_grid(num_masks), device=dev,
                           dtype=torch.long)
    counts = F.one_hot(preds_1.long(), num_classes).sum(dim=1)
    majority = torch.argmax(counts, dim=-1).to(preds_1.dtype)
    unanimous = (preds_1 == preds_1[:, :1]).all(dim=1)
    certified = unanimous & (preds_2 == majority[:, None]).all(dim=1)
    second = preds_2[:, grid]                                   # [B, M, M]
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
    second = preds_2[:, grid]
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
    (k*M >= P); a unanimous image needs the pair audit ("exact")."""
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
    """One pruned certification batch: phase 1 runs at construction,
    `schedule()` reads the `[B, M]` first-round table (the one designed
    host sync) and runs phase 2, `finalize()` runs `schedule()`, assembles
    the records and, under "token-exact", escalates."""

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
        # the token engine's margins; the stem fold is exact and its
        # margins are not read
        self.margins_on = incremental.startswith("token")
        self.t1_margins = None
        if incremental != "off":
            self.t1, self.t1_margins = pc._phase1_incr(imgs)
        else:
            self.t1 = pc._phase1(imgs)
        self.min_margin = None
        # phase-2 chunks: (prediction table, [(table_row, image[, mask])])
        self.pair_chunks = []
        self.row_chunks = []

    def schedule(self) -> None:
        pc = self.pc
        self.p1 = self.t1.cpu().numpy()[:self.n]
        self.majority, self.unanimous = host_round1(self.p1, self.num_classes)
        need_pairs, self.row_list = schedule_round2(
            self.p1, self.majority, self.unanimous, pc.num_first,
            pc.num_second, self.mode)
        self.pair_idx = np.nonzero(need_pairs)[0]
        dev = self.imgs.device
        pairs_prog = pc._pairs_incr if self.margins_on else pc._pairs
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
            if self.margins_on:
                # the engine's rows take each entry's row of combined-table
                # indices
                t = pc._rows_incr(xg, torch.as_tensor(
                    pc._np_grid_full[mask_idx], device=dev))
            else:
                t = pc._rows(xg, torch.as_tensor(mask_idx, device=dev))
            self.row_chunks.append(
                (t, [(pos, b, i) for pos, (b, i) in enumerate(chunk)]))

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
        if self.margins_on:
            fe_first, fe_pairs, fe_rows = pc._fe_first, pc._fe_pairs, \
                pc._fe_rows
        else:
            fe_first, fe_pairs = float(m), float(p)
            fe_rows = np.full((m,), float(m))
        # per image, the smallest top-2 margin over its evaluated token
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
                p2 = pair_tables[b]    # "exact": the certificate audit
                cert = bool((p2 == mj).all())
                records.append(PatchCleanserRecord(
                    mj, cert, p1[b], p2, m + p, fe_first + fe_pairs))
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
        if self.incr.endswith("-exact"):
            records = self._escalate(records, min_margin)
        return records

    def _escalate(self, records, min_margin) -> List[PatchCleanserRecord]:
        """Re-certify every image whose evaluated entries came within
        `incremental_margin` of the argmax boundary through the exhaustive
        sweep (bucketed); its record becomes the exhaustive path's, its
        cost the entries already spent plus the full M + P sweep."""
        pc = self.pc
        esc = np.nonzero(min_margin < pc.config.incremental_margin)[0]
        if not esc.size:
            return records
        m, p = pc.num_first, pc.num_second
        bs = (self.bucket_sizes if self.bucket_sizes is not None
              else data_lib.batch_buckets(int(self.imgs.shape[0])))
        dev = self.imgs.device
        for off, cnt, bucket in data_lib.bucket_plan(int(esc.size), bs):
            xe = data_lib.pad_to_bucket(
                self.imgs[torch.as_tensor(esc[off:off + cnt], device=dev)],
                bucket)
            pred, cert, p1, p2 = (t.cpu().numpy() for t in
                                  pc._predict(xe, self.num_classes))
            for pos in range(cnt):
                b = int(esc[off + pos])
                old = records[b]
                records[b] = PatchCleanserRecord(
                    int(pred[pos]), bool(cert[pos]), p1[pos], p2[pos],
                    old.forwards + m + p, old.forward_equivalents + m + p)
        return records


@dataclasses.dataclass
class PatchCleanser:
    """One certifier per mask family: `robust_predict` over image batches
    on `device`; `collect` aggregates records."""

    apply_fn: Callable[[torch.Tensor], torch.Tensor]
    spec: masks_lib.MaskSpec
    config: DefenseConfig = dataclasses.field(default_factory=DefenseConfig)
    incremental_engine: Any = None
    device: Any = "cuda"
    result: Any = None
    #: per-image smallest evaluated top-2 margin of the last pruned
    #: `robust_predict` (+inf where no margins were read)
    last_min_margin: Any = dataclasses.field(default=None, init=False,
                                             repr=False)

    def __post_init__(self):
        if self.spec.n_patch != 1:
            raise NotImplementedError(
                "the port certifies n_patch=1 mask families only")
        self.device = utils.resolve_device(self.device)
        singles, doubles = masks_lib.mask_sets(self.spec)
        self._num_singles = singles.shape[0]
        self._num_doubles = doubles.shape[0]
        k = max(singles.shape[1], doubles.shape[1])
        rects = np.concatenate([masks_lib.pad_rects(singles, k),
                                masks_lib.pad_rects(doubles, k)], axis=0)
        self._rects = torch.as_tensor(rects, dtype=torch.int32,
                                      device=self.device)
        m = self._num_singles
        self._grid_full = torch.as_tensor(
            masks_lib.second_round_table_indices(m), dtype=torch.long,
            device=self.device)
        self._np_grid = _second_round_index_grid(m)
        self._np_grid_full = masks_lib.second_round_table_indices(m)
        self.row_bucket_sizes = data_lib.batch_buckets(
            max(1, int(self.config.chunk_size)))
        self._incr_family = None
        if (self.incremental_engine is not None
                and self.config.incremental != "off"):
            self._incr_family = self.incremental_engine.build_family(
                rects, m, self.config.chunk_size, self.config.mask_fill)
        # forward equivalents per combined-table mask: 1 without the token
        # engine, its dirty-token fraction with it; `cache_fe` charges each
        # call's clean cache once per image (phase 1, each pair-audit image,
        # each gathered row entry)
        fe_combined = np.ones((rects.shape[0],), np.float64)
        cache_fe = 0.0
        if self._incr_family is not None and \
                self.incremental_engine.kind == "token":
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
        return masked_predictions(self.apply_fn, imgs, rects,
                                  self.config.chunk_size,
                                  self.config.mask_fill, with_margins)

    def _predict(self, imgs: torch.Tensor, num_classes: int):
        """The exhaustive 666-entry sweep and verdict: (pred, certified,
        preds_1, preds_2) tensors."""
        preds = self._sweep(imgs, self._rects)
        p1, p2 = preds[:, :self._num_singles], preds[:, self._num_singles:]
        pred, certified = double_masking_verdict(p1, p2, self._num_singles,
                                                 num_classes)
        return pred, certified, p1, p2

    def _phase1(self, imgs, with_margins=False):
        return self._sweep(imgs, self._rects[:self._num_singles],
                           with_margins)

    def _phase1_incr(self, imgs):
        return self._incr_family.phase1(imgs)

    def _pairs(self, imgs):
        return self._sweep(imgs, self._rects[self._num_singles:])

    def _pairs_incr(self, imgs):
        return self._incr_family.pairs(imgs)

    def _rows_incr(self, imgs_g, sets_idx):
        return self._incr_family.rows(imgs_g, sets_idx)

    @torch.no_grad()
    def _rows(self, imgs_g: torch.Tensor, mask_idx: torch.Tensor):
        """`[W,H,W,C]` gathered images x `[W]` first-round mask ids ->
        `[W, M]` second-round rows. The M second masks run in groups of G
        columns (G the largest divisor of M with G*W <= chunk_size), each
        group one forward of `[G*W]` images occluded by a rasterize-and-lerp
        of per-entry rectangle sets (entry w's column j is {mask_idx[w], j}).
        """
        m = self.num_first
        idx_tab = self._grid_full[mask_idx.long()]            # [W, M]
        w_sz = int(imgs_g.shape[0])
        cap = max(1, int(self.config.chunk_size) // max(1, w_sz))
        g = max(d for d in range(1, m + 1)
                if m % d == 0 and d <= cap) if cap > 1 else 1
        cols = idx_tab.t().reshape(m // g, g, w_sz)
        fill = self.config.mask_fill
        out = []
        for grp in cols:
            rects = self._rects[grp.reshape(-1)]               # [G*W, K, 4]
            mk = masks_lib.rasterize(rects, self.spec.img_size)[..., None]
            mk = mk.to(imgs_g.dtype)
            xm = imgs_g.repeat(g, 1, 1, 1) * mk + fill * (1.0 - mk)
            logits = self.apply_fn(xm)
            out.append(torch.argmax(logits, dim=-1).to(torch.int32)
                       .reshape(g, w_sz))
        return torch.cat(out, dim=0).t()                       # [W, M]

    # ---- modes ----

    def resolved_prune(self, prune: Optional[str] = None) -> str:
        mode = self.config.prune if prune is None else prune
        if mode not in PRUNE_MODES:
            raise ValueError(f"prune={mode!r} (legal: {', '.join(PRUNE_MODES)})")
        return mode

    def resolved_incremental(self, incremental: Optional[str] = None,
                             prune: Optional[str] = None) -> str:
        """explicit arg > config; "auto" -> the engine's kind ("token-exact"
        for the token engine). "off" without an engine or when the pruned
        path is off."""
        mode = (self.config.incremental if incremental is None
                else incremental)
        if mode not in INCREMENTAL_MODES:
            raise ValueError(f"incremental={mode!r} "
                             f"(legal: {', '.join(INCREMENTAL_MODES)})")
        if self._incr_family is None or self.resolved_prune(prune) == "off":
            return "off"
        kind = self.incremental_engine.kind
        if mode == "auto":
            return "token-exact" if kind == "token" else kind
        if mode != "off" and mode.split("-")[0] != kind:
            raise ValueError(f"incremental={mode!r} but this victim family's "
                             f"engine is {kind!r}")
        return mode

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
        pruned schedule with identical verdicts."""
        imgs = imgs.to(self.device)
        n = int(imgs.shape[0])
        mode = self.resolved_prune(prune)
        if bucket_sizes is not None and n:
            imgs = data_lib.pad_to_bucket(
                imgs, data_lib.bucket_batch(n, bucket_sizes))
        if n and mode != "off":
            incr = self.resolved_incremental(incremental, mode)
            pending = _PrunedPending(self, imgs, n, num_classes, bucket_sizes,
                                     mode, incr)
            records = pending.finalize()
            self.last_min_margin = pending.min_margin
            return records
        pred, certified, p1, p2 = (t.cpu().numpy() for t in
                                   self._predict(imgs, num_classes))
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
                   incremental=None, device="cuda") -> List[PatchCleanser]:
    """The 4-radius defense bank, one certifier per ratio of the config."""
    return [PatchCleanser(apply_fn,
                          masks_lib.geometry(img_size, r, config.n_patch,
                                             config.num_mask_per_axis),
                          config, incremental_engine=incremental,
                          device=device)
            for r in config.ratios]
