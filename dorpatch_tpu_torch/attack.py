"""The DorPatch optimizer: a two-stage EOT attack with on-device state.

Port of `dorpatch_tpu.attack`. All adaptive state lives in a `TrainState`
of device tensors; one optimization step samples masks (Gumbel top-k with a
failure bias, on a `torch.Generator`), runs the fused masked fill (kernels A
and B on the card) and the victim's forward and backward, and updates the
state with tensor selects: no host sync inside a step. Steps run in blocks
of `sweep_interval` between full-universe failure sweeps; the host reads one
flag per block.

Stage 0 learns a continuous importance map under group-lasso/density
regularization; stage 1 freezes the top-k hard mask (`patch_selection`) and
refines the pattern under EOT over the occlusion universe.

`AttackConfig.compute_dtype="bfloat16"` is the mixed-precision EOT step of
the JAX package: the masked batch is filled at float32 (kernel A) and runs
forward and backward through the victim's once-cast bf16 copy
(`utils.forward_at`: `apply_fn.at(torch.bfloat16)` of a
`models.registry.VictimForward`), which returns float32 logits; the patch,
the losses and every carry field stay float32, and the failure sweep runs
the same bf16 forward. The clean predictions (`y`, the stage-1 switch)
stay on the float32 forward.

Remat (`AttackConfig.remat`, `remat_policy`; `models/remat.py`): the EOT
forward under `torch.autograd.grad` checkpoints each residual block of the
victim, so the backward keeps the block inputs and recomputes the rest;
loss and gradients are bit-equal with it on and off. The failure sweep
and the clean predictions never differentiate and keep the plain forward.

Programs (`observe.timed_first_call`): the step runs as
"attack.step.stage0"/"attack.step.stage1" and the sweep as "attack.sweep",
each with the `recompile_budget` the pipeline declares (the batch size:
the correctness filter makes the batch the only legitimate shape bucket),
enforced under an armed recompile guard (`--sanitize`).

Crash recovery (`checkpoint.CarryCheckpointer`): with a `checkpointer`, the
carry is snapshotted at every block boundary, before the `on_block_end`
callback, and `generate` resumes from the newest snapshot; the generator's
state is part of the snapshot, so a resumed run draws the same masks and
ends on the same patch, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dorpatch_tpu_torch import losses, observe, utils
from dorpatch_tpu_torch import masks as masks_lib
from dorpatch_tpu_torch.config import AttackConfig
from dorpatch_tpu_torch.defense import masked_predictions
from dorpatch_tpu_torch.models import remat as remat_lib
from dorpatch_tpu_torch.ops.masked_fill import masked_fill

_FIELDS_LATCHED = ("step", "adv_mask", "adv_pattern", "best_mask",
                   "best_pattern", "loss_best", "lr", "not_decay",
                   "num_failure", "failed", "coeff_gl", "coeff_struct",
                   "coeff_density", "targeted", "y", "last_preds", "stopped",
                   "metrics")


@dataclasses.dataclass
class TrainState:
    """The optimizer's carry: device tensors plus its generator."""

    step: torch.Tensor          # int32 scalar, iteration within the stage
    gen: torch.Generator
    adv_mask: torch.Tensor      # [B,H,W,1]
    adv_pattern: torch.Tensor   # [B,H,W,3]
    best_mask: torch.Tensor
    best_pattern: torch.Tensor
    loss_best: torch.Tensor     # [B]
    lr: torch.Tensor            # [B]
    not_decay: torch.Tensor     # [B] int32
    num_failure: torch.Tensor   # int32 scalar
    failed: torch.Tensor        # [n_mask] bool
    coeff_gl: torch.Tensor      # f32 scalars
    coeff_struct: torch.Tensor
    coeff_density: torch.Tensor
    targeted: torch.Tensor      # [B] bool
    y: torch.Tensor             # [B] int64
    last_preds: torch.Tensor    # [B,S]
    stopped: torch.Tensor       # bool scalar
    metrics: torch.Tensor       # [8]: loss, adv, struc, gl, density, acc, l2, n_failed

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class AttackResult(NamedTuple):
    adv_mask: torch.Tensor
    adv_pattern: torch.Tensor
    y: np.ndarray
    targeted: np.ndarray
    stage0_mask: torch.Tensor
    stage0_pattern: torch.Tensor


def patch_selection(mask: torch.Tensor, patch_budget: float,
                    basic_unit: int = 7) -> torch.Tensor:
    """Importance map -> hard patch mask: window-sum over basic_unit cells,
    keep the top `floor(H*W*budget/unit^2)` cells with positive mass,
    upsample to pixels. `[B,H,W,1]` -> binary `[B,H,W,1]`."""
    b, h, w, _ = mask.shape
    cells = losses.window_sum(mask, basic_unit)[..., 0]
    hp, wp = cells.shape[1:]
    flat = cells.reshape(b, -1)
    k = int(np.floor(h * w * patch_budget / basic_unit**2))
    vals, idxs = torch.topk(flat, k, dim=1)
    sel = torch.zeros_like(flat).scatter(1, idxs, (vals > 0).to(mask.dtype))
    sel = sel.reshape(b, hp, wp)
    sel = sel.repeat_interleave(basic_unit, 1).repeat_interleave(basic_unit, 2)
    sel = F.pad(sel, (0, w - sel.shape[2], 0, h - sel.shape[1]))
    return sel[..., None]


def majority_incorrect_label(preds: torch.Tensor, y: torch.Tensor,
                             num_classes: int):
    """Per-image mode of the misclassified predictions `[B,S]` (smallest
    label on ties): `(labels, has_target)`; images with no misclassified
    prediction keep their label and report False."""
    incorrect = preds != y[:, None]
    counts = (F.one_hot(preds.long(), num_classes)
              * incorrect[..., None]).sum(dim=1)
    has_any = incorrect.any(dim=1)
    mode = torch.argmax(counts, dim=-1).to(y.dtype)
    return torch.where(has_any, mode, y), has_any


def _gumbel(gen: torch.Generator, n: int, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass
class DorPatch:
    """Two-stage distributed occlusion-robust patch attack on the victim's
    device. `apply_fn(images01) -> logits`; a bf16 `compute_dtype` runs
    the EOT step on `utils.forward_at(apply_fn, torch.bfloat16)`."""

    apply_fn: Callable[[torch.Tensor], torch.Tensor]
    num_classes: int
    config: AttackConfig = dataclasses.field(default_factory=AttackConfig)
    # called at every block boundary as (stage, iteration, info), info
    # holding the host copies "metrics" ([8]), "stopped" and "n_failed"
    on_block_end: Optional[Callable[[int, int, dict], None]] = None
    # optional checkpoint.CarryCheckpointer: mid-stage crash recovery
    checkpointer: Optional[Any] = None
    # None: follow config.remat ("auto" remats only when the masked batch
    # exceeds config.remat_threshold); True/False force it
    remat: Optional[bool] = None
    # input signatures each program (step, sweep) may run; inert unless a
    # recompile guard is armed (observe.set_recompile_guard)
    recompile_budget: Optional[int] = None

    def __post_init__(self):
        cfg = self.config
        # the EOT forward (step and sweep): the victim itself at float32,
        # its once-cast copy at bf16
        self._fwd = utils.forward_at(
            self.apply_fn, utils.compute_dtype(cfg.compute_dtype))
        if cfg.remat not in ("auto", "on", "off"):
            raise ValueError(f"remat={cfg.remat!r}")
        if cfg.remat_policy not in remat_lib.POLICIES:
            raise ValueError(f"remat_policy={cfg.remat_policy!r}")
        self._programs = {
            stage: observe.timed_first_call(
                self._step, f"attack.step.stage{stage}",
                recompile_budget=self.recompile_budget)
            for stage in (0, 1)}
        self._programs["sweep"] = observe.timed_first_call(
            self._sweep, "attack.sweep",
            recompile_budget=self.recompile_budget)

    def _grad_fwd(self, n_masked: int):
        """The forward used under `torch.autograd.grad`, with the remat
        policy applied. `remat=None` follows `config.remat`: "on"/"off"
        force it, "auto" remats when `n_masked` (images x EOT samples)
        exceeds `config.remat_threshold`. Remat recomputes each residual
        block of the victim in the backward instead of keeping its
        activations; `config.remat_policy` picks what a block keeps
        (`models/remat.py`)."""
        cfg = self.config
        if self.remat is not None:
            use = self.remat
        else:
            use = cfg.remat == "on" or (
                cfg.remat == "auto" and n_masked > cfg.remat_threshold)
        if not use:
            return self._fwd
        fwd, policy = self._fwd, cfg.remat_policy

        def remat_fwd(images: torch.Tensor) -> torch.Tensor:
            with remat_lib.enabled(policy):
                return fwd(images)

        return remat_fwd

    # ---------- mask sampling ----------

    def _sample_indices(self, gen, failed, step):
        """Failure-biased EOT sampling with fixed shapes: up to half the
        batch from the failure set (from `failure_sampling_start` on), the
        rest uniform from the universe, both without replacement within
        their draw (Gumbel top-k). Returns (idx [S], from_fail [S])."""
        cfg = self.config
        n_mask = failed.shape[0]
        dev = failed.device
        s = min(cfg.sampling_size, n_mask)
        half = s // 2
        uni_top = torch.topk(_gumbel(gen, n_mask, dev), s).indices
        pos = torch.arange(s, device=dev)
        if half == 0:
            return uni_top, torch.zeros((s,), dtype=torch.bool, device=dev)
        n_failed = failed.sum()
        n_from_fail = torch.where(
            step >= cfg.failure_sampling_start,
            torch.clamp(n_failed, max=half), torch.zeros_like(n_failed))
        g_fail = _gumbel(gen, n_mask, dev).masked_fill(~failed, -float("inf"))
        fail_top = torch.topk(g_fail, half).indices
        from_fail = pos < n_from_fail
        idx = torch.where(from_fail, fail_top[torch.clamp(pos, 0, half - 1)],
                          uni_top[torch.clamp(pos - n_from_fail, 0, s - 1)])
        return idx, from_fail

    # ---------- one optimization step ----------

    def _loss_and_aux(self, adv_mask, adv_pattern, x, local_var_x, rects,
                      state: TrainState, stage: int):
        cfg = self.config
        b = x.shape[0]
        s = rects.shape[0]
        delta = losses.l2_project(adv_mask, adv_pattern, x, cfg.eps)
        adv_x = x + delta
        # fused rasterize + fill (kernels A/B on the card): no [S,H,W] mask
        # tensor; gradients reach adv_x through the kept pixels
        masked = masked_fill(adv_x, rects, cfg.mask_fill)
        logits = self._grad_fwd(b * s)(
            masked.reshape((-1,) + tuple(x.shape[1:])))
        y_rep = state.y.repeat_interleave(s)
        targeted_rep = state.targeted.repeat_interleave(s)
        loss_adv = losses.cw_margin_switchable(
            logits, y_rep, self.num_classes, targeted_rep,
            cfg.confidence).reshape(b, s)
        loss_struc = losses.structural_loss(adv_x, local_var_x)
        loss = torch.mean(loss_adv, dim=1) + state.coeff_struct * loss_struc
        gl = torch.zeros(b, device=x.device)
        dens = torch.zeros(b, device=x.device)
        if stage == 0:
            dens = losses.density_loss(adv_mask, x.shape[1] // 8)
            loss = loss + state.coeff_density * dens
            gl = losses.group_lasso(adv_mask, cfg.basic_unit)
            loss = loss + state.coeff_gl * gl
        preds = torch.argmax(logits, dim=-1).reshape(b, s)
        aux = dict(loss=loss, loss_adv=loss_adv, loss_struc=loss_struc,
                   group_lasso=gl, density=dens, preds=preds, delta=delta)
        return torch.sum(loss), aux

    def _step(self, state: TrainState, x, local_var_x, universe, stage: int,
              idx=None, from_fail=None) -> TrainState:
        """One step. `idx`/`from_fail` inject the sample draw (tests)."""
        cfg = self.config
        if idx is None:
            idx, from_fail = self._sample_indices(state.gen, state.failed,
                                                  state.step)
        rects = universe[idx]
        if cfg.dual:
            idx2, _ = self._sample_indices(state.gen, state.failed, state.step)
            rects = torch.cat([rects, universe[idx2]], dim=1)

        with torch.enable_grad():
            m = state.adv_mask.detach().requires_grad_(True)
            p = state.adv_pattern.detach().requires_grad_(True)
            total, aux = self._loss_and_aux(m, p, x, local_var_x, rects,
                                            state, stage)
            g_mask, g_pattern = torch.autograd.grad(total, (m, p))
        aux = {k: v.detach() for k, v in aux.items()}

        # ---- bookkeeping, all as selects ----
        loss_adv = aux["loss_adv"]
        attack_success_bs = loss_adv < cfg.success_threshold     # [B,S]
        mask_success = attack_success_bs.all(dim=0)              # [S]

        # failure-set surgery: successes drawn from the failure set leave
        # it, failures drawn from the universe enter it
        n_mask = state.failed.shape[0]
        oob = torch.full_like(idx, n_mask)
        remove = torch.where(from_fail & mask_success, idx, oob)
        add = torch.where((~from_fail) & (~mask_success), idx, oob)
        ext = torch.cat([state.failed,
                         torch.zeros(1, dtype=torch.bool, device=idx.device)])
        ext[remove] = False
        ext[add] = True
        failed = ext[:n_mask]
        n_failed = failed.sum(dtype=torch.int32)

        attack_success = attack_success_bs.all()
        certifiable = n_failed == 0

        loss_target = aux["group_lasso"] if stage == 0 else aux["loss_struc"]
        loss_best = torch.where(n_failed < state.num_failure,
                                torch.full_like(state.loss_best, float("inf")),
                                state.loss_best)
        certify_better = n_failed <= state.num_failure
        loss_decay = certify_better & (
            (loss_target - loss_best) < -cfg.loss_decay_margin)
        any_save = loss_decay.any()
        num_failure = torch.where(any_save, n_failed, state.num_failure)
        loss_best = torch.where(loss_decay, loss_target, loss_best)
        sel = loss_decay[:, None, None, None]
        best_mask = (torch.where(sel, state.adv_mask, state.best_mask)
                     if stage == 0 else state.best_mask)
        best_pattern = torch.where(sel, state.adv_pattern, state.best_pattern)
        not_decay = torch.where(loss_decay, torch.zeros_like(state.not_decay),
                                state.not_decay + 1)

        # adaptive coefficients: stage 0 past adapt_start scales the
        # group-lasso coefficient, every other step the structural one
        grow = attack_success & certifiable
        one = torch.ones((), device=x.device)
        factor = torch.where(grow, one * cfg.scale_up, one / cfg.scale_down)
        if stage == 0:
            gl_adapts = state.step > cfg.adapt_start
        else:
            gl_adapts = torch.zeros((), dtype=torch.bool, device=x.device)
        coeff_gl = torch.where(gl_adapts, state.coeff_gl * factor,
                               state.coeff_gl)
        coeff_struct = torch.where(gl_adapts, state.coeff_struct,
                                   state.coeff_struct * factor)

        # patience lr decay
        early = not_decay > cfg.patience
        lr = torch.where(early, state.lr * cfg.lr_decay, state.lr)
        lr = torch.clamp(lr, min=cfg.lr_floor)
        not_decay = torch.where(early, torch.zeros_like(not_decay), not_decay)
        stopped = (lr < cfg.lr_stop).all()

        # signed-gradient updates (mask in stage 0 only); the stopping step
        # keeps its bookkeeping but applies no update
        lr_b = lr[:, None, None, None]
        new_pattern = torch.where(
            stopped, state.adv_pattern,
            torch.clamp(state.adv_pattern - lr_b * torch.sign(g_pattern),
                        cfg.clip_min, cfg.clip_max))
        if stage == 0:
            new_mask = torch.where(
                stopped, state.adv_mask,
                torch.clamp(state.adv_mask - lr_b * torch.sign(g_mask),
                            cfg.clip_min, cfg.clip_max))
        else:
            new_mask = state.adv_mask

        acc = (aux["preds"] == state.y[:, None]).float().mean()
        l2 = torch.sqrt(torch.sum(aux["delta"] ** 2, dim=(1, 2, 3))).mean()
        metrics = torch.stack([
            aux["loss"].mean(), loss_adv.mean(), aux["loss_struc"].mean(),
            aux["group_lasso"].mean(), aux["density"].mean(), acc, l2,
            n_failed.float()])

        new = state.replace(
            step=state.step + 1, adv_mask=new_mask, adv_pattern=new_pattern,
            best_mask=best_mask, best_pattern=best_pattern,
            loss_best=loss_best, lr=lr, not_decay=not_decay,
            num_failure=num_failure, failed=failed, coeff_gl=coeff_gl,
            coeff_struct=coeff_struct, last_preds=aux["preds"],
            stopped=state.stopped | stopped, metrics=metrics)
        # latched early stop: once stopped, the state passes through
        return new.replace(**{
            f: torch.where(state.stopped, getattr(state, f), getattr(new, f))
            for f in _FIELDS_LATCHED})

    # ---------- sweep ----------

    def sweep_failures(self, adv_mask, adv_pattern, x, y, targeted,
                       universe) -> torch.Tensor:
        """Full-universe failure sweep: a mask fails if any image's goal is
        violated under it. Returns bool `[n_mask]`."""
        return self._programs["sweep"](adv_mask, adv_pattern, x, y,
                                       targeted, universe)

    @torch.no_grad()
    def _sweep(self, adv_mask, adv_pattern, x, y, targeted,
               universe) -> torch.Tensor:
        delta = losses.l2_project(adv_mask, adv_pattern, x, self.config.eps)
        preds = masked_predictions(
            self._fwd, x + delta, universe,
            min(self.config.sampling_size, universe.shape[0]),
            self.config.mask_fill)
        hit = preds == y[:, None]
        return torch.where(targeted[:, None], ~hit, hit).any(dim=0)

    # ---------- host orchestration ----------

    def _init_state(self, gen, x, y, targeted, universe_size) -> TrainState:
        cfg = self.config
        b, h, w, _ = x.shape
        dev = x.device

        def full(v, dtype, shape=()):
            return torch.full(shape, v, dtype=dtype, device=dev)

        return TrainState(
            step=full(0, torch.int32),
            gen=gen,
            adv_mask=torch.rand((b, h, w, 1), generator=gen, device=dev),
            adv_pattern=torch.rand((b, h, w, 3), generator=gen, device=dev),
            best_mask=torch.zeros((b, h, w, 1), device=dev),
            best_pattern=torch.zeros((b, h, w, 3), device=dev),
            loss_best=full(float("inf"), torch.float32, (b,)),
            lr=full(cfg.lr, torch.float32, (b,)),
            not_decay=full(0, torch.int32, (b,)),
            num_failure=full(universe_size + 1, torch.int32),
            failed=torch.zeros((universe_size,), dtype=torch.bool, device=dev),
            coeff_gl=full(cfg.coeff_group_lasso, torch.float32),
            coeff_struct=full(cfg.structured, torch.float32),
            coeff_density=full(cfg.density, torch.float32),
            targeted=torch.as_tensor(targeted, dtype=torch.bool,
                                     device=dev).expand(b).clone(),
            y=torch.as_tensor(y, device=dev).long().clone(),
            last_preds=torch.zeros(
                (b, min(cfg.sampling_size, universe_size)),
                dtype=torch.long, device=dev),
            stopped=full(False, torch.bool),
            metrics=torch.zeros((8,), device=dev),
        )

    def _reset_schedules(self, state: TrainState,
                         universe_size: int) -> TrainState:
        """lr/best/patience reset at the targeted switch."""
        return state.replace(
            lr=torch.full_like(state.lr, self.config.lr),
            loss_best=torch.full_like(state.loss_best, float("inf")),
            not_decay=torch.zeros_like(state.not_decay),
            num_failure=torch.full_like(state.num_failure, universe_size + 1))

    @staticmethod
    def _finalize_best(state: TrainState) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images that never checkpointed fall back to their iterate."""
        never = torch.isinf(state.loss_best)[:, None, None, None]
        return (torch.where(never, state.adv_mask, state.best_mask),
                torch.where(never, state.adv_pattern, state.best_pattern))

    def _run_stage(self, stage: int, state: TrainState, x, local_var_x,
                   universe, start_iter: int = 0,
                   stage0_artifacts=None) -> TrainState:
        """Blocks of `sweep_interval` steps from `start_iter` (a resumed
        snapshot's iteration) to `max_iterations`, each after a failure
        sweep; at each boundary the carry is snapshotted (stage 1 with
        `stage0_artifacts`), then `on_block_end` is called."""
        cfg = self.config
        n_universe = universe.shape[0]
        interval, total = cfg.sweep_interval, cfg.max_iterations
        if bool(state.stopped):
            return state  # e.g. resumed from a snapshot taken at early stop
        i = start_iter
        with observe.span(f"attack.stage{stage}", start_iter=start_iter) as sp:
            while i < total:
                # full failure sweep at every sweep_interval boundary
                state = state.replace(failed=self.sweep_failures(
                    state.adv_mask, state.adv_pattern, x, state.y,
                    state.targeted, universe))
                n_steps = min(interval, total - i)
                step = self._programs[stage]
                for _ in range(n_steps):
                    state = step(state, x, local_var_x, universe, stage)
                i += n_steps
                # untargeted -> targeted switch at the boundary after
                # switch_iteration steps (stage 0)
                if (stage == 0 and i >= cfg.switch_iteration
                        and i - n_steps < cfg.switch_iteration
                        and not bool(state.targeted.all())):
                    y_new, has_target = majority_incorrect_label(
                        state.last_preds, state.y, self.num_classes)
                    switch = has_target & (~state.targeted)
                    state = state.replace(targeted=state.targeted | switch,
                                          y=torch.where(switch, y_new,
                                                        state.y))
                    state = self._reset_schedules(state, n_universe)
                # snapshot before the callback, so a crash anywhere after
                # the block's computation resumes from this block
                if self.checkpointer is not None:
                    s0 = stage0_artifacts or (None, None)
                    self.checkpointer.save(stage, i, state, s0[0], s0[1])
                # the block's one host read: the metrics and the stop flag
                host = torch.cat([state.metrics.float(),
                                  state.stopped.float()[None]]).cpu().numpy()
                stopped = bool(host[8])
                if self.on_block_end is not None:
                    self.on_block_end(stage, i, {
                        "metrics": host[:8], "stopped": stopped,
                        "n_failed": int(host[7])})
                if stopped:
                    break
            sp["end_iter"] = i
        return state

    @torch.no_grad()
    def generate(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                 targeted: bool = False, seed: int = 0, store=None,
                 batch_id: int = 0) -> AttackResult:
        """Run the two-stage attack on `x` `[B,H,W,C]` in [0,1] on its
        device. `y`: labels (targets when `targeted`), the model's own
        predictions when None. `store` shares stage-0 artifacts across patch
        budgets (`load_stage0` / `save_stage0`)."""
        cfg = self.config
        dev = x.device
        gen = utils.generator(seed, dev)
        universe = torch.as_tensor(
            masks_lib.dropout_universe(x.shape[1], cfg.dropout,
                                       cfg.dropout_sizes), device=dev)
        if y is None:
            y = torch.argmax(self.apply_fn(x), dim=-1)
        local_var_x = torch.mean(losses.local_variance(x)[0], dim=-1)
        n = universe.shape[0]
        state = self._init_state(gen, x, y, targeted, n)

        # mid-stage crash recovery: the newest carry snapshot, if any; its
        # generator state replaces the one drawn from above
        resume = None
        if self.checkpointer is not None:
            resume = self.checkpointer.restore(
                state, (state.adv_mask, state.adv_pattern))

        cached = store.load_stage0(batch_id) if store is not None else None
        if resume is not None and resume.stage == 1:
            # the snapshot is past stage 0: y, targeted and the
            # coefficients live inside the restored state
            stage0_mask, stage0_pattern = (resume.stage0_mask,
                                           resume.stage0_pattern)
        elif cached is not None:
            stage0_mask, stage0_pattern = (torch.as_tensor(a, device=dev)
                                           for a in cached)
            targeted_now = torch.as_tensor(targeted, device=dev)
            coeff_struct_carry = torch.full_like(state.coeff_struct,
                                                 cfg.structured)
        else:
            start0 = 0
            if resume is not None:
                state, start0 = resume.state, resume.iteration
            state = self._run_stage(0, state, x, local_var_x, universe,
                                    start_iter=start0)
            stage0_mask, stage0_pattern = self._finalize_best(state)
            targeted_now = state.targeted
            coeff_struct_carry = state.coeff_struct
            if store is not None:
                store.save_stage0(batch_id, stage0_mask.cpu().numpy(),
                                  stage0_pattern.cpu().numpy())

        if resume is not None and resume.stage == 1:
            # stage 1's init drew from the generator before the snapshot:
            # its draws are inside the restored generator state
            state, start1 = resume.state, resume.iteration
        else:
            start1 = 0
            delta = losses.l2_project(stage0_mask, stage0_pattern, x, cfg.eps)
            adv_x = x + delta
            targeted_vec = targeted_now.expand(x.shape[0]) | state.targeted
            preds = torch.argmax(self.apply_fn(adv_x), dim=-1)
            newly = (~targeted_vec) & (preds != state.y)
            y_cur = torch.where(newly, preds, state.y)
            targeted_vec = targeted_vec | newly
            hard_mask = patch_selection(stage0_mask, cfg.patch_budget,
                                        cfg.basic_unit)
            # the stage-0 carry's generator (a restored one after a
            # stage-0 resume)
            state = self._init_state(state.gen, x, y_cur, False, n).replace(
                adv_mask=hard_mask, adv_pattern=adv_x, best_mask=hard_mask,
                targeted=targeted_vec, coeff_struct=coeff_struct_carry)
        state = self._run_stage(1, state, x, local_var_x, universe,
                                start_iter=start1,
                                stage0_artifacts=(stage0_mask, stage0_pattern))
        best_mask, best_pattern = self._finalize_best(state)
        return AttackResult(adv_mask=best_mask, adv_pattern=best_pattern,
                            y=state.y.cpu().numpy(),
                            targeted=state.targeted.cpu().numpy(),
                            stage0_mask=stage0_mask,
                            stage0_pattern=stage0_pattern)
