"""Loss functions and the L2 projection of the DorPatch optimizer.

NHWC throughout: images `[B, H, W, C]`, patch masks `[B, H, W, 1]`. The
asymmetric gradient flow of the total-variation terms (gradients reach only
the shifted operand of each finite difference) is kept with `detach`, as
`dorpatch_tpu.losses` keeps it with `stop_gradient`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cw_margin_switchable(logits: torch.Tensor, labels: torch.Tensor,
                         num_classes: int, targeted: torch.Tensor,
                         confidence: float = 0.0) -> torch.Tensor:
    """Carlini-Wagner margin with a per-row `targeted` flag. logits `[N, C]`,
    labels `[N]`. Untargeted: hinge on `conf + logit_label - max_other`;
    targeted: `conf + max_other - logit_label`. The label's slot in the max
    over "others" is pushed to exactly -1e4. Returns `[N]`."""
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    real = torch.sum(logits * onehot, dim=-1)
    other = torch.amax((1.0 - onehot) * logits - onehot * 1e4, dim=-1)
    targeted = torch.as_tensor(targeted, device=logits.device)
    margin = torch.where(targeted, other - real, real - other)
    return torch.clamp(confidence + margin, min=0.0)


def cw_margin(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
              targeted: bool, confidence: float = 0.0) -> torch.Tensor:
    """`cw_margin_switchable` with one Python `targeted` flag."""
    return cw_margin_switchable(logits, labels, num_classes,
                                torch.tensor(bool(targeted)), confidence)


def local_variance(x: torch.Tensor):
    """Directional absolute differences with one-sided gradients. x
    `[B, H, W, C]` -> `(lv, grad_lr, grad_ud)`, each `[B, H, W, C]`:
    `grad_lr[..., w] = |sg(x[..., w]) - x[..., w+1]|` for w < W-1 and the
    last column is `sg(x[..., W-1])`; the same for rows."""
    sg = x.detach()
    diff_lr = torch.abs(sg[:, :, :-1, :] - x[:, :, 1:, :])
    grad_lr = torch.cat([diff_lr, sg[:, :, -1:, :]], dim=2)
    diff_ud = torch.abs(sg[:, :-1, :, :] - x[:, 1:, :, :])
    grad_ud = torch.cat([diff_ud, sg[:, -1:, :, :]], dim=1)
    return grad_lr + grad_ud, grad_lr, grad_ud


def min_var_weighted_variance(x: torch.Tensor) -> torch.Tensor:
    """TV weighted by the smaller directional gradient."""
    lv, grad_lr, grad_ud = local_variance(x)
    return lv * torch.where(grad_lr > grad_ud, grad_ud, grad_lr)


def structural_loss(adv_x: torch.Tensor,
                    local_var_x: torch.Tensor) -> torch.Tensor:
    """Per-image structural loss: channel-mean weighted TV of adv_x over
    the clean image's local variance (+1e-5), averaged over pixels.
    adv_x `[B,H,W,C]`, local_var_x `[B,H,W]` -> `[B]`."""
    mv = torch.mean(min_var_weighted_variance(adv_x), dim=-1)
    return torch.mean(mv / (local_var_x + 1e-5), dim=(1, 2))


def window_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping window sums (VALID): `[B, H, W, C] ->
    [B, H//w, W//w, C]`."""
    b, h, w, c = x.shape
    hh, ww = h // window, w // window
    x = x[:, :hh * window, :ww * window, :]
    return x.reshape(b, hh, window, ww, window, c).sum(dim=(2, 4))


def group_lasso(adv_mask: torch.Tensor, basic_unit: int) -> torch.Tensor:
    """`unit * sum_g sqrt(sum_cell m^2)` over basic_unit cells -> `[B]`."""
    g = window_sum(adv_mask ** 2, basic_unit)
    return basic_unit * torch.sum(torch.sqrt(g), dim=(1, 2, 3))


def density_loss(adv_mask: torch.Tensor, window: int) -> torch.Tensor:
    """Unbiased variance of the coarse-cell mask mass -> `[B]`."""
    cells = window_sum(adv_mask, window)
    return torch.var(cells.reshape(cells.shape[0], -1), dim=1, unbiased=True)


def l2_project(mask: torch.Tensor, pattern: torch.Tensor, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    """delta = mask * (pattern - x), scaled so ||delta||_2 <= eps per image,
    with the norm detached. Returns `[B,H,W,C]`."""
    delta = mask * (pattern - x)
    norm = torch.sqrt(torch.sum(delta ** 2, dim=(1, 2, 3))).detach()
    scale = torch.clamp(eps / norm, max=1.0)
    return delta * scale[:, None, None, None]
