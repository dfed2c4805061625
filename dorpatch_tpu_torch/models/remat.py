"""Rematerialization of the victims' residual blocks.

The attack's gradient forward runs under `enabled(policy)`; every victim
family runs each residual block through `block(fn, *args)`, which, while
the switch is on and autograd records, wraps the block in a non-reentrant
`torch.utils.checkpoint` region: the block's activations are not kept for
the backward but recomputed from its input when the backward reaches it.
Off (the default, and always under `torch.no_grad`), `block` is a plain
call. Remat changes what is stored, never the arithmetic: loss and
gradients are bit-equal with it on and off.

Where the boundaries lie. The JAX package wraps the whole victim forward
in one `jax.checkpoint` (`dorpatch_tpu/attack.py`, `_grad_fwd`); XLA then
schedules the recomputation. A single non-reentrant checkpoint around the
whole victim saves nothing in PyTorch: its first unpack in the backward
recomputes the region in full, and every activation is live again. So the
port places one region on each residual block (`small.BasicBlock`,
`resnetv2.PreActBottleneck`, `vit.ViTBlock`, `resmlp.ResMLPBlock`): the
backward keeps the block inputs and recomputes one block at a time. The
stems, heads and the masked fill outside the blocks keep their
activations. Both placements compute the same function.

The policies (`AttackConfig.remat_policy`), as selective checkpointing
(`torch.utils.checkpoint.create_selective_checkpoint_contexts`):

- "full": nothing inside a block is saved (`jax.checkpoint`'s default).
- "conv": the outputs of the convolutions tagged "conv_out" are saved
  (`tagged("conv_out")`, as the JAX package's `checkpoint_name` tags
  ResNetV2's `StdConv` outputs); the GroupNorm+ReLU chains between them
  are recomputed. The CIFAR ResNet-18's convolutions carry no tag, in the
  JAX package too, so "conv" saves nothing there and equals "full".
- "dots": the outputs of matrix products (`mm`, `addmm`, `bmm`,
  `baddbmm`) are saved, the analogue of `jax.checkpoint_policies.
  dots_saveable` for the ViT and ResMLP blocks; convolutions are not
  dots, so on the conv victims "dots" equals "full".

The port's kernels are `dorpatch_torch::` ops (`ops/_library.py`) inside
`torch.autograd.Function`s, which no policy names, so no policy saves
their outputs: under every policy the GroupNorm+ReLU forward kernel (D, or
E) runs again in the backward, and its saved tensors pass through
checkpoint's saved-tensor hooks like any other. The victims draw no random numbers (every sample is
drawn outside them from an explicit `torch.Generator`), so the regions do
not stash and restore the RNG state (`preserve_rng_state=False`).

The switch is per thread: a serve replica or a farm worker on another
thread never sees the attack's setting.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: the `AttackConfig.remat_policy` values
POLICIES = ("full", "conv", "dots")

_aten = torch.ops.aten
#: the matrix products "dots" saves
DOT_OPS = frozenset({_aten.mm.default, _aten.addmm.default,
                     _aten.bmm.default, _aten.baddbmm.default})

_STATE = threading.local()


def active_policy() -> Optional[str]:
    """The policy switched on in this thread, None when off."""
    return getattr(_STATE, "policy", None)


@contextlib.contextmanager
def enabled(policy: str):
    """Checkpoint every residual block run in this thread, under `policy`,
    for the duration of the block."""
    if policy not in POLICIES:
        raise ValueError(f"remat_policy={policy!r} (legal: "
                         f"{', '.join(POLICIES)})")
    prev = active_policy()
    _STATE.policy = policy
    try:
        yield
    finally:
        _STATE.policy = prev


@contextlib.contextmanager
def tagged(name: str):
    """Tag the ops run inside as `name` (`jax.ad_checkpoint.
    checkpoint_name`): the "conv" policy saves the outputs tagged
    "conv_out"."""
    prev = getattr(_STATE, "tag", None)
    _STATE.tag = name
    try:
        yield
    finally:
        _STATE.tag = prev


def _conv_policy(ctx, op, *args, **kwargs):
    if getattr(_STATE, "tag", None) == "conv_out":
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_policy(ctx, op, *args, **kwargs):
    if op in DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_CONTEXTS = {
    "conv": functools.partial(create_selective_checkpoint_contexts,
                              _conv_policy),
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy),
}


def block(fn, *args):
    """`fn(*args)`, in a checkpoint region when remat is on in this thread
    and autograd records."""
    policy = active_policy()
    if policy is None or not torch.is_grad_enabled():
        return fn(*args)
    kw = {"context_fn": _CONTEXTS[policy]} if policy in _CONTEXTS else {}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
