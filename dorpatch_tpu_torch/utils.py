"""Seeding, device selection, float32 numerics and the prediction readout.

Randomness is explicit: every stochastic component takes a
`torch.Generator` seeded from the config. `set_global_seed` covers the
host-side RNGs (python, numpy) the data and target sampling use.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_global_seed(seed: int = 1234) -> None:
    """Seed the host RNGs (python, numpy legacy, torch's default)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A `torch.Generator` on `device`, seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: "cuda" (the default) or "cpu" on
    request. A CUDA request without a visible GPU raises: nothing carries on
    quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def configure_numerics() -> None:
    """Full float32 on the card, repeatable bit for bit.

    - cuDNN convolutions default to TF32 (about three decimal digits),
      which would loosen every parity with the JAX package's f32 numerics;
      matmuls default to full f32 but are pinned too.
    - cuDNN may pick a convolution algorithm that sums in an order that
      changes from run to run (the data gradient of the attack's
      backward): the patch then drifts apart between two runs from one
      seed, and the certification's forward count with it. Deterministic
      algorithms only, and no benchmark mode, which may time its way to a
      different (deterministic) algorithm in each run; the JAX package's
      resume contract is a patch bit-identical to an uninterrupted run.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def preds_margins(logits: torch.Tensor):
    """(argmax predictions int32, top-1 minus top-2 logit gap float32) over
    the last axis."""
    top2 = torch.topk(logits, 2, dim=-1).values.float()
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            top2[..., 0] - top2[..., 1])
