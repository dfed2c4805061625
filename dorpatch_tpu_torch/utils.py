"""Seeding, device selection, numerics, the bf16 victim copy and the
prediction readout.

Randomness is explicit: every stochastic component takes a
`torch.Generator` seeded from the config. `set_global_seed` covers the
host-side RNGs (python, numpy) the data and target sampling use.
"""

from __future__ import annotations

import copy
import random

import numpy as np
import torch

#: the precisions of the attack's EOT step and of the certify sweep
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def compute_dtype(name: str, what: str = "compute_dtype") -> torch.dtype:
    """The torch dtype of a `compute_dtype` config value; anything but
    "float32" or "bfloat16" raises."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"{what}={name!r} (legal: "
                         f"{', '.join(COMPUTE_DTYPES)})")
    return COMPUTE_DTYPES[name]


def cast_module(module: torch.nn.Module,
                dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """A copy of `module` with its floating parameters and buffers cast to
    `dtype` and integer buffers as they are. The caller makes it once and
    keeps it (`registry.VictimForward.at`, the engines' `at`); the original
    keeps its own weights: the f32 oracle's."""
    out = copy.deepcopy(module)
    for t in list(out.parameters()) + list(out.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return out


def forward_at(apply_fn, dtype: torch.dtype):
    """`apply_fn`'s forward at `dtype`: itself at float32;
    `apply_fn.at(dtype)` where it has one (a victim's forward on its
    once-cast copy, `models.registry.VictimForward`); else, for a function
    without weights, `apply_fn` on the images cast to `dtype`. Either way
    the logits come back in float32."""
    if dtype == torch.float32:
        return apply_fn
    if hasattr(apply_fn, "at"):
        return apply_fn.at(dtype)

    def fwd(images: torch.Tensor) -> torch.Tensor:
        return apply_fn(images.to(dtype)).float()

    return fwd


def preds_margins(logits: torch.Tensor):
    """(argmax predictions int32, top-1 minus top-2 logit gap float32) over
    the last axis."""
    top2 = torch.topk(logits, 2, dim=-1).values.float()
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            top2[..., 0] - top2[..., 1])
