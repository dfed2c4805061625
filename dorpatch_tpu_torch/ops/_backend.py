"""The one dispatch rule of every kernel wrapper, and the launch counts.

- A CUDA tensor launches the hand-written kernel, or raises (a kernel that
  does not build or launch fails the call).
- A CPU tensor takes the plain PyTorch version.

There is no fallback from the kernel to the plain version and no "auto"
that picks the plain version on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

#: Launches of each kernel since the last `reset_launch_counts`; a wrapper
#: adds one exactly where it launches its kernel. A kernel's bf16 form
#: counts under its own name ("..._bf16").
_LAUNCHES: Dict[str, int] = {"masked_fill_fwd": 0, "masked_fill_bwd": 0,
                             "stem_fold": 0, "gn_relu_fwd": 0,
                             "gn_relu_bwd": 0, "masked_kv_attn": 0,
                             "masked_fill_fwd_bf16": 0, "stem_fold_bf16": 0,
                             "gn_relu_fwd_bf16": 0, "gn_relu_bwd_bf16": 0,
                             "masked_kv_attn_bf16": 0}
#: Of those launches, how many took each route, for kernels with more than
#: one ("gn_relu_fwd/one_pass", "gn_relu_bwd/split", ...), or each shape
#: class (kernel H by its dirty rows per entry: "masked_kv_attn_bf16/S99").
_ROUTES: Dict[str, int] = {}


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def count_launch(name: str, route: Optional[str] = None) -> None:
    _LAUNCHES[name] += 1
    if route is not None:
        key = f"{name}/{route}"
        _ROUTES[key] = _ROUTES.get(key, 0) + 1


def launch_counts() -> Dict[str, int]:
    """A copy of the per-kernel launch counts."""
    return dict(_LAUNCHES)


def route_counts() -> Dict[str, int]:
    """A copy of the per-route and per-shape-class launch counts
    ("kernel/route" -> launches)."""
    return dict(_ROUTES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    _ROUTES.clear()


def require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """A kernel argument check: a contiguous CUDA tensor of the given type
    (or one of a tuple of types) and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
