"""The one dispatch rule of every kernel wrapper, and the launch counts.

- A CUDA tensor launches the hand-written kernel, or raises (a kernel that
  does not build or launch fails the call).
- A CPU tensor takes the plain PyTorch version.

There is no fallback from the kernel to the plain version and no "auto"
that picks the plain version on the card.

The launch counts are shared by every thread (the serve pool's replicas
launch from their own threads), so every read and write holds one lock.

Each kernel entry is a `torch.library` op (`ops/_library.py`): its CUDA
kernel launches, its CPU kernel is the plain version. Under an armed
sanitizer (`analysis/sanitize.py`, `set_sanitize`) every wrapper decorated
with `sanitized(name)` checks its own floating outputs for NaN and raises
`FloatingPointError` naming itself, on the card and on the CPU alike; the
sanitizer's op-by-op check sees each kernel as the one op it is.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Optional

import torch

#: Launches of each kernel since the last `reset_launch_counts`; a wrapper
#: adds one exactly where it launches its kernel, and a CUDA graph's replay
#: one for each kernel launch its capture recorded. A kernel's bf16 form
#: counts under its own name ("..._bf16"), and its sharded form on a mesh
#: (`parallel/`) under its own too ("..._mesh"; kernel B's float64 form).
_LAUNCHES: Dict[str, int] = {
    "masked_fill_fwd": 0, "masked_fill_bwd": 0, "stem_fold": 0,
    "gn_relu_fwd": 0, "gn_relu_bwd": 0, "masked_kv_attn": 0,
    "masked_fill_fwd_bf16": 0, "stem_fold_bf16": 0, "gn_relu_fwd_bf16": 0,
    "gn_relu_bwd_bf16": 0, "masked_kv_attn_bf16": 0,
    "masked_fill_fwd_mesh": 0, "masked_fill_bwd_mesh": 0,
    "masked_fill_fwd_bf16_mesh": 0, "stem_fold_mesh": 0,
    "stem_fold_bf16_mesh": 0, "masked_kv_attn_mesh": 0,
    "masked_kv_attn_bf16_mesh": 0}
#: Of those launches, how many took each route, for kernels with more than
#: one ("gn_relu_fwd/one_pass", "gn_relu_bwd/split", ...), or each shape
#: class (kernel H by its dirty rows per entry: "masked_kv_attn_bf16/S99").
_ROUTES: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def require_card(t: torch.Tensor, name: str) -> None:
    """Refuse a tensor that is not on the card: a kernel entry has no
    plain path."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


#: per thread: the launches a CUDA graph capture on it records (`capturing`)
_CAPTURE = threading.local()


@contextlib.contextmanager
def capturing():
    """While this thread captures a CUDA graph (`aot/boot.py`), its kernel
    calls are recorded into the graph, not run: they are collected into
    the list the scope yields instead of counted. Each replay of the graph
    launches them, and counts them (`count_replay`)."""
    prev = getattr(_CAPTURE, "log", None)
    log: list = []
    _CAPTURE.log = log
    try:
        yield log
    finally:
        _CAPTURE.log = prev


def count_launch(name: str, route: Optional[str] = None) -> None:
    log = getattr(_CAPTURE, "log", None)
    if log is not None:
        log.append((name, route))
        return
    count_replay(((name, route),))


def count_replay(launches) -> None:
    """Count `(name, route)` launches: a wrapper's launch, or each kernel
    launch a CUDA graph's replay makes (the ones its capture recorded)."""
    with _COUNTS_LOCK:
        for name, route in launches:
            _LAUNCHES[name] += 1
            if route is not None:
                key = f"{name}/{route}"
                _ROUTES[key] = _ROUTES.get(key, 0) + 1


def launch_counts() -> Dict[str, int]:
    """A copy of the per-kernel launch counts."""
    with _COUNTS_LOCK:
        return dict(_LAUNCHES)


def route_counts() -> Dict[str, int]:
    """A copy of the per-route and per-shape-class launch counts
    ("kernel/route" -> launches)."""
    with _COUNTS_LOCK:
        return dict(_ROUTES)


def reset_launch_counts() -> None:
    with _COUNTS_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
        _ROUTES.clear()


_SANITIZE = False


def set_sanitize(on: bool) -> bool:
    """Arm (or disarm) the wrappers' NaN checks; returns the previous
    setting."""
    global _SANITIZE
    prev, _SANITIZE = _SANITIZE, bool(on)
    return prev


def tensors_in(value) -> list:
    """The tensors in `value`: itself, or in its tuples, lists, dicts and
    dataclass fields (the attack's carry), recursively."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    elif hasattr(value, "__dataclass_fields__"):
        value = [getattr(value, f) for f in value.__dataclass_fields__]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in tensors_in(v)]
    return []


def nan_tensors(value) -> list:
    """The floating tensors in `value` that hold a NaN."""
    return [t for t in tensors_in(value)
            if t.is_floating_point() and t.numel()
            and bool(torch.isnan(t).any())]


def sanitized(name: str):
    """Decorate a kernel wrapper: armed, it raises `FloatingPointError`
    naming kernel `name` when its output holds a NaN that its inputs did
    not (on the CPU: naming the kernel's plain version). A NaN that
    reached it from elsewhere passes on, for the replay of its program to
    find where it was made."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _SANITIZE:
                return fn(*args, **kwargs)
            clean = not nan_tensors((args, kwargs))
            out = fn(*args, **kwargs)
            bad = nan_tensors(out) if clean else []
            if bad:
                first = bad[0]
                where = ("kernel" if first.device.type == "cuda"
                         else "the plain version of kernel")
                raise FloatingPointError(
                    f"NaN produced by {where} {name} ({fn.__qualname__}, "
                    f"output {tuple(first.shape)} on {first.device})")
            return out
        return wrapper
    return deco


def require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """A kernel argument check: a contiguous CUDA tensor of the given type
    (or one of a tuple of types) and rank."""
    require_card(t, name)
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
