"""Runtime sanitizers: what static rules cannot prove, checked live.

Port of `dorpatch_tpu.analysis.sanitize`, behind the pipeline's
`--sanitize` flag (`ExperimentConfig.sanitize`):

- **NaN at the source.** `jax_debug_nans` checks a jitted program's
  outputs and, on a NaN, replays the program op by op and raises
  `FloatingPointError` at the primitive that made it. The port's programs
  are the `observe.timed_first_call` wrappers: the attack's step
  ("attack.step.stage0/1") and failure sweep ("attack.sweep") and the
  certification's programs (phase 1, pair audits, rows, each per chunk).
  After each call `NanGuard` checks the outputs for NaN (NaN only: the
  attack's carry holds `inf` by design, `loss_best`); on a hit it replays
  the call from the same inputs, with every generator among them rewound
  (so the step draws the same sample), under `NanOpMode`, a
  `TorchDispatchMode` that checks every op's floating outputs, and raises
  `FloatingPointError` at the first op that produced a NaN. The port's
  CUDA kernels run outside the dispatcher, so while the sanitizer is armed
  each kernel wrapper checks its own outputs and names itself
  (`ops._backend.sanitized`); a NaN made inside kernel A-H is blamed on
  the kernel, not on the next aten op.
- **Compile events.** The port has no JIT. Its compile-like events are the
  kernels' build (`ops/_build.py`, a `compile` record "kernels.build")
  and each new input signature of a program (a `compile` record under
  the program's name; the first call of a program is recorded anyway).
  `python -m dorpatch_tpu_torch.observe.report` lists them under
  "compile".
- **Recompile budgets.** `observe.RecompileWatchdog` is armed as the
  recompile guard: a program that sees more input signatures than its
  declared budget raises `RecompileBudgetExceeded` (the pipeline declares
  the JAX package's budgets: the batch size for the attack's programs,
  the image buckets for certification's). Each budget is written as a
  `sanitize.budget` event the first time its program runs.
- **Lock sanitizer.** `lockwatch.LockWatch` is armed process-wide, with no
  static seed (the port has no static concurrency tier yet).

Usage:

    with Sanitizer():          # or: python -m dorpatch_tpu_torch --sanitize
        run_experiment(cfg)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.analysis import lockwatch as _lockwatch
from dorpatch_tpu_torch.observe import events as _events
from dorpatch_tpu_torch.observe.events import (  # noqa: F401
    RecompileBudgetExceeded, RecompileWatchdog)
from dorpatch_tpu_torch.ops import _backend

#: ops whose outputs are uninitialized memory, never a computed NaN
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


class NanOpMode(TorchDispatchMode):
    """Checks every op's floating outputs; raises `FloatingPointError` at
    the first op whose output holds a NaN (the ops inside a sanitized
    kernel wrapper excepted: the wrapper checks itself)."""

    def __init__(self, program: str = ""):
        super().__init__()
        self.program = program

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (_backend.in_opaque()
                or func.overloadpacket.__name__ in _UNINITIALIZED):
            return out
        bad = _backend.nan_tensors(out)
        if bad:
            inputs = ("a NaN input" if _backend.nan_tensors((args, kwargs))
                      else "no NaN in its inputs")
            raise FloatingPointError(
                f"NaN produced by {func} (output {tuple(bad[0].shape)} on "
                f"{bad[0].device}, {inputs})"
                + (f" in program {self.program!r}" if self.program else ""))
        return out


class NanGuard:
    """The NaN check of the `timed_first_call` programs (installed with
    `observe.set_nan_guard`)."""

    def after_call(self, name: str, out, replay) -> None:
        if not _backend.nan_tensors(out):
            return
        observe.record_event("sanitize.nan", entry=name)
        # called right after the program, so under its grad mode
        with NanOpMode(name):
            replay()
        raise FloatingPointError(
            f"program {name!r} returned a NaN, but its op-by-op replay "
            "produced none (a nondeterministic op?)")


class Sanitizer:
    """Context manager arming the runtime sanitizers; restores every global
    it touched (the NaN guard, the kernel wrappers' checks, the compile
    log, the recompile guard, the lock watch) on exit, so tests and nested
    runs never leak sanitizer state."""

    def __init__(self, debug_nans: bool = True, log_compiles: bool = True,
                 recompile_budgets: bool = True, lock_order: bool = True,
                 lock_hold_budget_s: Optional[float] = None):
        self.debug_nans = debug_nans
        self.log_compiles = log_compiles
        self.recompile_budgets = recompile_budgets
        self.watchdog = (RecompileWatchdog(record_budgets=True)
                         if recompile_budgets else None)
        self.lock_watch = None
        if lock_order or lock_hold_budget_s is not None:
            self.lock_watch = _lockwatch.LockWatch(
                hold_budget_s=lock_hold_budget_s, static_graph=None)
        self._prev = None

    def __enter__(self) -> "Sanitizer":
        prev = {}
        if self.debug_nans:
            prev["nan_guard"] = _events.nan_guard()
            _events.set_nan_guard(NanGuard())
            prev["kernels"] = _backend.set_sanitize(True)
        if self.log_compiles:
            prev["compile_log"] = _events.set_compile_log(True)
        if self.watchdog is not None:
            prev["guard"] = _events.recompile_guard()
            _events.set_recompile_guard(self.watchdog)
        if self.lock_watch is not None:
            prev["watch"] = _lockwatch.set_active_watch(self.lock_watch)
        self._prev = prev
        observe.record_event(
            "sanitize.enabled", debug_nans=self.debug_nans,
            log_compiles=self.log_compiles,
            recompile_budgets=self.recompile_budgets,
            lock_order=self.lock_watch is not None)
        return self

    def __exit__(self, *exc) -> None:
        prev, self._prev = self._prev or {}, None
        if "watch" in prev:
            _lockwatch.set_active_watch(prev["watch"])
        if "guard" in prev:
            _events.set_recompile_guard(prev["guard"])
        if "compile_log" in prev:
            _events.set_compile_log(prev["compile_log"])
        if "nan_guard" in prev:
            _backend.set_sanitize(prev["kernels"])
            _events.set_nan_guard(prev["nan_guard"])
