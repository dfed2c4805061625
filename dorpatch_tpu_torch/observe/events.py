"""Span/event log: nested spans, first-call timings, device-memory samples.

Port of `dorpatch_tpu.observe.events`: the same `events.jsonl` records,
field for field. One `events.jsonl` per process under the results dir
(`events_filename`).
Every record carries a wall timestamp, the process index, the per-attempt
`run_id`, and a monotonically increasing `seq` — so records from a resumed
run group by attempt and a post-mortem reader can totally order one
process's telemetry even when wall clocks step.

Record kinds:

- `begin` / `span`  — a `begin` is written when a span opens, the matching
  `span` (with `dur_s` and any attributes) when it closes. A `begin` with
  no closing `span` is the signature of a hang: the last open path IS the
  phase the process died in (see `heartbeat.Watchdog`).
- `block`           — one attack block finished: stage, cumulative step, wall duration since the previous
  telemetry mark, and a `device.memory_stats()` sample when the backend
  provides one.
- `compile`         — first call of a program (`timed_first_call` wraps the
  serving and defense programs): on the card that call builds the kernel
  library, picks cuDNN's algorithms and sizes the allocator's blocks, so
  its wall time is the eager program's compile cost.
- `event`           — free-form point event.

The module-level `span()` / `record_event()` / `record_compile()` helpers
delegate to the process's ACTIVE EventLog and no-op when none is installed,
so the defense and serving layers can emit telemetry without holding a
reference to the sink the caller configured. A thread may install a sink
of its own ahead of the process's (`active_in_thread`): the farm worker
does, so that workers on threads of one process each record into their
own job's log.

The zero-recompile contract, eagerly: an eager program never retraces, so
each `timed_first_call` wrapper keeps the distinct input signatures (the
shapes, dtypes and devices of its tensor arguments, the values of the
others) it has seen; `_cache_size()` counts them, as a jit's does its
traces. An armed guard (`set_recompile_guard(RecompileWatchdog())`) raises
`RecompileBudgetExceeded` when a program sees more signatures than its
budget: on the card cuDNN picks its algorithms and the caching allocator
sizes its blocks per shape, so live traffic must run only warmed shapes.

Under `--sanitize` (`analysis/sanitize.py`) two more hooks are armed: a
NaN guard (`set_nan_guard`), which every `timed_first_call` program calls
after each call with its outputs and a replay of the call (the generators
among its arguments rewound to their states before it), and the compile
log (`set_compile_log`), which records every call that brings a program a
new input signature as a `compile` record, as the JAX package's
`jax_log_compiles` logs every trace.

Spans are main-thread only (the stack is per-process, not per-thread); the
heartbeat thread only *reads* `current_path()` under the lock.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import threading
import time
from typing import IO, List, Optional


def events_filename(process_index: int = 0) -> str:
    """Per-process event-log name; process 0 keeps the bare `events.jsonl`."""
    return ("events.jsonl" if process_index == 0
            else f"events_{process_index}.jsonl")


def device_memory_stats() -> Optional[List[dict]]:
    """Per-device CUDA allocator sample, or None when unavailable.

    Reads torch from `sys.modules` instead of importing it, and only once
    CUDA is initialized: a host-only consumer must never initialize the
    card as a side effect of telemetry."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        out = []
        for d in range(torch.cuda.device_count()):
            out.append({
                "device": d,
                "bytes_in_use": int(torch.cuda.memory_allocated(d)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(d).total_memory)})
    except Exception:
        return None
    return out or None


class EventLog:
    """Append-mode JSONL event sink with a nested-span stack.

    An unwritable results dir degrades to a no-file sink that still tracks
    the span stack (the heartbeat's phase and the watchdog's activity clock
    keep working; only persistence is lost) — same contract as the
    pipeline's best-effort `summary.json` write."""

    def __init__(self, path: Optional[str], run_id: str = "",
                 process_index: int = 0, clock=time.time,
                 perf=time.perf_counter):
        self.path = path
        self.run_id = run_id
        self.process_index = process_index
        self._clock = clock
        self._perf = perf
        self._lock = threading.RLock()
        self._seq = 0
        self._stack = []  # [(name, perf_t0)]
        self._last_mark = perf()
        self._last_activity = perf()
        self._fh: Optional[IO[str]] = None
        self._active_cms: List = []  # install-and-restore stack (__enter__)
        if path:
            try:
                os.makedirs(os.path.dirname(os.path.abspath(path)),
                            exist_ok=True)
                self._fh = open(path, "a", buffering=1)
            except OSError:
                self._fh = None

    # ---------------- record plumbing ----------------

    def _write(self, kind: str, name: Optional[str] = None, **fields) -> dict:
        with self._lock:
            rec = {"ts": round(self._clock(), 3), "seq": self._seq,
                   "proc": self.process_index, "run_id": self.run_id,
                   "kind": kind}
            if name is not None:
                rec["name"] = name
            rec.update(fields)
            self._seq += 1
            self._last_activity = self._perf()
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec, default=float) + "\n")
                except OSError:
                    # disk full / quota mid-run: telemetry must never take
                    # down the computation it observes — drop to the
                    # tracking-only sink (same contract as a failed open)
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
            return rec

    def seconds_since_activity(self) -> float:
        """Seconds since the main thread last wrote any record — the
        watchdog's liveness signal. Heartbeat beats deliberately do NOT
        count: they prove the process is alive, not that it progresses."""
        with self._lock:
            return self._perf() - self._last_activity

    def current_path(self) -> str:
        """`run/batch/attack.stage1`-style phase path (heartbeat payload)."""
        with self._lock:
            return "/".join(n for n, _ in self._stack) or "idle"

    # ---------------- span / event API ----------------

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Nested span; yields a mutable attrs dict — entries added inside
        the scope (e.g. the batch size discovered mid-span) land on the
        closing `span` record."""
        with self._lock:
            t0 = self._perf()
            self._stack.append((name, t0))
            depth = len(self._stack) - 1
            path = "/".join(n for n, _ in self._stack)
            self._last_mark = t0
        self._write("begin", name, path=path, depth=depth)
        out_attrs = dict(attrs)
        try:
            yield out_attrs
        finally:
            t1 = self._perf()
            with self._lock:
                self._stack.pop()
                self._last_mark = t1
            self._write("span", name, path=path, depth=depth,
                        dur_s=round(t1 - t0, 6), **out_attrs)

    def event(self, name: str, **attrs) -> None:
        self._write("event", name, **attrs)

    def compile(self, name: str, seconds: float) -> None:
        self._write("compile", name, dur_s=round(seconds, 6))

    def block_boundary(self, stage: int, step: int,
                       info: Optional[dict] = None) -> None:
        """One attack block finished: duration since the previous telemetry
        mark (span edge or block) plus a device-memory sample."""
        with self._lock:
            now = self._perf()
            dur = now - self._last_mark
            self._last_mark = now
        fields = {"stage": int(stage), "step": int(step),
                  "dur_s": round(dur, 6)}
        if info is not None:
            fields["stopped"] = bool(info.get("stopped", False))
        mem = device_memory_stats()
        if mem:
            fields["mem"] = mem
        self._write("block", None, **fields)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        # entering the log installs it as the process's active sink (and
        # exiting restores the previous one), so a bare
        # `with EventLog(path) as el:` wires up the module-level
        # span()/record_event() helpers. Historically __enter__ only
        # returned self — telemetry silently went nowhere unless the caller
        # also remembered `with observe.active(el):`, which remains legal
        # but redundant.
        cm = active(self)
        cm.__enter__()
        self._active_cms.append(cm)
        return self

    def __exit__(self, *exc):
        if self._active_cms:
            self._active_cms.pop().__exit__(None, None, None)
        self.close()


# ---------------- process-wide active log ----------------

_ACTIVE: Optional[EventLog] = None
_LOCAL = threading.local()


def active_event_log() -> Optional[EventLog]:
    """The calling thread's sink (`active_in_thread`), else the process's."""
    el = getattr(_LOCAL, "elog", None)
    return el if el is not None else _ACTIVE


@contextlib.contextmanager
def active(elog: Optional[EventLog]):
    """Install `elog` as the process's active sink for the scope (None is a
    legal no-op, so callers don't need to branch on telemetry being off)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = elog
    try:
        yield elog
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def active_in_thread(elog: Optional[EventLog]):
    """Install `elog` as the calling thread's sink for the scope, ahead of
    the process's. Unlike `active`, it installs and restores nothing that
    another thread sees, so scopes on concurrent threads need not nest."""
    prev = getattr(_LOCAL, "elog", None)
    _LOCAL.elog = elog
    try:
        yield elog
    finally:
        _LOCAL.elog = prev


@contextlib.contextmanager
def span(name: str, **attrs):
    """Span against the active EventLog; no-op when telemetry is off.

    Always yields a dict callers may add attributes to — a throwaway one
    when no log is active, so call sites never branch on telemetry."""
    el = active_event_log()
    if el is None:
        yield dict(attrs)
        return
    with el.span(name, **attrs) as out_attrs:
        yield out_attrs


def record_event(name: str, **attrs) -> None:
    el = active_event_log()
    if el is not None:
        el.event(name, **attrs)


def record_compile(name: str, seconds: float) -> None:
    el = active_event_log()
    if el is not None:
        el.compile(name, seconds)


# ---------------- recompile guard hook ----------------

# An object with `after_call(name, wrapped, budget)` inspected after EVERY
# call through a _FirstCallTimer (the serving layer arms a
# `RecompileWatchdog`); None means no enforcement.
_RECOMPILE_GUARD = None


def set_recompile_guard(guard) -> None:
    global _RECOMPILE_GUARD
    _RECOMPILE_GUARD = guard


def recompile_guard():
    return _RECOMPILE_GUARD


# A NaN guard (`analysis.sanitize.NanGuard`): `after_call(name, out,
# replay)` after every call through a _FirstCallTimer; None: no check.
_NAN_GUARD = None
# True: every call that brings a program a new input signature is recorded
# as a `compile` record (the first call always is).
_COMPILE_LOG = False


def set_nan_guard(guard) -> None:
    global _NAN_GUARD
    _NAN_GUARD = guard


def nan_guard():
    return _NAN_GUARD


def set_compile_log(on: bool) -> bool:
    """Switch the compile log; returns the previous setting."""
    global _COMPILE_LOG
    prev, _COMPILE_LOG = _COMPILE_LOG, bool(on)
    return prev


def log_compile(name: str, seconds: float) -> None:
    """A compile-like event outside the programs (the kernels' build),
    recorded as a `compile` record while the compile log is on."""
    if _COMPILE_LOG:
        record_compile(name, seconds)


class RecompileBudgetExceeded(RuntimeError):
    """A program saw more input signatures than its declared budget."""


class RecompileWatchdog:
    """Per-program signature accounting against declared budgets (the JAX
    package's `analysis.sanitize.RecompileWatchdog`, the same events).
    `_cache_size()` of a `timed_first_call` wrapper is the number of
    distinct input signatures it has run; programs without it are
    skipped. `record_budgets` (the sanitizer's) also writes one
    `sanitize.budget` event the first time a program with a declared
    budget runs."""

    def __init__(self, record_budgets: bool = False):
        self._last_seen = {}
        self._record_budgets = record_budgets

    def after_call(self, name: str, wrapped, budget: Optional[int]) -> None:
        try:
            traces = int(wrapped._cache_size())
        except (AttributeError, TypeError):
            return
        prev = self._last_seen.get(name, 0)
        if self._record_budgets and prev == 0 and budget is not None:
            record_event("sanitize.budget", entry=name, budget=budget)
        if traces > prev:
            self._last_seen[name] = traces
            if prev >= 1:
                # growth past the first signature is a new shape: always
                # recorded, only fatal past the budget
                record_event("sanitize.retrace", entry=name, traces=traces,
                             budget=-1 if budget is None else budget)
        if budget is not None and traces > budget:
            record_event("sanitize.recompile_budget_exceeded", entry=name,
                         traces=traces, budget=budget)
            raise RecompileBudgetExceeded(
                f"program {name!r} ran {traces} input signatures, over its "
                f"declared budget of {budget} (shape-unstable call pattern? "
                "every distinct input shape/dtype picks its own cuDNN "
                "algorithms and allocator blocks)")


def _generators(value) -> list:
    """The `torch.Generator`s among a program's arguments: at top level,
    in tuples and lists, and in dataclass fields (the attack's carry)."""
    if type(value).__name__ == "Generator" and hasattr(value, "get_state"):
        return [value]
    if isinstance(value, (tuple, list)):
        return [g for v in value for g in _generators(v)]
    fields = getattr(value, "__dataclass_fields__", None)
    if fields:
        return [g for f in fields for g in _generators(getattr(value, f))]
    return []


def _signature(value):
    """A hashable input signature: (shape, dtype, device) for tensors and
    arrays, recursively for tuples and lists, the value for scalars."""
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        return (tuple(int(d) for d in value.shape), str(value.dtype),
                str(getattr(value, "device", "")))
    if isinstance(value, (tuple, list)):
        return tuple(_signature(v) for v in value)
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return type(value).__name__


class _FirstCallTimer:
    """Callable proxy recording the wrapped fn's first-call wall time as a
    `compile` event and every call's input signature. Unknown attributes
    delegate to the wrapped callable."""

    def __init__(self, fn, name: str, clock, recompile_budget=None):
        self.__wrapped__ = fn
        self._name = name
        self._clock = clock
        self._done = False
        self._lock = threading.Lock()
        self._signatures = set()
        self.recompile_budget = recompile_budget
        functools.update_wrapper(self, fn, updated=())

    def _cache_size(self) -> int:
        """Distinct input signatures run so far (a jit's trace count)."""
        with self._lock:
            return len(self._signatures)

    def __call__(self, *args, **kwargs):
        sig = (_signature(args), _signature(sorted(kwargs.items())))
        with self._lock:
            first, self._done = not self._done, True
            new = sig not in self._signatures
            self._signatures.add(sig)
        nan = _NAN_GUARD
        rewind = ([(g, g.get_state()) for g in _generators(args)]
                  if nan is not None else None)
        if first or (new and _COMPILE_LOG):
            t0 = self._clock()
            out = self.__wrapped__(*args, **kwargs)
            record_compile(self._name, self._clock() - t0)
        else:
            out = self.__wrapped__(*args, **kwargs)
        guard = _RECOMPILE_GUARD
        if guard is not None:
            guard.after_call(self._name, self, self.recompile_budget)
        if nan is not None:
            def replay():
                for g, state in rewind:
                    g.set_state(state)
                return self.__wrapped__(*args, **kwargs)

            nan.after_call(self._name, out, replay)
        return out

    def __getattr__(self, item):
        return getattr(self.__wrapped__, item)


def timed_first_call(fn, name: str, clock=time.perf_counter,
                     recompile_budget=None):
    """Wrap a program so its FIRST invocation's wall time is recorded as a
    `compile` event (on the card that call builds kernels, picks cuDNN's
    algorithms and sizes the allocator's blocks). Later calls pass through
    untimed. Recording goes to whatever EventLog is active at first-call
    time — none active, nothing recorded.

    `recompile_budget` declares how many input signatures (shape/dtype
    buckets) this program is allowed. It is inert until a recompile guard
    is installed (`set_recompile_guard`), which then checks the
    signature count after every call and raises on excess."""
    return _FirstCallTimer(fn, name, clock, recompile_budget)
