"""Runtime lock sanitizer: acquisition-order + hold-budget watchdog.

The static concurrency tier (the JAX package's `analysis/concurrency.py`,
DP500-DP504) can only see lock nestings that are syntactically visible in one file. This is
its runtime wing: an instrumenting wrapper around `threading.Lock` /
`threading.RLock` that records, per thread, the *actual* acquisition order
and held durations, and cross-checks them against the static DP501 graph.

- **Order violations** — before acquiring lock `b` while holding `a`, the
  watch asks whether the combined graph (every order observed at runtime
  so far, union the static nested-`with` graph) already contains a path
  `b ⇝ a`. If it does, this acquisition closes an ABBA cycle: some other
  code path takes the same pair in the opposite order, and the two paths
  can deadlock each other under the right interleaving. The watch emits a
  `sanitize.lock_order` event and raises `LockOrderViolation` — crucially
  *before* touching the underlying lock, so nothing is left stranded in
  the acquired state when the `with` body never runs.
- **Hold budgets** — with `hold_budget_s` set, releasing a lock that was
  held longer than the budget emits `sanitize.lock_held` and raises
  `LockHoldBudgetExceeded` — *after* the real release, so the violation
  report never itself wedges the fleet. Same contract as the recompile
  watchdog in `sanitize.py`: the event is written first, so post-mortem
  telemetry has the record even if the raise is swallowed.

Armed process-wide by `Sanitizer(lock_order=True)` (`--sanitize`), which
installs the watch via `set_active_watch`. Production code opts in at
lock-construction time with the `watched_lock` factory, which degrades to
a bare `threading.Lock` when no watch is armed — zero overhead in normal
serving.

Like the static tier, this is a *sanitizer*, not a verifier: it only sees
orders that actually execute. Its value is catching the inversion the
static tier cannot see (cross-file, cross-callable) the first time it
runs, not proving absence.

Port of `dorpatch_tpu.analysis.lockwatch`, the same classes, checks,
events and messages. The port has no static concurrency tier yet (it
comes with the `analysis/` wings), so its `Sanitizer` arms the watch with
no static seed: only orders seen at runtime are checked.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Set, Tuple


class LockOrderViolation(RuntimeError):
    """Acquiring this lock here closes an ABBA cycle with an order seen
    elsewhere (at runtime or in the static DP501 graph)."""


class LockHoldBudgetExceeded(RuntimeError):
    """A watched lock was held longer than the sanitizer's hold budget."""


def _has_path(graph: Dict[str, Set[str]], src: str, dst: str) -> bool:
    """True when `dst` is reachable from `src` (iterative DFS)."""
    if src == dst:
        return True
    seen = {src}
    stack = [src]
    while stack:
        node = stack.pop()
        for nxt in graph.get(node, ()):
            if nxt == dst:
                return True
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


class WatchedLock:
    """One instrumented lock: context manager with the same acquire/release
    surface as the underlying `threading.Lock`/`RLock` it wraps."""

    def __init__(self, watch: "LockWatch", raw, name: str):
        self._watch = watch
        self._raw = raw
        self.name = name

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        # order check BEFORE the raw acquire: raising afterwards would
        # strand the lock (the `with` body — and release — never runs)
        self._watch._pre_acquire(self.name)
        got = self._raw.acquire(blocking, timeout)
        if got:
            self._watch._post_acquire(self.name)
        return got

    def release(self) -> None:
        held_s = self._watch._pre_release(self.name)
        self._raw.release()
        # budget check AFTER the raw release: the violation report must
        # never itself leave the fleet wedged on this lock
        self._watch._post_release(self.name, held_s)

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._raw.locked()


class LockWatch:
    """Process-wide acquisition recorder + checker (see module docstring).

    `static_graph` seeds the order relation with the analyzer's DP501
    nested-`with` edges, so a runtime acquisition that inverts an order
    the *source* commits to is caught on its first execution, before the
    opposite runtime path has ever run.
    """

    def __init__(self, hold_budget_s: Optional[float] = None,
                 static_graph: Optional[
                     Dict[str, Iterable[Tuple[str, object]]]] = None,
                 clock=time.monotonic):
        self.hold_budget_s = hold_budget_s
        self._clock = clock
        self._meta_lock = threading.Lock()
        # name -> set of names acquired while it was held
        self._observed: Dict[str, Set[str]] = {}  # guarded-by: self._meta_lock
        self._static: Dict[str, Set[str]] = {}
        for src, edges in (static_graph or {}).items():
            for edge in edges:
                dst = edge[0] if isinstance(edge, tuple) else edge
                self._static.setdefault(str(src), set()).add(str(dst))
        # per-thread stack of (name, acquired-at) — thread-local, unshared
        self._held = threading.local()
        self.violations = 0  # guarded-by: self._meta_lock

    # ---------------- construction ----------------

    def lock(self, name: str) -> WatchedLock:
        return WatchedLock(self, threading.Lock(), name)

    def rlock(self, name: str) -> WatchedLock:
        return WatchedLock(self, threading.RLock(), name)

    def wrap(self, raw, name: str) -> WatchedLock:
        return WatchedLock(self, raw, name)

    # ---------------- introspection ----------------

    def observed_edges(self) -> Dict[str, Set[str]]:
        with self._meta_lock:
            return {k: set(v) for k, v in self._observed.items()}

    def held_by_current_thread(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self._stack())

    def _stack(self):
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    # ---------------- acquire/release hooks ----------------

    def _combined_path(self, src: str, dst: str) -> bool:
        """Reachability over observed ∪ static edges. Caller holds
        `_meta_lock` (observed) — static is frozen after __init__."""
        merged = dict(self._static)
        for node, nxt in self._observed.items():
            merged[node] = merged.get(node, set()) | nxt
        return _has_path(merged, src, dst)

    def _pre_acquire(self, name: str) -> None:
        stack = self._stack()
        held = [h for h, _ in stack]
        if not held or name in held:
            # first lock, or a reentrant re-acquire (RLock): no new order
            return
        with self._meta_lock:
            for h in held:
                if self._combined_path(name, h):
                    self.violations += 1
                    cycle = f"{h} -> {name} here, {name} ~> {h} elsewhere"
                    from dorpatch_tpu_torch.observe import events as _events
                    _events.record_event(
                        "sanitize.lock_order", lock=name, held=held,
                        cycle=cycle,
                        thread=threading.current_thread().name)
                    raise LockOrderViolation(
                        f"lock order violation: acquiring {name!r} while "
                        f"holding {held!r} closes a cycle ({cycle}); "
                        f"canonical order is alphabetical by lock name "
                        f"(DP501)")
            for h in held:
                self._observed.setdefault(h, set()).add(name)

    def _post_acquire(self, name: str) -> None:
        self._stack().append((name, self._clock()))

    def _pre_release(self, name: str) -> float:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, t0 = stack.pop(i)
                return self._clock() - t0
        return 0.0  # release without a recorded acquire: nothing to time

    def _post_release(self, name: str, held_s: float) -> None:
        budget = self.hold_budget_s
        if budget is not None and held_s > budget:
            with self._meta_lock:
                self.violations += 1
            from dorpatch_tpu_torch.observe import events as _events
            _events.record_event(
                "sanitize.lock_held", lock=name,
                held_s=round(held_s, 6), budget_s=budget,
                thread=threading.current_thread().name)
            raise LockHoldBudgetExceeded(
                f"lock {name!r} held {held_s:.3f}s, over the "
                f"{budget:g}s sanitizer budget (DP502's runtime twin: "
                f"something blocking ran under this lock)")


# ---------------- process-wide arming (mirrors events._ACTIVE) ----------------

_ACTIVE_WATCH: Optional[LockWatch] = None


def active_watch() -> Optional[LockWatch]:
    return _ACTIVE_WATCH


def set_active_watch(watch: Optional[LockWatch]) -> Optional[LockWatch]:
    """Install `watch` as the process-active lock watch; returns the
    previous one so callers (the Sanitizer) can restore it on exit."""
    global _ACTIVE_WATCH
    prev = _ACTIVE_WATCH
    _ACTIVE_WATCH = watch
    return prev


def watched_lock(name: str, factory=threading.Lock):
    """Construction-time opt-in for production code: an instrumented lock
    when a watch is armed (`--sanitize`), a bare `factory()` otherwise —
    the unsanitized fleet pays nothing."""
    watch = _ACTIVE_WATCH
    if watch is None:
        return factory()
    return watch.wrap(factory(), name)
