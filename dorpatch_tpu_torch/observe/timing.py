"""Wall-clock block timing (with MFU accounting), `torch.profiler` traces,
and the shared latency-percentile formula.

Port of `dorpatch_tpu.observe.timing`; the profiler is `torch.profiler`
(CPU and, where there is one, CUDA activity), exported as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Optional, Sequence

import time


def nearest_rank_percentile(sorted_vals: Sequence[float],
                            q: float) -> Optional[float]:
    """Nearest-rank percentile over an ASCENDING sequence (None when empty).

    The ONE percentile formula for serving latency: the service's live
    `/stats`, the offline report's serve section, and `tools/loadgen.py`
    all route through it, so their p50/p95/p99 rows can never disagree on
    the same samples (same contract as `StepTimer.summary` for MFU)."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     math.ceil(q * len(sorted_vals)) - 1))
    return float(sorted_vals[idx])


class StepTimer:
    """Wall-clock series over timed blocks -> throughput summary."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = None
        self.block_seconds = []

    def start(self) -> None:
        self._t0 = self._clock()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = self._clock() - self._t0
        self._t0 = None
        self.block_seconds.append(dt)
        return dt

    def summary(self, steps_per_block: int, batch: int,
                flops_per_step: float = 0.0,
                peak_flops: float = 0.0) -> dict:
        """Throughput summary; pass `flops_per_step` (useful FLOPs of one
        optimization step, e.g. 3 x forward-FLOPs x EOT x batch) and the
        card's `peak_flops` to get an `mfu` row (the JAX package's
        formula, so the two packages' rows compare)."""
        total = float(sum(self.block_seconds))
        n_steps = steps_per_block * len(self.block_seconds)
        out = {
            "blocks": len(self.block_seconds),
            "total_seconds": round(total, 3),
            "steps_per_sec": round(n_steps / total, 3) if total else 0.0,
            "images_per_sec": round(n_steps * batch / total, 3) if total else 0.0,
        }
        if flops_per_step and peak_flops and total:
            out["achieved_tflops"] = round(
                n_steps * flops_per_step / total / 1e12, 2)
            out["mfu"] = round(n_steps * flops_per_step / total / peak_flops, 4)
        return out


#: the file a `trace` scope writes into its directory
TRACE_FILE = "trace.json"


class KernelGate:
    """Kernel op calls against the profiler's start and stop.

    A kernel's op (`dorpatch_torch::...`) runs a Python kernel behind the
    dispatcher: the op's profiler record opens before the call waits for
    the GIL and closes after it. A profiler stopped on another thread in
    between can free that record before it closes: a native crash of a
    serving process.
    Every kernel op call runs inside the gate (`with KERNEL_GATE:`, any
    number at once, from any thread); the profiler starts and stops inside
    `transition()`, which waits until no call is in flight and holds new
    ones back meanwhile. A call never makes another: not reentrant. A CUDA
    graph capture `hold()`s the gate: it counts as one call in flight for
    its whole scope, and the kernel calls it makes go through."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._calls = 0
        self._closed = False
        self._local = threading.local()

    def __enter__(self):
        with self._cond:
            while self._closed and not getattr(self._local, "held", 0):
                self._cond.wait(0.1)
            self._calls += 1

    def __exit__(self, *exc):
        with self._cond:
            self._calls -= 1
            if self._closed and not self._calls:
                self._cond.notify_all()

    @contextlib.contextmanager
    def hold(self):
        """One call in flight for the scope (a graph capture): a
        transition waits for it; the calls this thread makes inside go
        through while one waits."""
        self.__enter__()
        self._local.held = getattr(self._local, "held", 0) + 1
        try:
            yield
        finally:
            self._local.held -= 1
            self.__exit__(None, None, None)

    @contextlib.contextmanager
    def transition(self):
        with self._cond:
            while self._closed:
                self._cond.wait(0.1)
            self._closed = True
            while self._calls:
                self._cond.wait(0.1)
        try:
            yield
        finally:
            with self._cond:
                self._closed = False
                self._cond.notify_all()


KERNEL_GATE = KernelGate()


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """`torch.profiler` scope; no-op when `trace_dir` is falsy.

    Records the process's CPU operators and, on a machine with a GPU, its
    CUDA kernels, and writes `<trace_dir>/trace.json` (Chrome trace
    format) when the scope closes."""
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with KERNEL_GATE.transition():
        prof.start()
    try:
        yield
    finally:
        with KERNEL_GATE.transition():
            prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


# One capture at a time per process: the profiler is a process-global
# toggle, so overlapping captures would corrupt each other.
_PROFILE_LOCK = threading.Lock()
_INIT_LOCK = threading.Lock()
_profiler_ready = False


def init_profiler() -> None:
    """Set `torch.profiler` up on the calling thread, once per process.

    The profiler's client is registered on the thread that loaded torch,
    and its first use must be on that thread too: a first capture on any
    other thread (an HTTP handler's `POST /profile`, a signal's capture
    thread) prints "External init callback must run in same thread as
    registerClient" and skips the client's setup, and on an H100 a serve
    path failed after it (internal errors once, a segfault once). Every
    entry point loads torch on its main thread and boots there, so the
    service and the farm worker call this while booting, before any other
    thread may capture. Later calls return at once."""
    global _profiler_ready
    with _INIT_LOCK:
        if _profiler_ready:
            return
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with _PROFILE_LOCK, torch.profiler.profile(activities=activities):
            pass
        _profiler_ready = True


def capture_profile(out_dir: Optional[str], duration_s: float = 0.5,
                    max_duration_s: float = 10.0,
                    sleep=time.sleep) -> Optional[str]:
    """On-demand bounded-duration `torch.profiler` capture.

    Traces everything the process launches for (clamped) `duration_s`
    into ``<out_dir>/profile`` and emits a ``profile.captured`` event on
    the active EventLog. Serving keeps answering while the capture runs —
    this is the `POST /profile` hook, not a pause button.
    Returns the trace dir, or None when `out_dir` is falsy or another
    capture is already in flight (the lock is never waited on: a second
    concurrent request is refused, not queued)."""
    if not out_dir:
        return None
    if not _PROFILE_LOCK.acquire(blocking=False):
        return None
    try:
        dur = max(0.05, min(float(duration_s), float(max_duration_s)))
        trace_dir = os.path.join(out_dir, "profile")
        t0 = time.perf_counter()
        with trace(trace_dir):
            sleep(dur)
        from dorpatch_tpu_torch.observe import events

        events.record_event("profile.captured", dir=trace_dir,
                            duration_s=round(dur, 3),
                            wall_s=round(time.perf_counter() - t0, 3))
        return trace_dir
    finally:
        _PROFILE_LOCK.release()
