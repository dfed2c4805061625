"""Micro-batcher: bounded request queue with size-or-deadline flush.

Port of `dorpatch_tpu.serve.batcher`. Pure host-side queue logic (no
torch): single-image requests accumulate in a
FIFO guarded by one condition variable; the worker blocks in `next_batch`
until either

- **size trigger** — a full top bucket's worth of requests is pending
  (`max(bucket_sizes)`), or
- **deadline trigger** — the OLDEST pending request has spent
  `flush_fraction` of its latency budget (default: half). Flushing at the
  half-budget point leaves the other half for the batched forward + certify
  sweep itself, so a lone request still answers inside its deadline instead
  of waiting forever for company.

Backpressure is a typed reject at submit time: past `max_queue_depth`
pending requests, `submit` refuses (the service maps that onto an
`Overloaded` response) — the queue never grows unboundedly and latency
stays bounded by design.

The batcher never pads — it hands the worker at most `max(bucket_sizes)`
real requests; rounding the batch up to a shape bucket is the worker's job
(`service._run_batch`), because padding is a device-layout concern, not a
queueing concern.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional, Sequence


class PendingRequest:
    """One queued request: the image, its absolute deadline (perf-clock
    seconds), and the event/result slot the submitting thread waits on.

    Resolution is FIRST-WINS: with replica failover a request can briefly be
    visible to two resolvers (the stale replica that was holding it and the
    healthy one it was re-dispatched to), and the contract is exactly one
    answer — the loser's response is shed, never delivered. `claim()` is the
    atomic arbiter; callers that need to account for the outcome *before*
    waking the waiter claim first, then `deliver()`."""

    __slots__ = ("image", "enqueued", "deadline", "done", "result",
                 "redispatched", "trace_id", "_claim_lock", "_claimed")

    def __init__(self, image, enqueued: float, deadline: float,
                 trace_id: str = ""):
        self.image = image
        self.enqueued = enqueued
        self.deadline = deadline
        # ingress correlation id: minted once in `predict()` and carried
        # through dispatch, failover re-dispatch, and every telemetry
        # record this request touches — the SAME id survives a re-enqueue
        # because the request object itself does
        self.trace_id = trace_id
        self.done = threading.Event()
        self.result = None
        # set by the supervisor on failover: at most ONE re-enqueue per
        # request — a second replica failure resolves it as an error
        self.redispatched = False
        self._claim_lock = threading.Lock()
        self._claimed = False  # guarded-by: self._claim_lock

    def budget_s(self) -> float:
        return self.deadline - self.enqueued

    def claim(self) -> bool:
        """Atomically win the exclusive right to answer this request.
        Exactly one caller ever sees True."""
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True

    def deliver(self, result) -> None:
        """Publish the result and wake the waiter. Only the `claim()`
        winner may call this."""
        self.result = result
        self.done.set()

    def resolve(self, result) -> bool:
        """claim + deliver in one step; True if this call won."""
        if not self.claim():
            return False
        self.deliver(result)
        return True


class MicroBatcher:
    """Bounded FIFO with size-or-deadline flush (see module docstring)."""

    def __init__(self, bucket_sizes: Sequence[int], max_queue_depth: int,
                 flush_fraction: float = 0.5, clock=time.perf_counter):
        if not bucket_sizes:
            raise ValueError("bucket_sizes must be non-empty")
        if not 0.0 < flush_fraction <= 1.0:
            raise ValueError(f"flush_fraction must be in (0, 1], got "
                             f"{flush_fraction}")
        self.bucket_sizes = tuple(sorted(int(b) for b in bucket_sizes))
        self.max_batch = self.bucket_sizes[-1]
        self.max_queue_depth = int(max_queue_depth)  # guarded-by: self._cond
        self.flush_fraction = float(flush_fraction)
        self._clock = clock
        self._cond = threading.Condition()
        self._pending = collections.deque()  # guarded-by: self._cond
        self._closed = False  # guarded-by: self._cond

    # ---------------- producer side ----------------

    def submit(self, req: PendingRequest) -> bool:
        """Enqueue; False = backpressure reject (queue at max_queue_depth)
        or batcher closed. Nothing is ever queued on a False return."""
        with self._cond:
            if self._closed or len(self._pending) >= self.max_queue_depth:
                return False
            self._pending.append(req)
            self._cond.notify_all()
            return True

    def requeue(self, reqs: Sequence[PendingRequest]) -> bool:
        """Failover re-enqueue: put a failed replica's in-flight requests at
        the FRONT of the queue (they have already burned queue time) in
        their original arrival order. Deliberately exempt from the depth
        bound — these requests were admitted once and backpressure must not
        turn a replica failure into silent loss. False only when the
        batcher is closed (the caller resolves them as errors instead)."""
        with self._cond:
            if self._closed:
                return False
            self._pending.extendleft(reversed(list(reqs)))
            self._cond.notify_all()
            return True

    def qsize(self) -> int:
        with self._cond:
            return len(self._pending)

    def set_max_queue_depth(self, depth: int) -> None:
        """Degraded-capacity backpressure: when replicas retire, the pool
        shrinks the admission bound so the service rejects with
        `Overloaded` sooner instead of queueing work it can no longer
        answer inside a deadline. Already-queued requests are unaffected."""
        with self._cond:
            self.max_queue_depth = max(0, int(depth))

    def drain(self) -> List[PendingRequest]:
        """Remove and return every queued request (terminal degradation:
        nobody is left to serve them; the pool resolves them as typed
        errors so no waiter hangs)."""
        with self._cond:
            out = list(self._pending)
            self._pending.clear()
            return out

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self) -> None:
        """Stop admitting; the worker drains what is queued, then
        `next_batch` returns None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # ---------------- consumer side ----------------

    def _flush_at(self, req: PendingRequest) -> float:
        """Perf-clock instant at which `req` forces a flush."""
        return req.enqueued + self.flush_fraction * req.budget_s()

    def _next_flush(self) -> float:
        """Earliest flush instant over EVERY pending request — not just the
        head's: a short-deadline request queued behind a long-deadline one
        must still flush inside its own budget (head-of-line starvation)."""
        return min(self._flush_at(r) for r in self._pending)

    def next_batch(self, timeout: Optional[float] = None
                   ) -> Optional[List[PendingRequest]]:
        """Block until a flush triggers; returns up to `max_batch` requests
        in arrival order, or None when closed and fully drained.

        With `timeout`, returns an EMPTY list once that many seconds pass
        with no flush — the replica worker's idle heartbeat tick: the
        supervisor's missed-beat staleness detection needs workers to prove
        liveness on a bounded cadence even when no traffic arrives, and a
        worker parked forever inside this wait could not."""
        with self._cond:
            give_up = None if timeout is None else self._clock() + timeout
            while True:
                now = self._clock()
                if self._pending:
                    if (len(self._pending) >= self.max_batch
                            or self._closed
                            or now >= self._next_flush()):
                        return [self._pending.popleft()
                                for _ in range(min(len(self._pending),
                                                   self.max_batch))]
                    if give_up is not None and now >= give_up:
                        return []
                    # sleep until the earliest flush instant; a submit that
                    # fills the bucket (or carries a tighter deadline)
                    # notifies us and we recompute. The wait is clamped:
                    # a pathological deadline (inf/NaN slipping past
                    # validation) must degrade to a slow poll, never an
                    # OverflowError or an unbounded sleep in the worker
                    wait_s = self._next_flush() - now
                    if not (wait_s > 0.0):  # also catches NaN
                        wait_s = 0.05
                    wait_s = min(wait_s, 60.0)
                    if give_up is not None:
                        wait_s = min(wait_s, max(give_up - now, 0.0))
                    self._cond.wait(wait_s)
                elif self._closed:
                    return None
                elif give_up is not None:
                    if now >= give_up:
                        return []
                    self._cond.wait(give_up - now)
                else:
                    # deliberate untimed idle park: every producer path
                    # (submit/requeue/close) notifies under this same
                    # cond, and production workers always pass `timeout`
                    # (the heartbeat tick) — only timeout-less callers
                    # (tests, drains) can reach this branch
                    self._cond.wait()  # producers always notify  # noqa: DP502 — producers always notify
