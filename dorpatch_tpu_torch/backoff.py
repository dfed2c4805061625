"""Shared exponential-backoff/jitter math.

Port of `dorpatch_tpu.backoff`: the serve pool's replica restarts
(`serve/pool.py`) wait `retry_delay` seconds, the same formula as the JAX
package's farm retries and the load generator's 503 retry loop, so their
delays are comparable and their tests deterministic.
"""

from __future__ import annotations

import hashlib


def retry_delay(job_id: str, attempt: int, base: float = 2.0,
                cap: float = 300.0, jitter: float = 0.25) -> float:
    """Exponential backoff with *deterministic* jitter seeded from the job
    id and attempt number: retries are exactly reproducible (no flaky
    recovery tests), while a burst of simultaneous failures still spreads
    its retries instead of thundering back in lockstep."""
    delay = min(float(cap), float(base) * (2.0 ** max(0, attempt - 1)))
    seed = int.from_bytes(
        hashlib.sha256(f"{job_id}:{attempt}".encode()).digest()[:4], "big")
    return delay * (1.0 + float(jitter) * (seed / 2.0 ** 32))
