"""Attack-sweep farm: a standing, fault-tolerant red-teaming service.

Port of `dorpatch_tpu.farm`. A grid spec becomes a file-backed job queue
(`queue.py`) that N worker processes (`worker.py`) drain cooperatively:
atomic lease files with heartbeat-driven expiry make a SIGKILL'd or wedged
worker's jobs reclaimable by survivors with no coordinator; per-job carry
checkpoints make a reclaimed job *resume* rather than restart; a typed
failure taxonomy retries transient errors with backoff and quarantines
deterministic ones with their traceback. `chaos.py` injects each failure
mode deterministically, and `report.py` aggregates the fleet's accounting.
The farm directory's JSON records are the JAX package's, byte for byte.

CLI: ``python -m dorpatch_tpu_torch.farm submit|work|status|report``.

Import discipline: this module and `queue`/`report`/`chaos` stay host-only
and cheap; the model stack loads only inside a worker running a job
(`worker.default_runner`).
"""

from dorpatch_tpu_torch.farm.queue import (  # noqa: F401
    JobQueue,
    expand_grid,
    retry_delay,
)

__all__ = ["JobQueue", "expand_grid", "retry_delay"]
