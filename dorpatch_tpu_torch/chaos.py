"""Deterministic fault injection for the attack-sweep farm and the serve
replica pool.

Port of `dorpatch_tpu.chaos`, the farm and serve faults. Each fault is
seeded from the *job id* and fires *exactly once* per (job, fault): the
fired-marker is an O_EXCL file in the state directory created BEFORE the
fault is injected, so not even a SIGKILL fault can fire twice across
process restarts.

Farm faults (wired by `farm/worker.py`):

- ``crash_block``     - die at a seeded attack-block boundary. Injected
  inside the `on_block_end` callback, which `DorPatch._run_stage` invokes
  AFTER the carry snapshot for that block is saved: the job provably has a
  snapshot to resume from. ``crash_mode="kill"`` SIGKILLs the process (no
  cleanup, no finally blocks); ``"raise"`` raises `SimulatedPreemption`
  for in-process tests.
- ``ckpt_raise``      - a checkpointer proxy whose `save` raises ENOSPC at
  a seeded save ordinal (transient IO failure -> retry path).
- ``wedge_heartbeat`` - stop the worker's heartbeat thread without the
  exit beat (`Heartbeat.wedge`): the process stays alive but its leases go
  stale, exercising reclaim from a live zombie.
- ``enospc_events``   - the event log's file handle starts raising ENOSPC
  after a seeded number of writes; `EventLog._write` must degrade to its
  tracking-only sink and the job must still complete.

Serve faults (wired by `serve/pool.py` at the replica batch boundary,
`on_serve_batch`, called with a batch in flight, outside the per-batch
exception guard):

- ``wedge_dispatch``   - the target replica's worker thread blocks forever
  mid-batch (requests assigned, none resolved): the supervisor must detect
  the stale heartbeat, re-dispatch the in-flight requests, and quarantine.
- ``raise_in_worker``  - an exception escapes the worker loop entirely and
  the thread dies, exercising the dead-thread classification + restart.
- ``wedge_heartbeat``  - (shared name) the replica keeps serving but its
  heartbeat stops: staleness-based detection must fire even though the
  thread is alive.
- ``kill_backend``     - SIGKILL the whole serve process mid-batch, at a
  seeded batch ordinal; before dying it invokes the bound ``metrics_flush``
  callback so the committed counters reach metrics.json. Always SIGKILLs
  regardless of ``crash_mode``.

Serve faults always target replica 0. The JAX package's recert and
gateway faults belong to subsystems this port does not have yet;
`parse_faults` refuses them by name.
"""

from __future__ import annotations

import errno
import hashlib
import os
import signal
import threading
from typing import IO, Optional, Sequence

FARM_FAULTS = ("crash_block", "ckpt_raise", "wedge_heartbeat",
               "enospc_events")
SERVE_FAULTS = ("wedge_dispatch", "raise_in_worker", "wedge_heartbeat",
                "kill_backend")
FAULTS = FARM_FAULTS + ("wedge_dispatch", "raise_in_worker", "kill_backend")
#: the JAX package's faults of the subsystems not ported yet
NOT_PORTED = ("recert_kill_cycle", "recert_torn_state", "wedge_probe",
              "poison_canary")

# The replica every serve fault is aimed at (see module docstring).
SERVE_TARGET_REPLICA = 0


class SimulatedPreemption(RuntimeError):
    """A chaos-injected crash in ``crash_mode="raise"``."""


def fault_seed(job_id: str, fault: str) -> int:
    """Deterministic 32-bit seed per (job, fault)."""
    digest = hashlib.sha256(f"{job_id}:{fault}".encode()).digest()
    return int.from_bytes(digest[:4], "big")


def _check(faults: Sequence[str]) -> None:
    later = [f for f in faults if f in NOT_PORTED]
    if later:
        raise ValueError(
            f"chaos fault(s) {later} belong to the recert and gateway "
            f"subsystems, not yet ported to dorpatch_tpu_torch; farm "
            f"faults: {list(FARM_FAULTS)}, serve faults: "
            f"{list(SERVE_FAULTS)}")
    unknown = [f for f in faults if f not in FAULTS]
    if unknown:
        raise ValueError(
            f"unknown chaos fault(s) {unknown}; known: {list(FAULTS)}")


def parse_faults(spec: str) -> Sequence[str]:
    """Comma-joined fault list (the `--chaos` flag); unknown names are a
    configuration error, not a silent no-op."""
    faults = tuple(f.strip() for f in spec.split(",") if f.strip())
    _check(faults)
    return faults


class Chaos:
    def __init__(self, faults: Sequence[str], job_id: str, state_dir: str,
                 crash_mode: str = "kill"):
        _check(faults)
        if crash_mode not in ("kill", "raise"):
            raise ValueError(f"crash_mode must be kill|raise, got {crash_mode!r}")
        self.faults = tuple(faults)
        self.job_id = job_id
        self.state_dir = os.path.abspath(state_dir)
        self.crash_mode = crash_mode
        self._block_counter = 0
        self._serve_batch_counter = 0
        self._heartbeat = None
        self._metrics_flush = None

    def bind(self, heartbeat=None, metrics_flush=None) -> "Chaos":
        """Wire process-level collaborators: `heartbeat` for the wedge
        faults, `metrics_flush` (a zero-arg callable dumping the serve
        metric registry to metrics.json) for `kill_backend`'s
        flush-before-SIGKILL contract."""
        if heartbeat is not None:
            self._heartbeat = heartbeat
        if metrics_flush is not None:
            self._metrics_flush = metrics_flush
        return self

    # ---------------- fired-marker bookkeeping ----------------

    def marker_path(self, fault: str) -> str:
        return os.path.join(self.state_dir, f"chaos_{fault}.fired")

    def fired(self, fault: str) -> bool:
        return os.path.exists(self.marker_path(fault))

    def fire_once(self, fault: str) -> bool:
        """True exactly once per (job, fault) across all attempts and
        processes: the marker is committed via O_EXCL *before* the fault is
        injected."""
        if fault not in self.faults:
            return False
        os.makedirs(self.state_dir, exist_ok=True)
        try:
            fd = os.open(self.marker_path(fault),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return False
        os.close(fd)
        return True

    # ---------------- farm injection sites ----------------

    def crash_block_ordinal(self) -> int:
        """Which block boundary (0 or 1, counted per attempt) the crash
        targets: always early enough to land mid-job."""
        return fault_seed(self.job_id, "crash_block") % 2

    def events_write_budget(self) -> int:
        """How many event writes succeed before the injected ENOSPC."""
        return 1 + fault_seed(self.job_id, "enospc_events") % 5

    def ckpt_raise_ordinal(self) -> int:
        """Which checkpoint save (per attempt) raises."""
        return fault_seed(self.job_id, "ckpt_raise") % 2

    def on_block(self, stage: int, iteration: int,
                 info: Optional[dict] = None) -> None:
        """Block-boundary site, in the job's `on_block_end` chain: runs
        after the block's carry snapshot, before the lease renewal."""
        n = self._block_counter
        self._block_counter += 1
        if (self._heartbeat is not None
                and self.fire_once("wedge_heartbeat")):
            self._heartbeat.wedge()
        if ("crash_block" in self.faults
                and n >= self.crash_block_ordinal()
                and self.fire_once("crash_block")):
            if self.crash_mode == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise SimulatedPreemption(
                f"chaos: simulated preemption at block {n} "
                f"(stage {stage}, iteration {iteration})")

    def wrap_checkpointer(self, checkpointer):
        if "ckpt_raise" not in self.faults or self.fired("ckpt_raise"):
            return checkpointer
        return _CheckpointRaiseProxy(checkpointer, self)

    def wrap_event_log(self, event_log) -> None:
        """Swap the EventLog's live file handle for one that starts raising
        ENOSPC after a seeded number of writes: the fault must hit the
        exact handle `_write`'s OSError degradation guards."""
        if "enospc_events" not in self.faults or event_log._fh is None:
            return
        if not self.fire_once("enospc_events"):
            return
        event_log._fh = _ENOSPCFile(event_log._fh,
                                    self.events_write_budget())

    # ---------------- serve injection site ----------------

    def on_serve_batch(self, replica_id: int, heartbeat=None) -> None:
        """Replica batch-boundary site (see the module docstring). Only
        replica `SERVE_TARGET_REPLICA` is ever hit; each fault fires on the
        first in-flight batch that replica picks up (warmup never routes
        through the worker loop)."""
        if replica_id != SERVE_TARGET_REPLICA:
            return
        n = self._serve_batch_counter
        self._serve_batch_counter += 1
        if ("kill_backend" in self.faults
                and n >= self.kill_backend_ordinal()
                and self.fire_once("kill_backend")):
            # this batch is still uncounted (the site runs before
            # resolution), so the books flushed here are exact
            if self._metrics_flush is not None:
                try:
                    self._metrics_flush()
                except Exception:
                    pass
            os.kill(os.getpid(), signal.SIGKILL)
        if (heartbeat is not None and "wedge_heartbeat" in self.faults
                and self.fire_once("wedge_heartbeat")):
            heartbeat.wedge()
        if ("raise_in_worker" in self.faults
                and self.fire_once("raise_in_worker")):
            raise SimulatedPreemption(
                f"chaos: injected worker exception (replica {replica_id})")
        if ("wedge_dispatch" in self.faults
                and self.fire_once("wedge_dispatch")):
            # freeze forever mid-batch: the daemon thread is abandoned and
            # the supervisor's staleness detection takes over
            threading.Event().wait()

    def kill_backend_ordinal(self) -> int:
        """Which in-flight batch (counted per process) the SIGKILL targets
        — never the first, so the backend provably answered something."""
        return 1 + fault_seed(self.job_id, "kill_backend") % 2



class _CheckpointRaiseProxy:
    """`save` raises ENOSPC exactly once at the seeded ordinal; every other
    attribute (restore, latest_step_info, clear, close) delegates."""

    def __init__(self, checkpointer, chaos: Chaos):
        self._checkpointer = checkpointer
        self._chaos = chaos
        self._saves = 0

    def save(self, *args, **kwargs):
        n = self._saves
        self._saves += 1
        if (n >= self._chaos.ckpt_raise_ordinal()
                and self._chaos.fire_once("ckpt_raise")):
            raise OSError(errno.ENOSPC,
                          "chaos: injected checkpoint-write failure")
        return self._checkpointer.save(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._checkpointer, item)


class _ENOSPCFile:
    """File-object shim whose `write` raises ENOSPC once its budget runs
    out: the mid-run disk-full signature `EventLog._write` degrades on."""

    def __init__(self, fh: IO[str], budget: int):
        self._fh = fh
        self._budget = int(budget)

    def write(self, data: str):
        if self._budget <= 0:
            raise OSError(errno.ENOSPC, "chaos: injected event-write failure")
        self._budget -= 1
        return self._fh.write(data)

    def close(self) -> None:
        self._fh.close()

    def __getattr__(self, item):
        return getattr(self._fh, item)
