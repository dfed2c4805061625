"""Deterministic fault injection for the attack-sweep farm, the serve
replica pool, the fleet gateway and the recert scheduler.

Port of `dorpatch_tpu.chaos`, every fault. Each fault is
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

Serve faults always target replica 0.

Gateway faults (wired by `gateway/` at its probe and deploy sites):

- ``wedge_probe``     - the membership prober's next probes of backend 0
  fail artificially (no socket touched), a seeded count sized past the
  ejection threshold; then real probes resume and the re-admission
  hysteresis takes over.
- ``poison_canary``   - the rolling deploy's robustness evaluation of the
  canary is replaced once with a failing DP400 verdict, proving the
  automatic rollback without a genuinely regressed model.

Recert faults (wired by `recert/scheduler.py` at `on_recert`, called right
after the generation's grid is submitted, with the inflight record
already committed to `recert_state.json`):

- ``recert_kill_cycle`` - SIGKILL the scheduler mid-generation: jobs
  submitted, nothing harvested. Resume must finish the same generation
  with a baseline byte-identical to an uninterrupted run.
- ``recert_torn_state`` - truncate `recert_state.json` mid-byte (a torn
  write): the scheduler must recover from the generation directories.

Every fault's seeded ordinal equals the JAX package's (`fault_seed`).
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
RECERT_FAULTS = ("recert_kill_cycle", "recert_torn_state")
GATEWAY_FAULTS = ("wedge_probe", "poison_canary")
FAULTS = (FARM_FAULTS + ("wedge_dispatch", "raise_in_worker", "kill_backend")
          + RECERT_FAULTS + GATEWAY_FAULTS)

# The replica every serve fault is aimed at (see module docstring).
SERVE_TARGET_REPLICA = 0


class SimulatedPreemption(RuntimeError):
    """A chaos-injected crash in ``crash_mode="raise"``."""


def fault_seed(job_id: str, fault: str) -> int:
    """Deterministic 32-bit seed per (job, fault)."""
    digest = hashlib.sha256(f"{job_id}:{fault}".encode()).digest()
    return int.from_bytes(digest[:4], "big")


def _check(faults: Sequence[str]) -> None:
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
        self._probe_counter = {}
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

    # ---------------- recert injection site ----------------

    def on_recert(self, phase: str, state_path: str = "") -> None:
        """Scheduler cycle-boundary site, called by
        `RecertScheduler.begin_generation` right after `submit_spec`, with
        the inflight record already committed: earlier there is nothing to
        resume, later the farm's own crash story covers it."""
        if phase != "submitted":
            return
        if ("recert_torn_state" in self.faults and state_path
                and self.fire_once("recert_torn_state")):
            # tear the state file the way a crashed non-atomic writer
            # would: keep the first half of the bytes, drop the rest
            try:
                with open(state_path, "rb") as fh:
                    raw = fh.read()
                with open(state_path, "wb") as fh:
                    fh.write(raw[:max(1, len(raw) // 2)])
            except OSError:
                pass
        if ("recert_kill_cycle" in self.faults
                and self.fire_once("recert_kill_cycle")):
            if self.crash_mode == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            raise SimulatedPreemption(
                "chaos: simulated scheduler preemption mid-generation "
                "(grid submitted, nothing harvested)")

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

    # ---------------- gateway injection sites ----------------

    def wedge_probe_failures(self) -> int:
        """How many consecutive probes of the target backend fail
        artificially: sized past any sane ejection threshold, so the wedge
        provably ejects; then real probes resume."""
        return 4 + fault_seed(self.job_id, "wedge_probe") % 3

    def on_gateway_probe(self, backend_index: int, backend_name: str) -> bool:
        """Membership-prober site, called once per probe cycle per backend
        before any socket is touched. True when the probe must count as
        failed. Targets backend index 0; the first call commits the
        fired-marker, then the next `wedge_probe_failures()` probes of that
        backend fail."""
        if "wedge_probe" not in self.faults or backend_index != 0:
            return False
        if self.fire_once("wedge_probe"):
            self._probe_counter[backend_name] = self.wedge_probe_failures()
        left = self._probe_counter.get(backend_name, 0)
        if left <= 0:
            return False
        self._probe_counter[backend_name] = left - 1
        return True

    def poison_canary(self, verdict: dict) -> dict:
        """Deploy-evaluation site, called by the rolling deploy with the
        canary's real robustness verdict. Fires once, replacing it with a
        failing DP400 (robustness regression) verdict; every later
        evaluation passes the real verdict through."""
        if ("poison_canary" in self.faults
                and self.fire_once("poison_canary")):
            return {"status": "failed",
                    "findings_by_rule": {"DP400": [
                        "chaos: injected robustness regression "
                        "(certified-accuracy margin below baseline)"]},
                    "worst_margin": -1.0,
                    "poisoned": True}
        return verdict



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
