"""File-backed job queue: the farm's coordination substrate.

Port of `dorpatch_tpu.farm.queue`: the same directory layout, file names
and JSON records (`farm.json`, `job.json`, `lease.json`), byte for byte, so
either package's `status` and `report` read the other's farm directory.
Carry snapshots are each package's own format: one farm directory is
drained by workers of one package.

A farm directory is the whole database — no daemon, no sockets, no locks
held by live processes:

    <farm_dir>/
      farm.json                  # the submitted spec (marks the dir a farm)
      jobs/<job_id>/
        job.json                 # the job's state machine (single source of truth)
        lease.json               # present while a worker owns the job
        chaos_<fault>.fired      # chaos markers (fault fired exactly once)
        checkpoints/carry_<i>/   # carry snapshots (crash-resume)
        results/                 # run.json, events.jsonl, rows.jsonl, patches
      workers/<worker_id>/
        heartbeat_0.jsonl        # the worker's liveness signal (observe.Heartbeat)

`job.json` states: ``pending -> leased -> running -> done | failed |
quarantined``. ``failed`` is retryable while ``attempts < max_attempts`` and
the clock has passed ``next_retry_ts``; ``done``/``quarantined`` (and
exhausted ``failed``) are terminal. Every transition is one
`checkpoint.atomic_write_json` — a reader never sees a half-written state.

The lease protocol needs no coordinator:

- *claim*: the whole lease is written to a private tmp and hard-linked
  to `lease.json` (`os.link` fails if it exists) — the filesystem picks
  the single winner among racing workers, and no contender ever reads a
  lease that is still being written.
- *liveness*: a lease is fresh while the owning worker's heartbeat file
  (`observe.heartbeat`) keeps advancing within the TTL; a SIGKILL'd or
  wedged worker stops beating and its leases go stale with no cleanup code
  running anywhere. Belt-and-suspenders, the lease also carries an
  `expires_ts` renewed (tmp + `os.replace`) at block boundaries, covering
  workers whose heartbeat file was never created.
- *reclaim*: a contender renames the stale lease aside (`os.rename` — only
  one renamer wins; a renamer that finds it moved another's fresh lease
  links it back and loses) and then claims fresh by link. The renewal/takeover
  race window is a few milliseconds against a TTL of seconds, and every
  job-state commit re-checks `owns_lease` — acceptable for a cooperative
  single-filesystem farm (the design point of this queue).

Host-only logic throughout: nothing here touches torch or a device, so
the status/report CLIs stay cheap.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

# Backoff math lives in the shared module (serve replica restarts use the
# same formula); re-exported here because the farm grew it first.
from dorpatch_tpu_torch.backoff import retry_delay  # noqa: F401
from dorpatch_tpu_torch.checkpoint import atomic_write_json, load_json
from dorpatch_tpu_torch.observe.heartbeat import last_beat

FARM_NAME = "farm.json"
JOB_NAME = "job.json"
LEASE_NAME = "lease.json"

STATES = ("pending", "leased", "running", "done", "failed", "quarantined")
TERMINAL_STATES = ("done", "quarantined")


def expand_grid(axes: Dict[str, List]) -> List[Dict]:
    """Cartesian product of ``{param: [values]}`` into one override dict per
    job, in sorted-key order — the same spec always expands to the same job
    list in the same order (job ids, chaos seeds, and retry jitter all hang
    off that determinism)."""
    keys = sorted(axes)
    if not keys:
        return [{}]
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(axes[k] for k in keys))]


def job_slug(params: Dict) -> str:
    """Short filesystem-safe summary of a job's parameter point."""
    parts = []
    for k in sorted(params):
        v = params[k]
        tail = k.split(".")[-1]
        parts.append(f"{tail}={v}")
    return re.sub(r"[^A-Za-z0-9._=-]+", "_", "_".join(parts))[:80]




class JobQueue:
    """All reads/writes of one farm directory's job + lease state."""

    def __init__(self, farm_dir: str, clock=time.time, metrics=None):
        self.farm_dir = os.path.abspath(farm_dir)
        self.jobs_dir = os.path.join(self.farm_dir, "jobs")
        self._clock = clock
        # optional observe.MetricRegistry: claim/reclaim tallies land there
        # so the worker's heartbeat + /metrics surface them live
        self.metrics = metrics
        # seq-freshness cache: heartbeat path -> (last seen seq, OUR clock
        # when it was first seen). Lease liveness must survive wall-clock
        # skew between hosts, so advancement of the writer's monotonic
        # `seq`, timed on the READER's clock, outranks the beat's `ts`.
        # A queue instance may be shared across threads, so the cache
        # read-check-update is atomic under `_lock`.
        self._lock = threading.Lock()
        self._hb_seq: Dict[str, Tuple[int, float]] = {}  # guarded-by: self._lock

    # ---------------- submit ----------------

    def submit_spec(self, spec: Dict) -> List[str]:
        """Expand a spec into per-job directories.

        Spec shape: ``{"base": {partial ExperimentConfig dict}, "axes":
        {dotted param: [values]}, "sweep": {run_sweep kwargs},
        "max_attempts": N}``. Idempotent: resubmitting the same spec leaves
        existing job state untouched and only creates jobs that are missing
        — a farm can be topped up, never accidentally reset."""
        base = dict(spec.get("base", {}))
        axes = dict(spec.get("axes", {}))
        sweep = dict(spec.get("sweep", {}))
        max_attempts = int(spec.get("max_attempts", 3))
        os.makedirs(self.jobs_dir, exist_ok=True)
        ids: List[str] = []
        for idx, params in enumerate(expand_grid(axes)):
            slug = job_slug(params)
            job_id = f"{idx:04d}" + (f"-{slug}" if slug else "")
            jdir = self.job_dir(job_id)
            os.makedirs(jdir, exist_ok=True)
            jpath = os.path.join(jdir, JOB_NAME)
            if not os.path.exists(jpath):
                now = round(self._clock(), 3)
                atomic_write_json(jpath, {
                    "schema": 1,
                    "id": job_id,
                    "index": idx,
                    "state": "pending",
                    "params": params,
                    "base": base,
                    "sweep": sweep,
                    "attempts": 0,
                    "max_attempts": max_attempts,
                    "reclaims": 0,
                    "failures": [],
                    "next_retry_ts": 0.0,
                    "worker": "",
                    "created_ts": now,
                    "updated_ts": now,
                })
            ids.append(job_id)
        atomic_write_json(os.path.join(self.farm_dir, FARM_NAME),
                          {"schema": 1, "spec": spec, "jobs": len(ids)})
        return ids

    # ---------------- job state ----------------

    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, job_id)

    def job_ids(self) -> List[str]:
        try:
            return sorted(
                d for d in os.listdir(self.jobs_dir)
                if os.path.isdir(os.path.join(self.jobs_dir, d)))
        except OSError:
            return []

    def read_job(self, job_id: str) -> Optional[Dict]:
        """The job's state dict, or None when job.json is missing/corrupt
        (claimers skip it; `counts` surfaces it as `unreadable`)."""
        return load_json(os.path.join(self.job_dir(job_id), JOB_NAME))

    def _commit(self, job: Dict, **fields) -> Dict:
        job.update(fields)
        job["updated_ts"] = round(self._clock(), 3)
        atomic_write_json(os.path.join(self.job_dir(job["id"]), JOB_NAME), job)
        return job

    def mark_running(self, job: Dict, worker_id: str) -> Dict:
        """leased -> running; the attempt counter increments HERE, so a job
        reclaimed after a SIGKILL shows attempts == 2 on its second life."""
        return self._commit(job, state="running", worker=worker_id,
                            attempts=int(job.get("attempts", 0)) + 1,
                            started_ts=round(self._clock(), 3))

    def mark_done(self, job: Dict, result: Optional[Dict] = None) -> Dict:
        return self._commit(job, state="done", result=result or {},
                            completed_ts=round(self._clock(), 3))

    def mark_failed(self, job: Dict, failure: Dict,
                    next_retry_ts: Optional[float] = None) -> Dict:
        """Transient failure: retryable until attempts reach max_attempts,
        after which the job is exhausted (terminal `failed`)."""
        failures = list(job.get("failures", [])) + [failure]
        exhausted = int(job["attempts"]) >= int(job["max_attempts"])
        return self._commit(
            job, state="failed", failures=failures, exhausted=exhausted,
            next_retry_ts=0.0 if exhausted else float(next_retry_ts or 0.0))

    def mark_quarantined(self, job: Dict, failure: Dict) -> Dict:
        """Deterministic failure: retrying would fail identically, so the
        job leaves the queue immediately (traceback preserved in job.json)
        instead of burning retries or wedging the farm."""
        failures = list(job.get("failures", [])) + [failure]
        return self._commit(job, state="quarantined", failures=failures)

    def counts(self) -> Dict[str, int]:
        out = {"total": 0, "pending": 0, "leased": 0, "running": 0,
               "done": 0, "failed_retryable": 0, "failed_exhausted": 0,
               "quarantined": 0, "unreadable": 0}
        for job_id in self.job_ids():
            out["total"] += 1
            job = self.read_job(job_id)
            if job is None:
                out["unreadable"] += 1
                continue
            state = job.get("state", "")
            if state == "failed":
                key = ("failed_exhausted" if job.get("exhausted")
                       else "failed_retryable")
                out[key] += 1
            elif state in out:
                out[state] += 1
            else:
                out["unreadable"] += 1
        return out

    def drained(self, counts: Optional[Dict[str, int]] = None) -> bool:
        """True when no job can ever make progress again — every job is
        done, quarantined, exhausted, or unreadable."""
        c = counts if counts is not None else self.counts()
        live = (c["pending"] + c["leased"] + c["running"]
                + c["failed_retryable"])
        return c["total"] > 0 and live == 0

    # ---------------- leases ----------------

    def lease_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), LEASE_NAME)

    def read_lease(self, job_id: str) -> Optional[Dict]:
        return load_json(self.lease_path(job_id))

    def lease_fresh(self, lease: Dict) -> bool:
        """Heartbeat-driven liveness: the lease is fresh while the owner's
        heartbeat file advanced within the TTL. Workers without a readable
        heartbeat fall back to the renewed `expires_ts`.

        Freshness prefers the beat's monotonic ``seq`` over its wall-clock
        ``ts``: a live worker whose clock runs behind ours keeps its lease
        because its seq keeps advancing (measured on OUR clock), and a dead
        worker whose final beat carried a future ts still loses it once the
        seq has been frozen for a full TTL of local time. The ts comparison
        only decides when seq gives no verdict (first observation of a
        file, or a pre-seq beat record)."""
        ttl = float(lease.get("ttl", 60.0))
        now = self._clock()
        hb_path = lease.get("heartbeat") or ""
        if hb_path:
            beat = last_beat(hb_path)
            if beat is not None:
                seq = beat.get("seq")
                if isinstance(seq, int):
                    # the read-check-update of the seq cache is atomic; the
                    # heartbeat-file read above stays OUTSIDE the lock
                    with self._lock:
                        prev = self._hb_seq.get(hb_path)
                        if prev is not None and seq != prev[0]:
                            # advancement since our last look: alive
                            self._hb_seq[hb_path] = (seq, now)
                            return True
                        if prev is None:
                            self._hb_seq[hb_path] = (seq, now)
                        # deliberate wall clock (injectable via `clock=`):
                        # cross-process liveness cannot use a private
                        # monotonic epoch, and the skew hazard is exactly
                        # what the seq-preferred path above absorbs
                        elif now - prev[1] > ttl:  # noqa: DP504 — injectable cross-process clock
                            return False  # frozen a whole TTL: dead
                # ts fallback (pre-seq beats): same deliberate wall clock
                return (now - float(beat["ts"])) <= ttl  # noqa: DP504 — injectable cross-process clock
        return now <= float(lease.get("expires_ts", 0.0))  # noqa: DP504 — injectable cross-process clock

    def _lease_record(self, job_id: str, worker_id: str, ttl: float,
                      heartbeat_path: str) -> Dict:
        now = self._clock()
        return {"job": job_id, "worker": worker_id, "pid": os.getpid(),
                "ttl": float(ttl), "heartbeat": heartbeat_path,
                "acquired_ts": round(now, 3),
                "expires_ts": round(now + float(ttl), 3)}

    def _create_excl(self, path: str, payload: Dict) -> bool:
        """Exclusive create of a whole file: the payload is written to a
        private tmp and hard-linked to `path`, which fails if `path`
        exists. An O_EXCL create written after its open would show its
        contenders an empty file for a moment, which they would read as a
        corrupt lease and take over."""
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".new.",
                                   dir=os.path.dirname(path))
        os.fchmod(fd, 0o644)
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh)
        try:
            os.link(tmp, path)
        except FileExistsError:
            return False
        finally:
            os.remove(tmp)
        return True

    def try_claim_lease(self, job_id: str, worker_id: str, ttl: float,
                        heartbeat_path: str = "") -> bool:
        """One exclusive claim attempt; a stale (or corrupt) existing lease
        is renamed aside first — exactly one of N racing contenders wins
        the rename, and only that winner proceeds to the exclusive
        create."""
        path = self.lease_path(job_id)
        payload = self._lease_record(job_id, worker_id, ttl, heartbeat_path)
        if self._create_excl(path, payload):
            return True
        lease = load_json(path)
        if lease is not None and self.lease_fresh(lease):
            return False
        stale = f"{path}.stale.{worker_id}.{os.getpid()}"
        try:
            os.rename(path, stale)
        except OSError:
            return False  # another contender won the takeover race
        try:
            if load_json(stale) != lease:
                # another contender took the stale lease over between our
                # read and our rename: what we moved is its fresh lease
                try:
                    os.link(stale, path)
                except OSError:
                    pass
                return False
        finally:
            try:
                os.remove(stale)
            except OSError:
                pass
        return self._create_excl(path, payload)

    def renew_lease(self, job_id: str, worker_id: str, ttl: float) -> bool:
        """Refresh `expires_ts` via tmp + `os.replace`; False when the lease
        is no longer this worker's (it was reclaimed — the caller must stop
        touching the job)."""
        path = self.lease_path(job_id)
        lease = load_json(path)
        if not lease or lease.get("worker") != worker_id:
            return False
        lease["expires_ts"] = round(self._clock() + float(ttl), 3)
        lease["renewed_ts"] = round(self._clock(), 3)
        atomic_write_json(path, lease)
        return True

    def owns_lease(self, job_id: str, worker_id: str) -> bool:
        lease = self.read_lease(job_id)
        return lease is not None and lease.get("worker") == worker_id

    def release_lease(self, job_id: str, worker_id: str) -> None:
        if self.owns_lease(job_id, worker_id):
            try:
                os.remove(self.lease_path(job_id))
            except OSError:
                pass

    # ---------------- claiming ----------------

    def claimable(self, job: Dict) -> Tuple[bool, bool]:
        """(claimable now, is a reclaim of a leased/running job). Purely a
        job.json judgment — the lease race decides the actual winner."""
        state = job.get("state", "")
        if state in TERMINAL_STATES:
            return False, False
        if state == "failed":
            if (job.get("exhausted")
                    or int(job["attempts"]) >= int(job["max_attempts"])):
                return False, False
            return self._clock() >= float(job.get("next_retry_ts", 0.0)), False
        if state in ("leased", "running"):
            return True, True  # only wins if the owner's lease went stale
        return state == "pending", False

    def claim(self, worker_id: str, ttl: float,
              heartbeat_path: str = "") -> Optional[Dict]:
        """First claimable job (sorted id order) whose lease this worker
        wins; the job is committed to `leased` under this worker's name.
        None when nothing is currently claimable."""
        for job_id in self.job_ids():
            job = self.read_job(job_id)
            if job is None:
                continue
            ok, is_reclaim = self.claimable(job)
            if not ok:
                continue
            if not self.try_claim_lease(job_id, worker_id, ttl,
                                        heartbeat_path):
                continue
            # re-read under the lease: the owner commits `done` before it
            # releases its lease, so a job.json read before that commit
            # is stale once the lease is ours (the JAX package's queue
            # would run such a job twice)
            job = self.read_job(job_id)
            if job is None or self.claimable(job) != (ok, is_reclaim):
                self.release_lease(job_id, worker_id)
                continue
            fields = {"state": "leased", "worker": worker_id}
            if self.metrics is not None:
                self.metrics.counter(
                    "farm_jobs_claimed_total",
                    help="lease claims won by this worker").inc()
            if is_reclaim:
                fields["reclaims"] = int(job.get("reclaims", 0)) + 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "farm_jobs_reclaimed_total",
                        help="claims that took over a stale lease").inc()
            return self._commit(job, **fields)
        return None
