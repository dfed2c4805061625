"""Crash-resumable recert scheduler: grid generations on the farm.

One *generation* = one (model x defense x attack) grid submitted to a
private farm directory (``<recert_dir>/gen_NNNN``), drained by ordinary
farm workers, harvested into per-cell robust-accuracy measurements, and
checked against the checked-in `robustness_baseline.json` (DP400-DP402).

Crash discipline mirrors the farm queue it drives:

- `recert_state.json` is the scheduler's only mutable state and every
  transition is one `checkpoint.atomic_write_json` — a reader never sees
  a half-written generation counter.
- The in-flight record is committed BEFORE `submit_spec`, so a SIGKILL
  anywhere in the cycle leaves either (a) an inflight record whose farm
  dir resumes exactly where the workers left it (`submit_spec` is
  idempotent — resubmission tops up missing jobs, never resets live
  ones), or (b) a completed generation whose `recert_complete.json`
  marker already landed. Resume therefore finishes the SAME generation
  instead of starting a new one.
- A torn `recert_state.json` (corrupt/truncated) is recovered by scanning
  the generation dirs themselves: each completed generation carries an
  atomic completion marker, so the dirs are the ground truth and the
  state file is merely a cache of them.

A generation *completes* even when cells are missing: `JobQueue.drained`
counts quarantined/exhausted jobs as terminal, so a farm worker
quarantined mid-grid leaves a hole that harvests as DP402 — the scheduler
reports it rather than hanging on it.

Port of `dorpatch_tpu.recert.scheduler`, the same file names, state
records, events and metrics. Host-only orchestration: nothing here
imports torch; the model stack runs inside the farm workers.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.checkpoint import atomic_write_json, load_json
from dorpatch_tpu_torch.farm.queue import FARM_NAME, JobQueue
from dorpatch_tpu_torch.farm.report import read_result_rows
from dorpatch_tpu_torch.recert import baseline as rbase

STATE_NAME = "recert_state.json"
COMPLETE_NAME = "recert_complete.json"
VERDICT_NAME = "recert_verdict.json"
GEN_PREFIX = "gen_"


class RecertError(RuntimeError):
    """Typed scheduler-level refusal (no completed generation to check,
    baseline update would drop entries without --allow-remove, ...)."""


def is_recert_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, STATE_NAME))


def _gen_number(name: str) -> Optional[int]:
    if not name.startswith(GEN_PREFIX):
        return None
    try:
        return int(name[len(GEN_PREFIX):])
    except ValueError:
        return None


class RecertScheduler:
    """All reads/writes of one recert directory's generation state."""

    def __init__(self, recert_dir: str, baseline_file: str = "",
                 clock=time.time, chaos=None):
        self.recert_dir = os.path.abspath(recert_dir)
        os.makedirs(self.recert_dir, exist_ok=True)
        self.baseline_file = baseline_file or str(rbase.baseline_path())
        self._clock = clock
        self.chaos = chaos
        # generation timing/outcome series; snapshotted to
        # <recert_dir>/metrics.json at every completion so the fleet
        # report reads recert the same way it reads serve and farm dirs
        self.metrics = observe.MetricRegistry()
        # one shared log handle, opened lazily on the first record: a fresh
        # EventLog per record would restart its seq at 0 every time, and
        # two threads recording at once (drain poller + canary gate) would
        # interleave half-open handles on the same file
        self._lock = threading.Lock()
        self._elog = None  # guarded-by: self._lock

    def _record(self, name: str, **fields) -> None:
        """Append one event to the recert dir's own events.jsonl (the
        scheduler runs outside any job's event log, but its generation
        begin/complete records must land somewhere the fleet report can
        join on trace id)."""
        with self._lock:
            if self._elog is None:
                self._elog = observe.EventLog(
                    os.path.join(self.recert_dir,
                                 observe.events_filename(0)))
            self._elog.event(name, **fields)

    # ---------------- state ----------------

    @property
    def state_path(self) -> str:
        return os.path.join(self.recert_dir, STATE_NAME)

    @property
    def verdict_path(self) -> str:
        return os.path.join(self.recert_dir, VERDICT_NAME)

    def gen_dir(self, generation: int) -> str:
        return os.path.join(self.recert_dir,
                            f"{GEN_PREFIX}{int(generation):04d}")

    def gen_numbers(self) -> List[int]:
        try:
            names = os.listdir(self.recert_dir)
        except OSError:
            return []
        out = []
        for name in names:
            g = _gen_number(name)
            if g is not None and os.path.isdir(
                    os.path.join(self.recert_dir, name)):
                out.append(g)
        return sorted(out)

    def _gen_complete(self, generation: int) -> bool:
        return os.path.exists(
            os.path.join(self.gen_dir(generation), COMPLETE_NAME))

    def load_state(self) -> Dict[str, Any]:
        """The scheduler state, recovered from the generation dirs when the
        state file is missing or torn."""
        state = load_json(self.state_path)
        if (isinstance(state, dict) and "generation" in state
                and "inflight" in state):
            return state
        return self._recover_state()

    def _recover_state(self) -> Dict[str, Any]:
        """Rebuild `recert_state.json` from the ground truth: completed
        generations have an atomic `recert_complete.json` marker; a gen dir
        holding a farm spec but no marker is the in-flight generation."""
        completed = 0
        inflight: Optional[Dict[str, Any]] = None
        for g in self.gen_numbers():
            gdir = self.gen_dir(g)
            if self._gen_complete(g):
                completed = max(completed, g)
            elif os.path.exists(os.path.join(gdir, FARM_NAME)):
                farm = load_json(os.path.join(gdir, FARM_NAME), {})
                inflight = {"generation": g,
                            "farm_dir": os.path.basename(gdir),
                            "spec": farm.get("spec", {})}
        if inflight is not None and inflight["generation"] <= completed:
            inflight = None
        state = {"version": 1, "generation": completed, "inflight": inflight}
        atomic_write_json(self.state_path, state)
        return state

    # ---------------- generations ----------------

    def begin_generation(self, spec: Optional[Dict[str, Any]] = None
                         ) -> Tuple[int, str]:
        """Start the next generation — or resume the in-flight one.

        The inflight record (including the spec) is committed to the state
        file BEFORE jobs are submitted; `submit_spec` is idempotent, so a
        crash at any point between the two leaves a resumable farm, never a
        duplicated one. Returns (generation, farm_dir)."""
        state = self.load_state()
        inflight = state.get("inflight")
        if inflight:
            generation = int(inflight["generation"])
            spec = inflight.get("spec") or spec
        else:
            if spec is None:
                raise RecertError(
                    "no in-flight generation to resume and no spec given")
            generation = int(state.get("generation", 0)) + 1
            inflight = {"generation": generation,
                        "farm_dir": f"{GEN_PREFIX}{generation:04d}",
                        "spec": spec,
                        # generation wall-clock start + the cross-process
                        # correlation id minted at THIS ingress: both ride
                        # the inflight record so a crash/resume keeps the
                        # original start and trace, not a fresh pair
                        "began_ts": round(self._clock(), 3),
                        "trace": observe.new_trace_id()}
            atomic_write_json(self.state_path, {
                "version": 1, "generation": state.get("generation", 0),
                "inflight": inflight})
            self._record("recert.generation.begin", generation=generation,
                         trace=inflight["trace"], opens_trace=True)
        farm_dir = os.path.join(self.recert_dir, inflight["farm_dir"])
        if spec is None:
            raise RecertError(
                f"in-flight generation {generation} has no recorded spec")
        JobQueue(farm_dir, clock=self._clock).submit_spec(spec)
        if self.chaos is not None:
            self.chaos.on_recert("submitted", state_path=self.state_path)
        return generation, farm_dir

    def counts(self, farm_dir: str) -> Dict[str, int]:
        return JobQueue(farm_dir, clock=self._clock).counts()

    def drained(self, farm_dir: str) -> bool:
        return JobQueue(farm_dir, clock=self._clock).drained()

    def wait_drained(self, farm_dir: str, poll_interval: float = 0.5,
                     timeout: Optional[float] = None,
                     sleep=time.sleep) -> bool:
        """Poll until every job in the generation's farm is terminal.
        Quarantined/exhausted jobs count as terminal — a generation with
        holes completes (and reports them) instead of hanging."""
        # the timeout is a local bound on OUR waiting, not a cross-process
        # protocol — monotonic, so an NTP step mid-drain cannot expire it
        # early or stretch it
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            if self.drained(farm_dir):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            sleep(poll_interval)

    # ---------------- harvest ----------------

    def harvest(self, farm_dir: str
                ) -> Tuple[Dict[str, Dict[str, Any]], List[str]]:
        """(measured, holes) for one drained generation: done jobs' rows
        become per-cell measurements; every expected cell a job failed to
        produce (quarantined, exhausted, or a torn rows file) is a hole."""
        jq = JobQueue(farm_dir, clock=self._clock)
        measured: Dict[str, Dict[str, Any]] = {}
        holes: set = set()
        for job_id in jq.job_ids():
            job = jq.read_job(job_id)
            if job is None:
                continue  # unreadable job.json: cells not even enumerable
            expected = rbase.job_cells(job)
            if job.get("state") == "done":
                seen = set()
                rows = read_result_rows(
                    os.path.join(jq.job_dir(job_id), "results"))
                for row in rows:
                    key = rbase.cell_key(job, row)
                    measured[key] = rbase.row_measurement(row, job_id)
                    seen.add(key)
                holes.update(k for k in expected if k not in seen)
            else:
                holes.update(expected)
        holes -= set(measured)  # a sibling job may have covered the cell
        return measured, sorted(holes)

    # ---------------- completion / checking ----------------

    def _write_baseline(self, data: Dict[str, Any]) -> None:
        """Deterministic text + atomic replace: the baseline file carries
        no timestamps, so an interrupted-and-resumed generation commits a
        byte-identical file to an uninterrupted one."""
        text = rbase.dump_baseline(data)
        tmp = f"{self.baseline_file}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.baseline_file)

    def complete_generation(self, generation: int, farm_dir: str,
                            update_baseline: bool = False,
                            allow: Optional[Dict[str, Dict[str, str]]] = None
                            ) -> Dict[str, Any]:
        """Harvest a drained generation, check it against the baseline,
        publish the verdict, and commit the generation as done — in that
        order, each step atomic, so a crash replays idempotently."""
        measured, holes = self.harvest(farm_dir)
        data = rbase.load_baseline(self.baseline_file)
        if update_baseline:
            data = rbase.fold_measurements(data, measured, generation)
            self._write_baseline(data)
        findings = rbase.check_measurements(
            measured, holes, data, generation,
            baseline_file=self.baseline_file, allow=allow)
        verdict = rbase.build_verdict(measured, holes, data, generation,
                                      findings,
                                      baseline_file=self.baseline_file)
        atomic_write_json(self.verdict_path, verdict)
        # generation timing + trace come off the inflight record (absent
        # after a state recovery — seconds then reads null, never wrong)
        inflight = self.load_state().get("inflight") or {}
        began_ts = inflight.get("began_ts")
        trace = inflight.get("trace", "")
        seconds = (round(self._clock() - float(began_ts), 3)
                   if began_ts is not None else None)
        marker = {
            "generation": int(generation),
            "measured": len(measured),
            "holes": holes,
            "status": verdict["status"],
        }
        if seconds is not None:
            marker["seconds"] = seconds
        if trace:
            marker["trace"] = trace
        atomic_write_json(os.path.join(farm_dir, COMPLETE_NAME), marker)
        atomic_write_json(self.state_path, {
            "version": 1, "generation": int(generation), "inflight": None})
        self.metrics.counter(
            "recert_generations_total",
            help="completed generations by verdict status",
        ).inc(status=str(verdict["status"]))
        if seconds is not None:
            self.metrics.histogram(
                "recert_generation_seconds",
                help="submit-to-verdict wall seconds per generation",
            ).observe(seconds)
        fields = {"generation": int(generation), "status": verdict["status"],
                  "measured": len(measured), "holes": len(holes)}
        if seconds is not None:
            fields["seconds"] = seconds
        if trace:
            fields["trace"] = trace
        self._record("recert.generation", **fields)
        self.metrics.dump(os.path.join(self.recert_dir, "metrics.json"))
        return verdict

    def latest_completed(self) -> Tuple[int, str]:
        """(generation, farm_dir) of the newest completed generation."""
        done = [g for g in self.gen_numbers() if self._gen_complete(g)]
        if not done:
            raise RecertError(
                f"no completed generation under {self.recert_dir} — run "
                "`python -m dorpatch_tpu_torch.recert run` first")
        g = max(done)
        return g, self.gen_dir(g)

    def check_latest(self, allow: Optional[Dict[str, Dict[str, str]]] = None,
                     select=None) -> Tuple[int, List, Dict[str, Any]]:
        """Re-harvest the newest completed generation and diff it against
        the CURRENT baseline file (which may have changed since the
        generation completed); rewrites the published verdict. Returns
        (generation, findings, verdict)."""
        generation, farm_dir = self.latest_completed()
        measured, holes = self.harvest(farm_dir)
        data = rbase.load_baseline(self.baseline_file)
        findings = rbase.check_measurements(
            measured, holes, data, generation,
            baseline_file=self.baseline_file, allow=allow, select=select)
        verdict = rbase.build_verdict(measured, holes, data, generation,
                                      findings,
                                      baseline_file=self.baseline_file)
        atomic_write_json(self.verdict_path, verdict)
        return generation, findings, verdict

    def update_from_latest(self, allow_remove: bool = False
                           ) -> Dict[str, Any]:
        """Fold the newest completed generation's measurements into the
        baseline file. Entries that are neither measured nor holes (the
        grid shrank) are only dropped under `allow_remove`; without it the
        update REFUSES rather than silently losing entries — the same
        contract `analysis --baseline update` enforces."""
        generation, farm_dir = self.latest_completed()
        measured, holes = self.harvest(farm_dir)
        data = rbase.load_baseline(self.baseline_file) \
            or rbase.empty_baseline()
        old = set(data.get("entries", {}))
        removed = sorted(old - set(measured) - set(holes))
        if removed and not allow_remove:
            raise RecertError(
                f"update would drop {len(removed)} baseline entr(ies) no "
                "longer in the grid: "
                + ", ".join(removed[:4])
                + (" ..." if len(removed) > 4 else "")
                + " — pass --allow-remove to accept the shrink")
        new = rbase.fold_measurements(data, measured, generation)
        if allow_remove and removed:
            entries = dict(new["entries"])
            for key in removed:
                entries.pop(key, None)
            new["entries"] = entries
        self._write_baseline(new)
        findings = rbase.check_measurements(
            measured, holes, new, generation,
            baseline_file=self.baseline_file)
        verdict = rbase.build_verdict(measured, holes, new, generation,
                                      findings,
                                      baseline_file=self.baseline_file)
        atomic_write_json(self.verdict_path, verdict)
        return {"generation": generation, "baseline_file": self.baseline_file,
                "entries": len(new["entries"]), "folded": len(measured),
                "removed": removed, "holes": holes,
                "status": verdict["status"]}

    # ---------------- status ----------------

    def status(self) -> Dict[str, Any]:
        state = self.load_state()
        out: Dict[str, Any] = {
            "recert_dir": self.recert_dir,
            "baseline_file": self.baseline_file,
            "generation": int(state.get("generation", 0)),
            "inflight": None,
        }
        inflight = state.get("inflight")
        if inflight:
            farm_dir = os.path.join(self.recert_dir, inflight["farm_dir"])
            out["inflight"] = {
                "generation": int(inflight["generation"]),
                "farm_dir": farm_dir,
                "counts": self.counts(farm_dir),
            }
        verdict = load_json(self.verdict_path)
        if isinstance(verdict, dict):
            out["verdict"] = {
                "generation": verdict.get("generation"),
                "status": verdict.get("status"),
                "worst_margin": verdict.get("worst_margin"),
                "findings_by_rule": verdict.get("findings_by_rule", {}),
            }
        return out
