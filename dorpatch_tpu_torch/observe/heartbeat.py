"""Heartbeats + hang watchdog.

Port of `dorpatch_tpu.observe.heartbeat`, the same file format:

- `Heartbeat` — a daemon thread appending `{ts, seq, phase}` beats to
  `heartbeat_<proc>.jsonl` (the serve pool's replicas beat by hand, at
  batch boundaries and idle wakeups, see `serve/pool.py`). A thread wedged
  inside a device call does not stop a daemon's beats; what stops changing
  is the `phase` (the event log's current span path).
- `Watchdog` — when the process's EventLog has written nothing for longer
  than the timeout (heartbeats do not count as progress), it prints the
  last-known phase of every process from the heartbeat files and aborts
  (`os._exit`) instead of hanging forever.

`read_heartbeats` / `heartbeat_gaps` / `summarize_heartbeats` / `last_beat`
are the offline readers.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Callable, Dict, IO, List, Optional

from dorpatch_tpu_torch.observe import console


def heartbeat_filename(process_index: int = 0) -> str:
    return f"heartbeat_{process_index}.jsonl"


class Heartbeat:
    """Daemon-thread JSONL heartbeat; context manager starts/stops it."""

    def __init__(self, path: Optional[str],
                 get_phase: Optional[Callable[[], str]] = None,
                 interval: float = 5.0, process_index: int = 0,
                 run_id: str = "", clock=time.time,
                 extra: Optional[Callable[[], Dict]] = None):
        self.path = path
        self.interval = max(float(interval), 0.01)
        self.process_index = process_index
        self.run_id = run_id
        self._get_phase = get_phase
        # `extra` folds a caller dict into every beat (live counters a
        # reader can show without waiting for the run to finish)
        self._get_extra = extra
        self._clock = clock
        self._seq = 0  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wedged = False
        self._fh: Optional[IO[str]] = None  # guarded-by: self._lock
        if path:
            try:
                os.makedirs(os.path.dirname(os.path.abspath(path)),
                            exist_ok=True)
                self._fh = open(path, "a", buffering=1)
            except OSError:
                self._fh = None

    def beat(self, phase: Optional[str] = None) -> dict:
        if phase is None:
            phase = self._get_phase() if self._get_phase is not None else ""
        extra = {}
        if self._get_extra is not None:
            try:
                extra = dict(self._get_extra())
            except Exception:
                extra = {}  # a broken producer must not stop the beats
        with self._lock:
            rec = {"ts": round(self._clock(), 3), "seq": self._seq,
                   "phase": phase, "proc": self.process_index,
                   "pid": os.getpid()}
            for key, value in extra.items():
                rec.setdefault(str(key), value)
            if self.run_id:
                rec["run_id"] = self.run_id
            self._seq += 1
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec) + "\n")
                except OSError:
                    # disk full mid-run: stop persisting, keep beating (the
                    # thread must not die with an unlogged exception)
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
        return rec

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self.beat()  # first beat immediately: short runs still leave one
            self._thread = threading.Thread(
                target=self._loop, name="dorpatch-heartbeat", daemon=True)
            self._thread.start()
        return self

    def wedge(self) -> None:
        """Stop beating WITHOUT the final `exit` beat — the file freezes at
        the last ordinary beat, exactly what a process stuck inside a device
        call (or SIGSTOP'd) looks like from the outside. Chaos/test hook
        (`wedge_heartbeat`): the serve supervisor's wedge detection is
        driven by beat staleness, so wedging a live replica exercises it
        without killing the process that injects the fault."""
        self._wedged = True  # close() must not append the exit beat either
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 1.0)
            self._thread = None

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 1.0)
            self._thread = None
        if self._fh is not None:
            if not self._wedged:
                # outside the lock: beat() takes the same non-reentrant lock
                self.beat(phase="exit")  # clean shutdown visible post-mortem
            with self._lock:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


# ---------------- offline readers (shared with the report CLI) ----------------


def read_heartbeats(result_dir: str) -> Dict[str, List[dict]]:
    """{heartbeat filename: [beats...]} for every process's file, bad lines
    skipped (a beat truncated by an abort must not kill the post-mortem)."""
    out: Dict[str, List[dict]] = {}
    for path in sorted(glob.glob(os.path.join(result_dir, "heartbeat_*.jsonl"))):
        beats = []
        try:
            # errors="replace": a beat truncated mid-multibyte-char (SIGKILL
            # between write syscalls) must not raise UnicodeDecodeError; the
            # mangled line then fails json parsing and is skipped like any
            # other partial line.
            with open(path, errors="replace") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        beats.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
        out[os.path.basename(path)] = beats
    return out


def last_beat(path: str) -> Optional[dict]:
    """The newest parseable beat RECORD in ONE heartbeat file, or None
    when the file is missing/empty/unreadable.

    A liveness reader: a process is alive exactly while its heartbeat file
    keeps advancing, so the reader must be cheap (tail read, not a full
    parse) and must tolerate a final line truncated by the very crash it
    is there to detect. Callers that care about liveness under wall-clock
    skew should prefer the monotonic ``seq`` field over ``ts``."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - 8192))
            tail = fh.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
            float(rec["ts"])  # a beat without a parseable ts is torn
        except (ValueError, KeyError, TypeError):
            continue
        return rec
    return None


def last_beat_ts(path: str) -> Optional[float]:
    """Timestamp of the newest parseable beat (see `last_beat`)."""
    rec = last_beat(path)
    return None if rec is None else float(rec["ts"])


def heartbeat_gaps(beats: List[dict]) -> List[float]:
    """Gaps (seconds) between consecutive beats of the SAME attempt —
    run_id changes are resume boundaries, not stalls."""
    gaps = []
    prev = None
    for b in beats:
        if prev is not None and b.get("run_id") == prev.get("run_id"):
            gaps.append(float(b["ts"]) - float(prev["ts"]))
        prev = b
    return gaps


def summarize_heartbeats(result_dir: str, stall_factor: float = 5.0,
                         min_gap: float = 1.0) -> List[dict]:
    """Per-process stall summary: a gap is a stall when it exceeds both
    `stall_factor` x the median beat interval and `min_gap` seconds."""
    rows = []
    for fname, beats in read_heartbeats(result_dir).items():
        if not beats:
            rows.append({"file": fname, "beats": 0})
            continue
        gaps = heartbeat_gaps(beats)
        med = sorted(gaps)[len(gaps) // 2] if gaps else 0.0
        max_gap = max(gaps) if gaps else 0.0
        last = beats[-1]
        rows.append({
            "file": fname,
            "proc": last.get("proc"),
            "beats": len(beats),
            "last_phase": last.get("phase", ""),
            "last_ts": last.get("ts"),
            "clean_exit": last.get("phase") == "exit",
            "median_gap_s": round(med, 3),
            "max_gap_s": round(max_gap, 3),
            "stalled": bool(gaps) and max_gap > max(stall_factor * med,
                                                    min_gap),
        })
    return rows


class Watchdog:
    """Abort a wedged run instead of hanging forever (`--hang-timeout`).

    Progress signal: the EventLog's `seconds_since_activity()` — any record
    written (span edge, block boundary, compile) resets it. On expiry the
    watchdog prints every process's last-known phase from the heartbeat
    files, then calls `on_abort` (default `os._exit(2)`, because the main
    thread is presumed stuck inside a device call that no exception can
    reach)."""

    def __init__(self, result_dir: str, event_log, timeout_s: float,
                 interval: Optional[float] = None,
                 on_abort: Optional[Callable[[], None]] = None,
                 echo=console.log, clock=time.time):
        self.result_dir = result_dir
        self.event_log = event_log
        self.timeout_s = float(timeout_s)
        self.interval = (interval if interval is not None
                         else max(min(self.timeout_s / 4.0, 5.0), 0.05))
        self._on_abort = on_abort if on_abort is not None else (
            lambda: os._exit(2))
        self._echo = echo
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self) -> bool:
        """One poll; fires (and returns True) when the timeout has expired."""
        idle = self.event_log.seconds_since_activity()
        if idle <= self.timeout_s:
            return False
        self.fire(idle)
        return True

    def fire(self, idle: float) -> None:
        import sys

        echo = self._echo
        echo(f"WATCHDOG: no telemetry progress for {idle:.1f}s "
             f"(--hang-timeout {self.timeout_s:g}s); "
             "last-known phase per process:", file=sys.stderr)
        now = self._clock()
        beats_by_file = read_heartbeats(self.result_dir)
        if not beats_by_file:
            echo("  (no heartbeat files found)", file=sys.stderr)
        for fname, beats in beats_by_file.items():
            if not beats:
                echo(f"  {fname}: empty", file=sys.stderr)
                continue
            last = beats[-1]
            echo(f"  {fname}: phase={last.get('phase', '')!r} "
                 f"last beat {now - float(last['ts']):.1f}s ago "
                 f"(seq {last.get('seq')})", file=sys.stderr)
        echo("aborting (a hung collective cannot be unwound in-process)",
             file=sys.stderr)
        self._on_abort()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if self.check():
                return

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="dorpatch-watchdog", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
