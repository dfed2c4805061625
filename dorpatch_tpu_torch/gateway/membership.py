"""Health-probe-driven backend membership for the fleet gateway.

One `Backend` per serve process, one `BackendRegistry` owning the fleet
and a single prober thread. The prober polls every backend's `/healthz`
(+ `/stats` for load signals, + `/robustness` when configured) on a
jittered interval and drives the membership state machine:

    joining ──ok_threshold consecutive oks──▶ healthy ◀──▶ degraded
       ▲                                        │  (robustness verdict)
       │ first ok after ejection                │
       │                                        │ fail_threshold
    ejected ◀──consecutive probe failures───────┘ consecutive failures

plus `draining` — set only by the rolling deploy (`deploy.py`), never
left automatically: a draining backend takes no new traffic but keeps
being probed so its stats stay current for the report.

The hysteresis is the point: an ejected backend must first re-enter
`joining` (one good probe) and then string together `ok_threshold`
consecutive good probes before any traffic returns — a flapping backend
that alternates ok/fail never re-admits.

Lock discipline (the JAX package audits it as DP5xx): every mutable
`Backend` field is guarded by that backend's own `self.lock`; the
registry's backend list by `self._lock`. The two are NEVER nested — callers copy the list out
under the registry lock and then take per-backend locks one at a time —
and no HTTP call ever runs under any lock (probes collect their results
first, then apply them in one short critical section).
"""

from __future__ import annotations

import json
import random
import threading
import urllib.error
import urllib.request
from typing import Callable, List, Optional, Sequence, Tuple

from dorpatch_tpu_torch import observe

JOINING = "joining"
HEALTHY = "healthy"
DEGRADED = "degraded"
EJECTED = "ejected"
DRAINING = "draining"
STATES = (JOINING, HEALTHY, DEGRADED, EJECTED, DRAINING)

#: States the router may dispatch to. `degraded` (health ok, robustness
#: verdict failing) is routable only as a last resort — the router prefers
#: healthy backends and falls back to degraded ones when none remain.
ROUTABLE_STATES = (HEALTHY, DEGRADED)


def backend_name(url: str) -> str:
    """Stable display/label name for a backend URL: host:port."""
    return url.split("://", 1)[-1].rstrip("/")


class Backend:
    """One serve process behind the gateway: its URL plus the probe-fed
    view of its health and load. All mutable state lives behind
    `self.lock`; readers take a `snapshot()` instead of poking fields."""

    def __init__(self, url: str, name: str = "", weight: float = 1.0):
        self.url = url.rstrip("/")
        self.name = name or backend_name(url)
        self.lock = threading.Lock()
        self.state = JOINING        # guarded-by: self.lock
        self.consec_fail = 0        # guarded-by: self.lock
        self.consec_ok = 0          # guarded-by: self.lock
        self.weight = float(weight)  # guarded-by: self.lock
        self.inflight = 0           # guarded-by: self.lock
        self.occupancy = 0.0        # guarded-by: self.lock
        self.reject_rate = 0.0      # guarded-by: self.lock
        self.queue_depth = 0        # guarded-by: self.lock
        self.warm = False           # guarded-by: self.lock
        self.robustness_ok = True   # guarded-by: self.lock
        self.last_error = ""        # guarded-by: self.lock

    def snapshot(self) -> dict:
        with self.lock:
            return {"name": self.name, "url": self.url, "state": self.state,
                    "weight": round(self.weight, 6),
                    "inflight": self.inflight,
                    "occupancy": round(self.occupancy, 4),
                    "reject_rate": round(self.reject_rate, 4),
                    "queue_depth": self.queue_depth, "warm": self.warm,
                    "robustness_ok": self.robustness_ok,
                    "consec_fail": self.consec_fail,
                    "consec_ok": self.consec_ok,
                    "last_error": self.last_error}

    def score(self, inflight_cap: int) -> float:
        """Load score for power-of-two-choices (lower = better): scraped
        occupancy, reject pressure, and the gateway's own inflight view."""
        with self.lock:
            return (self.occupancy + 2.0 * self.reject_rate
                    + self.inflight / max(1, inflight_cap))

    def begin_dispatch(self, inflight_cap: int) -> bool:
        """Reserve an inflight slot iff the backend is routable and under
        its cap — the router's one atomic admission decision."""
        with self.lock:
            if (self.state not in ROUTABLE_STATES or self.weight <= 0.0
                    or self.inflight >= inflight_cap):
                return False
            self.inflight += 1
            return True

    def end_dispatch(self) -> None:
        with self.lock:
            self.inflight = max(0, self.inflight - 1)


class BackendRegistry:
    """The fleet roster plus its single daemon prober thread.

    `on_transition(backend_name, prev, new, reason)` fires OUTSIDE all
    locks for every membership change (the gateway wires it into its
    event log and the `gateway_membership_transitions_total` counter);
    `on_cycle(snapshots)` fires once per full probe sweep (the gateway
    feeds it to the autoscaler and the fleet gauges).
    """

    def __init__(self, backends: Sequence[Backend], cfg, chaos=None,
                 on_transition: Optional[Callable] = None,
                 on_cycle: Optional[Callable] = None):
        self._cfg = cfg
        self._chaos = chaos
        self._on_transition = on_transition
        self._on_cycle = on_cycle
        self._lock = threading.Lock()
        self._backends = list(backends)  # guarded-by: self._lock
        self._stop = threading.Event()
        # deterministic jitter source (probe-thread confined)
        self._rng = random.Random(0xD0B9A7C4)
        self._thread: Optional[threading.Thread] = None

    # ---------------- roster ----------------

    def backends(self) -> List[Backend]:
        with self._lock:
            return list(self._backends)

    def get(self, name: str) -> Optional[Backend]:
        for b in self.backends():
            if b.name == name:
                return b
        return None

    def add(self, backend: Backend) -> Backend:
        """Register a new backend (rolling deploys add canaries live). It
        enters `joining` and earns traffic through the normal probe path."""
        with self._lock:
            self._backends.append(backend)
        self._emit(backend.name, "", JOINING, "registered")
        return backend

    def set_weight(self, name: str, weight: float) -> None:
        b = self.get(name)
        if b is None:
            return
        with b.lock:
            b.weight = float(weight)

    def set_state(self, name: str, state: str, reason: str) -> None:
        """Administrative transition (the deploy's draining/restore path);
        probe-driven transitions go through `_apply_probe`."""
        if state not in STATES:
            raise ValueError(f"unknown backend state {state!r}")
        b = self.get(name)
        if b is None:
            return
        with b.lock:
            prev = b.state
            b.state = state
            if state == JOINING:
                b.consec_ok = 0
                b.consec_fail = 0
        if prev != state:
            self._emit(name, prev, state, reason)

    def routable(self) -> List[Backend]:
        """Dispatch candidates, healthy preferred: degraded backends are
        offered only when no healthy backend remains."""
        snaps = [(b, b.snapshot()) for b in self.backends()]
        healthy = [b for b, s in snaps
                   if s["state"] == HEALTHY and s["weight"] > 0.0]
        if healthy:
            return healthy
        return [b for b, s in snaps
                if s["state"] == DEGRADED and s["weight"] > 0.0]

    # ---------------- prober lifecycle ----------------

    def start(self) -> "BackendRegistry":
        self._stop.clear()
        self._thread = threading.Thread(target=self._probe_loop,
                                        name="gateway-prober", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_cycle()
            except Exception as e:  # a probe bug must never kill the fleet
                observe.log(f"gateway: probe cycle failed: {e!r}")
            jitter = 1.0 + self._cfg.probe_jitter * self._rng.random()
            self._stop.wait(self._cfg.probe_interval_s * jitter)

    def probe_cycle(self) -> None:
        """One synchronous sweep over the roster (public so tests can step
        membership deterministically without the thread)."""
        backends = self.backends()
        for i, b in enumerate(backends):
            if self._stop.is_set():
                return
            self._probe_one(i, b)
        if self._on_cycle is not None:
            self._on_cycle([b.snapshot() for b in backends])

    # ---------------- one probe ----------------

    def _probe_one(self, index: int, b: Backend) -> None:
        forced = (self._chaos is not None
                  and self._chaos.on_gateway_probe(index, b.name))
        if forced:
            ok, stats, robust_ok, err = False, None, True, "chaos: wedged probe"
        else:
            ok, stats, robust_ok, err = self._collect(b)
        transition = self._apply_probe(b, ok, stats, robust_ok, err)
        if transition is not None:
            prev, new, reason = transition
            self._emit(b.name, prev, new, reason)

    def _collect(self, b: Backend) -> Tuple[bool, Optional[dict], bool, str]:
        """All the probe's HTTP, outside every lock. A backend is probe-ok
        iff /healthz answers 200; /stats feeds the load signals (failure
        leaves them stale, not unhealthy); /robustness gates degradation."""
        health, err = self._get_json(b.url + "/healthz")
        if health is None:
            return False, None, True, err
        stats, _ = self._get_json(b.url + "/stats")
        robust_ok = True
        if getattr(self._cfg, "check_robustness", True):
            verdict, _ = self._get_json(b.url + "/robustness")
            robust_ok = verdict is not None
        return True, stats, robust_ok, ""

    def _get_json(self, url: str) -> Tuple[Optional[dict], str]:
        req = urllib.request.Request(
            url, headers={"Accept": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self._cfg.probe_timeout_s) as resp:
                return json.loads(resp.read().decode("utf-8") or "{}"), ""
        except urllib.error.HTTPError as e:
            return None, f"http {e.code}"
        except (urllib.error.URLError, OSError, ValueError) as e:
            return None, f"{type(e).__name__}: {e}"

    def _apply_probe(self, b: Backend, ok: bool, stats: Optional[dict],
                     robust_ok: bool, err: str
                     ) -> Optional[Tuple[str, str, str]]:
        """Fold one probe result into the state machine — the one short
        critical section per probe. Returns (prev, new, reason) when the
        membership state changed."""
        cfg = self._cfg
        with b.lock:
            prev = b.state
            reason = ""
            if ok:
                b.consec_ok += 1
                b.consec_fail = 0
                b.last_error = ""
                b.robustness_ok = robust_ok
                if stats is not None:
                    b.occupancy = float(stats.get("occupancy", b.occupancy))
                    b.reject_rate = float(
                        stats.get("reject_rate", b.reject_rate))
                    b.queue_depth = int(
                        stats.get("queue_depth", b.queue_depth))
                    b.warm = bool(stats.get("warm", b.warm))
                if b.state == EJECTED:
                    # re-admission hysteresis leg 1: one good probe only
                    # re-enters joining; traffic waits for ok_threshold
                    b.state = JOINING
                    b.consec_ok = 1
                    reason = "probe_ok"
                elif (b.state == JOINING
                      and b.consec_ok >= cfg.ok_threshold):
                    b.state = HEALTHY if robust_ok else DEGRADED
                    reason = "probe_ok" if robust_ok else "robustness"
                elif b.state == HEALTHY and not robust_ok:
                    b.state = DEGRADED
                    reason = "robustness"
                elif b.state == DEGRADED and robust_ok:
                    b.state = HEALTHY
                    reason = "robustness"
            else:
                b.consec_fail += 1
                b.consec_ok = 0
                b.last_error = err
                if (b.state in (JOINING, HEALTHY, DEGRADED)
                        and b.consec_fail >= cfg.fail_threshold):
                    b.state = EJECTED
                    reason = "probe_fail"
            new = b.state
        if new != prev:
            return prev, new, reason
        return None

    def _emit(self, name: str, prev: str, new: str, reason: str) -> None:
        if self._on_transition is not None:
            self._on_transition(name, prev, new, reason)
