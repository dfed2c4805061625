"""Load-aware request dispatch: power-of-two-choices, exactly-once.

Candidate selection never scans the fleet for the global minimum — it
weighted-samples TWO distinct routable backends (weights come from the
rolling deploy's traffic split) and dispatches to the less loaded of the
two (`Backend.score`: scraped occupancy + reject pressure + the
gateway's own inflight view). Power-of-two-choices gets within a
constant factor of the global scan's load balance without herding every
concurrent request onto the same momentarily-idle backend.

Failure semantics are the heart of the exactly-once story:

- **connection-level failures** (refused, reset, remote hung up before a
  status line) mean the backend never resolved the request — the router
  retries on a backend the request has NOT yet touched, up to
  `dispatch_retries` times.
- **anything with an HTTP status** — including 4xx/5xx — is an ANSWER:
  the backend admitted the request, so it is passed through verbatim and
  never re-dispatched (a retry could double-answer).
- **timeouts are never retried**: a timed-out backend may still be
  working on the request, and re-dispatching it would double-dispatch an
  admitted request. The caller gets a typed `deadline_exceeded`.

When no routable backend has a free inflight slot the router answers a
typed `FleetOverloaded` (503) — admission control, not queueing: the
gateway holds no queue of its own, backpressure lives in each backend's
bounded micro-batcher queue.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import urllib.error
import urllib.request
from typing import List, Optional, Tuple

from dorpatch_tpu_torch.gateway.membership import (ROUTABLE_STATES, Backend,
                                             BackendRegistry)

#: Exception types that prove the request never reached a resolving
#: backend (safe to re-dispatch). A timeout is deliberately absent.
_CONNECTION_ERRORS = (ConnectionRefusedError, ConnectionResetError,
                      ConnectionAbortedError, BrokenPipeError,
                      http.client.RemoteDisconnected,
                      http.client.BadStatusLine)


@dataclasses.dataclass(frozen=True)
class FleetOverloaded:
    """Typed admission reject: every routable backend is saturated (or
    none is routable). Mirrors the serve-side `Overloaded` contract —
    clients back off and retry; nothing was dispatched anywhere."""

    status = "overloaded"
    routable: int
    backends: int
    inflight_cap: int

    def to_dict(self) -> dict:
        return {"status": self.status, "scope": "fleet",
                "routable": self.routable, "backends": self.backends,
                "inflight_cap": self.inflight_cap}


@dataclasses.dataclass(frozen=True)
class RouteResult:
    """One routed request's outcome: the HTTP code + JSON payload to
    relay, which backend answered (\"\" for gateway-local rejects), and
    the re-dispatch trail for attribution."""

    code: int
    payload: dict
    backend: str
    retries: int
    attempted: Tuple[str, ...]


class Router:
    def __init__(self, registry: BackendRegistry, cfg):
        self._registry = registry
        self._cfg = cfg
        self._lock = threading.Lock()
        # weighted-choice source; its draws are the only state the router
        # owns, guarded because every handler thread routes through here
        self._rng = random.Random(0x90A7E)  # guarded-by: self._lock

    # ---------------- selection ----------------

    def _pick(self, candidates: List[Backend]) -> List[Backend]:
        """Up to two distinct candidates, weighted-sampled by deploy
        weight, ordered best-score-first (the power-of-two comparison)."""
        snaps = [(b, max(0.0, b.snapshot()["weight"])) for b in candidates]
        snaps = [(b, w) for b, w in snaps if w > 0.0]
        if not snaps:
            return []
        if len(snaps) == 1:
            return [snaps[0][0]]
        with self._lock:
            first = self._weighted_draw(snaps)
            rest = [(b, w) for b, w in snaps if b is not first]
            second = self._weighted_draw(rest)
        cap = self._cfg.inflight_cap
        pair = sorted((first, second), key=lambda b: b.score(cap))
        return pair

    def _weighted_draw(self, snaps: List[Tuple[Backend, float]]) -> Backend:
        total = sum(w for _, w in snaps)
        x = self._rng.random() * total
        for b, w in snaps:
            x -= w
            if x <= 0.0:
                return b
        return snaps[-1][0]

    def _reserve(self, exclude: List[str]) -> Optional[Backend]:
        """Pick and atomically reserve an inflight slot on a backend the
        request has not touched. The post-pick fallback over the remaining
        candidates only covers the reservation race (a slot vanishing
        between snapshot and reserve) — selection itself stays O(2)."""
        candidates = [b for b in self._registry.routable()
                      if b.name not in exclude]
        cap = self._cfg.inflight_cap
        pair = self._pick(candidates)
        for b in pair:
            if b.begin_dispatch(cap):
                return b
        for b in candidates:
            if b not in pair and b.begin_dispatch(cap):
                return b
        return None

    # ---------------- dispatch ----------------

    def route(self, body: bytes, trace_id: str) -> RouteResult:
        cfg = self._cfg
        attempted: List[str] = []
        last_err = ""
        while len(attempted) < cfg.dispatch_retries + 1:
            b = self._reserve(attempted)
            if b is None:
                break
            attempted.append(b.name)
            try:
                outcome = self._post(b, body, trace_id)
            finally:
                b.end_dispatch()
            code, payload, conn_failed, err = outcome
            if not conn_failed:
                return RouteResult(code, payload, b.name,
                                   retries=len(attempted) - 1,
                                   attempted=tuple(attempted))
            last_err = err
        if not attempted:
            snaps = [b.snapshot() for b in self._registry.backends()]
            routable = sum(1 for s in snaps
                           if s["state"] in ROUTABLE_STATES
                           and s["weight"] > 0.0)
            reject = FleetOverloaded(routable=routable, backends=len(snaps),
                                     inflight_cap=cfg.inflight_cap)
            return RouteResult(503, reject.to_dict(), "", retries=0,
                               attempted=())
        # connection failures exhausted every retry (or the fleet): the
        # request was never resolved anywhere, so an internal_error is
        # honest — nothing to double-answer
        payload = {"status": "internal_error",
                   "reason": f"no backend completed the request "
                             f"(connection failures on "
                             f"{', '.join(attempted)}): {last_err}"}
        return RouteResult(500, payload, "", retries=len(attempted) - 1,
                           attempted=tuple(attempted))

    def _post(self, b: Backend, body: bytes, trace_id: str
              ) -> Tuple[int, dict, bool, str]:
        """(code, payload, connection_failed, error). Runs outside every
        lock; the inflight slot is held by the caller."""
        req = urllib.request.Request(
            b.url + "/predict", data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "X-Trace-Id": trace_id})
        try:
            with urllib.request.urlopen(
                    req, timeout=self._cfg.dispatch_timeout_s) as resp:
                return (resp.status,
                        self._parse(resp.read()), False, "")
        except urllib.error.HTTPError as e:
            # an answered non-2xx (overloaded/deadline/error): relay it
            try:
                payload = self._parse(e.read())
            except OSError:
                payload = {"status": "error",
                           "reason": f"backend answered http {e.code}"}
            return e.code, payload, False, ""
        except _CONNECTION_ERRORS as e:
            return 0, {}, True, f"{type(e).__name__}: {e}"
        except TimeoutError as e:
            return (504, {"status": "deadline_exceeded",
                          "reason": "backend dispatch timed out "
                                    "(not retried: the backend may still "
                                    "answer)",
                          "backend": b.name}, False, str(e))
        except urllib.error.URLError as e:
            reason = getattr(e, "reason", None)
            if isinstance(reason, _CONNECTION_ERRORS):
                return 0, {}, True, f"{type(reason).__name__}: {reason}"
            if isinstance(reason, TimeoutError):
                return (504, {"status": "deadline_exceeded",
                              "reason": "backend dispatch timed out "
                                        "(not retried: the backend may "
                                        "still answer)",
                              "backend": b.name}, False, str(reason))
            # unresolvable host / closed socket family: never admitted
            return 0, {}, True, f"URLError: {reason}"

    @staticmethod
    def _parse(raw: bytes) -> dict:
        try:
            payload = json.loads(raw or b"{}")
        except ValueError:
            return {"status": "error", "reason": "backend sent non-JSON"}
        if not isinstance(payload, dict):
            return {"status": "error", "reason": "backend sent non-object"}
        return payload
