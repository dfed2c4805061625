"""Canary-gated rolling deploys over the live fleet.

Two versions coexist during a deploy: the stable group keeps serving
while the canary group (freshly booted serve processes, registered via
`Gateway.add_backend` at weight 0) earns traffic in configured steps.
The versions are AOT executable stores (`aot/`): a canary is a
`python -m dorpatch_tpu_torch.serve` process booted `--aot strict` on
the new store version, so it either comes up with every program from that
store or refuses to boot. At each step the deploy

1. shifts the traffic split (`canary_steps` fraction to the canary
   group, the rest to stable) by setting per-backend weights — the
   router's weighted power-of-two sampling does the rest;
2. soaks for `canary_hold_s`;
3. evaluates every canary's `GET /robustness` verdict (plus any findings
   an injected `finding_source` reports — `python -m
   dorpatch_tpu_torch.aot verify`'s DP305 store drift, the recert gate's
   DP400 robustness-regression rule ids).

Any DP305 or DP400 finding, a failing verdict, or an unreachable
`/robustness` probe rolls the fleet BACK automatically: canaries go to
weight 0 + `draining`, stable weights are restored, and the gateway
records the typed `gateway.rollback` event + counter. Surviving every
step promotes the canary: stable drains, the canary group takes weight
1.0, and `gateway.deploy.complete` is recorded.

Chaos hook: `poison_canary` (dorpatch_tpu_torch.chaos) replaces ONE evaluation
result with a failing DP400 verdict at this module's evaluation site —
the smoke proves the rollback machinery without regressing a real model.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, List, Optional, Sequence

from dorpatch_tpu_torch.gateway.membership import DRAINING, HEALTHY

#: Rule ids that gate a deploy: DP305 = AOT store drift (`aot verify`),
#: DP400 = robustness regression (recert/gate.py vocabulary).
BLOCKING_RULES = ("DP305", "DP400")


class RollingDeploy:
    def __init__(self, gateway, canaries: Sequence[str],
                 steps: Optional[Sequence[float]] = None,
                 hold_s: Optional[float] = None,
                 finding_source: Optional[Callable[[], List[str]]] = None):
        self.gateway = gateway
        self.canaries = list(canaries)
        cfg = gateway.cfg
        self.steps = tuple(steps if steps is not None else cfg.canary_steps)
        self.hold_s = float(hold_s if hold_s is not None
                            else cfg.canary_hold_s)
        self._finding_source = finding_source
        self._wake = threading.Event()  # interruptible soak timer

    # ---------------- driving ----------------

    def run(self, warm_timeout_s: float = 60.0) -> dict:
        gw = self.gateway
        reg = gw.registry
        stable = [b.name for b in reg.backends()
                  if b.name not in self.canaries
                  and b.snapshot()["state"] != DRAINING]
        gw.emit("gateway.deploy.begin", canaries=list(self.canaries),
                stable=stable, steps=[float(s) for s in self.steps],
                hold_s=self.hold_s)
        if not self._await_canaries_healthy(warm_timeout_s):
            result = self._rollback(stable, step=0.0,
                                    reason="canary never became healthy",
                                    findings=[])
            return result
        for fraction in self.steps:
            self._set_split(stable, float(fraction))
            gw.emit("gateway.deploy.step", fraction=float(fraction),
                    canaries=list(self.canaries))
            self._wake.wait(self.hold_s)
            bad_reason, findings = self._evaluate()
            if bad_reason:
                return self._rollback(stable, step=float(fraction),
                                      reason=bad_reason, findings=findings)
        return self._promote(stable)

    def _await_canaries_healthy(self, timeout_s: float) -> bool:
        """Wait (bounded, monotonic) until every canary probed healthy —
        a canary that cannot even pass admission must never take traffic."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            snaps = {b.name: b.snapshot()
                     for b in self.gateway.registry.backends()}
            if all(snaps.get(c, {}).get("state") == HEALTHY
                   for c in self.canaries):
                return True
            self._wake.wait(0.05)
        return False

    # ---------------- traffic split ----------------

    def _set_split(self, stable: List[str], fraction: float) -> None:
        reg = self.gateway.registry
        c_w = fraction / max(1, len(self.canaries))
        s_w = (1.0 - fraction) / max(1, len(stable))
        for name in self.canaries:
            reg.set_weight(name, c_w)
        for name in stable:
            reg.set_weight(name, s_w)

    # ---------------- the canary gate ----------------

    def _evaluate(self):
        """(reason, findings) — reason is \"\" when every canary passes.
        The chaos `poison_canary` site lives here: the verdict each canary
        actually answered is passed through it before judging."""
        findings: List[str] = []
        reason = ""
        chaos = getattr(self.gateway, "chaos", None)
        for name in self.canaries:
            b = self.gateway.registry.get(name)
            if b is None:
                return f"canary {name} left the roster", findings
            verdict = self._fetch_verdict(b.url)
            if chaos is not None and verdict is not None:
                verdict = chaos.poison_canary(verdict)
            if verdict is None:
                return (f"canary {name}: /robustness unreachable", findings)
            hit = [rule for rule in BLOCKING_RULES
                   if verdict.get("findings_by_rule", {}).get(rule)]
            if self._finding_source is not None:
                extra = [f for f in self._finding_source()
                         if f.split(":", 1)[0] in BLOCKING_RULES]
                hit.extend(f.split(":", 1)[0] for f in extra)
                findings.extend(extra)
            for rule in hit:
                for msg in (verdict.get("findings_by_rule", {})
                            .get(rule, []) or [f"{rule} reported"]):
                    findings.append(f"{rule}: {msg}")
            if hit:
                reason = (f"canary {name}: blocking finding(s) "
                          f"{sorted(set(hit))}")
                return reason, findings
            if verdict.get("status") != "ok":
                return (f"canary {name}: robustness verdict "
                        f"{verdict.get('status')!r}", findings)
        return "", findings

    def _fetch_verdict(self, url: str) -> Optional[dict]:
        """The canary's robustness verdict, 200 or 503 alike (a failing
        verdict IS data — only an unreachable canary returns None)."""
        req = urllib.request.Request(
            url + "/robustness", headers={"Accept": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.gateway.cfg.probe_timeout_s) as resp:
                return self._parse(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return self._parse(e.read())
            except OSError:
                return None
        except (urllib.error.URLError, OSError):
            return None

    @staticmethod
    def _parse(raw: bytes) -> Optional[dict]:
        try:
            payload = json.loads(raw or b"{}")
        except ValueError:
            return None
        return payload if isinstance(payload, dict) else None

    # ---------------- outcomes ----------------

    def _rollback(self, stable: List[str], step: float, reason: str,
                  findings: List[str]) -> dict:
        reg = self.gateway.registry
        for name in self.canaries:
            reg.set_weight(name, 0.0)
            reg.set_state(name, DRAINING, reason="deploy rollback")
        for name in stable:
            reg.set_weight(name, 1.0)
        self.gateway.record_rollback(reason, self.canaries, step, findings)
        return {"outcome": "rolled_back", "reason": reason,
                "step": step, "findings": findings,
                "canaries": list(self.canaries), "stable": stable}

    def _promote(self, stable: List[str]) -> dict:
        reg = self.gateway.registry
        for name in self.canaries:
            reg.set_weight(name, 1.0)
        for name in stable:
            reg.set_weight(name, 0.0)
            reg.set_state(name, DRAINING, reason="deploy promoted")
        self.gateway.emit("gateway.deploy.complete",
                          canaries=list(self.canaries), stable=stable,
                          steps=[float(s) for s in self.steps])
        return {"outcome": "promoted", "canaries": list(self.canaries),
                "stable": stable}
