"""Signal-only autoscaling: recommendations, never actions.

The gateway cannot start or stop serve processes (that is an operator's
or an orchestrator's job), so this module emits SIGNALS an external
scaler can act on: a typed `gateway.autoscale` event into the gateway's
events.jsonl plus gauges in the metric registry, derived from fleet
occupancy and reject rate over a sliding window.

Policy (deliberately boring — the value is in the plumbing, not the
controller):

- scale **up** when mean occupancy over the window exceeds
  `autoscale_high_occupancy`, or the mean reject rate exceeds
  `autoscale_high_reject` (the fleet is shedding load);
- scale **down** when mean occupancy sits below
  `autoscale_low_occupancy` AND nothing was rejected in the window;
- otherwise steady.

A cooldown (`autoscale_cooldown_s`, on the monotonic clock)
separates consecutive recommendations so a noisy boundary cannot spam
the event log; the gauges update every cycle regardless.

All state is confined to the registry's prober thread (`observe()` is
called from the probe cycle only), so the class needs no lock.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional


class Autoscaler:
    def __init__(self, cfg, metrics, emit: Callable[..., None]):
        self._cfg = cfg
        self._metrics = metrics
        self._emit = emit  # emit(event_name, **attrs) -> events.jsonl
        self._window = collections.deque()  # (t_mono, occupancy, reject)
        self._last_fired = float("-inf")
        self._events = metrics.counter(
            "gateway_autoscale_events_total",
            help="scale recommendations emitted, by direction")
        self._reco = metrics.gauge(
            "gateway_autoscale_recommendation",
            help="current recommendation: 1 scale-up, -1 scale-down, "
                 "0 steady")
        self._occ = metrics.gauge(
            "gateway_fleet_occupancy_mean",
            help="fleet mean occupancy over the autoscale window")
        self._rej = metrics.gauge(
            "gateway_fleet_reject_rate_mean",
            help="fleet mean reject rate over the autoscale window")

    def observe(self, occupancy: float, reject_rate: float,
                routable: int) -> Optional[str]:
        """Fold one probe cycle's fleet means in; returns the direction
        (\"up\"/\"down\") when a recommendation fired this cycle."""
        cfg = self._cfg
        now = time.monotonic()
        self._window.append((now, float(occupancy), float(reject_rate)))
        horizon = now - cfg.autoscale_window_s
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()
        n = len(self._window)
        mean_occ = sum(o for _, o, _ in self._window) / n
        mean_rej = sum(r for _, _, r in self._window) / n
        self._occ.set(mean_occ)
        self._rej.set(mean_rej)
        if (mean_occ > cfg.autoscale_high_occupancy
                or mean_rej > cfg.autoscale_high_reject):
            direction = "up"
        elif mean_occ < cfg.autoscale_low_occupancy and mean_rej == 0.0:
            direction = "down"
        else:
            direction = "steady"
        self._reco.set({"up": 1.0, "down": -1.0}.get(direction, 0.0))
        if direction == "steady":
            return None
        if now - self._last_fired < cfg.autoscale_cooldown_s:
            return None
        self._last_fired = now
        self._events.inc(direction=direction)
        self._emit("gateway.autoscale", direction=direction,
                   occupancy=round(mean_occ, 4),
                   reject_rate=round(mean_rej, 4), routable=int(routable),
                   window_s=float(cfg.autoscale_window_s),
                   samples=n)
        return direction
