"""Horizontal serve fleet: a stdlib-only gateway over N serve processes.

The serve package scales *vertically* (a replica pool inside one
process, one card); this package scales *horizontally*: each backend is
a whole `python -m dorpatch_tpu_torch.serve` process (its own device,
its own weights, its own telemetry dir) and the gateway is a separate,
deliberately torch-free process that routes `POST /predict` across
them.

    gateway = Gateway(cfg.gateway, result_dir=...)
    with gateway, GatewayFrontend(gateway, port=cfg.gateway.port):
        ...                      # or: python -m dorpatch_tpu_torch.gateway

Pieces (one module each):

- `membership.py` — probe-driven roster: joining → healthy ⇄ degraded →
  ejected → (re-admission hysteresis) → joining; `draining` for deploys.
- `router.py`     — power-of-two-choices dispatch, connection-failure
  retry on an untouched backend, typed fleet `Overloaded` admission.
- `deploy.py`     — canary-gated rolling deploys with automatic rollback
  on DP305/DP400 findings or a failing robustness verdict.
- `autoscale.py`  — signal-only scale recommendations (events + gauges).
- `http.py`       — the gateway's own /predict /healthz /stats /metrics.

Telemetry follows the standard contract (events.jsonl + metrics.json in
the gateway's run dir); `observe.report --fleet` joins the gateway's
books with every backend's and the client's, checking exactly-once
accounting end to end.

Port of `dorpatch_tpu.gateway`: the same seeded generators (so the
router and the prober make the JAX gateway's picks on the same roster
and load), state machine, events, metric names and HTTP surface. It
fronts the port's `serve` processes unchanged, and importing it, or
running `python -m dorpatch_tpu_torch.gateway`, loads no torch.
"""

from dorpatch_tpu_torch.gateway.autoscale import Autoscaler  # noqa: F401
from dorpatch_tpu_torch.gateway.deploy import RollingDeploy  # noqa: F401
from dorpatch_tpu_torch.gateway.http import GatewayFrontend  # noqa: F401
from dorpatch_tpu_torch.gateway.membership import (  # noqa: F401
    Backend,
    BackendRegistry,
)
from dorpatch_tpu_torch.gateway.router import (  # noqa: F401
    FleetOverloaded,
    RouteResult,
    Router,
)
from dorpatch_tpu_torch.gateway.service import Gateway  # noqa: F401

__all__ = [
    "Autoscaler",
    "Backend",
    "BackendRegistry",
    "FleetOverloaded",
    "Gateway",
    "GatewayFrontend",
    "RollingDeploy",
    "RouteResult",
    "Router",
]
