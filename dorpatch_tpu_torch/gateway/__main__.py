"""`python -m dorpatch_tpu_torch.gateway` — front a serve fleet until
interrupted.

Reuses the experiment CLI surface (`dorpatch_tpu_torch.cli.build_parser`): the
`--gateway-*` group names the backends and tunes membership/routing/
deploy knobs; `--chaos wedge_probe,poison_canary` arms the gateway-side
fault injection (dorpatch_tpu_torch.chaos) for recovery drills. Telemetry
lands in `<results_root>/gateway/` (run.json + events.jsonl +
metrics.json); render it together with the backends' dirs via
`python -m dorpatch_tpu_torch.observe.report --fleet <dirs...>`.

The gateway process never imports torch: it boots in milliseconds and
routes certified-inference traffic with sockets and JSON only.

    python -m dorpatch_tpu_torch.gateway --gateway-backends \
        http://127.0.0.1:8701,http://127.0.0.1:8702 --gateway-port 8800 \
        --results-root "$TMPDIR"/fleet
"""

from __future__ import annotations

import os
import time

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.gateway.http import GatewayFrontend
from dorpatch_tpu_torch.gateway.service import Gateway


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.gateway.backends:
        raise SystemExit("gateway: --gateway-backends is required "
                         "(comma-joined http://host:port list)")
    result_dir = os.path.join(cfg.results_root, "gateway")
    gateway = Gateway(cfg.gateway, result_dir=result_dir)
    with gateway:
        with GatewayFrontend(gateway, cfg.gateway.host, cfg.gateway.port):
            observe.log(
                f"gateway: fronting {len(cfg.gateway.backends)} backend(s) "
                f"{list(cfg.gateway.backends)} — probe every "
                f"{cfg.gateway.probe_interval_s:g}s, eject after "
                f"{cfg.gateway.fail_threshold}, re-admit after "
                f"{cfg.gateway.ok_threshold}"
                + (f", chaos [{cfg.gateway.chaos}]"
                   if cfg.gateway.chaos else ""))
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                observe.log("gateway: shutting down")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
