"""`python -m dorpatch_tpu_torch.serve` — stand up the certified-inference
service over the configured victim and serve HTTP until interrupted.

Reuses the port's CLI (`dorpatch_tpu_torch.cli.build_parser`): model,
dataset, defense and `--device` flags select what is served (on "cuda"
unless `--device cpu` is given), the `--serve-*` group sizes the
micro-batcher, replica pool and front-end; `--chaos wedge_dispatch,...`
arms the serve faults (`dorpatch_tpu_torch.chaos`) against replica 0;
`--recert-dir DIR --require-recert strict|warn` gates the boot on the
recert verdict in DIR (a strict refusal exits before any model is built).
Telemetry lands in `<results_root>/serve/` (run.json, events.jsonl,
metrics.json at a clean stop); render it with
`python -m dorpatch_tpu_torch.observe.report <results_root>/serve`.

    python -m dorpatch_tpu_torch.serve --synthetic --dataset imagenet \\
        --base_arch resnetv2 --img-size 224 --serve-replicas 2 \\
        --serve-max-batch 8 --serve-deadline-ms 60000
    python tools/loadgen.py --url http://127.0.0.1:8700 --requests 24 \\
        --concurrency 8 --img-size 224 --deadline-ms 60000 --expect-metrics

SIGINT (Ctrl-C) stops it cleanly: the queue drains, metrics.json is
written, and the process exits 0.
"""

from __future__ import annotations

import time

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.serve.http import HttpFrontend
from dorpatch_tpu_torch.serve.service import CertifiedInferenceService


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    service = CertifiedInferenceService.from_config(cfg)
    with service:
        observe.log(
            f"serve: warm ({service.trace_counts()}) — "
            f"device {service.device}, "
            f"replicas {cfg.serve.replicas}, "
            f"buckets {list(service.bucket_sizes)}, "
            f"queue depth {service.batcher.max_queue_depth}, "
            f"deadline {cfg.serve.deadline_ms:g} ms"
            + (f", chaos [{cfg.serve.chaos}]" if cfg.serve.chaos else ""))
        with HttpFrontend(service, cfg.serve.host, cfg.serve.port):
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                observe.log("serve: shutting down")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
