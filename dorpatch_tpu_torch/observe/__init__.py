"""Observability core of the port: run telemetry of the main path, the
sweep and farm, and the serving layer.

Port of `dorpatch_tpu.observe`, with the same file names, record schemas,
metric names and JSON keys, so the port's report (`python -m
dorpatch_tpu_torch.observe.report`, `report.py`, not imported here) and
the JAX package's readers (`python -m dorpatch_tpu.observe.report`,
`tools/loadgen.py --expect-metrics`) read the port's results directories:

- `run.json`               — run manifest (`manifest.py`): resolved config,
  torch/CUDA versions, device kind and count, hostname, git SHA,
  per-attempt run_id.
- `events.jsonl`           — span/event log (`events.EventLog`): nested
  spans, first-call (`compile`) durations, point events.
- `heartbeat_<proc>.jsonl` — heartbeats (`heartbeat.Heartbeat`);
  `heartbeat.Watchdog` aborts a wedged run.
- `metrics.json`           — the metric registry's snapshot
  (`metrics.MetricRegistry`), also served as `GET /metrics`.
- `metrics.jsonl`          — the attack's per-block metrics
  (`attack_log.AttackMetricsLogger`).

`StepTimer`/`trace`/`capture_profile`/`init_profiler` (`timing.py`,
`torch.profiler`) and `console.log` round out the surface.
"""

from dorpatch_tpu_torch.observe.attack_log import (  # noqa: F401
    METRIC_NAMES,
    AttackMetricsLogger,
)
from dorpatch_tpu_torch.observe.console import (  # noqa: F401
    elapsed,
    log,
    process_index,
    set_process_index,
)
from dorpatch_tpu_torch.observe.events import (  # noqa: F401
    EventLog,
    RecompileBudgetExceeded,
    RecompileWatchdog,
    active,
    active_event_log,
    active_in_thread,
    aot_resolver,
    device_memory_stats,
    entrypoint_recorder,
    events_filename,
    record_compile,
    record_event,
    recompile_guard,
    set_aot_resolver,
    set_entrypoint_recorder,
    set_recompile_guard,
    span,
    timed_first_call,
)
from dorpatch_tpu_torch.observe.heartbeat import (  # noqa: F401
    Heartbeat,
    Watchdog,
    heartbeat_filename,
    heartbeat_gaps,
    last_beat,
    last_beat_ts,
    read_heartbeats,
    summarize_heartbeats,
)
from dorpatch_tpu_torch.observe.manifest import (  # noqa: F401
    new_run_id,
    new_trace_id,
    run_manifest,
    torch_environment,
    write_run_manifest,
)
from dorpatch_tpu_torch.observe.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    labeled_values,
    parse_exposition,
)
from dorpatch_tpu_torch.observe.timing import (  # noqa: F401
    StepTimer,
    capture_profile,
    init_profiler,
    nearest_rank_percentile,
    trace,
)

__all__ = [
    "AttackMetricsLogger",
    "Counter",
    "EventLog",
    "Gauge",
    "Heartbeat",
    "Histogram",
    "METRIC_NAMES",
    "MetricRegistry",
    "RecompileBudgetExceeded",
    "RecompileWatchdog",
    "StepTimer",
    "Watchdog",
    "active",
    "active_event_log",
    "active_in_thread",
    "capture_profile",
    "device_memory_stats",
    "elapsed",
    "events_filename",
    "heartbeat_filename",
    "heartbeat_gaps",
    "init_profiler",
    "aot_resolver",
    "labeled_values",
    "last_beat",
    "last_beat_ts",
    "log",
    "nearest_rank_percentile",
    "new_run_id",
    "new_trace_id",
    "parse_exposition",
    "process_index",
    "read_heartbeats",
    "record_compile",
    "record_event",
    "recompile_guard",
    "entrypoint_recorder",
    "run_manifest",
    "set_aot_resolver",
    "set_entrypoint_recorder",
    "set_process_index",
    "set_recompile_guard",
    "span",
    "summarize_heartbeats",
    "timed_first_call",
    "torch_environment",
    "trace",
    "write_run_manifest",
]
