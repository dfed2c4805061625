"""Continuous re-certification: the standing red team as a subsystem.

The paper's thesis is that certified accuracy is a moving target — a
deployment that certifies once and serves forever is exactly the failure
mode DorPatch documents. This package closes the loop the farm and the
supervised serve pool leave open:

- `scheduler`  — crash-resumable generation state machine: expands
  (model x defense x attack) grids into farm jobs, survives SIGKILL
  mid-cycle by resuming the in-flight generation, recovers a torn
  `recert_state.json` from the generation dirs themselves.
- `baseline`   — the adversarial sibling of `analysis/baselines.json`:
  checked-in per-cell robust-accuracy references with absolute
  tolerances, diffed as DP400 (regression), DP401 (grid drift), DP402
  (stale cell / unseeded baseline) through `analysis.engine.Finding`.
- `gate`       — the serve-boot gate (`--require-recert strict|warn|off`):
  strict refuses serving-ready on a failing/stale/absent verdict with a
  typed `RecertGateError`, mirroring AOT strict boot.
- `__main__`   — `python -m dorpatch_tpu_torch.recert
  schedule|run|check|update|status`.

Port of `dorpatch_tpu.recert`. Host-only throughout: importing the package
loads no torch; the model stack runs inside the farm workers the
scheduler drives, never in the scheduler itself.
"""

from dorpatch_tpu_torch.recert.baseline import (  # noqa: F401 (public surface)
    ALLOWLIST,
    RECERT_RULE_IDS,
    RECERT_RULE_ROWS,
    baseline_path,
    check_measurements,
    load_baseline,
)
from dorpatch_tpu_torch.recert.gate import (  # noqa: F401 (public surface)
    RecertGateError,
    boot_gate,
)
from dorpatch_tpu_torch.recert.scheduler import (  # noqa: F401 (public surface)
    RecertError,
    RecertScheduler,
    is_recert_dir,
)
