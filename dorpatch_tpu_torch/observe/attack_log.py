"""Structured attack metrics: the JSONL sink for `DorPatch.on_block_end`.

Port of `dorpatch_tpu.observe.attack_log`, the same record keys. The
attack's on-device [8]-metrics vector is read once at every block boundary
and appended as one JSONL record (one file per experiment, under the
results dir), with an optional console mirror of the reference's periodic
loss line. Logging costs one [8]-vector copy to the host per block, not
per step.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

import numpy as np

# Layout of `TrainState.metrics` (see `attack.DorPatch._step`).
METRIC_NAMES = (
    "loss",         # total per-image objective, batch mean
    "loss_adv",     # CW margin over sampled masks, mean
    "loss_struc",   # structural TV ratio, mean
    "group_lasso",  # stage-0 group-lasso, mean
    "density",      # stage-0 density variance, mean
    "masked_acc",   # fraction of masked EOT samples predicted as state.y
    "l2",           # ||delta||_2 batch mean
    "n_failed",     # failure-set size (masks the attack currently loses to)
)


class AttackMetricsLogger:
    """JSONL metrics sink for `DorPatch.on_block_end`.

    Each record: `{"ts": ..., "batch": ..., "stage": 0|1, "step": ...,
    "stopped": ..., <METRIC_NAMES>...}`, plus `"run_id"` when one is given.
    The file opens in append mode so resumed runs accumulate; the run_id
    stamp tells the attempts apart. Use as
    `attack.on_block_end = logger.on_block_end` (optionally after
    `logger.set_batch(i)`), or chain from an existing callback.
    """

    def __init__(self, path: Optional[str] = None, echo_every: int = 0,
                 clock=time.time, run_id: str = ""):
        self.path = path
        self.echo_every = echo_every
        self.run_id = run_id
        self._clock = clock
        self._batch = 0
        self._fh: Optional[IO[str]] = None
        self.history = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def set_batch(self, batch_id: int) -> None:
        self._batch = batch_id

    def on_block_end(self, stage: int, step: int, info: dict) -> None:
        vals = np.asarray(info["metrics"], dtype=np.float64)
        rec = {
            "ts": round(self._clock(), 3),
            "batch": self._batch,
            "stage": int(stage),
            "step": int(step),
            "stopped": bool(info.get("stopped", False)),
        }
        if self.run_id:
            rec["run_id"] = self.run_id
        rec.update({k: float(v) for k, v in zip(METRIC_NAMES, vals)})
        self.history.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo_every and (step % self.echo_every == 0 or rec["stopped"]):
            from dorpatch_tpu_torch.observe.console import log

            log(f"[batch {self._batch} stage {stage} iter {step}] "
                f"loss {rec['loss']:.4f} (adv {rec['loss_adv']:.4f}, "
                f"struct {rec['loss_struc']:.4f}, gl {rec['group_lasso']:.5f}, "
                f"density {rec['density']:.5f}) l2 {rec['l2']:.2f} "
                f"masked-acc {rec['masked_acc']:.2f} "
                f"failures {rec['n_failed']:.0f}")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
