"""The analysis pieces the port's re-certification needs.

Plain-Python copies of parts of `dorpatch_tpu.analysis`, with the same
names and output bytes:

- `engine.Finding` — one rule offense at a location (the recert rules
  DP400-DP402 report through it);
- `baseline.dump_baseline` — the deterministic baseline serialization
  (sorted keys, normalized numbers), so a re-certification baseline the
  port writes is byte-equal to the JAX package's on the same data;
- `cli.emit` — the finding stream in the `human` and `json` formats.

The AST, trace, comms, concurrency and runtime wings of the JAX
package's `analysis/` (and its SARIF output, which needs their rule
tables) are not ported yet. Nothing here imports torch.
"""

from dorpatch_tpu_torch.analysis.engine import Finding  # noqa: F401

__all__ = ["Finding"]
