"""Deterministic baseline serialization.

Copy of `dump_baseline` and its number normalization from
`dorpatch_tpu.analysis.baseline`: sorted keys, whole floats as ints, the
rest rounded to 6 decimals, one trailing newline. The re-certification
baseline (`recert/robustness_baseline.json`) is written through it, so
an update twice is byte-identical, and the port's file is byte-equal to
the JAX package's for the same measurements. The program-baseline tier
(DP300-DP304) is not ported yet.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


def _normalize_numbers(x):
    """Floats that are whole numbers become ints; the rest round to 6
    decimals, so regeneration diffs never churn on float repr noise."""
    if isinstance(x, dict):
        return {k: _normalize_numbers(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_normalize_numbers(v) for v in x]
    if isinstance(x, float):
        if x != x or x in (float("inf"), float("-inf")):
            return str(x)
        if abs(x) < 1e15 and float(x).is_integer():
            return int(x)
        return round(x, 6)
    return x


def dump_baseline(data: Mapping[str, Any]) -> str:
    """Deterministic serialization: sorted keys, normalized numbers, one
    trailing newline."""
    return json.dumps(_normalize_numbers(dict(data)), sort_keys=True,
                      indent=1) + "\n"
