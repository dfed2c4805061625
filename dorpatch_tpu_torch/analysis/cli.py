"""The finding stream of the analysis CLIs.

Copy of `emit` from `dorpatch_tpu.analysis.cli` for the `human` format
(one `path:line:col: DPxxx message` line per finding) and the `json`
format (one JSON object per line), the two that
`python -m dorpatch_tpu_torch.recert` offers. SARIF waits for the rule
tables of the analysis wings.
"""

from __future__ import annotations

import json
import sys
from typing import List

from dorpatch_tpu_torch.analysis.engine import Finding


def emit(findings: List[Finding], fmt: str, out=None) -> None:
    out = out if out is not None else sys.stdout
    if fmt not in ("human", "json"):
        raise ValueError(f"finding format must be human|json, got {fmt!r}")
    for f in findings:
        if fmt == "json":
            out.write(json.dumps(
                {"rule": f.rule_id, "path": f.path, "line": f.line,
                 "col": f.col, "message": f.message,
                 "fixable": f.fixable}) + "\n")
        else:
            out.write(f.render() + "\n")
