"""`Finding`: one rule offense at a location.

Copy of `dorpatch_tpu.analysis.engine.Finding` (frozen, ordered, the same
`render`), so findings sort and print identically in both packages. The
AST rule engine around it is not ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule offense at a source location."""

    path: str
    line: int
    col: int
    rule_id: str
    message: str
    fixable: bool = False

    def render(self) -> str:
        tail = "  [fixable]" if self.fixable else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule_id} "
                f"{self.message}{tail}")
