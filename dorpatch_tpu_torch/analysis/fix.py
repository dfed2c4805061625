"""Mechanical fixer for DP106 (unused import), the one rule flagged
`fixable` — `python -m dorpatch_tpu_torch.analysis --fix [--diff]`.

Port of `dorpatch_tpu.analysis.fix`, byte-equal in behaviour. The fixer
re-runs the DP106 rule itself (so `# noqa` suppressions, `__all__`
re-exports, and string-annotation uses are honored exactly as the lint
gate honors them), maps each finding back to its import statement, and
rewrites the statement keeping only the used aliases — dropping the whole
statement when nothing survives. Regenerated statements are canonical
single-line imports (parenthesized and wrapped when they would exceed 79
columns); comments inside a rewritten statement are not preserved, since a
comment naming dropped imports would be stale anyway. A statement that
shares a physical line with any other statement (`import os; x = 1`) is
left alone rather than risk clobbering its neighbor.

Fixing is idempotent by construction: the second pass re-lints the
rewritten source, finds zero DP106 findings, and changes nothing.
"""

from __future__ import annotations

import ast
import difflib
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

from dorpatch_tpu_torch.analysis.engine import (
    analyze_source,
    iter_python_files,
)

_BOUND_RE = re.compile(r"\(bound as '([^']+)'\)")


def _bound_name(message: str) -> Optional[str]:
    m = _BOUND_RE.search(message)
    return m.group(1) if m else None


def _alias_text(alias: ast.alias) -> str:
    return f"{alias.name} as {alias.asname}" if alias.asname else alias.name


def _regenerate(node: Union[ast.Import, ast.ImportFrom],
                keep: List[ast.alias], indent: str) -> str:
    names = ", ".join(_alias_text(a) for a in keep)
    if isinstance(node, ast.Import):
        line = f"{indent}import {names}"
    else:
        module = "." * node.level + (node.module or "")
        line = f"{indent}from {module} import {names}"
    if len(line) <= 79:
        return line + "\n"
    # wrap: one alias per line inside parentheses (ImportFrom only; a plain
    # `import` this long is vanishingly rare and stays on one line)
    if isinstance(node, ast.ImportFrom):
        module = "." * node.level + (node.module or "")
        body = "".join(f"{indent}    {_alias_text(a)},\n" for a in keep)
        return f"{indent}from {module} import (\n{body}{indent})\n"
    return line + "\n"


def fix_source(source: str, path: str = "<string>",
               logical_path: Optional[str] = None) -> Tuple[str, int]:
    """Remove DP106-flagged imports from `source`; returns
    `(fixed_source, n_removed)`. The input comes back unchanged (and 0)
    when there is nothing to fix — including when it does not parse."""
    findings = analyze_source(source, path, logical_path, select=["DP106"])
    findings = [f for f in findings if f.rule_id == "DP106"]
    if not findings:
        return source, 0
    tree = ast.parse(source, filename=path)

    # finding line -> bound names to drop there
    drop: Dict[int, Set[str]] = {}
    for f in findings:
        name = _bound_name(f.message)
        if name:
            drop.setdefault(f.line, set()).add(name)

    # each import statement owns the line span [lineno, end_lineno]; a span
    # shared with any OTHER statement (semicolon compounds) is untouchable
    stmts = [n for n in ast.walk(tree) if isinstance(n, ast.stmt)]
    # statement -> the block body list that owns it, so a whole-statement
    # removal that would EMPTY an indented block leaves `pass` behind
    # (deleting the sole statement of `def f():` writes invalid Python)
    owner: Dict[int, Tuple[ast.AST, list]] = {}
    for container in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(container, field, None)
            if isinstance(block, list):
                for s in block:
                    if isinstance(s, ast.stmt):
                        owner[id(s)] = (container, block)

    lines = source.splitlines(keepends=True)
    n_removed = 0
    edits: List[Tuple[int, int, str, ast.stmt]] = []
    emptied: List[ast.stmt] = []  # whole-statement removals
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        names = drop.get(node.lineno)
        if not names:
            continue
        span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
        # another statement starting inside this span = a semicolon compound
        # (`import os; x = 1`) or a one-line suite (`if x: import os`) —
        # line surgery would clobber the neighbor, so leave the finding
        if any(other is not node and other.lineno in span
               for other in stmts):
            continue
        keep = [a for a in node.names
                if (a.asname or a.name.split(".")[0]) not in names]
        n_removed += len(node.names) - len(keep)
        first = lines[node.lineno - 1]
        indent = first[:len(first) - len(first.lstrip())]
        text = _regenerate(node, keep, indent) if keep else ""
        if not keep:
            emptied.append(node)
        edits.append((node.lineno - 1, (node.end_lineno or node.lineno),
                      text, node))

    # a block whose every statement is being removed gets one `pass` (an
    # empty MODULE is legal, an empty indented suite is a SyntaxError)
    removed_ids = {id(n) for n in emptied}
    needs_pass: set = set()
    for node in emptied:
        container, block = owner.get(id(node), (None, []))
        if container is None or isinstance(container, ast.Module):
            continue
        if all(id(s) in removed_ids for s in block):
            needs_pass.add(id(min(block, key=lambda s: s.lineno)))
    final: List[Tuple[int, int, str]] = []
    for start, end, text, node in edits:
        if not text and id(node) in needs_pass:
            first = lines[start]
            indent = first[:len(first) - len(first.lstrip())]
            text = f"{indent}pass\n"
        final.append((start, end, text))

    for start, end, text in sorted(final, reverse=True):
        lines[start:end] = [text] if text else []
    return "".join(lines), n_removed


def fix_file(path: Union[str, pathlib.Path], write: bool = True,
             logical_path: Optional[str] = None) -> Tuple[int, str]:
    """Fix one file; returns `(n_removed, unified_diff)`. Writes back only
    when `write` and something changed."""
    p = pathlib.Path(path)
    source = p.read_text(encoding="utf-8")
    fixed, n = fix_source(source, str(p), logical_path)
    if n == 0:
        return 0, ""
    diff = "".join(difflib.unified_diff(
        source.splitlines(keepends=True), fixed.splitlines(keepends=True),
        fromfile=str(p), tofile=f"{p} (fixed)"))
    if write:
        p.write_text(fixed, encoding="utf-8")
    return n, diff


def fix_paths(paths: Iterable[Union[str, pathlib.Path]],
              write: bool = True) -> Tuple[int, int, List[str]]:
    """Fix every python file under `paths`; returns
    `(files_changed, imports_removed, diffs)`."""
    files = 0
    total = 0
    diffs: List[str] = []
    for f in iter_python_files(paths):
        n, diff = fix_file(f, write=write)
        if n:
            files += 1
            total += n
            diffs.append(diff)
    return files, total, diffs
