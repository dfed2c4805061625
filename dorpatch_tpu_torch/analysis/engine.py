"""AST rule engine: file contexts, the rule registry, noqa suppressions.

Port of `dorpatch_tpu.analysis.engine`, over the port's sources. Rules are
small `ast.NodeVisitor`-style classes registered under stable `DPxxx` IDs
(the JAX package's IDs, each with its torch reading in `rules_torch.py`);
a file is parsed once into a `FileContext` (tree, import-alias map,
per-line suppressions) and every rule runs over the shared context. The
engine is stdlib-only (ast + tokenize): linting imports no torch.

Suppression syntax (flake8-compatible):

    g = utils.generator(0, dev)  # noqa: DP104 — a fixed seed is the point
    from foo import bar          # noqa          (blanket: all rules)
    from foo import baz          # noqa: F401    (alias for DP106)

Codes are matched per finding line; unknown codes are ignored. `F401` is
accepted as an alias for DP106 so existing re-export annotations keep
working.

Path scoping: rules that are scoped to the package (DP101, DP107, DP108,
DP5xx) or exempt certain locations (DP104) decide from the *logical* path —
normally the scanned path itself, but overridable via `analyze_file(...,
logical_path=...)` so tests can exercise path-scoped rules on fixture
files living elsewhere. When the path contains a `dorpatch_tpu_torch`
component, only the components AFTER it are scope-significant — a checkout
under e.g. `/data/tests/repo/` must not disable rules for the whole
package.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import pathlib
import re
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Union

#: The package component path scoping anchors on.
PACKAGE = "dorpatch_tpu_torch"

#: Sentinel for a blanket `# noqa` (suppresses every rule on the line).
ALL_CODES = "ALL"

#: Codes accepted as aliases for our stable IDs (flake8 compatibility).
CODE_ALIASES = {"F401": "DP106"}

_NOQA_RE = re.compile(r"#\s*noqa\b(?P<codes>\s*:[^#]*)?", re.IGNORECASE)
# case-insensitive like flake8: `# noqa: dp104` suppresses DP104; it does
# NOT degrade to a blanket suppression of every rule on the line
_CODE_RE = re.compile(r"\b[A-Za-z]{1,3}\d{3}\b")


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
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}{tail}"


def _parse_noqa(source: str) -> Dict[int, Union[str, Set[str]]]:
    """line -> ALL_CODES (blanket) or the set of suppressed rule IDs."""
    out: Dict[int, Union[str, Set[str]]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for line, text in comments:
        m = _NOQA_RE.search(text)
        if not m:
            continue
        codes_part = m.group("codes")
        if not codes_part:
            out[line] = ALL_CODES
            continue
        codes = {CODE_ALIASES.get(c.upper(), c.upper())
                 for c in _CODE_RE.findall(codes_part)}
        # `# noqa:` with no parseable code degrades to a blanket suppression
        # (matching flake8), rather than silently suppressing nothing
        out[line] = codes or ALL_CODES
    return out


def _import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> fully dotted module path, for resolving call targets.

    `import numpy as np` -> {"np": "numpy"}; `import torch.nn.functional
    as F` -> {"F": "torch.nn.functional"}; `from torch import cuda` ->
    {"cuda": "torch.cuda"}. Relative imports are left unresolved (their
    targets are in-package, never torch/numpy).
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(node: ast.AST) -> Optional[str]:
    """`torch.cuda.synchronize` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class FileContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, path: str, source: str,
                 logical_path: Optional[str] = None):
        self.path = path
        self.source = source
        self.logical_path = logical_path or path
        self.parts = tuple(pathlib.PurePath(self.logical_path).parts)
        # scope decisions ignore everything up to (and including) the LAST
        # package component: an absolute checkout prefix that happens to
        # contain `tests`/`observe` must not flip path-scoped rules
        if PACKAGE in self.parts:
            last = len(self.parts) - 1 - self.parts[::-1].index(PACKAGE)
            self.scoped_parts = self.parts[last + 1:]
        else:
            self.scoped_parts = self.parts
        self.tree = ast.parse(source, filename=path)
        self.noqa = _parse_noqa(source)
        self.aliases = _import_aliases(self.tree)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Fully-qualified dotted name of a call target, through the file's
        import aliases: with `import torch.nn.functional as F`, the node for
        `F.conv2d` resolves to "torch.nn.functional.conv2d"."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        full = self.aliases.get(head)
        if full is None:
            return name
        return f"{full}.{rest}" if rest else full

    def in_package(self) -> bool:
        """True when the logical path lies inside the port's package.

        Scoped: a CHECKOUT directory that happens to be named like the
        package must not pull the repo-level siblings (`tools/`, `tests/`)
        into package scope."""
        if PACKAGE not in self.parts:
            return False
        return bool(self.scoped_parts) and \
            self.scoped_parts[0] not in ("tools", "tests")

    def in_observe(self) -> bool:
        """True inside the package's observe/ subpackage (checkout-prefix
        directories named `observe` don't count — see scoped_parts)."""
        return "observe" in self.scoped_parts

    def in_tests(self) -> bool:
        """True for test-tree files (path under a `tests` component after
        any package prefix)."""
        return "tests" in self.scoped_parts

    def suppressed(self, line: int, rule_id: str) -> bool:
        codes = self.noqa.get(line)
        if codes is None:
            return False
        return codes == ALL_CODES or rule_id in codes


class Rule:
    """Base class: subclasses set the class attributes and implement
    `check`, usually by running an `ast.NodeVisitor` over `ctx.tree`."""

    id: str = ""
    name: str = ""
    description: str = ""
    fixable: bool = False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str) -> Finding:
        return Finding(path=ctx.path, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0) + 1,
                       rule_id=self.id, message=message, fixable=self.fixable)


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and register a rule under its stable ID."""
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls()
    return cls


def all_rules() -> List[Rule]:
    _ensure_rules_loaded()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    _ensure_rules_loaded()
    return _REGISTRY[rule_id]


def _ensure_rules_loaded() -> None:
    # Rule modules self-register on import; importing here (not at module
    # top) keeps engine importable from the rule modules themselves.
    from dorpatch_tpu_torch.analysis import (  # noqa: F401
        concurrency, rules_output, rules_torch)


def analyze_source(source: str, path: str = "<string>",
                   logical_path: Optional[str] = None,
                   select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run (selected) rules over one source blob; suppressions applied.

    A file that does not parse yields a single DP000 finding — a syntax
    error must fail the lint gate loudly, not vanish."""
    try:
        ctx = FileContext(path, source, logical_path)
    except SyntaxError as e:
        return [Finding(path=path, line=e.lineno or 1, col=(e.offset or 0) + 1,
                        rule_id="DP000", message=f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for rule in all_rules():
        if select is not None and rule.id not in select:
            continue
        for f in rule.check(ctx):
            if not ctx.suppressed(f.line, f.rule_id):
                findings.append(f)
    return sorted(findings)


def analyze_file(path: Union[str, pathlib.Path],
                 logical_path: Optional[str] = None,
                 select: Optional[Sequence[str]] = None) -> List[Finding]:
    p = pathlib.Path(path)
    # explicit utf-8: the gate must not depend on the runner's locale
    # (LANG=C would decode as ASCII and crash on any non-ASCII comment)
    return analyze_source(p.read_text(encoding="utf-8"), str(p),
                          logical_path, select)


def iter_python_files(paths: Iterable[Union[str, pathlib.Path]]) -> Iterator[pathlib.Path]:
    """Expand files/directories into a sorted stream of .py files
    (skipping __pycache__ and hidden directories)."""
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                # "." / ".." path components are navigation, not hidden dirs
                if any(part == "__pycache__"
                       or (part.startswith(".") and part not in (".", ".."))
                       for part in f.parts):
                    continue
                yield f
        else:
            yield p


def analyze_paths(paths: Iterable[Union[str, pathlib.Path]],
                  select: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(analyze_file(f, select=select))
    return findings
