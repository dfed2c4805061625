"""Output- and hygiene-rules: DP101 (bare print) and DP106 (unused import).

Port of `dorpatch_tpu.analysis.rules_output`, with the same messages.
DP101: under several processes (the mesh's ranks, the farm's workers),
anonymous `print` output from the package interleaves unattributably —
everything routes through `observe.log()` (`[pN +T.Ts]` prefix). The rule
is scoped to modules *inside* the dorpatch_tpu_torch package, excluding
`observe/` itself (which implements the sink and the report CLI's stdout);
standalone tools and scripts outside the package may print.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set, Tuple

from dorpatch_tpu_torch.analysis.engine import FileContext, Finding, Rule, register


@register
class BarePrintRule(Rule):
    id = "DP101"
    name = "bare-print"
    description = ("bare print() inside the dorpatch_tpu_torch package "
                   "(outside observe/) — route output through observe.log() "
                   "so multi-process logs stay attributable")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_package() or ctx.in_observe():
            return
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                yield self.finding(
                    ctx, node,
                    "bare print() call — use observe.log() so multi-process "
                    "output stays attributable")


def _all_exports(tree: ast.AST) -> Set[str]:
    """Names listed in `__all__` (string constants in list/tuple/set
    assignments and `__all__ +=` augmentations)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        target = None
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            target = node.value
        elif (isinstance(node, ast.AugAssign)
              and isinstance(node.target, ast.Name)
              and node.target.id == "__all__"):
            target = node.value
        if isinstance(target, (ast.List, ast.Tuple, ast.Set)):
            for elt in target.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    names.add(elt.value)
    return names


def _string_annotation_names(tree: ast.AST) -> Set[str]:
    """Names referenced inside explicitly quoted annotations
    (`def f(x: "np.ndarray")`, `y: "List[int]" = ...`)."""
    ann: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            ann.extend(a.annotation for a in
                       args.posonlyargs + args.args + args.kwonlyargs)
            ann.extend([args.vararg and args.vararg.annotation,
                        args.kwarg and args.kwarg.annotation,
                        node.returns])
        elif isinstance(node, (ast.AnnAssign, ast.arg)):
            ann.append(node.annotation)
    names: Set[str] = set()
    for a in ann:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            try:
                parsed = ast.parse(a.value, mode="eval")
            except SyntaxError:
                continue
            names |= {n.id for n in ast.walk(parsed)
                      if isinstance(n, ast.Name)}
    return names


@register
class UnusedImportRule(Rule):
    id = "DP106"
    name = "unused-import"
    fixable = True
    description = ("imported name is never used (names in __all__ and "
                   "explicit `import x as x` re-exports are considered used)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        imported: List[Tuple[str, ast.AST, str]] = []  # (name, node, shown)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    # `import a.b.c` binds `a`; `import a.b.c as d` binds `d`
                    bound = a.asname or a.name.split(".")[0]
                    if a.asname is not None and a.asname == a.name:
                        continue  # `import x as x`: explicit re-export
                    imported.append((bound, node, a.name))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    if a.asname is not None and a.asname == a.name:
                        continue  # `from m import x as x`: re-export
                    imported.append((a.asname or a.name, node,
                                     f"{node.module or '.'}.{a.name}"))
        if not imported:
            return

        used: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
        # unquoted annotations (incl. under `from __future__ import
        # annotations`) are real AST nodes and already counted above;
        # explicitly QUOTED ones (`x: "np.ndarray"`) are string constants
        # and need parsing so their imports count as used
        used |= _string_annotation_names(ctx.tree)
        used |= _all_exports(ctx.tree)

        for name, node, shown in imported:
            if name not in used:
                yield self.finding(
                    ctx, node, f"unused import: {shown!r} (bound as {name!r})")
