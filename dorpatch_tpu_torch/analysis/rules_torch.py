"""Torch-aware rules: the torch readings of the JAX package's DP102-DP105,
DP107 and DP108 (`dorpatch_tpu.analysis.rules_jax`), under their IDs.

Each rule keeps its JAX ID, name and intent; what it looks for is read
for eager PyTorch:

- **DP102 host-sync-in-program.** JAX: a host sync inside a `jax.jit`
  body. Here a program is a function wrapped by `observe.timed_first_call`
  (passed to it by name, as `self.<method>` or as a lambda in the same
  file); inside its body `.item()`, `.cpu()`, `.tolist()`, `.numpy()`,
  `float(t)`/`int(t)`/`bool(t)` on a non-static value, or
  `torch.cuda.synchronize()` waits for the card and stalls the launch
  queue the program exists to keep full. Intraprocedural: a callee's sync
  is not seen.
- **DP103 global-generator-draw.** JAX: the same key fed to two
  `jax.random` draws. Torch has no keys: the reproducibility hazard is a
  draw from torch's process-global generator — `torch.rand*`/`randn*`/
  `randint*`/`randperm`/`normal`/`bernoulli`/`multinomial`/`poisson`
  without `generator=`, or an in-place draw (`.uniform_()`,
  `.normal_()`, ...) without one — inside the package, where every draw
  takes a seeded `torch.Generator` (`utils.generator`) so a run repeats.
- **DP104 literal-seed.** JAX: `PRNGKey(<int>)`. Here `manual_seed(<int>)`
  or `utils.generator(<int>, ...)` outside the package-root `utils.py` and
  the tests: seeds flow from the config.
- **DP105 unwrapped-compiled-program.** JAX: a `jax.jit` not wrapped by
  `observe.timed_first_call`. Here a `torch.compile`, `torch.jit.script`/
  `trace` or `torch.cuda.make_graphed_callables` program, or a
  `torch.cuda.graph` capture, whose result does not reach
  `timed_first_call`: its build time is invisible to the telemetry and the
  recompile watchdog.
- **DP107 serve-host-sync.** JAX: `.item()`/`device_get`/
  `block_until_ready`/`np.asarray` in `serve/` outside `marshal_response`.
  Here `.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `.synchronize()` (a
  stream's, an event's or `torch.cuda.synchronize`) and `numpy.asarray`/
  `numpy.array` in `serve/` outside the one sanctioned marshal point,
  `serve.service.marshal_response`.
- **DP108 adhoc-counter-state.** Unchanged: `self.x += ...` in `serve/`
  and `farm/` is counter state outside `observe.metrics`.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from dorpatch_tpu_torch.analysis.engine import (FileContext, Finding, Rule,
                                                register)

#: tensor methods that wait for the card and copy to the host
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
#: torch's draws, in the namespace `torch`, that take `generator=`
_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
          "randint_like", "normal", "bernoulli", "multinomial", "poisson"}
#: in-place tensor draws that take `generator=`
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}
#: calls that build a compiled or captured program
_COMPILE_TARGETS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                    "torch.cuda.make_graphed_callables", "torch.cuda.graph"}


def _parent_map(tree: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def _is_timer(ctx: FileContext, node: ast.AST) -> bool:
    target = ctx.resolve(node)
    return bool(target) and target.split(".")[-1] == "timed_first_call"


def _program_functions(ctx: FileContext) -> List[ast.AST]:
    """Function/lambda nodes wrapped by `timed_first_call` in this file: a
    def passed by name, a method passed as `self.<name>`, or a lambda."""
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    out: List[ast.AST] = []
    seen: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and _is_timer(ctx, node.func)
                and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Lambda):
            found = [arg]
        elif isinstance(arg, ast.Name):
            found = defs.get(arg.id, [])
        elif (isinstance(arg, ast.Attribute)
              and isinstance(arg.value, ast.Name) and arg.value.id == "self"):
            found = defs.get(arg.attr, [])
        else:
            found = []
        for fn in found:
            if id(fn) not in seen:
                seen.add(id(fn))
                out.append(fn)
    return out


def _mentions_static_attr(node: ast.AST) -> bool:
    """Heuristic: expressions over `.shape`/`.ndim`/`.dtype`, `.size()`,
    `.numel()`, `.dim()` or `len()` are host values — `int(x.shape[0])`
    syncs nothing."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "dtype", "size", "numel", "dim"):
            return True
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "len"):
            return True
    return False


def _sync_offense(ctx: FileContext, node: ast.AST) -> Optional[str]:
    """What host sync `node` is (DP102's kinds), or None."""
    if not isinstance(node, ast.Call):
        return None
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS and not node.args:
        return f".{node.func.attr}() waits for the card and copies to the host"
    if ctx.resolve(node.func) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize() waits for the card"
    if (isinstance(node.func, ast.Name)
            and node.func.id in ("float", "int", "bool")
            and len(node.args) == 1):
        arg = node.args[0]
        if isinstance(arg, ast.Constant) or _mentions_static_attr(arg):
            return None
        return (f"{node.func.id}() on a (likely) tensor value waits for the "
                "card")
    return None


@register
class HostSyncInProgramRule(Rule):
    id = "DP102"
    name = "host-sync-in-program"
    description = ("host-synchronizing call (.item()/.cpu()/.tolist()/"
                   ".numpy()/float()/int()/bool() of a tensor, "
                   "torch.cuda.synchronize) inside a program wrapped by "
                   "observe.timed_first_call")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        emitted: Set[Tuple[int, int, str]] = set()
        for fn in _program_functions(ctx):
            for node in ast.walk(fn):
                msg = _sync_offense(ctx, node)
                if msg is None:
                    continue
                key = (node.lineno, node.col_offset, msg)
                if key in emitted:
                    continue
                emitted.add(key)
                yield self.finding(
                    ctx, node, msg + " inside a timed_first_call program — "
                    "the launch queue drains on every call")


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register
class GlobalGeneratorDrawRule(Rule):
    id = "DP103"
    name = "global-generator-draw"
    description = ("torch draw without generator= inside the package — it "
                   "consumes the process-global generator, so a run no "
                   "longer repeats from its seed")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_package():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or _has_generator(node):
                continue
            target = ctx.resolve(node.func) or ""
            head, _, tail = target.rpartition(".")
            if head == "torch" and tail in _DRAWS:
                what = target
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_DRAWS):
                what = f".{node.func.attr}"
            else:
                continue
            yield self.finding(
                ctx, node,
                f"{what}() draws from torch's global generator — pass "
                "generator= (a seeded utils.generator) so the draw repeats")


@register
class LiteralSeedRule(Rule):
    id = "DP104"
    name = "literal-seed"
    description = ("literal manual_seed(<int>) / utils.generator(<int>) "
                   "outside utils.py/tests — seeds must flow from config.py "
                   "(via utils.generator)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.in_tests():
            return
        # only the package-root utils.py (home of `generator`) may seed
        # with a literal — not any file named utils.py deeper in the tree
        if ctx.scoped_parts == ("utils.py",):
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, int)
                    and not isinstance(node.args[0].value, bool)):
                continue
            target = ctx.resolve(node.func) or ""
            tail = target.rpartition(".")[2]
            if tail == "manual_seed" or target in (
                    "utils.generator", "dorpatch_tpu_torch.utils.generator"):
                yield self.finding(
                    ctx, node,
                    f"hard-coded seed {tail}({node.args[0].value!r}) — "
                    "derive it from the config seed (utils.generator)")


@register
class UnwrappedProgramRule(Rule):
    id = "DP105"
    name = "unwrapped-compiled-program"
    description = ("torch.compile / torch.jit / CUDA-graph program not "
                   "wrapped by observe.timed_first_call — its build time is "
                   "invisible to the telemetry layer and the recompile "
                   "watchdog")

    _MSG = ("{} program not wrapped by observe.timed_first_call (the "
            "telemetry contract: a program's build wall time must land in "
            "events.jsonl)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        parents = _parent_map(ctx.tree)
        wrapped_names: Set[str] = set()
        wrapped_nodes: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call) and _is_timer(ctx, node.func)
                    and node.args):
                arg = node.args[0]
                if isinstance(arg, ast.Name):
                    wrapped_names.add(arg.id)
                else:
                    wrapped_nodes.add(id(arg))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.resolve(node.func)
            if target not in _COMPILE_TARGETS or id(node) in wrapped_nodes:
                continue
            parent = parents.get(id(node))
            bound = None
            if (isinstance(parent, ast.Assign) and parent.value is node
                    and len(parent.targets) == 1
                    and isinstance(parent.targets[0], ast.Name)):
                bound = parent.targets[0].id
            if bound is not None and bound in wrapped_names:
                continue
            if (isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node in parent.decorator_list
                    and parent.name in wrapped_names):
                continue
            yield self.finding(ctx, node, self._MSG.format(target))
        # decorator form: @torch.compile / @torch.jit.script
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call):
                    continue  # the call form, covered above
                target = ctx.resolve(dec)
                if target in _COMPILE_TARGETS \
                        and node.name not in wrapped_names:
                    yield self.finding(ctx, dec, self._MSG.format(target))


@register
class ServeHostSyncRule(Rule):
    id = "DP107"
    name = "serve-host-sync"
    description = ("blocking host sync (.item()/.cpu()/.tolist()/.numpy()/"
                   ".synchronize()/np.asarray) inside serve/ outside the "
                   "designated response-marshalling function")

    #: The ONE function in serve/ allowed to synchronize device results to
    #: the host (`serve.service.marshal_response`). Everything else in the
    #: worker-loop path must stay launch-only, or every batch stalls the
    #: pipeline mid-flight and the micro-batcher serializes.
    MARSHAL_FUNCTION = "marshal_response"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_package() or "serve" not in ctx.scoped_parts:
            return
        for node in self._own_nodes(ctx.tree):
            msg = self._offense(ctx, node)
            if msg is not None:
                yield self.finding(ctx, node, msg)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == self.MARSHAL_FUNCTION:
                continue
            for node in self._own_nodes(fn):
                msg = self._offense(ctx, node)
                if msg is not None:
                    yield self.finding(ctx, node, msg)

    @staticmethod
    def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
        """Walk a function body WITHOUT descending into nested defs (each
        nested def is visited — and possibly exempted — on its own)."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _offense(self, ctx: FileContext, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        tail = (f" — only {self.MARSHAL_FUNCTION}() may sync to the host "
                "in serve/")
        target = ctx.resolve(node.func)
        if target == "torch.cuda.synchronize":
            return "torch.cuda.synchronize() stalls the dispatch pipeline" \
                + tail
        if isinstance(node.func, ast.Attribute) and not node.args:
            attr = node.func.attr
            if attr in _SYNC_METHODS:
                return (f".{attr}() blocks the serving worker on a device "
                        "round-trip" + tail)
            if attr == "synchronize":
                return ".synchronize() stalls the dispatch pipeline" + tail
        if target in ("numpy.asarray", "numpy.array"):
            # blocking when fed a device tensor; host-data parsing that
            # needs it carries a reasoned `# noqa: DP107`
            return (f"{target}() materializes a device tensor on the host "
                    "when fed one" + tail)
        return None


@register
class AdHocCounterRule(Rule):
    id = "DP108"
    name = "adhoc-counter-state"
    description = ("hand-rolled counter/gauge mutation in serve//farm/ "
                   "outside observe.metrics — accounting the /metrics "
                   "exposition and the fleet cross-check cannot see")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_package():
            return
        if not {"serve", "farm"} & set(ctx.scoped_parts):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.AugAssign):
                continue
            if not isinstance(node.op, (ast.Add, ast.Sub)):
                continue
            spelled = self._attr_target(node.target)
            if spelled is None:
                continue
            yield self.finding(
                ctx, node,
                f"`{spelled} {'+=' if isinstance(node.op, ast.Add) else '-='}"
                f" ...` is counter state outside the metric registry — "
                f"route it through observe.metrics (MetricRegistry.counter/"
                f"gauge) so /metrics, /stats and the report CLI read one "
                f"set of books, or mark genuine control state with a "
                f"reasoned `# noqa: DP108`")

    @staticmethod
    def _attr_target(target: ast.AST) -> Optional[str]:
        """The flagged spelling for attribute-state mutations: `x.attr` and
        `x.attr[key]`. Plain locals (`n += 1`) and Name-rooted subscripts
        (`counts[k] += 1` on a local dict) are loop bookkeeping, not
        published state, and stay exempt."""
        if isinstance(target, ast.Attribute):
            return f"<obj>.{target.attr}"
        if isinstance(target, ast.Subscript) \
                and isinstance(target.value, ast.Attribute):
            return f"<obj>.{target.value.attr}[...]"
        return None
