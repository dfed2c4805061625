"""Concurrency analysis tier: lock-discipline rules DP500-DP504.

Port of `dorpatch_tpu.analysis.concurrency` over the port's threaded
packages: `serve/` (the replica pool, the micro-batcher, the HTTP front),
`farm/` (lease contention, worker threads), `observe/` (heartbeat daemons,
the metrics registry), `recert/`, `gateway/`, `parallel/` (the process-0
store), `backoff.py` and `chaos.py`. A stdlib-only, intraprocedural AST
pass, registered in the same engine as DP1xx so findings ride the standard
`--select` / `# noqa: DP5xx` / exit-code machinery (and the default lint
gate), plus a dedicated `--concurrency` CLI mode that runs only this wing.
The rules and their messages are the JAX package's:

- **DP500 guarded-state violation** — a mutable instance attribute declares
  its lock with a trailing `# guarded-by: self._lock` comment on its
  assignment line (normally in `__init__`); any mutation of that attribute
  outside a `with self._lock:` block in any other method of the class is a
  finding. The annotation is the contract; the rule proves it.
- **DP501 lock-order cycle** — the per-class and cross-class lock
  acquisition graph is built from nested `with`-statements (lock-like
  context expressions, keyed by their final attribute name so an ABBA
  inversion across two classes still closes the cycle); any cycle is a
  potential deadlock, reported once per strongly connected component with
  the canonical (alphabetical) order in the message.
- **DP502 blocking call while holding a lock** — `time.sleep`, thread
  `join`, `socket.*`/HTTP-client/`subprocess` calls, untimed `.wait()`,
  and untimed queue `get`/`put` inside a `with <lock>` body: a telemetry
  call that blocks under the pool's lock strands every replica behind it.
- **DP503 thread-lifecycle hygiene** — a non-daemon `threading.Thread`
  with no `join` on the owning object's `stop()`/`close()` path (or, for a
  function-local thread, none in its creating function), and any thread
  `start()`ed inside `__init__` before every `guarded-by` attribute of the
  class has been assigned (the thread observes a half-built object).
- **DP504 wall-clock liveness** — a `time.time()`-derived value (including
  injected `clock=time.time` defaults and `self._clock = clock` rebinds)
  compared against a ttl/deadline/expiry/staleness bound. A stepped or
  skewed wall clock flips the liveness decision (a farm lease judged
  expired on a skewed host); liveness wants `time.monotonic()` or a
  seq-based freshness check.

All five rules are intraprocedural and deliberately conservative: locks
taken via bare `.acquire()`/`.release()` pairs, cross-file lock nesting,
and closures executed on other threads are out of scope (documented, not
guessed at).

`static_lock_graph()` exposes the DP501 acquisition graph for the runtime
wing (`analysis/lockwatch.py`), which `--sanitize` seeds with it and which
cross-checks the order actually observed against the statically proven
one.
"""

from __future__ import annotations

import ast
import fnmatch
import io
import pathlib
import re
import tokenize
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

from dorpatch_tpu_torch.analysis.engine import (FileContext, Finding, Rule,
                                                dotted_name, iter_python_files,
                                                register)

#: The wing's stable rule IDs (CLI `--concurrency` select set).
CONCURRENCY_RULE_IDS = ("DP500", "DP501", "DP502", "DP503", "DP504")

#: Logical-path glob -> {rule_id: reason}: the file-level analog of a
#: `# noqa:` comment, for files whose offense has no single ownable line
#: (as `analysis.program.ALLOWLIST`). Shipped entries must carry their
#: reason; everything else found in the shipped tree is FIXED or carries a
#: line-level `# noqa: DP5xx <reason>`.
ALLOWLIST: Dict[str, Dict[str, str]] = {}

_SCOPE_DIRS = ("serve", "farm", "observe", "recert", "gateway", "parallel")
_SCOPE_FILES = ("backoff.py", "chaos.py")

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*self\.(\w+)")
_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
    "multiprocessing.Lock", "multiprocessing.RLock",
}
_LOCKISH_RE = re.compile(r"lock|mutex|cond(?:ition)?$", re.IGNORECASE)
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "update", "add", "setdefault", "sort", "reverse", "write",
}
_LIFECYCLE_METHODS = {"stop", "close", "shutdown", "join", "terminate",
                      "wedge", "drain", "__exit__", "__del__"}
_BLOCKING_EXACT = {
    "time.sleep", "select.select", "signal.pause",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
}
_BLOCKING_PREFIXES = ("socket.", "requests.", "urllib.request.",
                      "http.client.")
_LIVENESS_RE = re.compile(
    r"ttl|deadline|expir|stale|liveness", re.IGNORECASE)
_WALL_CLOCKS = {"time.time"}


def in_concurrency_scope(ctx: FileContext) -> bool:
    """True for files in the threaded packages this tier audits."""
    if not ctx.in_package():
        return False
    sp = ctx.scoped_parts
    if not sp:
        return False
    return sp[0] in _SCOPE_DIRS or (len(sp) == 1 and sp[0] in _SCOPE_FILES)


def allowlisted(rule_id: str, logical_path: str) -> Optional[str]:
    """The ALLOWLIST reason granting `rule_id` for this file, or None."""
    path = pathlib.PurePath(logical_path).as_posix()
    for pattern, rules in ALLOWLIST.items():
        if rule_id in rules and fnmatch.fnmatch(path, pattern):
            return rules[rule_id]
    return None


# ---------------- shared AST helpers ----------------


def _guard_annotations(source: str) -> Dict[int, str]:
    """line -> lock attribute name, from `# guarded-by: self.<lock>`."""
    out: Dict[int, str] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _GUARDED_RE.search(tok.string)
            if m:
                out[tok.start[0]] = m.group(1)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def _self_attr(node: ast.AST) -> Optional[str]:
    """`x` for a `self.x` attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _guarded_attrs(cls: ast.ClassDef,
                   annotations: Dict[int, str]) -> Dict[str, str]:
    """attr -> declared lock attr, for one class's guarded-by lines."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        lock = annotations.get(node.lineno)
        if lock is None:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                out[attr] = lock
    return out


def _lock_names(ctx: FileContext) -> Set[str]:
    """Final-component names assigned from a threading lock factory."""
    names: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if not (isinstance(value, ast.Call)
                and ctx.resolve(value.func) in _LOCK_FACTORIES):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            name = dotted_name(t)
            if name:
                names.add(name.rpartition(".")[2])
    return names


def _lockish(name: str, known: Set[str]) -> bool:
    return name in known or bool(_LOCKISH_RE.search(name))


def _with_locks(stmt: Union[ast.With, ast.AsyncWith], known: Set[str]
                ) -> List[Tuple[str, str]]:
    """(key, spelling) for each lock-like context expression, in order.

    Keys are the FINAL attribute/name component so `self._lock` in class A
    and `pool._lock` in class B land on the same graph node — the only way
    an intraprocedural pass can close a cross-class ABBA cycle."""
    out: List[Tuple[str, str]] = []
    for item in stmt.items:
        spelling = dotted_name(item.context_expr)
        if spelling is None:
            continue
        key = spelling.rpartition(".")[2]
        if _lockish(key, known):
            out.append((key, spelling))
    return out


def _body_lists(stmt: ast.stmt) -> List[List[ast.stmt]]:
    """The nested statement lists of a compound statement (empty for a
    simple one)."""
    out: List[List[ast.stmt]] = []
    for field in ("body", "orelse", "finalbody"):
        val = getattr(stmt, field, None)
        if val and isinstance(val[0], ast.stmt):
            out.append(val)
    for handler in getattr(stmt, "handlers", []) or []:
        out.append(handler.body)
    for case in getattr(stmt, "cases", []) or []:
        out.append(case.body)
    return out


def _guard_exprs(stmt: ast.stmt) -> List[ast.expr]:
    """Expressions a compound statement evaluates itself (its test/iter)."""
    out: List[ast.expr] = []
    for field in ("test", "iter", "subject"):
        val = getattr(stmt, field, None)
        if isinstance(val, ast.expr):
            out.append(val)
    return out


def _walk_expr(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk minus Lambda bodies (deferred code runs on another
    thread's schedule; proving anything about it here would be a guess)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if not isinstance(child, ast.Lambda):
                stack.append(child)


def _functions(tree: ast.AST) -> Iterator[Tuple[Optional[ast.ClassDef],
                                                ast.FunctionDef]]:
    """(owning class or None, function) for every def in the module,
    including methods; nested defs are yielded with their own scope."""
    def visit(node: ast.AST, cls: Optional[ast.ClassDef]) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield cls, child
                yield from visit(child, cls)
            else:
                yield from visit(child, cls)
    yield from visit(tree, None)


def _scan_scopes(stmts: Sequence[ast.stmt], held: Tuple[str, ...],
                 known: Set[str]
                 ) -> Iterator[Tuple[ast.AST, Tuple[str, ...], bool]]:
    """Linear walk of one function body yielding (node, held-lock keys,
    is_statement). Compound statements yield their guard expressions with
    is_statement=False and recurse; nested defs are skipped (their bodies
    run under a different call's lock state)."""
    for s in stmts:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(s, (ast.With, ast.AsyncWith)):
            acquired = _with_locks(s, known)
            inner = list(held)
            for key, _ in acquired:
                if key not in inner:
                    inner.append(key)
            yield from _scan_scopes(s.body, tuple(inner), known)
            continue
        bodies = _body_lists(s)
        if bodies:
            for e in _guard_exprs(s):
                yield e, held, False
            for b in bodies:
                yield from _scan_scopes(b, held, known)
        else:
            yield s, held, True


def _mutated_attrs(node: ast.AST, is_statement: bool
                   ) -> Iterator[Tuple[str, ast.AST]]:
    """(self-attr, site) for every mutation the node performs: assignment
    / augmented assignment / deletion targeting `self.x` (or a subscript
    of it), and mutating method calls like `self.x.append(...)`."""
    targets: List[ast.expr] = []
    if is_statement:
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
    flat: List[ast.expr] = []
    while targets:
        t = targets.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            targets.extend(t.elts)
        elif isinstance(t, ast.Starred):
            targets.append(t.value)
        else:
            flat.append(t)
    for t in flat:
        attr = _self_attr(t)
        if attr is None and isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
        if attr is not None:
            yield attr, t
    for sub in _walk_expr(node):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _MUTATORS):
            attr = _self_attr(sub.func.value)
            if attr is not None:
                yield attr, sub
        # a subscript store buried in an expression statement
        # (e.g. `self.x[k] = v` handled above; `self.x[k] += 1` arrives
        # as AugAssign with a Subscript target, also handled above)


class _ConcurrencyRule(Rule):
    """Shared scope gate: DP5xx rules only audit the threaded packages."""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not in_concurrency_scope(ctx):
            return
        if allowlisted(self.id, ctx.logical_path) is not None:
            return
        yield from self._check(ctx)

    def _check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


@register
class GuardedStateRule(_ConcurrencyRule):
    id = "DP500"
    name = "guarded-state-violation"
    description = ("attribute declared `# guarded-by: self.<lock>` mutated "
                   "outside a `with self.<lock>` block")

    def _check(self, ctx: FileContext) -> Iterator[Finding]:
        annotations = _guard_annotations(ctx.source)
        if not annotations:
            return
        known = _lock_names(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            guarded = _guarded_attrs(node, annotations)
            if not guarded:
                continue
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__":
                    # construction happens-before every reader thread; the
                    # publish-a-half-built-object hazard is DP503's check
                    continue
                seen: Set[Tuple[int, int]] = set()
                for sub, held, is_stmt in _scan_scopes(fn.body, (), known):
                    for attr, site in _mutated_attrs(sub, is_stmt):
                        lock = guarded.get(attr)
                        if lock is None or lock in held:
                            continue
                        key = (site.lineno, site.col_offset)
                        if key in seen:
                            continue
                        seen.add(key)
                        yield self.finding(
                            ctx, site,
                            f"{node.name}.{attr} is declared `# guarded-by: "
                            f"self.{lock}` but {fn.name}() mutates it "
                            f"outside `with self.{lock}`")


def _file_lock_graph(ctx: FileContext
                     ) -> Tuple[Dict[str, Set[str]],
                                Dict[Tuple[str, str], ast.AST]]:
    """(edges, first acquisition site per edge) from nested with-blocks."""
    known = _lock_names(ctx)
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], ast.AST] = {}

    def walk(stmts: Sequence[ast.stmt], held: Tuple[str, ...]) -> None:
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                walk(s.body, ())
                continue
            if isinstance(s, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for key, _ in _with_locks(s, known):
                    for h in inner:
                        if h != key:
                            edges.setdefault(h, set()).add(key)
                            sites.setdefault((h, key), s)
                    if key not in inner:
                        inner.append(key)
                walk(s.body, tuple(inner))
                continue
            for b in _body_lists(s):
                walk(b, held)

    walk(ctx.tree.body, ())  # type: ignore[attr-defined]
    return edges, sites


def _cyclic_sccs(edges: Dict[str, Set[str]]) -> List[List[str]]:
    """Strongly connected components with a cycle (size > 1, or a
    self-loop), via iterative Tarjan — the graph is a handful of locks."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]
    nodes = sorted(set(edges) | {v for vs in edges.values() for v in vs})

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(edges.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1 or v in edges.get(v, ()):
                    sccs.append(sorted(comp))

    for n in nodes:
        if n not in index:
            strongconnect(n)
    return sccs


@register
class LockOrderRule(_ConcurrencyRule):
    id = "DP501"
    name = "lock-order-cycle"
    description = ("nested `with` blocks acquire locks in conflicting "
                   "orders (potential deadlock)")

    def _check(self, ctx: FileContext) -> Iterator[Finding]:
        edges, sites = _file_lock_graph(ctx)
        for scc in _cyclic_sccs(edges):
            members = set(scc)
            internal = sorted(
                ((site.lineno, site.col_offset), a, b)
                for (a, b), site in sites.items()
                if a in members and b in members)
            if not internal:
                continue
            (line, col), a, b = internal[0]
            site = sites[(a, b)]
            cycle = " -> ".join(scc + [scc[0]])
            canonical = " < ".join(scc)
            yield self.finding(
                ctx, site,
                f"lock-order cycle {cycle}: nested `with` blocks acquire "
                f"these locks in conflicting orders — a potential "
                f"deadlock; pick the canonical order {canonical} and "
                f"acquire in that order everywhere")


def _call_receiver(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return dotted_name(call.func.value)
    return None


def _has_timeout(call: ast.Call) -> bool:
    if any(kw.arg == "timeout" for kw in call.keywords):
        return True
    return bool(call.args)


@register
class BlockingUnderLockRule(_ConcurrencyRule):
    id = "DP502"
    name = "blocking-call-under-lock"
    description = ("sleep/join/socket/HTTP/untimed-wait call inside a "
                   "`with <lock>` body")

    def _blocking_reason(self, ctx: FileContext, call: ast.Call,
                         known: Set[str]) -> Optional[str]:
        resolved = ctx.resolve(call.func)
        if resolved is not None:
            if resolved in _BLOCKING_EXACT:
                return f"{resolved}()"
            if resolved.startswith(_BLOCKING_PREFIXES):
                return f"{resolved}()"
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        receiver = dotted_name(call.func.value)
        if attr == "join":
            # str.join / os.path.join are pure; everything else named
            # .join in a lock body is a thread/process rendezvous
            if isinstance(call.func.value, ast.Constant):
                return None
            if resolved is not None and (
                    resolved.startswith("os.path.")
                    or ".path." in resolved or resolved.startswith("str.")):
                return None
            if receiver is None:
                return None
            return f"{receiver}.join()"
        if attr == "wait" and not _has_timeout(call):
            target = receiver or "<expr>"
            return f"{target}.wait() without a timeout"
        if attr in ("get", "put") and receiver is not None:
            last = receiver.rpartition(".")[2].lower()
            if "queue" in last and not _has_timeout(call):
                return f"{receiver}.{attr}() without a timeout"
        return None

    def _check(self, ctx: FileContext) -> Iterator[Finding]:
        known = _lock_names(ctx)
        seen: Set[Tuple[int, int]] = set()
        for _, fn in _functions(ctx.tree):
            for sub, held, _ in _scan_scopes(fn.body, (), known):
                if not held:
                    continue
                for node in _walk_expr(sub):
                    if not isinstance(node, ast.Call):
                        continue
                    reason = self._blocking_reason(ctx, node, known)
                    if reason is None:
                        continue
                    key = (node.lineno, node.col_offset)
                    if key in seen:
                        continue
                    seen.add(key)
                    locks = ", ".join(held)
                    yield self.finding(
                        ctx, node,
                        f"blocking call {reason} while holding {locks}: "
                        f"every other thread contending for the lock "
                        f"stalls behind it (the stranded-replica shape)")


def _thread_call(ctx: FileContext, node: ast.AST) -> Optional[ast.Call]:
    if (isinstance(node, ast.Call)
            and ctx.resolve(node.func) == "threading.Thread"):
        return node
    return None


def _is_daemon(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return (isinstance(kw.value, ast.Constant)
                    and bool(kw.value.value))
    return False


def _joins_in(node: ast.AST) -> Set[str]:
    """Dotted receivers of `.join(...)` calls anywhere under `node`."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "join"):
            receiver = dotted_name(sub.func.value)
            if receiver:
                out.add(receiver)
    return out


@register
class ThreadLifecycleRule(_ConcurrencyRule):
    id = "DP503"
    name = "thread-lifecycle-hygiene"
    description = ("non-daemon thread never joined on stop()/close(), or "
                   "thread started in __init__ before guarded state is "
                   "assigned")

    def _check(self, ctx: FileContext) -> Iterator[Finding]:
        annotations = _guard_annotations(ctx.source)
        for cls, fn in _functions(ctx.tree):
            yield from self._check_nondaemon(ctx, cls, fn)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_init_start(ctx, node, annotations)

    def _check_nondaemon(self, ctx: FileContext,
                         cls: Optional[ast.ClassDef],
                         fn: ast.FunctionDef) -> Iterator[Finding]:
        local_joins = _joins_in(fn)
        class_joins: Set[str] = set()
        if cls is not None:
            for m in cls.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and m.name in _LIFECYCLE_METHODS):
                    class_joins |= _joins_in(m)
        starts = {dotted_name(s.func.value)
                  for s in ast.walk(fn)
                  if isinstance(s, ast.Call)
                  and isinstance(s.func, ast.Attribute)
                  and s.func.attr == "start"
                  and dotted_name(s.func.value)}
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign):
                call = _thread_call(ctx, stmt.value)
                if call is None or _is_daemon(call):
                    continue
                for t in stmt.targets:
                    name = dotted_name(t)
                    if name is None:
                        continue
                    if name.startswith("self."):
                        if name in class_joins or name in local_joins:
                            continue
                        owner = cls.name if cls else "<module>"
                        yield self.finding(
                            ctx, call,
                            f"non-daemon thread {name} is never joined on "
                            f"a {owner} stop()/close() path — process "
                            f"exit and test teardown will hang on it")
                    else:
                        if name in local_joins or name not in starts:
                            continue
                        yield self.finding(
                            ctx, call,
                            f"non-daemon thread {name} is start()ed in "
                            f"{fn.name}() but never joined there")
            elif (isinstance(stmt, ast.Expr)
                  and isinstance(stmt.value, ast.Call)
                  and isinstance(stmt.value.func, ast.Attribute)
                  and stmt.value.func.attr == "start"):
                call = _thread_call(ctx, stmt.value.func.value)
                if call is not None and not _is_daemon(call):
                    yield self.finding(
                        ctx, call,
                        "anonymous non-daemon thread start()ed with no "
                        "reference left to join")

    def _check_init_start(self, ctx: FileContext, cls: ast.ClassDef,
                          annotations: Dict[int, str]) -> Iterator[Finding]:
        guarded = _guarded_attrs(cls, annotations)
        init = next((m for m in cls.body
                     if isinstance(m, ast.FunctionDef)
                     and m.name == "__init__"), None)
        if init is None or not guarded:
            return
        thread_locals: Set[str] = set()
        first_start: Optional[ast.Call] = None
        for stmt in ast.walk(init):
            if isinstance(stmt, ast.Assign):
                if _thread_call(ctx, stmt.value) is not None:
                    for t in stmt.targets:
                        name = dotted_name(t)
                        if name:
                            thread_locals.add(name)
        for node in ast.walk(init):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "start"):
                receiver = dotted_name(node.func.value)
                if receiver in thread_locals or _thread_call(
                        ctx, node.func.value) is not None:
                    if first_start is None or node.lineno < first_start.lineno:
                        first_start = node
        if first_start is None:
            return
        late = sorted(
            attr for node in ast.walk(init)
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign))
            and node.lineno > first_start.lineno
            for attr in {a for a, _ in _mutated_attrs(node, True)}
            if attr in guarded)
        if late:
            yield self.finding(
                ctx, first_start,
                f"thread started in {cls.name}.__init__ before guarded "
                f"attribute(s) {', '.join(late)} are assigned — the "
                f"thread can observe a half-built object")


def _wall_clock_names(ctx: FileContext) -> Tuple[Set[str], Set[str]]:
    """(parameter names, self attrs) bound to time.time in this file:
    `def __init__(..., clock=time.time)` plus `self._clock = clock`."""
    params: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        pos = args.posonlyargs + args.args
        for arg, default in zip(pos[len(pos) - len(args.defaults):],
                                args.defaults):
            if ctx.resolve(default) in _WALL_CLOCKS:
                params.add(arg.arg)
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None and ctx.resolve(default) in _WALL_CLOCKS:
                params.add(arg.arg)
    attrs: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        from_param = (isinstance(value, ast.Name) and value.id in params)
        direct = ctx.resolve(value) in _WALL_CLOCKS
        if not (from_param or direct):
            continue
        for t in node.targets:
            attr = _self_attr(t)
            if attr is not None:
                attrs.add(attr)
    return params, attrs


@register
class WallClockLivenessRule(_ConcurrencyRule):
    id = "DP504"
    name = "wall-clock-liveness"
    description = ("time.time()-derived value compared against a "
                   "ttl/deadline — liveness wants time.monotonic()")

    def _is_wall_call(self, ctx: FileContext, node: ast.AST,
                      params: Set[str], attrs: Set[str]) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if ctx.resolve(node.func) in _WALL_CLOCKS:
            return True
        if isinstance(node.func, ast.Name) and node.func.id in params:
            return True
        attr = _self_attr(node.func)
        return attr is not None and attr in attrs

    def _check(self, ctx: FileContext) -> Iterator[Finding]:
        params, attrs = _wall_clock_names(ctx)
        for _, fn in _functions(ctx.tree):
            tainted: Set[str] = set()
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign)
                        and self._is_wall_call(ctx, node.value, params,
                                               attrs)):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            tainted.add(t.id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Compare):
                    continue
                sides = [node.left] + list(node.comparators)
                wall = any(
                    self._is_wall_call(ctx, sub, params, attrs)
                    or (isinstance(sub, ast.Name) and sub.id in tainted)
                    for side in sides for sub in ast.walk(side))
                if not wall:
                    continue
                words: List[str] = []
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name):
                        words.append(sub.id)
                    elif isinstance(sub, ast.Attribute):
                        words.append(sub.attr)
                    elif (isinstance(sub, ast.Constant)
                          and isinstance(sub.value, str)):
                        words.append(sub.value)
                if not any(_LIVENESS_RE.search(w) for w in words):
                    continue
                yield self.finding(
                    ctx, node,
                    "wall-clock liveness: a time.time()-derived value is "
                    "compared against a ttl/deadline; a stepped or skewed "
                    "wall clock flips the decision (the lease-skew class) "
                    "— use time.monotonic() or a seq-based freshness "
                    "check")


# ---------------- static graph export (runtime lockwatch) ----------------


def static_lock_graph(paths: Optional[Sequence[Union[str, pathlib.Path]]]
                      = None) -> Dict[str, Set[str]]:
    """The merged DP501 acquisition graph over `paths` (default: the
    installed dorpatch_tpu_torch package), keyed by final lock-attribute
    name.
    The runtime lockwatch (`analysis/lockwatch.py`) cross-checks the order
    it actually observes against this statically proven order."""
    if paths is None:
        paths = [pathlib.Path(__file__).resolve().parents[1]]
    merged: Dict[str, Set[str]] = {}
    for f in iter_python_files(paths):
        try:
            ctx = FileContext(str(f), f.read_text(encoding="utf-8"))
        except (OSError, UnicodeDecodeError, SyntaxError):
            continue
        if not in_concurrency_scope(ctx):
            continue
        edges, _ = _file_lock_graph(ctx)
        for a, bs in edges.items():
            merged.setdefault(a, set()).update(bs)
    return merged
