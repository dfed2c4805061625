"""Program auditor: the DP2xx trace-time rule family, over torch graphs.

Port of `dorpatch_tpu.analysis.program`. The AST wing proves what is
visible in source; this module proves what is only visible in the traced
program. A program is the graph that `make_fx` records when the entry
point runs on fake tensors (`FakeTensorMode`: shapes, dtypes and devices,
no data, no device work), with the backward that `torch.autograd.grad`
(or `.backward()`) adds inside it. Each kernel is one node, its
`dorpatch_torch::` op (`ops/_library.py`); a closed-over tensor (a
weight, a table) is a constant of the graph, a closed-over
`torch.Generator` an opaque object.

- **DP200 untraceable-entrypoint** — the program fails to trace on fake
  tensors (a data-dependent `.item()`, a host read of a tensor's values),
  or was wrapped by `timed_first_call` but never given example arguments.
- **DP201 carry-instability** — an output that is fed back as a later
  call's input (the same structure as an argument: the attack's
  `TrainState`) comes out with another dtype, shape or memory format than
  it went in: `timed_first_call` sees a new input signature each
  iteration (the recompile watchdog's bug class).
- **DP202 precision-leak** — float64/complex128 at the program boundary or
  in its compute. Kernel B's float64 sums are inside its op and do not
  show; its float64 mesh form is not traced here.
- **DP203 const-bloat** — a tensor above the byte threshold made from host
  data inside the program (`torch.as_tensor(numpy)`, `torch.tensor(...)`:
  a constant the graph lifts with `lift_fresh_copy`), so it is copied to
  the device on every call instead of made once and kept. Tensors the
  program closes over (the victim's weights, an engine's tables: made
  once) are exempt.
- **DP204 dead-code** — a chain of nodes whose results reach no output
  and carry no effect (no in-place write, no draw), flagged when it holds
  real compute (a matmul, a convolution, a kernel, a sort).
- **DP208 bf16-silent-upcast** — in a declared-bf16 program (the name
  carries `.bf16`), large float32 compute fed by a bf16->f32 conversion;
  conversions reduced straight back down and readout-scale outputs
  (<= 8192 elements) are exempt.

The JAX package's DP205 (a collective's axis) waits for the mesh entry
points, which this auditor does not trace yet; DP206 (donation) has no
counterpart: eager torch donates nothing. Both are listed by
`--list-rules` as not applicable.

Findings flow through `engine.Finding` (`# noqa: DP2xx` on the program's
`def` line) or the programmatic `ALLOWLIST` (entry-point-name glob ->
{rule: reason}).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import pathlib
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

from dorpatch_tpu_torch.analysis.engine import ALL_CODES, Finding, _parse_noqa
from dorpatch_tpu_torch.analysis.entrypoints import EntryPoint, map_tensors

#: Entry-point-name glob -> {rule_id: reason}. The trace-level analog of a
#: `# noqa:` comment, for programs whose offense has no ownable source line.
ALLOWLIST: Dict[str, Dict[str, str]] = {}

#: DP203 default: constants this large belong outside the program.
CONST_BYTES_THRESHOLD = 128 * 1024

#: The namespace of the kernels' ops.
KERNEL_NAMESPACE = "dorpatch_torch"

#: DP204 reports a dead chain only when it holds one of these ops (real
#: compute); cheap dead views and copies stay quiet.
_EXPENSIVE_OPS = {
    "mm", "bmm", "addmm", "matmul", "baddbmm", "convolution",
    "convolution_backward", "_convolution", "sort", "topk", "einsum",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
}

#: The rules with no torch reading, for `--list-rules`.
NOT_APPLICABLE_ROWS: Tuple[Tuple[str, str, str], ...] = (
    ("DP205", "collective-axis",
     "not applicable to the port yet: the mesh's entry points (parallel/, "
     "one process a rank over torch.distributed) are not traced by this "
     "auditor, so no collective appears in a traced program"),
    ("DP206", "donation",
     "not applicable to the port: eager torch has no buffer donation "
     "(`donate_argnums`); a program's outputs are fresh allocations"),
)


# ---------------------------------------------------------------- plumbing

def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of `tree`, in `entrypoints.map_tensors` order."""
    out: List[torch.Tensor] = []

    def take(t):
        out.append(t)
        return t

    map_tensors(take, tree)
    return out


def rebuild(tree, leaves: Sequence[Any]):
    """`tree` with its tensor leaves replaced by `leaves`, in order."""
    it = iter(leaves)
    return map_tensors(lambda _: next(it), tree)


def structure(tree) -> str:
    """The structure of a value: containers and field names, "T" for a
    tensor, the type name of any other leaf."""
    if isinstance(tree, torch.Tensor):
        return "T"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(structure(v) for v in tree)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{structure(tree[k])}"
                              for k in sorted(tree, key=str)) + "}"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return f"{type(tree).__name__}(" + ",".join(
            f"{f.name}={structure(getattr(tree, f.name))}"
            for f in dataclasses.fields(tree)) + ")"
    return type(tree).__name__


def memory_format(t: torch.Tensor) -> str:
    """"contiguous", "channels_last", "channels_last_3d" or "strided"."""
    if t.is_contiguous():
        return "contiguous"
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    if t.dim() == 5 and t.is_contiguous(
            memory_format=torch.channels_last_3d):
        return "channels_last_3d"
    return "strided"


def tensor_sig(t: torch.Tensor) -> str:
    """`float32[2,32,32,3]` (plus `:channels_last` or `:strided` when not
    contiguous): a tensor's signature, without its device."""
    dt = str(t.dtype).replace("torch.", "")
    sig = f"{dt}[{','.join(str(int(d)) for d in t.shape)}]"
    fmt = memory_format(t)
    return sig if fmt == "contiguous" else f"{sig}:{fmt}"


def _remap_device(mode, device: torch.device) -> None:
    """Make `mode` convert every real tensor a program closes over to a
    fake tensor on `device` (the program's weights and tables live on the
    device it was built on; a trace for another device sees them there)."""
    conv = mode.fake_tensor_converter
    orig = conv.from_real_tensor

    def from_real_tensor(fake_mode, t, *args, **kwargs):
        out = orig(fake_mode, t, *args, **kwargs)
        if out.device != device:
            out.fake_device = device
        return out

    conv.from_real_tensor = from_real_tensor


@dataclasses.dataclass
class ProgramContext:
    """Everything a trace rule needs about one traced program."""

    name: str
    gm: Any                          # torch.fx.GraphModule
    args: Tuple[Any, ...]            # example args (fake tensor leaves)
    out_tree: Any                    # the program's output, fake leaves
    path: str
    line: int

    def nodes(self, op: Optional[str] = None) -> List[Any]:
        return [n for n in self.gm.graph.nodes if op is None or n.op == op]


def trace_program(fn: Callable, args: Tuple[Any, ...] = (),
                  kwargs: Optional[Dict[str, Any]] = None,
                  device=None):
    """Trace `fn(*args, **kwargs)` on fake tensors: `(graph module,
    output)`. Every tensor leaf of the arguments becomes a fake tensor of
    its shape, dtype and strides, on `device` (default: its own); with a
    `device`, the tensors the program closes over are seen there too.
    Nothing runs on a device, and no generator is drawn from."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from dorpatch_tpu_torch.ops import stem_fold

    kwargs = dict(kwargs or {})
    tree = (tuple(args), kwargs)
    leaves = tensor_leaves(tree)
    dev = None if device is None else torch.device(device)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    if dev is not None:
        _remap_device(mode, dev)
    with mode:
        fakes = [torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                                     dtype=t.dtype,
                                     device=dev if dev is not None
                                     else t.device)
                 for t in leaves]
    box: Dict[str, Any] = {}

    def flat(*ts):
        a, k = rebuild(tree, ts)
        with _NoGenerators():
            out = fn(*a, **k)
        box["out"] = out
        return tuple(tensor_leaves(out))

    # the stem fold's device plans are cached per family: none of real
    # tensors is read into the trace, none of fake tensors outlives it
    stem_fold.drop_plans()
    try:
        with mode:
            gm = make_fx(flat, tracing_mode="real")(*fakes)
    finally:
        stem_fold.drop_plans()
    return gm, box.get("out")


class _NoGenerators(torch.overrides.TorchFunctionMode):
    """Drops the `generator=` of every call while a program is traced: a
    draw stays a node of the graph (`aten.rand`, ...), its generator — an
    object of the host, not a tensor — stays out (some torch builds cannot
    trace one). The trace runs on fake tensors, so it draws nothing from
    the generator either way."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        return func(*args, **kwargs)


class TraceRule:
    """Base for program rules; mirrors `engine.Rule` but checks a
    `ProgramContext`."""

    id: str = ""
    name: str = ""
    description: str = ""

    def check(self, ctx: ProgramContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ProgramContext, message: str) -> Finding:
        return Finding(path=ctx.path, line=ctx.line, col=1, rule_id=self.id,
                       message=f"[{ctx.name}] {message}")


_TRACE_REGISTRY: Dict[str, TraceRule] = {}


def register_trace(cls):
    if not cls.id:
        raise ValueError(f"trace rule {cls.__name__} has no id")
    if cls.id in _TRACE_REGISTRY:
        raise ValueError(f"duplicate trace rule id {cls.id}")
    _TRACE_REGISTRY[cls.id] = cls()
    return cls


def all_trace_rules() -> List[TraceRule]:
    return [_TRACE_REGISTRY[k] for k in sorted(_TRACE_REGISTRY)]


def source_location(fn) -> Tuple[str, int]:
    """Best-effort (file, `def` line) of the function under a wrapper
    chain (bound methods included) — the anchor `# noqa:` suppressions
    attach to."""
    f = fn
    for _ in range(10):
        f = getattr(f, "__wrapped__", None) or getattr(f, "__func__", f)
        if not hasattr(f, "__wrapped__") and not hasattr(f, "__func__"):
            break
    code = getattr(f, "__code__", None)
    if code is None:
        return "<entrypoint>", 1
    path, line = code.co_filename, code.co_firstlineno
    try:
        lines = pathlib.Path(path).read_text(encoding="utf-8").splitlines()
        for i in range(line - 1, min(line + 30, len(lines))):
            if lines[i].lstrip().startswith(("def ", "async def ", "lambda")):
                line = i + 1
                break
    except OSError:
        pass
    try:
        path = str(pathlib.Path(path).resolve().relative_to(
            pathlib.Path.cwd()))
    except ValueError:
        pass
    return path, line


def node_val(node) -> Any:
    """The fake value a node produced (a tensor, a tuple of them, ...)."""
    return node.meta.get("val") if hasattr(node, "meta") else None


def _tensors_of(value) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors_of(v)]
    return []


def op_name(node) -> str:
    """`aten.mm.default` / `dorpatch_torch.stem_fold.default`, or the
    callable's name."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return f"{t.namespace}.{t._schema.name.split('::')[-1]}." \
            f"{t._overloadname}"
    return getattr(t, "__name__", str(t))


def op_packet(node) -> str:
    """The op's name without namespace and overload (`mm`, `stem_fold`)."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t._schema.name.split("::")[-1]
    return getattr(t, "__name__", str(t))


def is_kernel(node) -> bool:
    t = node.target
    return isinstance(t, torch._ops.OpOverload) \
        and t.namespace == KERNEL_NAMESPACE


def has_effect(node) -> bool:
    """An in-place write (mutable schema) or a draw (a seeded op)."""
    t = node.target
    if not isinstance(t, torch._ops.OpOverload):
        return True
    return t._schema.is_mutable \
        or torch.Tag.nondeterministic_seeded in t.tags


# ---------------------------------------------------------------- DP201

def _kind(t: torch.Tensor) -> str:
    if t.dtype == torch.bool:
        return "bool"
    if t.is_floating_point() or t.is_complex():
        return "float"
    return "int"


def _carry_candidates(args: Tuple[Any, ...], out) -> List[Tuple[Any, Any]]:
    """(input, output) pairs that plausibly form a carry: the whole output
    against each argument, and — when the output is a tuple/list — its
    elements zipped against the leading arguments; kept when their
    structures match."""
    cands = [(a, out) for a in args]
    if isinstance(out, (tuple, list)) and not hasattr(out, "_fields"):
        cands.extend(zip(args, out))
    uniq, seen = [], set()
    for a, o in cands:
        if (id(a), id(o)) in seen:
            continue
        seen.add((id(a), id(o)))
        if structure(a) == structure(o):
            uniq.append((a, o))
    return uniq


@register_trace
class CarryInstabilityRule(TraceRule):
    id = "DP201"
    name = "carry-instability"
    description = ("carry slot whose dtype, shape or memory format differs "
                   "between program input and output — every host-level "
                   "iteration is a new input signature")

    def check(self, ctx: ProgramContext) -> Iterator[Finding]:
        for a_tree, o_tree in _carry_candidates(ctx.args, ctx.out_tree):
            a_leaves, o_leaves = tensor_leaves(a_tree), tensor_leaves(o_tree)
            multi = len(a_leaves) > 1
            for i, (a, o) in enumerate(zip(a_leaves, o_leaves)):
                shape_ok = tuple(a.shape) == tuple(o.shape)
                dtype_ok = a.dtype == o.dtype
                fmt_ok = memory_format(a) == memory_format(o)
                if multi:
                    bad = not (shape_ok and dtype_ok and fmt_ok)
                else:
                    # a single-leaf structure matches ANY tensor->tensor
                    # fn; only an identical shape with a drifting dtype of
                    # the same kind, or layout, is evidence of a carry
                    bad = shape_ok and _kind(a) == _kind(o) \
                        and not (dtype_ok and fmt_ok)
                if bad:
                    yield self.finding(
                        ctx, f"carry leaf {i} is {tensor_sig(a)} going in "
                        f"but {tensor_sig(o)} coming out — the next call is "
                        "a new input signature (declare explicit dtypes)")


# ---------------------------------------------------------------- DP202

@register_trace
class PrecisionLeakRule(TraceRule):
    id = "DP202"
    name = "precision-leak"
    description = ("float64/complex128 tensor at a program boundary or "
                   "inside the program's compute")

    _WIDE = (torch.float64, torch.complex128)

    def check(self, ctx: ProgramContext) -> Iterator[Finding]:
        ins = [node_val(n) for n in ctx.nodes("placeholder")]
        outs = _tensors_of(ctx.out_tree)
        for side, vals in (("input", ins), ("output", outs)):
            for i, v in enumerate(vals):
                if isinstance(v, torch.Tensor) and v.dtype in self._WIDE:
                    yield self.finding(
                        ctx, f"{side} {i} is {tensor_sig(v)} — double "
                        "precision at a program boundary")
        reported = 0
        for n in ctx.nodes("call_function"):
            wide = [t for t in _tensors_of(node_val(n))
                    if t.dtype in self._WIDE]
            if wide:
                yield self.finding(
                    ctx, f"`{op_name(n)}` produces {tensor_sig(wide[0])} "
                    "inside the program")
                reported += 1
                if reported >= 3:  # one program, one story: cap the noise
                    return


# ---------------------------------------------------------------- DP203

def tensor_constants(ctx: ProgramContext) -> List[Tuple[str, Any]]:
    """(attribute name, value) of the graph's get_attr constants."""
    return [(n.target, getattr(ctx.gm, n.target))
            for n in ctx.nodes("get_attr")]


def is_parameter_constant(name: str, value) -> bool:
    """A closed-over parameter (make_fx names them `_param_constant*`)."""
    return isinstance(value, torch.nn.Parameter) \
        or name.startswith("_param_constant")


def _lifted(node) -> bool:
    """A constant made from host data inside the program: the graph lifts
    it into a fresh tensor (`lift_fresh_copy`)."""
    return any(op_packet(u) in ("lift_fresh", "lift_fresh_copy")
               for u in node.users)


@register_trace
class ConstBloatRule(TraceRule):
    id = "DP203"
    name = "const-bloat"
    description = ("tensor above the byte threshold made from host data "
                   "inside the program (copied to the device on every call) "
                   "instead of made once")

    threshold = CONST_BYTES_THRESHOLD

    def check(self, ctx: ProgramContext) -> Iterator[Finding]:
        for n in ctx.nodes("get_attr"):
            value = getattr(ctx.gm, n.target)
            if not isinstance(value, torch.Tensor) or not _lifted(n):
                continue
            nbytes = value.numel() * value.element_size()
            if nbytes > self.threshold:
                yield self.finding(
                    ctx, f"host constant {tensor_sig(value)} "
                    f"({nbytes / 1024:.0f} KiB > "
                    f"{self.threshold / 1024:.0f} KiB) is made inside the "
                    "program and copied to the device on every call — make "
                    "it once, outside the program")


# ---------------------------------------------------------------- DP204

def dead_nodes(ctx: ProgramContext) -> List[Any]:
    """call_function nodes whose results reach no output and that write
    and draw nothing, in graph order."""
    live = set()
    dead = []
    for n in reversed(list(ctx.gm.graph.nodes)):
        if n.op == "output" or (n.op == "call_function" and has_effect(n)) \
                or n in live:
            live.add(n)
            live.update(n.all_input_nodes)
        elif n.op == "call_function":
            dead.append(n)
    return dead[::-1]


@register_trace
class DeadCodeRule(TraceRule):
    id = "DP204"
    name = "dead-code"
    description = ("node chain whose results reach no program output and "
                   "carry no effect — computed for nothing")

    def check(self, ctx: ProgramContext) -> Iterator[Finding]:
        dead = dead_nodes(ctx)
        heavy = sorted({op_name(n) for n in dead
                        if op_packet(n) in _EXPENSIVE_OPS or is_kernel(n)})
        if heavy:
            yield self.finding(
                ctx, f"{len(dead)} dead node(s) including real compute "
                f"({', '.join(heavy[:3])}) — their outputs reach no "
                "program output; delete the computation or return it")


# ---------------------------------------------------------------- DP208

def _numel(t: torch.Tensor) -> int:
    n = 1
    for d in t.shape:
        n *= int(d)
    return n


def is_upcast(node) -> bool:
    """A bf16 -> f32 conversion node."""
    if op_packet(node) not in ("_to_copy", "to", "_to_dtype"):
        return False
    src = [a for a in node.args if hasattr(a, "meta")]
    out = node_val(node)
    return (bool(src) and isinstance(node_val(src[0]), torch.Tensor)
            and node_val(src[0]).dtype == torch.bfloat16
            and isinstance(out, torch.Tensor) and out.dtype == torch.float32)


@register_trace
class SilentUpcastRule(TraceRule):
    id = "DP208"
    name = "bf16-silent-upcast"
    description = ("large float32 compute fed by a bfloat16->float32 "
                   "conversion inside a declared-bf16 program (f32 "
                   "accumulations reduced straight back down, the kernels' "
                   "ops and readout-scale outputs are exempt)")

    #: consuming an f32 upcast here is the accumulate idiom (means/stats)
    _REDUCERS = frozenset({
        "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
        "var", "var_mean", "std", "prod", "logsumexp", "norm",
        "linalg_vector_norm"})
    #: f32 outputs at or below this element count are readout-scale
    _SMALL_ELEMS = 8192

    def check(self, ctx: ProgramContext) -> Iterator[Finding]:
        if ".bf16" not in ctx.name:
            return
        upcast = {n for n in ctx.nodes("call_function") if is_upcast(n)}
        if not upcast:
            return
        reported = 0
        for n in ctx.nodes("call_function"):
            packet = op_packet(n)
            if n in upcast or packet in self._REDUCERS or is_kernel(n) \
                    or packet in ("_to_copy", "to", "view", "reshape",
                                  "_unsafe_view", "expand", "permute",
                                  "t", "transpose", "clone", "detach",
                                  "unsqueeze", "squeeze", "select", "slice"):
                continue
            if not any(a in upcast for a in n.all_input_nodes):
                continue
            big = [t for t in _tensors_of(node_val(n))
                   if t.dtype == torch.float32
                   and _numel(t) > self._SMALL_ELEMS]
            if not big:
                continue
            users = list(n.users)
            if users and all(op_packet(u) in self._REDUCERS for u in users):
                continue
            yield self.finding(
                ctx, f"`{op_name(n)}` turns a bf16->f32 conversion into a "
                f"{tensor_sig(big[0])} intermediate inside a bf16 bank — "
                "this math runs at f32; keep the slab at bfloat16 or reduce "
                "it immediately")
            reported += 1
            if reported >= 3:  # one program, one story: cap the noise
                return


# ---------------------------------------------------------------- audit

def allowed(name: str, rule_id: str,
            allow: Optional[Dict[str, Dict[str, str]]] = None) -> bool:
    """True when `ALLOWLIST` (or the per-call `allow` overlay) grants
    `rule_id` for entry point `name` (keys are fnmatch globs)."""
    for table in (ALLOWLIST, allow or {}):
        for pattern, rules in table.items():
            if fnmatch.fnmatchcase(name, pattern) and rule_id in rules:
                return True
    return False


_noqa_cache: Dict[str, Dict[int, Any]] = {}


def suppressed_in_source(path: str, line: int, rule_id: str) -> bool:
    """Honor a `# noqa: DP2xx`/`DP3xx` on the entry point's `def` line."""
    if path not in _noqa_cache:
        try:
            src = pathlib.Path(path).read_text(encoding="utf-8")
            _noqa_cache[path] = _parse_noqa(src)
        except OSError:
            _noqa_cache[path] = {}
    codes = _noqa_cache[path].get(line)
    if codes is None:
        return False
    return codes == ALL_CODES or rule_id in codes


def trace_entrypoint(ep: EntryPoint, device=None
                     ) -> Tuple[Optional[ProgramContext], List[Finding]]:
    """Trace one entry point on fake tensors. A failure is a DP200 finding
    — a program that cannot trace fails the gate loudly, like a syntax
    error fails lint."""
    path, line = source_location(ep.fn)
    try:
        gm, out = trace_program(ep.fn, ep.args, ep.kwargs, device)
    except Exception as e:  # the error class varies by torch version
        first = f"{type(e).__name__}: {e}".splitlines()[0][:300]
        return None, [Finding(
            path=path, line=line, col=1, rule_id="DP200",
            message=f"[{ep.name}] failed to trace on fake tensors: {first}")]
    return ProgramContext(name=ep.name, gm=gm, args=tuple(ep.args),
                          out_tree=out, path=path, line=line), []


def audit_entrypoint(ep: EntryPoint,
                     select: Optional[Sequence[str]] = None,
                     allow: Optional[Dict[str, Dict[str, str]]] = None
                     ) -> List[Finding]:
    ctx, findings = trace_entrypoint(ep)
    if ctx is not None:
        for rule in all_trace_rules():
            if select is not None and rule.id not in select:
                continue
            findings.extend(rule.check(ctx))
    out = []
    for f in findings:
        if select is not None and f.rule_id not in select:
            continue
        if allowed(ep.name, f.rule_id, allow):
            continue
        if suppressed_in_source(f.path, f.line, f.rule_id):
            continue
        out.append(f)
    return sorted(out)


def audit_entrypoints(eps: Iterable[EntryPoint],
                      select: Optional[Sequence[str]] = None,
                      allow: Optional[Dict[str, Dict[str, str]]] = None,
                      uncovered: Sequence[str] = ()) -> List[Finding]:
    """Audit a batch of entry points; `uncovered` names (discovered via a
    timed_first_call wrap but never given example args) are DP200
    findings — an unauditable production program is a hole in the gate."""
    findings: List[Finding] = []
    for name in uncovered:
        if select is not None and "DP200" not in select:
            continue
        if not allowed(name, "DP200", allow):
            findings.append(Finding(
                path="<entrypoint>", line=1, col=1, rule_id="DP200",
                message=f"[{name}] entry point was wrapped by "
                        "timed_first_call but no example args were "
                        "registered — the auditor cannot trace it "
                        "(register it in analysis/entrypoints.py)"))
    for ep in eps:
        findings.extend(audit_entrypoint(ep, select=select, allow=allow))
    return sorted(findings)


#: The trace-failure meta rule: not a registered TraceRule (it has no graph
#: to check — it IS the absence of one), but it owns a stable ID, a row in
#: `--list-rules`, and a slot in `--select` like any other rule.
DP200_ROW = ("DP200", "untraceable-entrypoint",
             "registered entry point failed to trace on fake tensors (or "
             "has no registered example args)")

#: Rule IDs the trace wing owns (DP200 is the trace-failure meta rule).
TRACE_RULE_IDS = ("DP200",) + tuple(sorted(_TRACE_REGISTRY))
