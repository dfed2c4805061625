"""Program-baseline tier: graph fingerprints + static cost model (DP3xx).

Port of `dorpatch_tpu.analysis.baseline`. The trace tier (DP2xx) proves
what one version's programs show; this tier compares programs *across
versions* against the checked-in `analysis/baselines.json`:

- **Fingerprint** — what an eager program's identity is: the sha256
  (first 16 hex) of a canonical text of its traced graph
  (`program.trace_program`): the op overloads in graph (topological)
  order, the inputs renumbered by position and every value by first
  appearance, each tensor's shape and dtype (and the memory format of the
  constants and of the kernels' results, which the kernels fix), scalars
  normalized, the kernels' `dorpatch_torch::` ops by name, tensor
  constants by the sha of their bytes (the victim's parameters by shape
  and dtype: weights are data, not program), generators as opaque objects.
  It holds no node names, addresses, device indices or object reprs, and
  no placement: a copy that only changes a tensor's device is its source,
  and the memory format an aten op's result takes is the backend's choice
  (cuDNN and the CPU's convolutions pick differently). So the same program
  traced on `cpu` and on `cuda` fake tensors has one fingerprint.
- **Interface record** — the input and output signatures with their
  memory formats, and the inputs the program writes in place, hashed apart
  from the body: a change there with an unchanged body (a channels-last
  input to the same ops) is DP304.
- **Static cost vector** — `est_flops` from the formulas of
  `torch.utils.flop_counter.FlopCounterMode` (`flop_registry`) for aten
  ops, and for each kernel's op the formula of its bound (kernel C: 2 k*k*
  Cin flops an output of its uniform windows; kernel H: 4 (T+S) f flops a
  query row and head; the others none); `est_bytes` by a walk over the
  nodes (each operand and result once, as the JAX package's `_eqn_bytes`;
  a kernel's op reads each input once and writes each output once); the
  per-op breakdown names the dominant regressing op.

Rules (`--baseline check`; `--baseline update` regenerates the file
deterministically — sorted keys, normalized numbers — so diffs review):

- **DP300 fingerprint-drift**, **DP301 cost-regression** (flops/bytes past
  the entry's tolerance; names the op), **DP302 entrypoint-set-drift**,
  **DP303 budget-ladder-mismatch**, **DP304 interface-drift** — the JAX
  package's rules — and **DP305 aot-store-drift**, which `python -m
  dorpatch_tpu_torch.aot verify` reports (`aot/store.verify_against`).

XLA's compiled `cost_analysis` (`--baseline-cost compiled`) has no eager
counterpart: the CLI refuses it.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import json
import pathlib
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

from dorpatch_tpu_torch.analysis.engine import Finding

#: The checked-in baseline, shipped inside the package.
BASELINE_FILENAME = "baselines.json"

#: DP301 default relative tolerance.
DEFAULT_TOLERANCE = 0.10

#: Per-entry tolerance overrides: fnmatch glob -> relative tolerance.
TOLERANCES: Dict[str, float] = {}

#: Entry-point-name glob -> {rule_id: reason}: the baseline tier's analog
#: of `program.ALLOWLIST`. Shipped entries must carry their reason.
ALLOWLIST: Dict[str, Dict[str, str]] = {}

#: (id, name, description) rows for `--list-rules`.
BASELINE_RULE_ROWS: Tuple[Tuple[str, str, str], ...] = (
    ("DP300", "fingerprint-drift",
     "entry point's canonical graph fingerprint differs from "
     "analysis/baselines.json — program changed but the baseline was not "
     "regenerated (--baseline update)"),
    ("DP301", "cost-regression",
     "entry point's static cost (est flops/bytes) grew past its relative "
     "tolerance vs the baseline — the bench-free perf-regression gate"),
    ("DP302", "entrypoint-set-drift",
     "entry point added or removed relative to the baseline — the audited "
     "program set changed shape"),
    ("DP303", "budget-ladder-mismatch",
     "declared timed_first_call recompile_budget differs from the bucket "
     "count the registered program set implies"),
    ("DP304", "interface-drift",
     "input/output signature or in-place-write drift with an UNCHANGED "
     "body fingerprint"),
    ("DP305", "aot-store-drift",
     "AOT executable store entry disagrees with analysis/baselines.json "
     "(stale fingerprint/interface, missing entry, corrupt blob) or was "
     "built for another environment — `python -m dorpatch_tpu_torch.aot "
     "verify`"),
)

BASELINE_RULE_IDS: Tuple[str, ...] = tuple(r[0] for r in BASELINE_RULE_ROWS)

#: Cap the stored per-op breakdown.
TOP_K_PRIMITIVES = 8


def baseline_path() -> pathlib.Path:
    """The checked-in default baseline file (inside the package)."""
    return pathlib.Path(__file__).with_name(BASELINE_FILENAME)


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


# ------------------------------------------------------------- fingerprint

def tensor_bytes_sha(t) -> str:
    """sha256 (12 hex) of a real tensor's bytes."""
    import torch

    raw = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:12]


def _value_sig(v, layout: bool = True) -> str:
    """A node's value: tensor signature(s) (with the memory format unless
    `layout` is False), a scalar, or its type."""
    import torch

    from dorpatch_tpu_torch.analysis.program import tensor_sig

    if isinstance(v, torch.Tensor):
        return tensor_sig(v) if layout else tensor_sig(v).split(":")[0]
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_value_sig(x, layout) for x in v) + ")"
    if v is None or isinstance(v, (bool, int, float)):
        return repr(v)
    return type(v).__name__


def _norm_arg(a, names: Dict[Any, str]) -> str:
    """Deterministic, address-free and device-free rendering of an op
    argument."""
    import torch
    import torch.fx

    if isinstance(a, torch.fx.Node):
        return names.get(a, "?")
    if isinstance(a, (tuple, list)):
        inner = ",".join(_norm_arg(x, names) for x in a)
        return f"({inner})" if isinstance(a, tuple) else f"[{inner}]"
    if isinstance(a, dict):
        return "{" + ",".join(f"{k}:{_norm_arg(a[k], names)}"
                              for k in sorted(a, key=str)) + "}"
    if isinstance(a, torch.device):
        return "dev"
    if isinstance(a, (torch.dtype, torch.memory_format, torch.layout)):
        return str(a).replace("torch.", "")
    if isinstance(a, float):
        return repr(a)
    if a is None or isinstance(a, (bool, int, str)):
        return repr(a)
    if isinstance(a, slice):
        return f"slice({a.start},{a.stop},{a.step})"
    return type(a).__name__


def _device_copy(node) -> bool:
    """A copy that changes only the device (`x.to(device)`,
    `torch.as_tensor(t, device=...)`): placement, not program."""
    from dorpatch_tpu_torch.analysis.program import node_val, op_packet

    if op_packet(node) not in ("_to_copy", "to") or not node.args:
        return False
    src, out = node.args[0], node_val(node)
    src_val = node_val(src) if hasattr(src, "meta") else None
    extra = set(node.kwargs) - {"device", "dtype", "non_blocking", "layout",
                                "memory_format"}
    return (not extra and src_val is not None and out is not None
            and src_val.dtype == out.dtype
            and tuple(src_val.shape) == tuple(out.shape))


def canonical_graph(gm) -> str:
    """Canonical text of a traced graph: one line a node, values named by
    first appearance (`p0..` the inputs, `v0..` the rest), op overloads,
    normalized arguments, result signatures. Two traces of one program —
    fresh processes, fresh objects, renamed locals, another device — give
    the same text; a changed op, literal, constant or signature changes
    it. Device-dependent placement stays out: a copy that only moves a
    tensor to another device is its source, so is the lift of a constant
    made from host data (`lift_fresh_copy`: a table a program keeps on one
    device and makes per call on another is the same constant), and an
    aten op's result
    carries its shape and dtype but not the memory format the backend
    chose for it (the inputs', the constants' and the kernels' results'
    do)."""
    import torch

    from dorpatch_tpu_torch.analysis.program import (is_kernel,
                                                     is_parameter_constant,
                                                     node_val, op_name,
                                                     op_packet, tensor_sig)

    names: Dict[Any, str] = {}
    lines: List[str] = []
    n_in = n_vals = 0
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            names[n] = f"p{n_in}"
            n_in += 1
            lines.append(f"{names[n]} = input "
                         f"{_value_sig(node_val(n), False)}")
        elif n.op == "get_attr":
            names[n] = f"v{n_vals}"
            n_vals += 1
            value = getattr(gm, n.target)
            if isinstance(value, torch.Tensor):
                if is_parameter_constant(n.target, value):
                    what = f"param {tensor_sig(value)}"
                elif type(value) is torch.Tensor \
                        or isinstance(value, torch.nn.Parameter):
                    what = (f"const {tensor_sig(value)}:"
                            f"{tensor_bytes_sha(value)}")
                else:   # a fake tensor: no bytes to hash
                    what = f"const {tensor_sig(value)}"
            else:
                what = f"opaque {type(value).__name__}"
            lines.append(f"{names[n]} = {what}")
        elif n.op == "call_function" and (
                _device_copy(n) or op_packet(n) in ("lift_fresh",
                                                    "lift_fresh_copy")):
            names[n] = names.get(n.args[0], "?")
        elif n.op == "call_function":
            names[n] = f"v{n_vals}"
            n_vals += 1
            args = ",".join(_norm_arg(a, names) for a in n.args)
            kwargs = ",".join(f"{k}={_norm_arg(n.kwargs[k], names)}"
                              for k in sorted(n.kwargs))
            lines.append(f"{names[n]} = {op_name(n)}({args}"
                         f"{';' + kwargs if kwargs else ''}) -> "
                         f"{_value_sig(node_val(n), is_kernel(n))}")
        elif n.op == "output":
            lines.append("out " + _norm_arg(n.args[0], names))
    return "\n".join(lines)


def fingerprint(gm) -> str:
    """16-hex stable hash of the canonical graph body."""
    return _sha(canonical_graph(gm))


def interface_record(ctx) -> Dict[str, Any]:
    """The entry point's boundary contract: the input and output tensor
    signatures (count + hash + a readable head) and the inputs it writes
    in place."""
    import torch

    from dorpatch_tpu_torch.analysis.program import (node_val, tensor_leaves,
                                                     tensor_sig)

    placeholders = ctx.nodes("placeholder")
    ins = [_value_sig(node_val(n)) for n in placeholders]
    outs = [tensor_sig(t) for t in tensor_leaves(ctx.out_tree)]
    index = {n: i for i, n in enumerate(placeholders)}
    mutated = set()
    for n in ctx.nodes("call_function"):
        t = n.target
        if not isinstance(t, torch._ops.OpOverload) \
                or not t._schema.is_mutable:
            continue
        for arg, a in zip(t._schema.arguments, n.args):
            if arg.alias_info is not None and arg.alias_info.is_write \
                    and a in index:
                mutated.add(index[a])
    return _interface(ins, outs, mutated)


def _interface(ins: List[str], outs: List[str], mutated) -> Dict[str, Any]:
    """The interface record of input and output signatures and written
    inputs, with its sha."""
    rec: Dict[str, Any] = {
        "inputs": {"count": len(ins), "sha": _sha("|".join(ins)),
                   "head": ins[:4]},
        "outputs": {"count": len(outs), "sha": _sha("|".join(outs)),
                    "head": outs[:4]},
        "mutated": sorted(mutated),
    }
    rec["sha"] = _sha(json.dumps(rec, sort_keys=True))
    return rec


def _seedless(func, args, kwargs):
    """`func`'s overload and arguments with its generator taken out, as a
    trace records a draw (`program._NoGenerators`): `rand.generator` is
    `rand.default`, `randint.low_generator` is `randint.low`."""
    import torch

    gen = torch.Generator
    args = tuple(a for a in args if not isinstance(a, gen))
    kwargs = {k: v for k, v in kwargs.items() if not isinstance(v, gen)}
    name = func._overloadname
    if name == "generator" or name.endswith("_generator"):
        base = name[:-len("generator")].rstrip("_") or "default"
        func = getattr(func.overloadpacket, base)
    return func, args, kwargs


def _has_tensor(x) -> bool:
    import torch

    if isinstance(x, torch.Tensor):
        return True
    if isinstance(x, (tuple, list)):
        return any(_has_tensor(v) for v in x)
    return False


class _OpInfo:
    """What the record needs of an op overload, worked out once."""

    __slots__ = ("name", "packet", "kernel", "writes", "seeded")

    def __init__(self, func, kernel_namespace: str):
        schema = func._schema
        self.packet = schema.name.split("::")[-1]
        self.name = f"{func.namespace}.{self.packet}.{func._overloadname}"
        self.kernel = func.namespace == kernel_namespace
        self.writes = tuple(
            i for i, arg in enumerate(schema.arguments)
            if arg.alias_info is not None and arg.alias_info.is_write)
        # "Generator" or "Optional[Generator]"
        self.seeded = any("Generator" in str(arg.type)
                          for arg in schema.arguments)


_OP_INFO: Dict[Any, _OpInfo] = {}


def canonical_run(fn, args: Tuple[Any, ...] = (),
                  kwargs: Optional[Dict[str, Any]] = None):
    """Run `fn(*args, **kwargs)` for real, recording what `canonical_graph`
    renders of its trace: `(text, output, interface sha, indices of the
    inputs written in place)`. The record is taken at the dispatcher, where
    `make_fx` takes its graph, and renders each op as that graph's node
    would render: inputs by position, values by first appearance, a
    closed-over tensor a new constant at each use (a parameter by
    signature, any other by its bytes), a device copy or a lifted constant
    its source, a tuple result's elements as `getitem`s, a draw without
    its generator. So it costs one eager call and tens of microseconds an
    op instead of a trace, which is how a warm boot (`aot/boot.py`) keys
    a program at serving size; the fingerprint of `text` is the trace's
    (`tests/test_torch_aot.py` holds them equal on the registry's
    programs)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from dorpatch_tpu_torch.analysis.program import (KERNEL_NAMESPACE,
                                                     tensor_leaves,
                                                     tensor_sig)

    kwargs = dict(kwargs or {})
    token = object()        # names of this record, kept on the tensors
    Tensor, Parameter = torch.Tensor, torch.nn.Parameter
    sigs: Dict[Any, str] = {}

    def sig(t, layout: bool = True) -> str:
        """`tensor_sig` (or its layout-free head), memoized by geometry."""
        key = (t.shape, t.dtype, t.stride())
        got = sigs.get(key)
        if got is None:
            got = sigs[key] = tensor_sig(t)
        return got if layout else got.split(":")[0]

    def value_sig(v, layout: bool) -> str:
        if isinstance(v, Tensor):
            return sig(v, layout)
        if isinstance(v, (tuple, list)):
            return "(" + ",".join(value_sig(x, layout) for x in v) + ")"
        return _value_sig(v, layout)

    lines: List[str] = []
    count = [0]
    mutated = set()
    shas: Dict[int, Tuple[Any, int, str]] = {}
    inputs = tensor_leaves((tuple(args), kwargs))
    ins: List[str] = []
    for i, t in enumerate(inputs):
        t._dp_rec = (token, f"p{i}")
        lines.append(f"p{i} = input {_value_sig(t, False)}")
        ins.append(_value_sig(t))

    def name_of(t) -> Optional[str]:
        rec = t.__dict__.get("_dp_rec")
        return rec[1] if rec is not None and rec[0] is token else None

    def bytes_sha(t) -> str:
        # a constant read at every use (rects, plans): hashed once a version
        got = shas.get(id(t))
        if got is None or got[0] is not t or got[1] != t._version:
            got = (t, t._version, tensor_bytes_sha(t))
            shas[id(t)] = got
        return got[2]

    plain = (int, float, bool)

    def ref(a) -> str:
        """A value as the graph holds it: the name of a tensor (a new
        constant for an untracked one), containers rendered."""
        if isinstance(a, Tensor):
            rec = a.__dict__.get("_dp_rec")
            if rec is not None and rec[0] is token:
                return rec[1]
            name = f"v{count[0]}"
            count[0] += 1
            if isinstance(a, Parameter):
                what = f"param {sig(a)}"
            else:
                what = f"const {sig(a)}:{bytes_sha(a)}"
            lines.append(f"{name} = {what}")
            return name
        if type(a) in plain:
            return repr(a)
        if isinstance(a, tuple):
            return "(" + ",".join(ref(x) for x in a) + ")"
        if isinstance(a, list):
            return "[" + ",".join(ref(x) for x in a) + "]"
        return _norm_arg(a, {})

    def track(val, name: str) -> None:
        if isinstance(val, torch.Tensor):
            val._dp_rec = (token, name)
        elif isinstance(val, (tuple, list)):
            for i, v in enumerate(val):
                item = f"v{count[0]}"
                count[0] += 1
                lines.append(f"{item} = getitem({name},{i}) -> "
                             f"{value_sig(v, False)}")
                track(v, item)

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            info = _OP_INFO.get(func)
            if info is None:
                info = _OP_INFO[func] = _OpInfo(func, KERNEL_NAMESPACE)
            op_args, op_kwargs = args, kwargs
            if info.seeded:
                func2, op_args, op_kwargs = _seedless(func, args, kwargs)
                info = _OP_INFO.get(func2) or _OpInfo(func2,
                                                      KERNEL_NAMESPACE)
            for i in info.writes:
                if i < len(op_args) and isinstance(op_args[i],
                                                   torch.Tensor):
                    name = name_of(op_args[i])
                    if name is not None and name[0] == "p":
                        mutated.add(int(name[1:]))
            out = func(*args, **kwargs)
            if not isinstance(out, torch.Tensor) and not _has_tensor(out) \
                    and not _has_tensor(op_args) \
                    and not any(_has_tensor(v) for v in op_kwargs.values()):
                return out          # a host computation (promote_types)
            r_args = [ref(x) for x in op_args]
            r_kwargs = {k: ref(v) for k, v in op_kwargs.items()}
            src = op_args[0] if op_args else None
            if isinstance(src, torch.Tensor) and isinstance(
                    out, torch.Tensor) and (
                    info.packet in ("lift_fresh", "lift_fresh_copy")
                    or (info.packet in ("_to_copy", "to")
                        and not set(op_kwargs) - {"device", "dtype",
                                                  "non_blocking", "layout",
                                                  "memory_format"}
                        and src.dtype == out.dtype
                        and tuple(src.shape) == tuple(out.shape))):
                out._dp_rec = (token, r_args[0])
                return out
            name = f"v{count[0]}"
            count[0] += 1
            kw = ",".join(f"{k}={r_kwargs[k]}" for k in sorted(r_kwargs))
            lines.append(f"{name} = {info.name}({','.join(r_args)}"
                         f"{';' + kw if kw else ''}) -> "
                         f"{value_sig(out, info.kernel)}")
            track(out, name)
            return out

    with Recorder():
        out = fn(*args, **kwargs)
        leaves = tensor_leaves(out)
        lines.append("out (" + ",".join(ref(t) for t in leaves) + ")")
    outs = [tensor_sig(t) for t in leaves]
    return ("\n".join(lines), out, _interface(ins, outs, mutated)["sha"],
            sorted(mutated))


# -------------------------------------------------------------- cost model

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def kernel_flops(name: str, args: Sequence[Any], out) -> float:
    """The flops of a kernel's op by the formula of its bound: kernel C 2
    k*k*Cin an output of its `[N, OH, OW]` uniform windows and image,
    kernel H 4 (T + S) f a query row, head and entry; the fill and
    GroupNorm kernels none (they are bound by bytes)."""
    if name == "stem_fold":
        kernel, clean, _, _, occ, oh, ow = args[:7]
        k, _, cin, c = kernel.shape
        return 2.0 * clean.shape[0] * occ.shape[0] * oh * ow * c * k * k \
            * cin
    if name == "masked_kv_attn":
        q, kc = args[0], args[3]
        b, c, s, h, f = q.shape
        return 4.0 * b * c * h * s * (kc.shape[1] + s) * f
    return 0.0


def node_cost(node) -> Tuple[float, float]:
    """(est flops, est bytes) of one call_function node."""
    import torch
    from torch.utils.flop_counter import flop_registry

    from dorpatch_tpu_torch.analysis.program import (_tensors_of, is_kernel,
                                                     node_val, op_packet)

    def val(a):
        if isinstance(a, torch.fx.Node):
            return node_val(a)
        if isinstance(a, (tuple, list)):
            return type(a)(val(x) for x in a)
        return a

    args = [val(a) for a in node.args]
    kwargs = {k: val(v) for k, v in node.kwargs.items()}
    out = node_val(node)
    nbytes = sum(_nbytes(t) for t in _tensors_of(args) + _tensors_of(out))
    flops = 0.0
    if is_kernel(node):
        flops = kernel_flops(op_packet(node), args, out)
    else:
        packet = getattr(node.target, "overloadpacket", None)
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
    return flops, float(nbytes)


def estimate_cost(gm) -> Dict[str, Any]:
    """Static cost of a traced graph: flops, boundary bytes, arithmetic
    intensity (flops/byte) and the flops (or, for flop-free ops, bytes)
    by op, the heaviest first."""
    from dorpatch_tpu_torch.analysis.program import op_packet

    flops = nbytes = 0.0
    by_op: Dict[str, float] = {}
    for n in gm.graph.nodes:
        if n.op != "call_function":
            continue
        f, b = node_cost(n)
        flops += f
        nbytes += b
        if f:
            by_op[op_packet(n)] = by_op.get(op_packet(n), 0.0) + f
    top = dict(sorted(by_op.items(),
                      key=lambda kv: (-kv[1], kv[0]))[:TOP_K_PRIMITIVES])
    return {"est_flops": flops, "est_bytes": nbytes,
            "est_ai": flops / max(nbytes, 1.0), "primitives": top}


def kernel_ops(gm) -> Dict[str, int]:
    """The kernels' ops in a graph: op name -> nodes."""
    from dorpatch_tpu_torch.analysis.program import is_kernel, op_packet

    out: Dict[str, int] = {}
    for n in gm.graph.nodes:
        if n.op == "call_function" and is_kernel(n):
            out[op_packet(n)] = out.get(op_packet(n), 0) + 1
    return out


# ---------------------------------------------------------------- snapshot

def snapshot_entrypoint(ep, device=None
                        ) -> Tuple[Optional[Dict[str, Any]], List[Finding]]:
    """One entry point -> its baseline entry dict. A program that cannot
    trace cannot be fingerprinted: a DP300 gate failure (the `--trace`
    tier says why)."""
    from dorpatch_tpu_torch.analysis import program as program_mod

    ctx, errs = program_mod.trace_entrypoint(ep, device)
    if ctx is None:
        first = errs[0] if errs else None
        return None, [Finding(
            path=first.path if first else "<entrypoint>",
            line=first.line if first else 1, col=1, rule_id="DP300",
            message=f"[{ep.name}] cannot fingerprint: program failed to "
                    "trace on fake tensors"
                    + (f" ({first.message.split(': ', 1)[-1][:160]})"
                       if first else ""))]
    est = estimate_cost(ctx.gm)
    entry: Dict[str, Any] = {
        "fingerprint": fingerprint(ctx.gm),
        "interface": interface_record(ctx),
        "cost": {"est_flops": est["est_flops"], "est_bytes": est["est_bytes"],
                 # derived: flops and bytes already gate DP301
                 "est_ai": est["est_ai"]},
        "primitives": est["primitives"],
        "kernels": kernel_ops(ctx.gm),
        "_path": ctx.path,
        "_line": ctx.line,
    }
    return entry, []


def build_baseline(eps: Iterable[Any]) -> Tuple[Dict[str, Any], List[Finding]]:
    """Snapshot every entry point into the baseline-file structure.
    Findings (untraceable programs) make the build unusable for
    `update`."""
    entries: Dict[str, Any] = {}
    findings: List[Finding] = []
    for ep in eps:
        snap, errs = snapshot_entrypoint(ep)
        findings.extend(errs)
        if snap is not None:
            entries[ep.name] = {k: v for k, v in snap.items()
                                if not k.startswith("_")}
    data = {
        "version": 1,
        "tolerance_default": DEFAULT_TOLERANCE,
        "entries": entries,
    }
    return data, findings


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


def load_baseline(path: Optional[pathlib.Path] = None
                  ) -> Optional[Dict[str, Any]]:
    p = pathlib.Path(path) if path is not None else baseline_path()
    try:
        return json.loads(p.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None


def fingerprint_set_hash(entries: Mapping[str, Any]) -> str:
    """One hash over the whole program set (sorted `name:fingerprint`
    lines): the identity a measurement or a cache keys on."""
    lines = [f"{name}:{entries[name].get('fingerprint', '?')}"
             for name in sorted(entries)]
    return _sha("\n".join(lines))


def program_set_stamp(path: Optional[pathlib.Path] = None
                      ) -> Optional[Dict[str, Any]]:
    """{hash, entries, file} of the checked-in baseline, so a recorded
    measurement is attributable to an exact program set. None when no
    baseline file exists."""
    data = load_baseline(path)
    if not data or not data.get("entries"):
        return None
    return {"hash": fingerprint_set_hash(data["entries"]),
            "entries": len(data["entries"]),
            "file": f"analysis/{BASELINE_FILENAME}"}


# ------------------------------------------------------------------- check

def allowed(name: str, rule_id: str,
            allow: Optional[Dict[str, Dict[str, str]]] = None) -> bool:
    for table in (ALLOWLIST, allow or {}):
        for pattern, rules in table.items():
            if fnmatch.fnmatchcase(name, pattern) and rule_id in rules:
                return True
    return False


def tolerance_for(name: str, data: Mapping[str, Any]) -> float:
    for pattern, tol in TOLERANCES.items():
        if fnmatch.fnmatchcase(name, pattern):
            return float(tol)
    return float(data.get("tolerance_default", DEFAULT_TOLERANCE))


def _fmt_count(x: float) -> str:
    return f"{int(x):,}" if float(x).is_integer() else f"{x:,.1f}"


#: the metrics DP301 gates
_COST_METRICS = ("est_flops", "est_bytes")


def _cost_findings(name: str, live: Mapping[str, Any],
                   base: Mapping[str, Any], tol: float,
                   path: str, line: int) -> List[Finding]:
    """DP301: the worst relative cost growth across the metrics both sides
    carry, beyond tolerance; names the dominant regressing op."""
    lcost, bcost = live.get("cost", {}), base.get("cost", {})
    worst = None
    for metric in _COST_METRICS:
        lv, bv = lcost.get(metric), bcost.get(metric)
        if lv is None or bv is None or float(bv) <= 0:
            continue
        rel = float(lv) / float(bv) - 1.0
        if rel > tol and (worst is None or rel > worst[1]):
            worst = (metric, rel, float(bv), float(lv))
    if worst is None:
        return []
    metric, rel, bv, lv = worst
    lprims = live.get("primitives", {}) or {}
    bprims = base.get("primitives", {}) or {}
    deltas = sorted(
        ((p, float(lprims.get(p, 0.0)) - float(bprims.get(p, 0.0)))
         for p in set(lprims) | set(bprims)),
        key=lambda kv: (-kv[1], kv[0]))
    dom = ""
    if deltas and deltas[0][1] > 0:
        dom = (f"; dominant op increase: {deltas[0][0]} "
               f"(+{_fmt_count(deltas[0][1])} est flops)")
    return [Finding(
        path=path, line=line, col=1, rule_id="DP301",
        message=f"[{name}] {metric} regressed {100.0 * rel:.1f}% over the "
                f"baseline ({_fmt_count(bv)} -> {_fmt_count(lv)}; "
                f"tolerance {100.0 * tol:.0f}%){dom} — a perf regression, "
                "or a baseline missing its --baseline update")]


def _iface_findings(name: str, live: Mapping[str, Any],
                    base: Mapping[str, Any], path: str,
                    line: int) -> List[Finding]:
    li, bi = live.get("interface", {}), base.get("interface", {})
    if li.get("sha") == bi.get("sha"):
        return []
    drifted = []
    for side in ("inputs", "outputs"):
        ls, bs = li.get(side, {}), bi.get(side, {})
        if ls.get("sha") != bs.get("sha") or ls.get("count") != bs.get("count"):
            drifted.append(
                f"{side} {bs.get('count', '?')} "
                f"{', '.join(bs.get('head', [])) or '?'}... -> "
                f"{ls.get('count', '?')} "
                f"{', '.join(ls.get('head', [])) or '?'}...")
    if li.get("mutated") != bi.get("mutated"):
        drifted.append(f"inputs written in place {bi.get('mutated')} -> "
                       f"{li.get('mutated')}")
    return [Finding(
        path=path, line=line, col=1, rule_id="DP304",
        message=f"[{name}] interface drifted with an UNCHANGED program "
                f"fingerprint ({'; '.join(drifted) or 'signature metadata'})"
                " — regenerate the baseline and audit the caller")]


def _implied_buckets(base_name: str, live_names: Iterable[str],
                     ladders: Mapping[str, int]) -> Optional[int]:
    """Bucket count the program set implies for a wrapped entry point: an
    explicitly registered ladder wins; otherwise the `name[...]` variant
    count in the registry. None = nothing implied."""
    if base_name in ladders:
        return int(ladders[base_name])
    variants = [n for n in live_names
                if n.startswith(base_name + "[") and n.endswith("]")]
    return len(variants) or None


def check_entrypoints(
        eps: Iterable[Any],
        data: Mapping[str, Any],
        budgets: Optional[Mapping[str, Optional[int]]] = None,
        ladders: Optional[Mapping[str, int]] = None,
        select: Optional[Sequence[str]] = None,
        allow: Optional[Dict[str, Dict[str, str]]] = None,
        live_out: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """Diff the live program set against the baseline: DP300-DP304.
    `budgets`/`ladders` feed DP303 (from `entrypoints.declared_budgets()`
    / `bucket_ladders()`). `live_out` receives each program's live entry
    (the AOT store's build keys on them)."""
    from dorpatch_tpu_torch.analysis import program as program_mod

    entries: Mapping[str, Any] = data.get("entries", {})
    live: Dict[str, Dict[str, Any]] = {}
    findings: List[Finding] = []
    anchors: Dict[str, Tuple[str, int]] = {}
    for ep in eps:
        snap, errs = snapshot_entrypoint(ep)
        findings.extend(errs)
        if snap is None:
            continue
        anchors[ep.name] = (snap.pop("_path"), snap.pop("_line"))
        live[ep.name] = snap
    if live_out is not None:
        live_out.update(live)

    for name in sorted(set(live) - set(entries)):
        path, line = anchors.get(name, ("<entrypoint>", 1))
        findings.append(Finding(
            path=path, line=line, col=1, rule_id="DP302",
            message=f"[{name}] entry point is registered in production but "
                    "missing from the baseline — regenerate with "
                    "--baseline update so the program set stays covered"))
    for name in sorted(set(entries) - set(live)):
        findings.append(Finding(
            path="<baseline>", line=1, col=1, rule_id="DP302",
            message=f"[{name}] entry point exists in the baseline but is "
                    "no longer registered — removed program, or a "
                    "registration hole; regenerate with --baseline update"))

    for name in sorted(set(live) & set(entries)):
        cur, base = live[name], entries[name]
        path, line = anchors.get(name, ("<entrypoint>", 1))
        if cur.get("fingerprint") != base.get("fingerprint"):
            findings.append(Finding(
                path=path, line=line, col=1, rule_id="DP300",
                message=f"[{name}] program fingerprint drifted "
                        f"({base.get('fingerprint', '?')} -> "
                        f"{cur.get('fingerprint', '?')}) but the baseline "
                        "still records the old program — regenerate with "
                        "--baseline update in the same change"))
        else:
            findings.extend(_iface_findings(name, cur, base, path, line))
        findings.extend(_cost_findings(
            name, cur, base, tolerance_for(name, data), path, line))

    for base_name in sorted(budgets or {}):
        budget = (budgets or {})[base_name]
        if budget is None:
            continue
        implied = _implied_buckets(base_name, live, ladders or {})
        if implied is None or int(budget) == implied:
            continue
        path, line = ("<entrypoint>", 1)
        for cand in ([base_name]
                     + [n for n in sorted(live)
                        if n.startswith(base_name + "[")]):
            if cand in anchors:
                path, line = anchors[cand]
                break
        findings.append(Finding(
            path=path, line=line, col=1, rule_id="DP303",
            message=f"[{base_name}] declared recompile_budget {budget} but "
                    f"the registered program set implies {implied} "
                    "bucket(s) — the watchdog budget and the bucket "
                    "ladder drifted apart"))

    out: List[Finding] = []
    for f in findings:
        name = f.message.split("]", 1)[0].lstrip("[")
        if select is not None and f.rule_id not in select:
            continue
        if allowed(name, f.rule_id, allow):
            continue
        if program_mod.suppressed_in_source(f.path, f.line, f.rule_id):
            continue
        out.append(f)
    return sorted(out)


def check_summary(findings: List[Finding], entries: int,
                  data: Mapping[str, Any],
                  path: pathlib.Path) -> Dict[str, Any]:
    """The machine-readable check result (`--baseline-report` writes it as
    `baseline_check.json`)."""
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule_id] = by_rule.get(f.rule_id, 0) + 1
    intensity = []
    for name, e in data.get("entries", {}).items():
        cost = e.get("cost", {}) or {}
        fl, by = cost.get("est_flops"), cost.get("est_bytes")
        if fl is None or by is None:
            continue
        intensity.append({
            "name": name, "est_flops": float(fl), "est_bytes": float(by),
            "est_ai": float(cost.get("est_ai",
                                     float(fl) / max(float(by), 1.0)))})
    intensity.sort(key=lambda r: (-r["est_bytes"], r["name"]))
    bf16_bytes = f32_bytes = 0.0
    paired = 0
    all_entries = data.get("entries", {})
    for name, e in all_entries.items():
        if ".bf16" not in name:
            continue
        twin = all_entries.get(name.replace(".bf16", ""))
        if twin is None:
            continue
        by = (e.get("cost", {}) or {}).get("est_bytes")
        twin_by = (twin.get("cost", {}) or {}).get("est_bytes")
        if by is None or twin_by is None:
            continue
        paired += 1
        bf16_bytes += float(by)
        f32_bytes += float(twin_by)
    dtype_bytes = None
    if paired:
        dtype_bytes = {"paired_entries": paired,
                       "bf16_bytes": bf16_bytes, "f32_bytes": f32_bytes,
                       "ratio": round(bf16_bytes / f32_bytes, 4)
                       if f32_bytes else None}
    return {
        "entries": entries,
        "baseline_file": str(path),
        "baseline_entries": len(data.get("entries", {})),
        "fingerprint_set": fingerprint_set_hash(data.get("entries", {})),
        "clean": not findings,
        "findings_by_rule": dict(sorted(by_rule.items())),
        "findings": [
            {"rule": f.rule_id, "path": f.path, "line": f.line,
             "message": f.message} for f in findings],
        "intensity": intensity[:8],
        "dtype_bytes": dtype_bytes,
    }


@dataclasses.dataclass
class DeviceCheck:
    """One program traced on fake tensors of several devices: its
    fingerprint on each ("untraceable: ..." where it does not trace) and
    the kernels' ops of its graph."""

    name: str
    fingerprints: Dict[str, str]
    kernels: Dict[str, int]

    @property
    def same(self) -> bool:
        return len(set(self.fingerprints.values())) == 1 and not any(
            v.startswith("untraceable") for v in self.fingerprints.values())


def device_fingerprints(eps: Iterable[Any],
                        devices: Sequence[str] = ("cuda", "cpu")
                        ) -> List[DeviceCheck]:
    """Each program traced on fake tensors of every device in `devices`."""
    from dorpatch_tpu_torch.analysis import program as program_mod

    out = []
    for ep in eps:
        fps: Dict[str, str] = {}
        kernels: Dict[str, int] = {}
        for dev in devices:
            ctx, errs = program_mod.trace_entrypoint(ep, dev)
            if ctx is None:
                fps[dev] = "untraceable: " + errs[0].message[:200]
                continue
            fps[dev] = fingerprint(ctx.gm)
            kernels = kernel_ops(ctx.gm)
        out.append(DeviceCheck(ep.name, fps, kernels))
    return out
