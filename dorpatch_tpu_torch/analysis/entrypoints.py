"""Entry-point registry: the exact programs production runs.

Port of `dorpatch_tpu.analysis.entrypoints`. The program auditor
(`program.py`) and the baseline tier (`baseline.py`) need the callable of
every program and example arguments to trace it with:

- **Discovery** — `observe.timed_first_call` reports every wrap (and every
  call) through the recorder hook (`observe.set_entrypoint_recorder`), so
  constructing a subsystem under `capture_entrypoints()` records the exact
  `(name, fn)` pairs production registers with the telemetry layer, and
  running it records each program's arguments. A program the enumerators
  construct but never give example arguments is *discovered but
  unauditable*: the audit fails on it (DP200) instead of skipping it.
- **Registration** — `register_entrypoint(fn, args=...)` attaches example
  arguments to a discovered wrapper, or registers another program under an
  explicit name.
- **Enumeration** — `production_entrypoints()` constructs (and never runs)
  the programs the production stack runs: the attack's
  "attack.step.stage0/1" and "attack.sweep", the defense's predict, phase1,
  pairs and rows programs per radius (f32, the bf16 bank, and the stem,
  token and mixer engines' banks in both dtypes), "serve.clean_predict" at
  the service's buckets, "train.step"/"train.eval_step", and probes of
  the GroupNorm kernels, which no CIFAR program runs. The victims
  are the CIFAR family at the JAX auditor's size (32 px, batch 2, 10
  classes), so the gate stays cheap on the CPU while driving the
  production code paths.

Example arguments are fake tensors (`FakeTensorMode`): shape, dtype,
strides and device, no data. Non-tensor arguments (ints, a
`torch.Generator`) pass through as they are. The victims' weights are
real (seeded, on the CPU): the programs close over them, as production's
do.

Eager torch has no program for two of the JAX package's entry points:
`NOT_PROGRAMS` lists them with the reason.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from dorpatch_tpu_torch import observe

#: The JAX package's entry points that have no program in eager torch.
NOT_PROGRAMS: Dict[str, str] = {
    "train.init": ("eager torch initializes the parameters in the module's "
                   "constructor (`registry.build_bare_model`): nothing is "
                   "traced or compiled for it"),
    "model.init.*": ("the victim's initializer is its constructor and "
                     "`init_weights`, run once on the host; no program"),
}


@dataclasses.dataclass
class EntryPoint:
    """One auditable program: the (unwrapped) callable plus the example
    arguments it is traced with. Tensor leaves of `args`/`kwargs` are fake
    tensors; other leaves pass through as they are."""

    name: str
    fn: Callable
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: "registered" (explicit example args) or "captured" (args recorded
    #: from a live call through the timed_first_call wrapper)
    source: str = "registered"


#: name -> EntryPoint with example args attached (auditable)
_REGISTRY: Dict[str, EntryPoint] = {}
#: every name seen through a timed_first_call wrap (discoverability ledger)
_WRAPPED: Dict[str, Callable] = {}
#: base name -> the recompile_budget its timed_first_call wrap declared
#: (None = undeclared); feeds the baseline tier's DP303 consistency check
_BUDGETS: Dict[str, Optional[int]] = {}
#: base name -> the bucket-ladder length the constructing subsystem
#: registered (`register_bucket_ladder`); the ground truth DP303 compares
#: declared budgets against
_LADDERS: Dict[str, int] = {}
_EXAMPLE_MODE = None


def _example_mode():
    """The fake mode the example arguments live in."""
    global _EXAMPLE_MODE
    if _EXAMPLE_MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _EXAMPLE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _EXAMPLE_MODE


def abstractify(tree):
    """The value with every tensor leaf (in tuples, lists, dicts and
    dataclass fields) replaced by a fake tensor of the same shape, dtype,
    strides and device; other leaves pass through."""
    from torch._subclasses.fake_tensor import FakeTensor

    def leaf(t):
        if isinstance(t, FakeTensor):
            return t
        with _example_mode():
            return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                                       dtype=t.dtype, device=t.device)

    return map_tensors(leaf, tree)


def map_tensors(fn: Callable, tree):
    """`tree` with `fn` applied to every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        out = [map_tensors(fn, v) for v in tree]
        return type(tree)(out) if not hasattr(tree, "_fields") \
            else type(tree)(*out)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _unwrap(fn: Callable) -> Callable:
    """Strip `timed_first_call` wrappers, and only those."""
    from dorpatch_tpu_torch.observe.events import _FirstCallTimer

    while isinstance(fn, _FirstCallTimer):
        fn = fn.__wrapped__
    return fn


def register_entrypoint(fn: Callable, args: Tuple[Any, ...] = (),
                        kwargs: Optional[Dict[str, Any]] = None,
                        name: Optional[str] = None) -> EntryPoint:
    """Attach example args to a program. `fn` may be a `timed_first_call`
    wrapper (its telemetry name is reused) or any callable (pass `name`).
    Tensor leaves are made fake; the program is never run."""
    resolved = name or getattr(fn, "_name", None) or getattr(
        fn, "__name__", None)
    if not resolved:
        raise ValueError(f"cannot derive a name for entry point {fn!r}")
    ep = EntryPoint(name=resolved, fn=_unwrap(fn),
                    args=tuple(abstractify(a) for a in args),
                    kwargs={k: abstractify(v)
                            for k, v in (kwargs or {}).items()})
    _REGISTRY[resolved] = ep
    return ep


def registered_entrypoints() -> List[EntryPoint]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def uncovered_names() -> List[str]:
    """Discovered-but-unauditable names: a `timed_first_call` site was
    constructed, but no registration attached example args (bucketed
    registrations like `serve.clean_predict[b4]` cover their base name)."""
    out = []
    for name in sorted(_WRAPPED):
        if name in _REGISTRY:
            continue
        if any(r.startswith(name + "[") for r in _REGISTRY):
            continue
        out.append(name)
    return out


def register_bucket_ladder(name: str, sizes) -> None:
    """Record the bucket ladder a subsystem builds for a wrapped program
    (e.g. the defense row programs' `row_bucket_sizes`). DP303 checks the
    wrap's declared `recompile_budget` against this count."""
    _LADDERS[name] = len(tuple(sizes))


def declared_budgets() -> Dict[str, Optional[int]]:
    """base name -> `recompile_budget` declared at its timed_first_call
    wrap (captured through the recorder's `on_budget` hook)."""
    return dict(_BUDGETS)


def bucket_ladders() -> Dict[str, int]:
    """base name -> explicitly registered bucket-ladder length."""
    return dict(_LADDERS)


def clear_entrypoints() -> None:
    _REGISTRY.clear()
    _WRAPPED.clear()
    _BUDGETS.clear()
    _LADDERS.clear()


class _CaptureRecorder:
    """The `observe.set_entrypoint_recorder` hook: wraps land in the
    discoverability ledger; live calls contribute example args (made fake
    before the call) for any entry point not explicitly registered."""

    def on_wrap(self, name: str, fn: Callable) -> None:
        _WRAPPED[name] = fn

    def on_budget(self, name: str, budget: Optional[int]) -> None:
        # last write wins: a name wrapped twice keeps its latest
        # declaration, the live wrapper's
        _BUDGETS[name] = budget

    def on_call(self, name: str, fn: Callable, args, kwargs) -> None:
        _WRAPPED.setdefault(name, fn)
        if name not in _REGISTRY:
            _REGISTRY[name] = EntryPoint(
                name=name, fn=_unwrap(fn),
                args=tuple(abstractify(a) for a in args),
                kwargs={k: abstractify(v) for k, v in kwargs.items()},
                source="captured")


@contextlib.contextmanager
def capture_entrypoints() -> Iterator[None]:
    """Record every `timed_first_call` wrap/call in the scope into the
    registry; restores any previously installed recorder on exit."""
    prev = observe.entrypoint_recorder()
    observe.set_entrypoint_recorder(_CaptureRecorder())
    try:
        yield
    finally:
        observe.set_entrypoint_recorder(prev)


# ---------------------------------------------------------------- enumerators

#: Victim geometry for enumeration: the small CIFAR family keeps the gate's
#: tracing cost in CPU seconds while driving the production code paths.
#: A program's chunk loops run in Python and each chunk is a copy of the
#: forward in the graph: the audit's chunks are large (one or two a
#: program), the code paths the same.
AUDIT_IMG_SIZE = 32
AUDIT_BATCH = 2
AUDIT_CLASSES = 10
AUDIT_SEED = 0
AUDIT_CHUNK = 1024
AUDIT_SAMPLES = 64
CPU = torch.device("cpu")
#: the device the enumerators build on (`registry_device`): the CPU for the
#: audits, the card for an AOT store's build
_DEV = CPU


@contextlib.contextmanager
def registry_device(device) -> Iterator[None]:
    """Build the registry's victims, banks and example arguments on
    `device` within the scope (`python -m dorpatch_tpu_torch.aot build`
    materializes the programs on the card). The programs and their
    fingerprints are the same on every device."""
    global _DEV
    prev, _DEV = _DEV, torch.device(device)
    try:
        yield
    finally:
        _DEV = prev


def _victim(arch: str):
    """`(apply_fn, engine)` of a frozen CIFAR-family victim on the
    registry's device, seeded: its forward and its incremental engine."""
    from dorpatch_tpu_torch.models import registry

    model = registry.build_bare_model(arch, AUDIT_CLASSES, AUDIT_IMG_SIZE)
    model = model.to(_DEV).eval().requires_grad_(False)
    return (registry.VictimForward(model),
            registry.incremental_engine(arch, model, AUDIT_IMG_SIZE))


def _imgs(b: int) -> torch.Tensor:
    return torch.zeros((b, AUDIT_IMG_SIZE, AUDIT_IMG_SIZE, 3), device=_DEV)


def _enumerate_attack(apply_fn) -> None:
    from dorpatch_tpu_torch import losses, utils
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.attack import DorPatch
    from dorpatch_tpu_torch.config import AttackConfig

    cfg = AttackConfig(sampling_size=AUDIT_SAMPLES, dropout=1,
                       sweep_interval=50, max_iterations=100)
    atk = DorPatch(apply_fn, AUDIT_CLASSES, cfg,
                   recompile_budget=AUDIT_BATCH)
    x = _imgs(AUDIT_BATCH)
    y = torch.zeros((AUDIT_BATCH,), dtype=torch.long, device=_DEV)
    universe = torch.as_tensor(masks_lib.dropout_universe(
        AUDIT_IMG_SIZE, cfg.dropout, cfg.dropout_sizes), device=_DEV)
    gen = utils.generator(AUDIT_SEED, _DEV)
    state = atk._init_state(gen, x, y, False, int(universe.shape[0]))
    lvx = torch.mean(losses.local_variance(x)[0], dim=-1)
    for stage in (0, 1):
        register_entrypoint(atk._programs[stage],
                            (state, x, lvx, universe, stage))
    register_entrypoint(atk._programs["sweep"],
                        (state.adv_mask, state.adv_pattern, x, state.y,
                         state.targeted, universe))


def _register_bank(defenses, imgs_args=True) -> None:
    """The programs of a defense bank: the pruned path's three per radius
    (and, with `imgs_args`, the exhaustive predict program)."""
    imgs = _imgs(AUDIT_BATCH)
    for d in defenses:
        if imgs_args:
            register_entrypoint(d._predict, (imgs, AUDIT_CLASSES))
        w = int(d.row_bucket_sizes[0])
        imgs_g = _imgs(w)
        for name, fn, kind in d.pruned_programs():
            if kind == "imgs":
                register_entrypoint(fn, (imgs,), name=name)
            elif kind == "rows_sets":
                sets = torch.zeros((w, d.num_first), dtype=torch.long,
                                   device=_DEV)
                register_entrypoint(fn, (imgs_g, sets), name=name)
            else:
                register_entrypoint(
                    fn, (imgs_g, torch.zeros((w,), dtype=torch.long,
                                             device=_DEV)),
                    name=name)
            if kind != "imgs":
                register_bucket_ladder(name, d.row_bucket_sizes)


def _enumerate_defense(apply_fn) -> None:
    """The f32 bank at the four radii (exhaustive and pruned programs) and
    the bf16 bank's pruned programs (`.bf16`): under bf16 the predict
    program is the f32 escalation oracle, the same program and name."""
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import build_defenses

    for dtype in ("float32", "bfloat16"):
        cfg = DefenseConfig(chunk_size=AUDIT_CHUNK, compute_dtype=dtype,
                            incremental="off")
        _register_bank(build_defenses(apply_fn, AUDIT_IMG_SIZE, cfg,
                                      device=_DEV, recompile_budget=1),
                       imgs_args=dtype == "float32")


def _enumerate_incremental() -> None:
    """The engines' banks at one radius (0.06), in f32 and bf16: the stem
    fold (CIFAR ResNet-18, kernel C), the token engine (cifar_vit, kernel
    H) and the mixer engine (cifar_resmlp)."""
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import build_defenses

    for arch in ("cifar_resnet18", "cifar_vit", "cifar_resmlp"):
        apply_fn, engine = _victim(arch)
        for dtype in ("float32", "bfloat16"):
            cfg = DefenseConfig(ratios=(0.06,), chunk_size=AUDIT_CHUNK,
                                compute_dtype=dtype)
            _register_bank(build_defenses(apply_fn, AUDIT_IMG_SIZE, cfg,
                                          incremental=engine, device=_DEV,
                                          recompile_budget=1),
                           imgs_args=False)


def _enumerate_serve(apply_fn) -> None:
    """The service's programs as it names them (`trace_entrypoints()`,
    replica 0's bank: every replica runs the same programs under the same
    names): at each of its buckets the clean forward and its bank's
    exhaustive and pruned image programs; the rows programs at the bank's
    smallest row bucket."""
    from dorpatch_tpu_torch.config import DefenseConfig, ServeConfig
    from dorpatch_tpu_torch.serve.service import CertifiedInferenceService

    svc = CertifiedInferenceService(
        apply_fn, num_classes=AUDIT_CLASSES, img_size=AUDIT_IMG_SIZE,
        serve_cfg=ServeConfig(max_batch=4, bucket_sizes=(1, 4)),
        defense_cfg=DefenseConfig(ratios=(0.1,), chunk_size=AUDIT_CHUNK),
        device=_DEV)
    for name, fn, args in svc.trace_entrypoints():
        register_entrypoint(fn, args, name=name)
    for d in svc.defenses:
        for name, _fn, kind in d.pruned_programs():
            if kind in ("rows", "rows_sets"):
                register_bucket_ladder(name, d.row_bucket_sizes)


def _enumerate_train() -> None:
    from dorpatch_tpu_torch import train, utils
    from dorpatch_tpu_torch.models import registry

    cfg = train.TrainConfig()
    model = registry.build_bare_model("cifar_resnet18", AUDIT_CLASSES,
                                      AUDIT_IMG_SIZE).to(_DEV)
    step, evals = train.make_train_programs(
        cfg, model, train.make_optimizer(cfg, model))
    b = AUDIT_BATCH
    x = torch.zeros((b, AUDIT_IMG_SIZE, AUDIT_IMG_SIZE, 3),
                    dtype=torch.uint8, device=_DEV)
    y = torch.zeros((b,), dtype=torch.long, device=_DEV)
    offsets, flips = train.draw_augment(utils.generator(AUDIT_SEED, _DEV), b)
    register_entrypoint(step, (x, y, offsets, flips))
    register_entrypoint(evals, (x, y))


def _gn_relu_grad(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """GroupNorm+ReLU and its gradient, as ResNetV2's blocks run them."""
    from dorpatch_tpu_torch.ops.fused_gn import gn_relu

    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        y = gn_relu(x, scale, bias)
        (dx,) = torch.autograd.grad(y.sum(), (x,))
    return y.detach(), dx


def _enumerate_kernel_probes() -> None:
    """Audit-only probe programs for the kernels no CIFAR program runs:
    the GroupNorm+ReLU forward and backward (kernels D-G, ResNetV2's), at
    a RN50 stage-1 width and float32 and bf16. Never run in production;
    there to put their ops under the trace and baseline gates."""
    for dtype in (torch.float32, torch.bfloat16):
        tag = ".bf16" if dtype == torch.bfloat16 else ""
        x = torch.zeros((AUDIT_BATCH, 8, 8, 256), dtype=dtype, device=_DEV)
        register_entrypoint(_gn_relu_grad,
                            (x, torch.ones((256,), device=_DEV),
                             torch.zeros((256,), device=_DEV)),
                            name=f"ops.gn_relu.grad{tag}")


def production_entrypoints(clear: bool = True) -> List[EntryPoint]:
    """Construct — never run — every production program with example
    arguments: the `--trace` and `--baseline` audits' work list."""
    if clear:
        clear_entrypoints()
    with capture_entrypoints():
        apply_fn, _ = _victim("cifar_resnet18")
        _enumerate_attack(apply_fn)
        _enumerate_defense(apply_fn)
        _enumerate_incremental()
        _enumerate_serve(apply_fn)
        _enumerate_train()
        _enumerate_kernel_probes()
    return registered_entrypoints()
