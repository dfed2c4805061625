"""Warm-boot loader: install each program's executable before traffic.

Port of `dorpatch_tpu.aot.boot`. The port's programs are eager; their
executable is a **CUDA graph captured for one call signature**: it
replays the same kernels on the same stream, so it computes the same bits
as the eager call it was captured from (checked at capture, bit for bit).

* `AotDispatcher` — stands in for a program behind its
  `observe._FirstCallTimer` (`__wrapped__`). It routes each call by its
  structural signature (`call_signature`) to an installed executable: a
  graph replay (inputs copied into the graph's static buffers, the
  outputs cloned so no caller holds memory the next replay overwrites) or
  an eager run (method `eager`: a CPU tensor, or a program capture
  refused). Unknown signatures fall through to the program itself (one
  `aot.miss` event a signature). `_cache_size()` counts the signatures the
  program ran eagerly, so a fully graphed path reads 0.

* `warm_boot(programs, aot_cfg)` — the eager loader of serve: for every
  (name, timer, example args) triple of `trace_entrypoints()` it runs the
  program once (the cold first call, which also picks cuDNN's algorithms
  and fills the engines' plans), keyed by the canonical fingerprint of
  that call (`analysis/baseline.canonical_run`, the trace's fingerprint
  at the cost of one call), looks the record up in the store and captures
  it. Misses under `strict` raise `AotBootError` before anything is
  captured or warmed; under `auto` they capture and rewrite the store
  entry, so a stale record is never served. The kernel library comes from
  the store's blob when the store has one for these sources (sha-checked;
  a failed check is a `corrupt` miss, never a silent rebuild).

* `FirstCallAotResolver` — the lazy, read-only variant for farm workers,
  installed through `observe.set_aot_resolver`: on a timer's first call it
  substitutes a store-backed dispatcher that resolves by fingerprint on
  each new signature and never writes (no multi-worker write races), and
  never raises into its host: every miss is an `aot.miss` with its reason.

A replica's graphs share one memory pool (`torch.cuda.graph_pool_handle`);
since outputs are cloned, replays may come in any order (one at a time: a
replica runs one batch at a time). A program whose arguments hold a
`torch.Generator` (the attack's carry) is captured with its own generator
registered to the graph (`CUDAGraph.register_generator_state`); a replay
starts it from the live generator's state and hands the advanced state
back, so consecutive calls draw as eager ones do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.aot.store import ExecutableStore


class AotBootError(RuntimeError):
    """Strict-mode warm boot failed: a program missed the store."""


class ReplayDiffers(RuntimeError):
    """A graph's replay did not equal its eager call bit for bit."""


# ------------------------------------------------------------------ trees

def _is_tensor(x) -> bool:
    import torch

    return isinstance(x, torch.Tensor)


def _is_generator(x) -> bool:
    import torch

    return isinstance(x, torch.Generator)


def _map(fn: Callable, tree):
    """`tree` with `fn` applied to every tensor and generator leaf (in
    tuples, lists, dicts and dataclass fields); other leaves pass."""
    if _is_tensor(tree) or _is_generator(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _leaves(tree) -> List[Any]:
    out: List[Any] = []

    def take(x):
        out.append(x)
        return x

    _map(take, tree)
    return out


def _structure(tree) -> Tuple[str, List[Any]]:
    """(text of the containers, their non-array leaves in order)."""
    leaves: List[Any] = []

    def walk(t) -> str:
        if _is_tensor(t):
            leaves.append(t)
            return "T"
        if _is_generator(t):
            leaves.append(t)
            return "G"
        if isinstance(t, (tuple, list)):
            return f"{type(t).__name__}(" + ",".join(walk(v) for v in t) + ")"
        if isinstance(t, dict):
            return "{" + ",".join(f"{k}:{walk(t[k])}"
                                  for k in sorted(t, key=str)) + "}"
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return f"{type(t).__name__}(" + ",".join(
                f"{f.name}={walk(getattr(t, f.name))}"
                for f in dataclasses.fields(t)) + ")"
        leaves.append(t)
        return "S"

    return walk(tree), leaves


def call_signature(args: tuple, kwargs: dict) -> Tuple[str, tuple]:
    """Structural dispatch key, the same for a program's example arguments
    (fake or real) and the tensors of a live call: the tree's structure
    (tuples, lists, dicts, dataclass fields), each tensor's (shape, dtype,
    device, memory format), each generator's device, each other leaf by
    repr. A value baked into a graph at capture (`num_classes`,
    `with_margins`, a stage) is part of the key: a different one can
    miss, it can never replay the wrong graph."""
    from dorpatch_tpu_torch.analysis.program import memory_format

    text, leaves = _structure((tuple(args), dict(kwargs)))
    sig = []
    for leaf in leaves:
        if _is_tensor(leaf):
            sig.append(("t", tuple(int(d) for d in leaf.shape),
                        str(leaf.dtype), str(leaf.device),
                        memory_format(leaf)))
        elif _is_generator(leaf):
            sig.append(("g", str(leaf.device)))
        else:
            sig.append(("s", repr(leaf)))
    return (text, tuple(sig))


def _bit_equal(a, b) -> bool:
    """Two output trees equal bit for bit (NaN payloads included)."""
    import torch

    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if _is_generator(x) or _is_generator(y):
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[x.element_size()]
            x, y = x.contiguous().view(ints), y.contiguous().view(ints)
        if not torch.equal(x, y):
            return False
    return True


def _sync(tree) -> None:
    import torch

    if any(_is_tensor(t) and t.is_cuda for t in _leaves(tree)):
        torch.cuda.synchronize()  # noqa: DP107 — boot timing, before traffic


def _on_cuda(args, kwargs=None) -> bool:
    return any(_is_tensor(t) and t.is_cuda
               for t in _leaves((tuple(args), dict(kwargs or {}))))


# ---------------------------------------------------------- executables

class _Eager:
    """Method `eager`: the program runs itself for this signature."""

    method = "eager"

    def __init__(self, fn: Callable, reason: str, detail: str = ""):
        self.fn = fn
        self.reason = reason
        self.detail = detail

    def __call__(self, args, kwargs):
        return self.fn(*args, **kwargs)


class _Pool:
    """The memory pool a replica's graphs share. A capture that fails
    leaves its pool unusable to the caching allocator, so the captures
    after it take a new one (`renew`)."""

    def __init__(self):
        self.renew()

    def renew(self) -> None:
        import torch

        self.handle = torch.cuda.graph_pool_handle()


class _Graph:
    """Method `cuda_graph`: one program signature captured into a
    `torch.cuda.CUDAGraph`. A call copies its tensors into the static
    inputs, starts the graph's generators from the live ones, replays on
    the current stream, hands the generators' advanced states back and
    returns clones of the static outputs."""

    method = "cuda_graph"

    def __init__(self, fn: Callable, args: tuple, kwargs: dict, pool,
                 mutated: Iterable[int] = ()):
        import torch

        from dorpatch_tpu_torch.observe.timing import KERNEL_GATE
        from dorpatch_tpu_torch.ops import _backend

        self.graph = torch.cuda.CUDAGraph()
        self._gens: List[Any] = []

        def static(x):
            if _is_generator(x):
                g = torch.Generator(device=x.device)
                g.set_state(x.get_state())
                self.graph.register_generator_state(g)
                self._gens.append(g)
                return g
            buf = torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                      dtype=x.dtype, device=x.device)
            buf.copy_(x)
            return buf

        tree = (tuple(args), dict(kwargs))
        self._static_tree = _map(static, tree)
        self._inputs = [t for t in _leaves(self._static_tree)
                        if _is_tensor(t)]
        self._mutated = sorted(int(i) for i in mutated)
        cur = torch.cuda.current_stream()
        side = (torch.cuda.Stream() if cur == torch.cuda.default_stream()
                else cur)
        side.wait_stream(cur)
        s_args, s_kwargs = self._static_tree
        # the capture counts as one kernel call in flight: a profiler
        # transition waits for it, and the capture's own kernel calls go
        # through while a transition waits (KernelGate.hold); the kernel
        # calls are recorded, not launched: each replay counts them
        try:
            with KERNEL_GATE.hold(), torch.cuda.stream(side), \
                    _backend.capturing() as launches:
                self.graph.capture_begin(pool=pool.handle,
                                         capture_error_mode="thread_local")
                try:
                    out = fn(*s_args, **s_kwargs)
                finally:
                    self.graph.capture_end()
        except BaseException:
            pool.renew()
            raise
        self._launches = tuple(launches)
        cur.wait_stream(side)
        self._static_out = out

    def replay(self, args, kwargs):
        from dorpatch_tpu_torch.ops import _backend

        live = _leaves((tuple(args), dict(kwargs)))
        tensors = [t for t in live if _is_tensor(t)]
        gens = [g for g in live if _is_generator(g)]
        for buf, t in zip(self._inputs, tensors):
            buf.copy_(t)
        for mine, theirs in zip(self._gens, gens):
            mine.set_state(theirs.get_state())
        self.graph.replay()
        _backend.count_replay(self._launches)
        for mine, theirs in zip(self._gens, gens):
            theirs.set_state(mine.get_state())
        for i in self._mutated:
            tensors[i].copy_(self._inputs[i])
        swap = {id(m): t for m, t in zip(self._gens, gens)}

        def out(x):
            if _is_generator(x):
                return swap.get(id(x), x)
            return x.clone()

        return _map(out, self._static_out)

    def __call__(self, args, kwargs):
        return self.replay(args, kwargs)


@dataclasses.dataclass
class _Run:
    """One eager call of a program, recorded: the canonical fingerprint
    and interface of the call, its output, its seconds."""

    fingerprint: str
    interface_sha: str
    out: Any
    mutated: List[int]
    seconds: float
    gen_states: List[Any]


def _recorded_call(fn: Callable, args: tuple, kwargs: dict, clock) -> _Run:
    """Run `fn` once, recording its canonical text (the first call of a
    program: it builds what it builds, then the record keys it)."""
    from dorpatch_tpu_torch.analysis import baseline as baseline_mod

    gens = [g for g in _leaves((tuple(args), dict(kwargs)))
            if _is_generator(g)]
    states = [g.get_state() for g in gens]
    t0 = clock()
    text, out, iface, mutated = baseline_mod.canonical_run(fn, args, kwargs)
    _sync(out)
    return _Run(baseline_mod._sha(text), iface, out, mutated, clock() - t0,
                states)


def _capture_checked(fn: Callable, args: tuple, kwargs: dict, run: _Run,
                     pool) -> _Graph:
    """Capture `fn` at `args` and replay it once from the recorded call's
    inputs and generator states: the replay must equal the recorded call's
    output bit for bit, else `ReplayDiffers`."""
    graph = _Graph(fn, args, kwargs, pool, run.mutated)
    gens = [g for g in _leaves((tuple(args), dict(kwargs)))
            if _is_generator(g)]
    after = [g.get_state() for g in gens]
    for g, s in zip(gens, run.gen_states):
        g.set_state(s)
    got = graph.replay(args, kwargs)
    _sync(got)
    same = _bit_equal(got, run.out) and all(
        bool((g.get_state() == s).all()) for g, s in zip(gens, after))
    for g, s in zip(gens, after):
        g.set_state(s)
    if not same:
        raise ReplayDiffers("replay differs from the eager call")
    return graph


def _materialize(fn: Callable, args: tuple, kwargs: dict, run: _Run, pool,
                 method: Optional[str] = None, reason: str = "recorded"):
    """The executable of one program signature: a graph on the card, an
    eager run on the CPU (reason "cpu") or where the entry says "eager".
    Every graph's replay is checked against the recorded call of this
    process bit for bit. With `method` None (a build) a refused capture or
    a differing replay becomes an eager executable whose reason says why;
    with "cuda_graph" (a hit) either raises (`ReplayDiffers` for a replay
    that differs), and the caller counts a miss."""
    if method == "eager":
        return _Eager(fn, reason)
    if not _on_cuda(args, kwargs):
        return _Eager(fn, "cpu")
    try:
        return _capture_checked(fn, args, kwargs, run, pool)
    except Exception as e:
        if method is not None:
            raise
        reason = _capture_reason(e)
        return _Eager(fn, reason, str(e).strip().splitlines()[0][:200]
                      if str(e).strip() else "")


def _capture_reason(e: Exception) -> str:
    """The miss or eager reason of a capture that raised `e`."""
    return ("replay_differs" if isinstance(e, ReplayDiffers)
            else f"capture:{type(e).__name__}")


def _new_pool(args, kwargs=None) -> Optional[_Pool]:
    return _Pool() if _on_cuda(args, kwargs) else None


# ------------------------------------------------------------- dispatcher

class AotDispatcher:
    """Stands in for a program behind a `_FirstCallTimer`.

    Holds {call signature: executable}. Known signatures run their
    executable; unknown ones optionally try a lazy read-only store load
    (farm path), then run the program itself with a single `aot.miss`
    event a signature. Other attributes delegate to the program.
    """

    def __init__(self, fallback, name: str,
                 store: Optional[ExecutableStore] = None,
                 stats: Optional[Dict[str, Any]] = None, pool=None):
        self.fallback = fallback
        self._name = name
        self._store = store
        self._stats = stats
        self._pool = pool
        self._table: Dict[Tuple[str, tuple], Any] = {}
        self._missed: set = set()
        self._eager: set = set()

    def install(self, sig, executable) -> None:
        self._table[sig] = executable

    def installed(self) -> int:
        return len(self._table)

    def methods(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ex in self._table.values():
            out[ex.method] = out.get(ex.method, 0) + 1
        return out

    def _cache_size(self) -> int:
        """Signatures the program ran eagerly (misses and method-eager
        entries): 0 on a fully graphed path."""
        return len(self._eager)

    def __call__(self, *args, **kwargs):
        sig = call_signature(args, kwargs)
        ex = self._table.get(sig)
        if ex is not None:
            if ex.method == "eager":
                self._eager.add(sig)
            return ex(args, kwargs)
        self._eager.add(sig)
        if sig in self._missed:
            return self.fallback(*args, **kwargs)
        self._missed.add(sig)
        if self._store is None:
            self._note("signature")
            return self.fallback(*args, **kwargs)
        return self._lazy_call(sig, args, kwargs)

    def _note(self, reason: str) -> None:
        observe.record_event("aot.miss", program=self._name, reason=reason)
        if self._stats is not None:
            self._stats["misses"] = self._stats.get("misses", 0) + 1
            self._stats.setdefault("programs", {}).setdefault(
                self._name, f"miss:{reason}")

    def _lazy_call(self, sig, args, kwargs):
        """Read-only on-demand resolution (farm): this call runs the
        program eagerly under the recorder; its fingerprint is looked up
        by content and, on a hit, the signature's executable is installed
        for the next calls. Lookup and capture never raise into the
        caller (the program's own errors do); a miss is recorded once."""
        t0 = time.perf_counter()
        run = _recorded_call(self.fallback, args, kwargs, time.perf_counter)
        try:
            _, entry, reason = self._store.lookup_by_fingerprint(
                run.fingerprint, run.interface_sha)
            if reason is None:
                method = entry.get("method", "cuda_graph")
                ex = _materialize(self.fallback, args, kwargs, run,
                                  self._pool, method,
                                  entry.get("reason", "recorded"))
        except ReplayDiffers:
            reason = "replay_differs"
        except Exception as e:
            reason = f"error:{type(e).__name__}"
        if reason is not None:
            self._note(reason)
            return run.out
        self._table[sig] = ex
        self._missed.discard(sig)
        if ex.method != "eager":
            self._eager.discard(sig)
        load_s = round(time.perf_counter() - t0, 6)
        if self._stats is not None:
            self._stats["hits"] = self._stats.get("hits", 0) + 1
            self._stats["load_s"] = round(
                self._stats.get("load_s", 0.0) + load_s, 6)
            self._stats.setdefault("programs", {})[self._name] = "hit"
        observe.record_event("aot.load", program=self._name,
                             method=ex.method, load_s=load_s, lazy=True)
        return run.out

    def __getattr__(self, item):
        fallback = self.__dict__.get("fallback")
        if fallback is None:
            raise AttributeError(item)
        return getattr(fallback, item)


# -------------------------------------------------------------- warm boot

def _note_miss(stats: Dict[str, Any], name: str, reason: str,
               mode: str) -> None:
    stats["misses"] += 1
    stats["miss_reasons"][reason] = stats["miss_reasons"].get(reason, 0) + 1
    stats["programs"][name] = f"miss:{reason}"
    observe.record_event("aot.miss", program=name, reason=reason)
    if mode == "strict":
        raise AotBootError(
            f"[{name}] AOT store miss ({reason}) under strict warm boot — "
            "rebuild the store (`python -m dorpatch_tpu_torch.aot build`) "
            "or boot with --aot auto")


def _count_method(stats: Dict[str, Any], name: str, ex) -> None:
    stats["methods"][ex.method] = stats["methods"].get(ex.method, 0) + 1
    if ex.method == "eager":
        stats["eager"][name] = ex.reason


def _boot_kernels(store: ExecutableStore, mode: str,
                  stats: Dict[str, Any]) -> bool:
    """Load the kernel library from the store's blob when it holds one for
    these sources, else build it; under auto a store without the blob
    gets it (also from a process that loaded the library before its boot,
    for the processes that boot from the store after it). Returns True
    when the store was changed."""
    from dorpatch_tpu_torch.ops import _build

    if store.env_reason:
        path, reason = None, store.env_reason
    else:
        path, reason = store.kernels_blob()
    if _build.loaded() is None:
        if reason is None:
            _build.load_from_store(path)
            stats["kernels"] = "store"
            return False
        _note_miss(stats, "<kernels>", reason, mode)  # raises under strict
        _build.library()
    stats["kernels"] = _build.loaded_source()
    if reason is None or mode != "auto":
        return False
    store.put_kernels(str(_build.library_path()))
    return True


def _plain_call(fn: Callable, args: tuple, key: tuple, clock) -> _Run:
    """Run `fn` once where its key is known already (another replica of
    the same service recorded the same program)."""
    gens = [g for g in _leaves(args) if _is_generator(g)]
    states = [g.get_state() for g in gens]
    t0 = clock()
    out = fn(*args)
    _sync(out)
    return _Run(key[0], key[1], out, list(key[2]), clock() - t0, states)


def _boot_one(store: ExecutableStore, disp: AotDispatcher, timer,
              fallback, name: str, args: tuple, mode: str,
              stats: Dict[str, Any], clock, keys: Dict[str, tuple]) -> bool:
    """Load-or-build one program signature; returns True when the store
    was changed (an auto-mode rewrite). The program's first call goes
    through its timer (the cold first call it records, the signature it
    counts: what warmup would have run), its capture through the program
    itself."""
    try:
        if name in keys:
            run = _plain_call(timer, args, keys[name], clock)
        else:
            run = _recorded_call(timer, args, {}, clock)
            keys[name] = (run.fingerprint, run.interface_sha,
                          tuple(run.mutated))
        sig = call_signature(args, {})
    except Exception as e:
        _note_miss(stats, name, f"untraceable:{type(e).__name__}", mode)
        return False
    _, entry, reason = store.lookup(name, run.fingerprint, run.interface_sha)
    if reason is None:
        t0 = clock()
        try:
            ex = _materialize(fallback, args, {}, run, disp._pool,
                              entry.get("method", "cuda_graph"),
                              entry.get("reason", "recorded"))
        except ReplayDiffers:
            reason = "replay_differs"
        except Exception as e:
            reason = f"untraceable:{type(e).__name__}"
        else:
            load_s = clock() - t0 + run.seconds
            disp.install(sig, ex)
            saved = max(0.0, float(entry.get("build_compile_s", 0.0))
                        + float(entry.get("capture_s", 0.0)) - load_s)
            stats["hits"] += 1
            stats["load_s"] = round(stats["load_s"] + load_s, 6)
            stats["saved_s"] = round(stats["saved_s"] + saved, 6)
            stats["programs"][name] = "hit"
            _count_method(stats, name, ex)
            observe.record_event(
                "aot.load", program=name, method=ex.method,
                load_s=round(load_s, 6), saved_s=round(saved, 3))
            return False
    _note_miss(stats, name, reason, mode)  # raises under strict
    t0 = clock()
    ex = _materialize(fallback, args, {}, run, disp._pool)
    capture_s = clock() - t0
    extra = {"capture_s": round(capture_s, 6)}
    if ex.method == "eager":
        extra["reason"] = ex.reason
        if ex.detail:
            extra["detail"] = ex.detail
    store.put(name, run.fingerprint, run.interface_sha, ex.method, b"",
              run.seconds, **extra)
    disp.install(sig, ex)
    stats["builds"] += 1
    stats["build_s"] = round(stats["build_s"] + run.seconds + capture_s, 6)
    stats["programs"][name] = f"rebuilt:{reason}"
    _count_method(stats, name, ex)
    observe.record_event(
        "aot.build", program=name, reason=reason, method=ex.method,
        compile_s=round(run.seconds, 6), capture_s=round(capture_s, 6))
    return True


def warm_boot(programs: Iterable[Tuple[str, Any, tuple]], aot_cfg,
              store: Optional[ExecutableStore] = None,
              clock=time.perf_counter,
              keys: Optional[Dict[str, tuple]] = None) -> Dict[str, Any]:
    """Install an executable for every (name, timer, example args) triple
    (the `trace_entrypoints()` shape; the args real tensors on the
    programs' device). Bucket variants sharing one timer share one
    dispatcher, and every graph of one boot one memory pool. Each
    program's first call goes through its timer, so a boot that installs
    every program (`stats["installed"]`) has run every one at every shape
    warmup would. `keys`
    ({name: (fingerprint, interface sha, written inputs)}) carries the
    records of an earlier boot of the same programs in this process (the
    replicas of one service run one program set): a name found there is
    not recorded again, and each recorded name is added. Returns the boot
    stats and emits the `aot.boot` summary event; raises `AotBootError` on
    any miss when aot_cfg.mode == "strict"."""
    from dorpatch_tpu_torch.observe.events import _FirstCallTimer

    programs = [(name, fn, tuple(args)) for name, fn, args in programs]
    keys = {} if keys is None else keys
    mode = getattr(aot_cfg, "mode", "auto")
    cuda = any(_on_cuda(args) for _, _, args in programs)
    if store is None:
        store = ExecutableStore(getattr(aot_cfg, "cache_dir", ""),
                                device="cuda" if cuda else "cpu")
    t0_boot = clock()
    stats: Dict[str, Any] = {
        "mode": mode, "store": store.store_dir, "hits": 0, "misses": 0,
        "builds": 0, "load_s": 0.0, "build_s": 0.0, "saved_s": 0.0,
        "miss_reasons": {}, "programs": {}, "methods": {}, "eager": {},
        "kernels": None, "installed": 0,
    }
    groups: Dict[int, Tuple[Any, List[Tuple[str, tuple]]]] = {}
    order: List[int] = []
    for name, fn, args in programs:
        key = id(fn)
        if key not in groups:
            groups[key] = (fn, [])
            order.append(key)
        groups[key][1].append((name, args))
    pool = _new_pool(programs[0][2]) if cuda else None
    dirty = False
    try:
        if cuda:
            dirty |= _boot_kernels(store, mode, stats)
        for key in order:
            timer, items = groups[key]
            if not isinstance(timer, _FirstCallTimer):
                for name, _ in items:
                    _note_miss(stats, name, "unsupported", mode)
                continue
            fallback = timer.__wrapped__
            if isinstance(fallback, AotDispatcher):
                fallback = fallback.fallback
            disp = AotDispatcher(fallback, timer._name, store=None,
                                 pool=pool)
            for name, args in items:
                dirty |= _boot_one(store, disp, timer, fallback, name, args,
                                   mode, stats, clock, keys)
            timer.__wrapped__ = disp
            stats["installed"] += disp.installed()
    finally:
        if dirty:
            store.save()
    stats["boot_s"] = round(clock() - t0_boot, 3)
    observe.record_event(
        "aot.boot", mode=mode, hits=stats["hits"], misses=stats["misses"],
        builds=stats["builds"], boot_s=stats["boot_s"],
        saved_s=round(stats["saved_s"], 3),
        method=dict(sorted(stats["methods"].items())),
        kernels=stats["kernels"])
    return stats


class FirstCallAotResolver:
    """`observe.set_aot_resolver` hook for farm workers: on a timer's first
    call, substitute a read-only store-backed dispatcher. Never writes the
    store and never raises into the host — any internal failure means "no
    substitution"."""

    def __init__(self, store: ExecutableStore):
        self.store = store
        self.stats: Dict[str, Any] = {
            "store": store.store_dir, "hits": 0, "misses": 0,
            "load_s": 0.0, "programs": {},
        }

    def before_first_call(self, name: str, wrapped, args, kwargs):
        try:
            if isinstance(wrapped, AotDispatcher):
                return None
            return AotDispatcher(wrapped, name, store=self.store,
                                 stats=self.stats,
                                 pool=_new_pool(args, kwargs))
        except Exception:
            return None


__all__ = [
    "AotBootError",
    "AotDispatcher",
    "FirstCallAotResolver",
    "call_signature",
    "warm_boot",
]
