"""The port's AOT executable store (`dorpatch_tpu_torch/aot/`) on the CPU,
held against `dorpatch_tpu.aot` where the two can meet.

- The counterparts of `tests/test_aot.py`'s 13 cases on small CPU
  programs (method "eager": a CPU program is never captured): round trip,
  strict miss, strict hit, a corrupt blob, a torn manifest, a fingerprint
  rewrite, dispatch on a baked-in value, gc, the farm's read-only
  resolver, DP305 and the call-signature discriminator.
- One script of `put`, `save`, reopen, `lookup`, `gc`, `select` and
  `verify_against(check_env=False)` on both packages' stores, with
  hand-made entries (the JAX package's fingerprinting fails on jax
  0.9.0): the same miss reasons, removed lists, entries and DP305
  messages.
- Both packages' `observe.report` render one `-- aot --` section from a
  port service's run directory.
- `canonical_run` (the fingerprint a boot keys on) equals the trace's on
  registry programs.
- `python -m dorpatch_tpu_torch.aot build` refuses on drift (exit 1,
  nothing written); usage errors exit 2.
- The build records and names a program whose recorded call renders
  another fingerprint than its trace; a hit whose replay differs is a
  miss.
- The card's cases (`cuda` marker): a graph's replay equals the eager call
  bit for bit in any order, its outputs survive the next replay, a
  generator program advances as it does in eager, and a hit whose replay
  differs is refused.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.aot import build as aot_build
from dorpatch_tpu_torch.aot.boot import (AotBootError, AotDispatcher,
                                         FirstCallAotResolver,
                                         call_signature, warm_boot)
from dorpatch_tpu_torch.aot.store import (MANIFEST, ExecutableStore,
                                          open_readonly)
from dorpatch_tpu_torch.config import AotConfig


@pytest.fixture(autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def fresh_program(budget=8):
    """A new program behind its own first-call timer."""

    def f(x):
        return x * 2.0 + 1.0

    return observe.timed_first_call(f, "aot.test.double",
                                    recompile_budget=budget)


def example(shape=(4,)):
    return torch.zeros(shape, dtype=torch.float32)


def boot(timer, store_dir, mode, name="aot.test.double", shape=(4,)):
    return warm_boot([(name, timer, (example(shape),))],
                     AotConfig(cache_dir=store_dir, mode=mode))


def test_build_then_hit_round_trip(tmp_path):
    store = str(tmp_path / "store")
    stats = boot(fresh_program(), store, "auto")
    assert stats["builds"] == 1 and stats["hits"] == 0
    assert stats["miss_reasons"] == {"absent": 1}
    assert os.path.exists(os.path.join(store, MANIFEST))
    [entry] = ExecutableStore(store).entries().values()
    assert entry["method"] == "eager" and entry["reason"] == "cpu"

    second = fresh_program()
    stats = boot(second, store, "auto")
    assert stats["hits"] == 1 and stats["misses"] == 0
    assert stats["builds"] == 0 and stats["methods"] == {"eager": 1}
    out = second(torch.arange(4, dtype=torch.float32))
    np.testing.assert_allclose(out.numpy(), [1.0, 3.0, 5.0, 7.0])
    assert isinstance(second.__wrapped__, AotDispatcher)
    # an eager entry is counted apart from graph hits, never hidden
    assert second.__wrapped__.methods() == {"eager": 1}
    assert second.__wrapped__._cache_size() == 1


def test_strict_miss_on_empty_store_raises(tmp_path):
    with pytest.raises(AotBootError, match="absent"):
        boot(fresh_program(), str(tmp_path / "empty"), "strict")
    assert not os.path.exists(str(tmp_path / "empty" / MANIFEST))


def test_strict_hit_boots_clean(tmp_path):
    store = str(tmp_path / "store")
    boot(fresh_program(), store, "auto")
    timer = fresh_program()
    stats = boot(timer, store, "strict")
    assert stats["hits"] == 1 and stats["misses"] == 0
    assert isinstance(timer.__wrapped__, AotDispatcher)


def test_corrupt_blob_rebuilds_never_crashes(tmp_path):
    store_dir = str(tmp_path / "store")
    boot(fresh_program(), store_dir, "auto")
    store = ExecutableStore(store_dir)
    [(name, entry)] = store.entries().items()
    # an entry whose blob fails its sha (the port writes blobs only for the
    # kernel library and for methods that carry a payload)
    store.put(name, entry["fingerprint"], entry["interface_sha"],
              "serialized", b"payload", 0.1)
    store.save()
    with open(os.path.join(store_dir, store.entries()[name]["payload"]),
              "wb") as fh:
        fh.write(b"\x00garbage payload\x00")
    stats = boot(fresh_program(), store_dir, "auto")
    assert stats["miss_reasons"] == {"corrupt": 1}
    assert stats["builds"] == 1
    stats = boot(fresh_program(), store_dir, "auto")
    assert stats["hits"] == 1 and stats["misses"] == 0
    # the kernel library's blob is sha-checked the same way
    lib = tmp_path / "libdorpatch_kernels_x.so"
    lib.write_bytes(b"\x7fELF not really")
    store = ExecutableStore(store_dir)
    rec = store.put_kernels(str(lib))
    assert store.kernels_blob() == (
        os.path.join(store_dir, rec["payload"]), None)
    with open(os.path.join(store_dir, rec["payload"]), "ab") as fh:
        fh.write(b"!")
    assert store.kernels_blob() == (None, "corrupt")


def test_torn_manifest_acts_as_empty_store(tmp_path):
    store_dir = str(tmp_path / "store")
    os.makedirs(store_dir)
    with open(os.path.join(store_dir, MANIFEST), "w") as fh:
        fh.write('{"entries": {"trunc')
    stats = boot(fresh_program(), store_dir, "auto")
    assert stats["miss_reasons"] == {"absent": 1}
    assert stats["builds"] == 1
    assert ExecutableStore(store_dir).entries()


def test_fingerprint_mismatch_rewrites_entry(tmp_path):
    store_dir = str(tmp_path / "store")
    boot(fresh_program(), store_dir, "auto")
    mpath = os.path.join(store_dir, MANIFEST)
    manifest = json.load(open(mpath))
    [name] = manifest["entries"]
    live_fp = manifest["entries"][name]["fingerprint"]
    manifest["entries"][name]["fingerprint"] = "0" * 16
    json.dump(manifest, open(mpath, "w"))

    stats = boot(fresh_program(), store_dir, "auto")
    assert stats["miss_reasons"] == {"fingerprint": 1}
    rewritten = json.load(open(mpath))["entries"][name]["fingerprint"]
    assert rewritten == live_fp


def test_static_value_dispatch(tmp_path):
    """A non-tensor argument is baked into the program: another value is
    another signature — a miss that runs the program itself, never the
    installed executable."""
    store_dir = str(tmp_path / "store")
    calls = []

    def make():
        def g(x, n):
            calls.append(n)
            return x * float(n)

        return observe.timed_first_call(g, "aot.test.static",
                                        recompile_budget=4)

    stats = warm_boot([("aot.test.static", make(), (example(), 3))],
                      AotConfig(cache_dir=store_dir, mode="auto"))
    assert stats["builds"] == 1
    timer = make()
    stats = warm_boot([("aot.test.static", timer, (example(), 3))],
                      AotConfig(cache_dir=store_dir, mode="strict"))
    assert stats["hits"] == 1
    disp = timer.__wrapped__
    events = []
    log = observe.EventLog(str(tmp_path / "events.jsonl"))
    with log, observe.active(log):
        out = timer(torch.ones(4), 3)
        np.testing.assert_allclose(out.numpy(), 3.0)
        assert disp._missed == set()
        out = timer(torch.ones(4), 5)
        np.testing.assert_allclose(out.numpy(), 5.0)
    for line in open(str(tmp_path / "events.jsonl")):
        rec = json.loads(line)
        if rec.get("name") == "aot.miss":
            events.append(rec)
    assert [(e["program"], e["reason"]) for e in events] == [
        ("aot.test.static", "signature")]
    assert len(disp._missed) == 1 and disp.installed() == 1


def test_gc_removes_departed_entries(tmp_path):
    store_dir = str(tmp_path / "store")
    boot(fresh_program(), store_dir, "auto")
    store = ExecutableStore(store_dir)
    [name] = store.entries()
    store.put("with.blob", "1" * 16, "", "serialized", b"x", 0.0)
    store.save()
    blob = os.path.join(store_dir, store.entries()["with.blob"]["payload"])
    assert os.path.exists(blob)
    removed = store.gc({})  # baselines.json no longer records the programs
    store.save()
    assert removed == sorted([name, "with.blob"])
    assert not ExecutableStore(store_dir).entries()
    assert not os.path.exists(blob)


def test_gc_keeps_matching_entries(tmp_path):
    store_dir = str(tmp_path / "store")
    boot(fresh_program(), store_dir, "auto")
    store = ExecutableStore(store_dir)
    [name] = store.entries()
    fp = store.entries()[name]["fingerprint"]
    assert store.gc({name: {"fingerprint": fp}}) == []
    assert list(store.entries()) == [name]


def test_first_call_resolver_hit_is_read_only(tmp_path):
    store_dir = str(tmp_path / "store")
    boot(fresh_program(), store_dir, "auto")
    manifest_bytes = open(os.path.join(store_dir, MANIFEST), "rb").read()

    resolver = FirstCallAotResolver(open_readonly(store_dir))
    prev = observe.aot_resolver()
    observe.set_aot_resolver(resolver)
    try:
        timer = fresh_program()
        out = timer(torch.arange(4, dtype=torch.float32))
        again = timer(torch.arange(4, dtype=torch.float32))
    finally:
        observe.set_aot_resolver(prev)
    np.testing.assert_allclose(out.numpy(), [1.0, 3.0, 5.0, 7.0])
    np.testing.assert_allclose(again.numpy(), [1.0, 3.0, 5.0, 7.0])
    assert resolver.stats["hits"] == 1 and resolver.stats["misses"] == 0
    assert isinstance(timer.__wrapped__, AotDispatcher)
    assert timer.__wrapped__.installed() == 1
    # never writes: the shared store's manifest is byte-identical
    assert open(os.path.join(store_dir, MANIFEST), "rb").read() \
        == manifest_bytes


def test_first_call_resolver_miss_runs_normally(tmp_path):
    resolver = FirstCallAotResolver(
        open_readonly(str(tmp_path / "missing-store")))
    prev = observe.aot_resolver()
    observe.set_aot_resolver(resolver)
    try:
        timer = fresh_program()
        out = timer(torch.arange(4, dtype=torch.float32))
    finally:
        observe.set_aot_resolver(prev)
    np.testing.assert_allclose(out.numpy(), [1.0, 3.0, 5.0, 7.0])
    assert resolver.stats["misses"] == 1
    assert resolver.stats["programs"] == {"aot.test.double": "miss:absent"}
    assert not os.path.exists(str(tmp_path / "missing-store"))


def test_verify_against_flags_drift_and_absence(tmp_path):
    store_dir = str(tmp_path / "store")
    boot(fresh_program(), store_dir, "auto")
    store = ExecutableStore(store_dir)
    [name] = store.entries()
    entry = store.entries()[name]
    clean_baseline = {"entries": {name: {
        "fingerprint": entry["fingerprint"],
        "interface": {"sha": entry["interface_sha"]},
    }}}
    assert store.verify_against(clean_baseline, allow={}) == []

    drifted = {"entries": {name: {"fingerprint": "0" * 16,
                                  "interface": {"sha": "x"}},
                           "other.program": {"fingerprint": "1" * 16}}}
    findings = store.verify_against(drifted, allow={})
    assert findings and all(f.rule_id == "DP305" for f in findings)
    msgs = "\n".join(f.message for f in findings)
    assert f"[{name}]" in msgs          # fingerprint drift
    assert "[other.program]" in msgs    # baselined, no store entry

    allow = {name: {"DP305": "known"}, "other.program": {"DP305": "known"}}
    assert store.verify_against(drifted, allow=allow) == []


def test_call_signature_discriminates():
    from torch._subclasses.fake_tensor import FakeTensorMode

    a4 = torch.zeros((4,), dtype=torch.float32)
    base = call_signature((a4,), {})
    with FakeTensorMode():
        fake = torch.empty((4,), dtype=torch.float32)
    assert call_signature((fake,), {}) == base                 # fake==live
    assert call_signature((torch.zeros(8),), {}) != base        # shape
    assert call_signature((a4.to(torch.int32),), {}) != base    # dtype
    assert call_signature((a4, 3), {}) != call_signature((a4, 5), {})
    assert call_signature((a4,), {"k": a4}) != base             # structure
    x = torch.zeros((2, 3, 4, 5))
    assert call_signature((x,), {}) != call_signature(
        (x.contiguous(memory_format=torch.channels_last),), {})  # layout
    g1, g2 = torch.Generator(), torch.Generator()
    assert call_signature((a4, g1), {}) == call_signature((a4, g2), {})


# ------------------------------------------------------- the JAX store

def _store_script(mod, d):
    """One script of store operations; every observable result."""
    S = mod.ExecutableStore
    st = S(d, check_env=False)
    st.put("serve.a[b1]", "f" * 16, "i" * 16, "serialized", b"abc", 1.5)
    st.put("serve.b[b1]", "e" * 16, "j" * 16, "persistent_cache", b"", 0.5)
    st.put("attack.c", "d" * 16, "", "serialized", b"xyz", 0.25)
    st.stamp_baseline("s" * 16, "analysis/baselines.json")
    st.save()
    st = S(d, check_env=False)
    out = {"entries": st.entries(), "state": st.state_hash(),
           "select": st.select(["serve.*"]),
           "baseline": st.manifest.get("baseline")}
    out["lookups"] = [
        st.lookup(*key)[2] for key in (
            ("serve.a[b1]", "f" * 16, "i" * 16),
            ("serve.a[b1]", "0" * 16, "i" * 16),
            ("serve.a[b1]", "f" * 16, "x" * 16),
            ("serve.z", "f" * 16, ""),
            ("serve.b[b1]", "e" * 16, "j" * 16))]
    out["by_fp"] = st.lookup_by_fingerprint("d" * 16)[2]
    with open(os.path.join(d, st.entries()["attack.c"]["payload"]),
              "wb") as fh:
        fh.write(b"torn")
    out["corrupt"] = st.lookup("attack.c", "d" * 16, "")[2]
    baseline = {"entries": {
        "serve.a[b1]": {"fingerprint": "f" * 16,
                        "interface": {"sha": "q" * 16}},
        "serve.b[b1]": {"fingerprint": "0" * 16},
        "attack.c": {"fingerprint": "d" * 16},
        "train.step": {"fingerprint": "t" * 16}}}
    out["dp305"] = [(f.rule_id, f.message.replace("dorpatch_tpu_torch",
                                                  "dorpatch_tpu"))
                    for f in st.verify_against(baseline, allow={},
                                               check_env=False)]
    out["gc"] = st.gc({"serve.a[b1]": {"fingerprint": "f" * 16}})
    st.save()
    out["after_gc"] = sorted(S(d, check_env=False).entries())
    out["blobs"] = sorted(os.listdir(os.path.join(d, "blobs")))
    return out


def test_store_script_equals_the_jax_store(tmp_path):
    from dorpatch_tpu.aot import store as jax_store
    from dorpatch_tpu_torch.aot import store as port_store

    port = _store_script(port_store, str(tmp_path / "port"))
    jax = _store_script(jax_store, str(tmp_path / "jax"))
    assert port == jax
    assert port["lookups"] == [None, "fingerprint", "interface", "absent",
                               None]
    assert port["corrupt"] == "corrupt" and port["gc"] == [
        "attack.c", "serve.b[b1]"]
    assert [r for r, _ in port["dp305"]] == ["DP305"] * 4


def test_report_aot_section_equals_jax(tmp_path, capsys):
    """A CPU service booted `--aot auto` on an empty store, then `strict`:
    both packages' reports render one `-- aot --` section of each run."""
    from dorpatch_tpu.observe import report as jax_report
    from dorpatch_tpu_torch.config import DefenseConfig, ServeConfig
    from dorpatch_tpu_torch.observe import report
    from dorpatch_tpu_torch.serve import CertifiedInferenceService

    def stub(x):
        s = x.mean(dim=(1, 2, 3))
        return torch.nn.functional.one_hot(
            (s * 7).to(torch.int32).long() % 5, 5).float()

    store = str(tmp_path / "store")
    texts = {}
    for mode in ("auto", "strict"):
        run = str(tmp_path / mode)
        svc = CertifiedInferenceService(
            stub, 5, 32,
            serve_cfg=ServeConfig(max_batch=2, bucket_sizes=(1, 2),
                                  deadline_ms=20000.0, flush_fraction=0.01),
            defense_cfg=DefenseConfig(ratios=(0.1,), chunk_size=64),
            result_dir=run, device="cpu",
            aot_cfg=AotConfig(cache_dir=store, mode=mode))
        with svc:
            svc.predict(np.full((32, 32, 3), 0.25, np.float32))
        outs = []
        for mod in (report, jax_report):
            capsys.readouterr()
            assert mod.main([run]) == 0
            text = capsys.readouterr().out
            outs.append(text[text.index("-- aot --"):].split("\n--")[0])
        assert outs[0] == outs[1]
        texts[mode] = outs[0]
    assert "0 load(s), 10 miss(es), 10 build(s)" in texts["auto"]
    assert "10 load(s), 0 miss(es), 0 build(s)" in texts["strict"]
    assert "warm boot [strict]" in texts["strict"]


# ------------------------------------------------- the fingerprint a boot keys

#: registry programs held to their trace (each family and dtype; the
#: attack's steps hold `utils.one_hot`, which `F.one_hot` would split: it
#: checks its indices and fills by `scatter_` when it runs, and decomposes
#: to `arange`/`eq` on fake tensors)
RUN_EQUALS = ("attack.step.stage0", "attack.step.stage1",
              "serve.clean_predict[b1]", "defense.phase1.r0.1[b1]",
              "defense.rows.r0.1[w1]", "defense.phase1.stem.r0.06",
              "defense.phase1.token.bf16.r0.06", "defense.rows.token.r0.06",
              "defense.phase1.mixer.r0.06", "defense.rows.bf16.r0.03",
              "train.eval_step", "ops.gn_relu.grad.bf16")


def test_canonical_run_equals_the_trace_on_registry_programs():
    from dorpatch_tpu_torch.analysis import baseline, program
    from dorpatch_tpu_torch.analysis.entrypoints import production_entrypoints

    eps = {ep.name: ep for ep in production_entrypoints()}
    for name in RUN_EQUALS:
        ep = eps[name]
        gm, out = program.trace_program(ep.fn, ep.args, ep.kwargs)
        ctx = program.ProgramContext(name=name, gm=gm, args=tuple(ep.args),
                                     out_tree=out, path="", line=0)
        args = aot_build.example_inputs(tuple(ep.args))
        kwargs = aot_build.example_inputs(dict(ep.kwargs))
        text, _, iface, mutated = baseline.canonical_run(ep.fn, args, kwargs)
        assert mutated == []
        assert text == baseline.canonical_graph(gm), name
        assert iface == baseline.interface_record(ctx)["sha"], name


# ------------------------------------------------------------ the build CLI

def _toy_entrypoints():
    from dorpatch_tpu_torch.analysis.entrypoints import (EntryPoint,
                                                         abstractify)

    def double(x):
        return x * 2.0 + 1.0

    def scale(x, n):
        return (x * float(n)).sum(dim=-1)

    x = abstractify(torch.zeros((2, 3)))
    return [EntryPoint("toy.double", double, (x,)),
            EntryPoint("toy.scale", scale, (x, 3))]


def test_build_verify_and_refusal(tmp_path, monkeypatch, capsys):
    from dorpatch_tpu_torch.analysis import baseline
    from dorpatch_tpu_torch.analysis import cli as analysis_cli

    eps = _toy_entrypoints()
    monkeypatch.setattr(analysis_cli, "_load_entrypoints",
                        lambda spec: (eps, {}, {}, []))
    data, errs = baseline.build_baseline(eps)
    assert not errs
    bfile = tmp_path / "baselines.json"
    bfile.write_text(baseline.dump_baseline(data))
    store = str(tmp_path / "store")
    main = aot_build.main
    assert main(["build", "--store", store, "--baseline-file", str(bfile),
                 "--device", "cpu"]) == 0
    assert main(["verify", "--store", store, "--baseline-file",
                 str(bfile)]) == 0
    entries = ExecutableStore(store).entries()
    assert {n: e["fingerprint"] for n, e in entries.items()} == {
        n: e["fingerprint"] for n, e in data["entries"].items()}
    assert {e["method"] for e in entries.values()} == {"eager"}
    capsys.readouterr()
    assert main(["ls", "--store", store, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == entries

    # an edited fingerprint is DP305, exit 1
    mpath = os.path.join(store, MANIFEST)
    manifest = json.load(open(mpath))
    manifest["entries"]["toy.double"]["fingerprint"] = "0" * 16
    json.dump(manifest, open(mpath, "w"))
    capsys.readouterr()
    assert main(["verify", "--store", store, "--baseline-file",
                 str(bfile)]) == 1
    assert re.search(r"DP305 \[toy\.double\] store fingerprint",
                     capsys.readouterr().out)

    # a drifted baseline: refused before anything is run or written
    drifted = json.loads(bfile.read_text())
    drifted["entries"]["toy.scale"]["fingerprint"] = "1" * 16
    bfile.write_text(json.dumps(drifted))
    fresh = str(tmp_path / "fresh")
    assert main(["build", "--store", fresh, "--baseline-file", str(bfile),
                 "--device", "cpu"]) == 1
    assert "REFUSED" in capsys.readouterr().err
    assert not os.path.exists(fresh)

    # gc drops the entry whose fingerprint left the baseline
    assert main(["gc", "--store", store, "--baseline-file",
                 str(bfile)]) == 0
    assert sorted(ExecutableStore(store).entries()) == []


def test_build_records_a_program_whose_recorded_call_splits_its_key(
        tmp_path, monkeypatch, capsys):
    """`F.one_hot` runs another graph than it traces: a boot (keyed by the
    recorded call) would never hit the build's entry (keyed by the trace),
    so the entry records the call's fingerprint and the build names the
    program; `utils.one_hot` keeps one key."""
    from dorpatch_tpu_torch import utils
    from dorpatch_tpu_torch.analysis import baseline
    from dorpatch_tpu_torch.analysis import cli as analysis_cli
    from dorpatch_tpu_torch.analysis.entrypoints import (EntryPoint,
                                                         abstractify)

    y = abstractify(torch.zeros((4,), dtype=torch.int64))
    cases = ((torch.nn.functional.one_hot, True), (utils.one_hot, False))
    for i, (one_hot, splits) in enumerate(cases):
        eps = [EntryPoint("toy.onehot", lambda t, f=one_hot: f(t, 5), (y,))]
        monkeypatch.setattr(analysis_cli, "_load_entrypoints",
                            lambda spec, eps=eps: (eps, {}, {}, []))
        data, errs = baseline.build_baseline(eps)
        assert not errs
        bfile = str(tmp_path / f"baselines{i}.json")
        with open(bfile, "w") as fh:
            fh.write(baseline.dump_baseline(data))
        store = str(tmp_path / f"store{i}")
        capsys.readouterr()
        assert aot_build.main(["build", "--store", store, "--baseline-file",
                               bfile, "--device", "cpu"]) == 0
        err = capsys.readouterr().err
        assert ("a boot would miss: toy.onehot" in err) == splits
        [entry] = ExecutableStore(store).entries().values()
        assert entry["fingerprint"] == (
            data["entries"]["toy.onehot"]["fingerprint"])
        recorded = entry.get("recorded_fingerprint")
        assert (recorded is not None) == splits
        assert recorded != entry["fingerprint"]


def test_a_hit_whose_replay_differs_is_a_miss(tmp_path, monkeypatch):
    """Every installed graph replays once against this process's eager
    call: a hit that differs is the miss "replay_differs" (strict raises
    before warmup; auto rebuilds the entry, here as eager with that
    reason). The capture is stood in for on the CPU."""
    from dorpatch_tpu_torch.aot import boot as aot_boot

    store = str(tmp_path / "store")
    boot(fresh_program(), store, "auto")
    mpath = os.path.join(store, MANIFEST)
    manifest = json.load(open(mpath))
    [entry] = manifest["entries"].values()
    entry.update(method="cuda_graph")
    entry.pop("reason")
    json.dump(manifest, open(mpath, "w"))

    def differs(*args, **kwargs):
        raise aot_boot.ReplayDiffers("replay differs from the eager call")

    monkeypatch.setattr(aot_boot, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(aot_boot, "_new_pool", lambda *a, **k: None)
    monkeypatch.setattr(aot_boot, "_boot_kernels", lambda *a: False)
    monkeypatch.setattr(aot_boot, "_capture_checked", differs)

    def boot_on(mode):
        return warm_boot([("aot.test.double", fresh_program(), (example(),))],
                         AotConfig(cache_dir=store, mode=mode),
                         store=ExecutableStore(store, device="cpu"))

    with pytest.raises(AotBootError, match="replay_differs"):
        boot_on("strict")
    stats = boot_on("auto")
    assert stats["hits"] == 0 and stats["builds"] == 1
    assert stats["miss_reasons"] == {"replay_differs": 1}
    [entry] = ExecutableStore(store).entries().values()
    assert (entry["method"], entry["reason"]) == ("eager", "replay_differs")


def test_cli_usage_errors_exit_2(tmp_path, capsys):
    main = aot_build.main
    assert main([]) == 2
    assert main(["build"]) == 2
    assert main(["bogus", "--store", "x"]) == 2
    assert main(["verify", "--store", str(tmp_path),
                 "--baseline-file", str(tmp_path / "none.json")]) == 2


# ------------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replays_equal_eager_in_any_order():
    from dorpatch_tpu_torch.aot import boot as aot_boot

    dev = _card()

    def f(x, w):
        return torch.relu(x @ w).sum(dim=0), torch.argmax(x, dim=-1)

    def g(x):
        return torch.cumsum(x * 3.0, dim=0)

    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand((64, 32), generator=gen, device=dev) for _ in range(3)]
    w = torch.rand((32, 16), generator=gen, device=dev)
    pool = aot_boot._Pool()
    run_f = aot_boot._recorded_call(f, (xs[0], w), {}, lambda: 0.0)
    gf = aot_boot._capture_checked(f, (xs[0], w), {}, run_f, pool)
    run_g = aot_boot._recorded_call(g, (xs[0],), {}, lambda: 0.0)
    gg = aot_boot._capture_checked(g, (xs[0],), {}, run_g, pool)
    for x in (xs[2], xs[1], xs[0]):
        got_g = gg.replay((x,), {})
        got_f = gf.replay((x, w), {})
        assert aot_boot._bit_equal(got_f, f(x, w))
        assert aot_boot._bit_equal(got_g, g(x))


@pytest.mark.cuda
def test_graph_outputs_survive_the_next_replay():
    from dorpatch_tpu_torch.aot import boot as aot_boot

    dev = _card()

    def f(x):
        return x * 2.0

    a, b = torch.ones(8, device=dev), torch.full((8,), 3.0, device=dev)
    run = aot_boot._recorded_call(f, (a,), {}, lambda: 0.0)
    graph = aot_boot._capture_checked(f, (a,), {}, run,
                                      aot_boot._Pool())
    first = graph.replay((a,), {})
    second = graph.replay((b,), {})
    torch.cuda.synchronize()
    assert torch.equal(first, torch.full((8,), 2.0, device=dev))
    assert torch.equal(second, torch.full((8,), 6.0, device=dev))


@pytest.mark.cuda
def test_generator_program_advances_as_in_eager():
    from dorpatch_tpu_torch.aot import boot as aot_boot

    dev = _card()

    def f(x, gen):
        return x + torch.rand(x.shape, generator=gen, device=x.device)

    x = torch.zeros(1024, device=dev)
    eager_gen = torch.Generator(device=dev).manual_seed(7)
    want = [f(x, eager_gen) for _ in range(3)]
    gen = torch.Generator(device=dev).manual_seed(7)
    run = aot_boot._recorded_call(f, (x, gen), {}, lambda: 0.0)
    graph = aot_boot._capture_checked(f, (x, gen), {}, run,
                                      aot_boot._Pool())
    # the recorded call drew the first sample; the graph draws the next two
    got = [run.out] + [graph.replay((x, gen), {}) for _ in range(2)]
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert torch.equal(gen.get_state(), eager_gen.get_state())


@pytest.mark.cuda
def test_a_hit_whose_replay_differs_is_refused_on_the_card(tmp_path):
    """A program that bakes a host value into its capture: the build's
    boot checks it and installs a graph; when the value later changes
    between its eager call and its capture, the strict hit is refused."""
    dev = _card()
    calls, switch = [0], [False]

    def f(x):
        calls[0] += 1
        return x * (2.0 if switch[0] and calls[0] % 2 == 0 else 1.0)

    def program():
        return observe.timed_first_call(f, "aot.test.baked",
                                        recompile_budget=8)

    store = str(tmp_path / "store")
    x = torch.ones(8, device=dev)
    cfg = AotConfig(cache_dir=store, mode="auto")
    stats = warm_boot([("aot.test.baked", program(), (x,))], cfg)
    assert stats["methods"] == {"cuda_graph": 1}, stats
    switch[0], calls[0] = True, 0
    with pytest.raises(AotBootError, match="replay_differs"):
        warm_boot([("aot.test.baked", program(), (x,))],
                  AotConfig(cache_dir=store, mode="strict"))


@pytest.mark.cuda
def test_a_failed_capture_leaves_later_captures_working():
    """A program whose capture fails (a copy from pageable host memory)
    becomes `eager` with the reason, and the pool's next capture works."""
    from dorpatch_tpu_torch.aot import boot as aot_boot

    dev = _card()

    def host_copy(x):
        return x + torch.ones(x.shape).to(x.device)

    def double(x):
        return x * 2.0

    x = torch.ones(16, device=dev)
    pool = aot_boot._Pool()
    for fn, method in ((host_copy, "eager"), (double, "cuda_graph")):
        run = aot_boot._recorded_call(fn, (x,), {}, lambda: 0.0)
        ex = aot_boot._materialize(fn, (x,), {}, run, pool)
        assert ex.method == method, getattr(ex, "detail", "")
        assert torch.equal(ex((x,), {}), fn(x))
    assert ex.method == "cuda_graph"
