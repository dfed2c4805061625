"""The port's ResMLP family (`dorpatch_tpu_torch.models.resmlp`) against
`dorpatch_tpu.models.resmlp` and `dorpatch_tpu.defense` on the CPU, with the
same weights in both packages: the victim's logits and clean cache, the
timm checkpoint contract through both packages' loaders, the mixer
engine's tables and programs, and the "mixer" / "mixer-exact"
certification records in float32 and in the bf16 bank, alone and under
`prune="consensus"`; then `--base_arch resmlp` through the command line."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dorpatch_tpu import defense as jdef
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.config import DefenseConfig as JaxDefenseConfig
from dorpatch_tpu.models import convert as jconvert
from dorpatch_tpu.models import resmlp as jresmlp
from dorpatch_tpu.models import timm_keys
from dorpatch_tpu.models.registry import incremental_engine as j_engine
from dorpatch_tpu_torch import defense as tdef
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import DefenseConfig
from dorpatch_tpu_torch.models import registry
from dorpatch_tpu_torch.models import resmlp as tresmlp
from dorpatch_tpu_torch.models.convert import from_flax_resmlp
from dorpatch_tpu_torch.models.registry import incremental_engine as t_engine
from dorpatch_tpu_torch.pipeline import run_experiment

# float32 through a few residual blocks in two frameworks
LOGIT_ATOL = 1e-4
NAME = "cifar_resmlp"
IMG, RATIO, CLASSES = 32, 0.12, 10
#: the JAX package's cifar_resmlp, and 2 blocks of ResMLP-24's width at
#: 224 px with its 16 px patches
CONFIGS = {"cifar_resmlp": (dict(jresmlp.CIFAR_RESMLP), 32),
           "resmlp_224x2": (dict(patch_size=16, dim=384, depth=2,
                                 img_size=224), 224)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engine runs many small ops: one intra-op thread keeps them from
    contending with the other test processes' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synced_resmlp(cfg, img, seed, classes=CLASSES, head_scale=1.0):
    """The same ResMLP in both packages: flax init with the Affines and
    layerscales perturbed so that every carried parameter is exercised,
    and the head scaled. Returns (flax module, params, port module)."""
    cfg = {k: v for k, v in cfg.items() if k != "img_size"}
    fnet = jresmlp.ResMLP(num_classes=classes, img_size=img, **cfg)
    params = jax.jit(fnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, img, img, 3)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] in ("alpha", "ls1", "ls2"):
            return leaf + rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        if keys[-1] == "beta":
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        if keys[-2] == "head":
            return leaf * head_scale
        return leaf

    params_np = jax.tree_util.tree_map_with_path(perturb, params)
    tnet = tresmlp.ResMLP(classes, img_size=img, **cfg)
    tnet.load_state_dict(from_flax_resmlp(params_np))
    tnet = tnet.eval().requires_grad_(False)
    return fnet, jax.tree_util.tree_map(jnp.asarray, params_np), tnet


def _images(seed, b, img):
    return np.random.default_rng(seed).uniform(0, 1, (b, img, img, 3)) \
        .astype(np.float32)


def _rects(img, ratio):
    """The certifier's combined `[singles; pairs]` rectangle table."""
    singles, doubles = jmasks.mask_sets(jmasks.geometry(img, ratio))
    return (np.concatenate([jmasks.pad_rects(singles, 2),
                            jmasks.pad_rects(doubles, 2)]), len(singles))


@pytest.mark.parametrize("img,patch,ratio", [(32, 4, 0.12), (32, 4, 0.015),
                                             (224, 16, 0.12),
                                             (224, 16, 0.03)])
def test_mixer_tables_match_jax(img, patch, ratio):
    rects, m = _rects(img, ratio)
    for part in (rects[:m], rects[m:], rects):
        got = tresmlp._build_mixer_tables(part, img, patch)
        want = jresmlp._build_mixer_tables(part, img, patch)
        for name in got._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)))
    assert got.w.min() == 0.0 and got.w.max() == 1.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_resmlp_logits_and_cache_match_flax(name):
    """Logits within LOGIT_ATOL of flax in float32 on numpy-seeded inputs,
    and the "cache" mode's block inputs, token-mix outputs and final
    activations too."""
    cfg, img = CONFIGS[name]
    fnet, params, tnet = synced_resmlp(cfg, img, 1, head_scale=4.0)
    x = _images(2, 2, img)
    want = np.asarray(fnet.apply(params, jnp.asarray(x)))
    wxs, wzs, wxf = fnet.apply(params, jnp.asarray(x), "cache")
    with torch.no_grad():
        got = tnet(torch.as_tensor(x)).numpy()
        xs, zs, xf = tnet(torch.as_tensor(x), "cache")
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    assert len(xs) == len(zs) == len(wxs) == len(wzs) == cfg["depth"]
    for a, w in zip(list(xs) + list(zs) + [xf],
                    list(wxs) + list(wzs) + [wxf]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                   atol=LOGIT_ATOL, rtol=0)
    assert len(set(np.argmax(want, -1).tolist())) > 1 or want.std() > 0
    with pytest.raises(ValueError, match="mode"):
        tnet(torch.as_tensor(x), "stem")


def test_timm_state_dict_round_trips_both_loaders(tmp_path):
    """The port's ResMLP-24 carries timm's `resmlp_24_distilled_224` names
    and shapes; a timm-keyed state dict (random, at cifar_resmlp's size)
    gives the same logits through the JAX package's `convert_resmlp` and
    the port's strict load, `from_flax_resmlp` inverts `convert_resmlp`
    exactly, and `get_model` loads the `.pth` from the model directory."""
    full = tresmlp.resmlp_24(1000).state_dict()
    assert {k: tuple(v.shape) for k, v in full.items()} == \
        dict(timm_keys.resmlp_24_keys(1000))

    tnet = tresmlp.resmlp_cifar(CLASSES)
    gen = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.1
          for k, v in tnet.state_dict().items()}
    tnet.load_state_dict(sd, strict=True)
    tnet.eval()
    params = jconvert.convert_resmlp({k: v.numpy() for k, v in sd.items()},
                                     depth=jresmlp.CIFAR_RESMLP["depth"])
    back = from_flax_resmlp(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    x = _images(3, 2, IMG)
    fnet = jresmlp.resmlp_cifar(CLASSES)
    want = np.asarray(fnet.apply(jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)

    path = registry.checkpoint_path(str(tmp_path), "cifar10", NAME)
    (tmp_path / "cifar10").mkdir()
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               path)
    victim = registry.get_model("cifar10", NAME, str(tmp_path), IMG,
                                device="cpu")
    assert victim.from_checkpoint
    with torch.no_grad():
        got = victim.model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_registry_builds_both_resmlps_and_their_engines():
    """`--base_arch resmlp` and `cifar_resmlp` resolve to the JAX package's
    names; the engine is the mixer one, and None where the patch does not
    divide the image; the seeded init has the JAX initializers'
    distributions."""
    assert registry.resolve_arch("resmlp") == "resmlp_24_distilled_224"
    assert registry.resolve_arch(NAME) == NAME
    victim = registry.get_model("cifar10", NAME, "/nonexistent", IMG,
                                device="cpu")
    assert not victim.from_checkpoint
    eng = victim.incremental
    assert isinstance(eng, tresmlp.MixerPrunedResMLP) and eng.kind == "mixer"
    assert (eng.tokens, victim.model.dim, victim.model.depth) == (64, 128, 6)
    blk = victim.model.blocks[0]
    assert tuple(blk.linear_tokens.weight.shape) == (64, 64)
    w = blk.mlp_channels.fc1.weight
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
    assert float(blk.norm1.alpha.min()) == float(blk.ls1.max()) == 1.0
    assert float(victim.model.head.bias.abs().max()) == 0.0
    odd = registry.get_model("cifar10", NAME, "/nonexistent", 30,
                             device="cpu")
    assert odd.incremental is None


@pytest.fixture(scope="module")
def engines():
    """cifar_resmlp's mixer engine in both packages on the 0.12-radius
    table at 32 px."""
    fnet, params, tnet = synced_resmlp(jresmlp.CIFAR_RESMLP, IMG, 3,
                                       head_scale=4.0)
    rects, m = _rects(IMG, RATIO)
    jeng = j_engine(NAME, fnet, IMG)
    teng = t_engine(NAME, tnet, IMG)
    return jeng, params, teng, rects, m, _images(4, 2, IMG)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("program", ["phase1", "pairs", "rows"])
def test_mixer_engine_matches_jax(engines, program, dtype):
    """The engine's three programs: margins within 1e-4 in float32 (1.0 in
    bf16, where both run the cast victim: 8 ulps of bf16 at these logits,
    about 25, after 6 blocks of bf16 roundings in two frameworks),
    predictions equal wherever both margins clear that."""
    jeng, params, teng, rects, m, x = engines
    atol = 1e-4 if dtype == "float32" else 1.0
    jfam = jeng.build_family(rects, m, 64, 0.5, compute_dtype=dtype)
    tfam = teng.build_family(rects, m, 64, 0.5, compute_dtype=dtype)
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                        params)
    if program == "rows":
        sets = jmasks.second_round_table_indices(m)[[3, 7, 20, 35]]
        xg = x[[0, 1, 0, 1]]
        jp, jm = map(np.asarray, jax.jit(jfam.rows)(
            params, jnp.asarray(xg), jnp.asarray(sets, dtype=jnp.int32)))
        tp, tm = (t.numpy() for t in tfam.rows(torch.as_tensor(xg),
                                               torch.as_tensor(sets)))
    else:
        jp, jm = map(np.asarray, jax.jit(getattr(jfam, program))(
            params, jnp.asarray(x)))
        tp, tm = (t.numpy() for t in getattr(tfam, program)(
            torch.as_tensor(x)))
    assert tp.shape == jp.shape and tp.dtype == np.int32
    assert tm.dtype == np.float32
    np.testing.assert_allclose(tm, jm, atol=atol, rtol=0)
    sure = np.minimum(tm, jm) > atol
    np.testing.assert_array_equal(tp[sure], jp[sure])
    assert sure.mean() > 0.9
    assert tfam.fe_first == pytest.approx(jfam.fe_first, rel=1e-12)
    assert tfam.fe_pairs == pytest.approx(jfam.fe_pairs, rel=1e-12)
    assert tfam.cache_fe == jfam.cache_fe


# ---------------------------------------------------- certification records


def _cfg(prune, incremental, dtype, margin):
    return dict(ratios=(RATIO,), prune=prune, incremental=incremental,
                incremental_margin=margin, compute_dtype=dtype)


def _port_bank(tnet, cfg):
    return tdef.PatchCleanser(registry.VictimForward(tnet),
                              tmasks.geometry(IMG, RATIO),
                              DefenseConfig(**cfg),
                              incremental_engine=t_engine(NAME, tnet, IMG),
                              device="cpu")


def _jax_bank(fnet, cfg):
    return jdef.PatchCleanser(lambda p, z: fnet.apply(p, (z - 0.5) / 0.5),
                              jmasks.geometry(IMG, RATIO),
                              JaxDefenseConfig(**cfg),
                              incremental_engine=j_engine(NAME, fnet, IMG))


@pytest.fixture(scope="module")
def record_victim():
    """Seed 1's cifar_resmlp: its four images cover a certified image, an
    unanimous one whose pair audit kills the certificate and a disagreeing
    one that takes the minority rows; two of the smallest evaluated
    margins are below 0.05, two above 0.9."""
    fnet, params, tnet = synced_resmlp(jresmlp.CIFAR_RESMLP, IMG, 1)
    return fnet, params, tnet, _images(1, 4, IMG)


@pytest.mark.parametrize("prune,dtype,incremental,margin", [
    ("exact", "float32", "mixer", 0.5),
    ("exact", "float32", "mixer-exact", None),
    ("consensus", "float32", "mixer-exact", None),
    ("exact", "bfloat16", "auto", 0.5),
    ("consensus", "bfloat16", "mixer-exact", 0.5)])
def test_mixer_records_match_jax(record_victim, prune, dtype, incremental,
                                 margin):
    """Verdicts, `preds_1`, `preds_2`, `forwards` and `forward_equivalents`
    of the port's bank equal the JAX package's. margin None: the
    threshold goes into the widest gap between the images' smallest
    evaluated margins (some escalate, some do not), at least 1e-3 from
    every one of them in both packages. The bf16 banks run the cast
    victim and escalate the images under 0.5."""
    fnet, params, tnet, x = record_victim
    if margin is None:
        probe = _port_bank(tnet, _cfg(prune, "mixer", dtype, 0.5))
        probe.robust_predict(torch.as_tensor(x), CLASSES)
        mins = np.sort(probe.last_min_margin)
        cut = int(np.argmax(np.diff(mins))) + 1
        margin = float((mins[cut - 1] + mins[cut]) / 2)
    cfg = _cfg(prune, incremental, dtype, margin)
    tpc, jpc = _port_bank(tnet, cfg), _jax_bank(fnet, cfg)
    assert tpc.resolved_incremental() == jpc.resolved_incremental()
    want = jpc.robust_predict(params, jnp.asarray(x), CLASSES)
    got = tpc.robust_predict(torch.as_tensor(x), CLASSES)
    jmin = np.asarray(jpc.last_min_margin)
    esc = tpc.last_min_margin < margin
    np.testing.assert_array_equal(esc, jmin < margin)
    if dtype == "float32":
        np.testing.assert_allclose(tpc.last_min_margin, jmin, atol=1e-4)
        if incremental != "mixer":
            assert 0 < esc.sum() < len(x)
    for g, w in zip(got, want):
        assert (g.prediction, g.certification, g.forwards) == \
            (w.prediction, w.certification, w.forwards)
        assert g.forward_equivalents == pytest.approx(w.forward_equivalents,
                                                      rel=1e-12)
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        np.testing.assert_array_equal(g.preds_2, w.preds_2)
    exhaustive = tpc.num_forwards_exhaustive
    if tpc.resolved_incremental().endswith("-exact") or dtype == "bfloat16":
        assert [g.forwards > exhaustive for g in got] == esc.tolist()
    if prune == "consensus":
        # a unanimous image that did not escalate stopped after round 1
        assert any(g.forwards == tpc.num_first for g in got)


def test_bf16_bank_with_full_forwards_keeps_the_f32_verdicts(record_victim):
    """The bf16 bank with incremental="off" runs the victim's once-cast
    copy (`VictimForward.at`): every image's verdict equals the float32
    exhaustive sweep's and the JAX bf16 bank's, and an image whose margins
    clear 0.5 keeps the JAX bank's whole record. An escalated image's
    tables are the f32 sweep's; its forwards also count the minority rows
    of its bf16 first round, where a near-tie entry may round either way
    in the two frameworks, so they are not compared."""
    fnet, params, tnet, x = record_victim
    cfg = _cfg("exact", "off", "bfloat16", 0.5)
    tpc = _port_bank(tnet, cfg)
    want = _jax_bank(fnet, cfg).robust_predict(params, jnp.asarray(x),
                                               CLASSES)
    got = tpc.robust_predict(torch.as_tensor(x), CLASSES)
    off = _port_bank(tnet, _cfg("off", "off", "float32", 0.5)) \
        .robust_predict(torch.as_tensor(x), CLASSES)
    esc = tpc.last_min_margin < 0.5
    np.testing.assert_array_equal(esc, [g.forwards > 666 for g in want])
    for g, w, o, e in zip(got, want, off, esc):
        assert (g.prediction, g.certification) == \
            (w.prediction, w.certification) == \
            (o.prediction, o.certification)
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        np.testing.assert_array_equal(g.preds_2, w.preds_2)
        if e:
            np.testing.assert_array_equal(g.preds_2, o.preds_2)
            assert g.forwards > tpc.num_forwards_exhaustive
        else:
            assert g.forwards == w.forwards
    cast = tpc._capply
    assert next(cast.model.parameters()).dtype == torch.bfloat16
    assert next(tnet.parameters()).dtype == torch.float32


def test_auto_resolves_to_mixer_exact_and_rejects_other_engines(
        record_victim):
    _, _, tnet, x = record_victim
    tpc = _port_bank(tnet, _cfg("exact", "auto", "float32", 0.5))
    assert tpc.resolved_incremental() == "mixer-exact"
    assert tpc.resolved_incremental("mixer") == "mixer"
    assert tpc.resolved_incremental("auto", prune="off") == "off"
    for bad in ("token", "token-exact", "stem"):
        with pytest.raises(ValueError, match="engine is 'mixer'"):
            tpc.resolved_incremental(bad)
    # a mixer entry costs a fraction of a forward, the cache one forward
    fam = tpc._incr_family
    assert fam.cache_fe == 1.0 and 0 < fam.fe.max() < 1
    assert tpc._fe_first == pytest.approx(fam.fe_first + 1.0)


def test_run_experiment_resmlp_on_cpu(tmp_path, monkeypatch):
    """`--base_arch resmlp` through the command line and `run_experiment` on
    the CPU (the factory builds a 2-block ResMLP of width 32 at the 32 px
    grid of 16 px patches): attack, L2 projection and the four-radius
    mixer-exact certification, with its forward equivalents and
    escalations."""
    built = []

    def narrow(n, img):
        built.append((n, img))
        return tresmlp.ResMLP(n, 16, 32, 2, img)

    name = "resmlp_24_distilled_224"
    _, init_weights = registry._FAMILIES[name]
    monkeypatch.setitem(registry._FAMILIES, name, (narrow, init_weights))
    args = build_parser().parse_args([
        "--device", "cpu", "--synthetic", "--dataset", "cifar10",
        "--base_arch", "resmlp", "--img-size", "32", "-b", "2",
        "--sampling-size", "4", "--dropout", "1", "--max-iterations", "2",
        "--num-batches", "1",
        "--model_dir", str(tmp_path / "models"),
        "--results-root", str(tmp_path / "results")])
    cfg = config_from_args(args)
    assert (cfg.base_arch, cfg.defense.incremental) == ("resmlp", "auto")
    m = run_experiment(cfg, verbose=False)
    assert built == [(10, 32)]
    assert m["evaluated_images"] == 2
    assert len(m["acc_pc"]) == len(m["certified_asr_pc"]) == 4
    assert 0 < m["forward_equivalents"] < m["forwards"]
    assert 0 <= m["escalated"] <= 2 * 4
