"""The ViT slice on the CPU: the "token-exact" certification records of the
port against `dorpatch_tpu.defense.PatchCleanser` with the same narrow ViT
in both packages (one case where some images escalate to the exhaustive
sweep and one where none does), `forward_equivalents` on the stem path, and
`run_experiment` with `--base_arch vit` through the command line."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dorpatch_tpu import defense as jdef
from dorpatch_tpu import masks as jmasks
from dorpatch_tpu.config import DefenseConfig as JaxDefenseConfig
from dorpatch_tpu.models.registry import incremental_engine as j_engine
from dorpatch_tpu_torch import defense as tdef
from dorpatch_tpu_torch import masks as tmasks
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import DefenseConfig
from dorpatch_tpu_torch.models import registry, small, vit
from dorpatch_tpu_torch.models.registry import incremental_engine as t_engine
from dorpatch_tpu_torch.models.registry import normalize
from dorpatch_tpu_torch.pipeline import run_experiment

from test_torch_vit import NARROW, _one_torch_thread, synced_vit  # noqa: F401

NAME = "cifar_vit"
IMG, RATIO, CLASSES = 32, 0.12, 10


#: a head scaled so that the images' smallest margins spread out
HEAD_SCALE = 30.0


def _port_bank(tnet, margin):
    return tdef.PatchCleanser(
        lambda z: tnet(normalize(z)), tmasks.geometry(IMG, RATIO),
        DefenseConfig(ratios=(RATIO,), incremental_margin=margin),
        incremental_engine=t_engine(NAME, tnet, IMG), device="cpu")


@pytest.mark.parametrize("seed,some", [(17, True), (12, False)])
def test_token_exact_records_match_jax(seed, some):
    """The threshold goes into the widest gap between the 4 images' smallest
    evaluated margins (some escalate) or at half the smallest (none does),
    and lies at least 1e-3 from every one of them in both packages."""
    fnet, params, tnet = synced_vit(NARROW, IMG, seed, head_scale=HEAD_SCALE)
    x = np.random.default_rng(seed).uniform(0, 1, (4, IMG, IMG, 3)) \
        .astype(np.float32)
    probe = _port_bank(tnet, 0.5)
    probe.robust_predict(torch.as_tensor(x), CLASSES, incremental="token")
    mins = np.sort(probe.last_min_margin)
    escalated = int(np.argmax(np.diff(mins))) + 1 if some else 0
    margin = float((mins[escalated - 1] + mins[escalated]) / 2
                   if escalated else mins[0] / 2)

    jpc = jdef.PatchCleanser(
        lambda p, z: fnet.apply(p, (z - 0.5) / 0.5),
        jmasks.geometry(IMG, RATIO),
        JaxDefenseConfig(ratios=(RATIO,), incremental_margin=margin),
        incremental_engine=j_engine(NAME, fnet, IMG))
    want = jpc.robust_predict(params, jnp.asarray(x), CLASSES, prune="exact",
                              incremental="token-exact")
    tpc = _port_bank(tnet, margin)
    assert tpc.resolved_incremental() == "token-exact"
    got = tpc.robust_predict(torch.as_tensor(x), CLASSES)
    for mm in (tpc.last_min_margin, np.asarray(jpc.last_min_margin)):
        assert np.abs(mm - margin).min() > 1e-3
    np.testing.assert_allclose(tpc.last_min_margin, jpc.last_min_margin,
                               atol=1e-4)
    assert int((tpc.last_min_margin < margin).sum()) == escalated
    exhaustive = tpc.num_forwards_exhaustive
    for g, w in zip(got, want):
        assert (g.prediction, g.certification, g.forwards) == \
            (w.prediction, w.certification, w.forwards)
        assert g.forward_equivalents == pytest.approx(w.forward_equivalents,
                                                      rel=1e-12)
        np.testing.assert_array_equal(g.preds_1, w.preds_1)
        np.testing.assert_array_equal(g.preds_2, w.preds_2)
    assert sum(g.forwards > exhaustive for g in got) == escalated
    # a token entry costs a fraction of a forward
    assert all(g.forward_equivalents < g.forwards for g in got
               if g.forwards <= exhaustive)


def test_escalation_gives_the_exhaustive_verdicts():
    """With a threshold above every margin, "token-exact" re-certifies
    every image: its verdicts and tables are the exhaustive sweep's."""
    _, _, tnet = synced_vit(NARROW, IMG, 13, head_scale=HEAD_SCALE)
    x = torch.as_tensor(np.random.default_rng(13).uniform(
        0, 1, (3, IMG, IMG, 3)).astype(np.float32))
    tpc = _port_bank(tnet, 1e9)
    got = tpc.robust_predict(x, CLASSES)
    off = tpc.robust_predict(x, CLASSES, prune="off")
    m, p = tpc.num_first, tpc.num_second
    for g, o in zip(got, off):
        assert (g.prediction, g.certification) == (o.prediction,
                                                   o.certification)
        np.testing.assert_array_equal(g.preds_2, o.preds_2)
        assert g.forwards > m + p and o.forward_equivalents == m + p
    with pytest.raises(ValueError, match="engine is 'token'"):
        tpc.robust_predict(x, CLASSES, incremental="stem")


def test_stem_path_forward_equivalents_equal_forwards():
    """Without the token engine an entry costs one forward: the stem fold,
    full masked forwards and the exhaustive sweep all count
    `forward_equivalents == forwards` (a shallow CIFAR ResNet at 11 px)."""
    img = 11
    net = small.CifarResNet18(10, (1, 1, 1, 1))
    small.init_weights(net, torch.Generator().manual_seed(3))
    net = net.eval().requires_grad_(False)
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        0, 1, (2, img, img, 3)).astype(np.float32))
    pc = tdef.PatchCleanser(lambda z: net(normalize(z)),
                            tmasks.geometry(img, 0.12),
                            DefenseConfig(ratios=(0.12,)),
                            incremental_engine=t_engine("cifar_resnet18",
                                                        net, img),
                            device="cpu")
    assert pc.resolved_incremental() == "stem"
    for kwargs in ({}, {"incremental": "off"}, {"prune": "off"}):
        recs = pc.robust_predict(x, 10, **kwargs)
        assert all(r.forward_equivalents == r.forwards > 0 for r in recs)


def test_run_experiment_vit_on_cpu(tmp_path, monkeypatch):
    """`--base_arch vit` through the command line and `run_experiment` on
    the CPU (the factory builds a narrow ViT at the 32 px grid of 16 px
    patches): attack, L2 projection and the four-radius token-exact
    certification, with its forward equivalents and escalations."""
    built = []

    def narrow(n, img):
        built.append((n, img))
        return vit.ViT(n, 16, 32, 2, 2, img)

    name = "vit_base_patch16_224"
    _, init_weights = registry._FAMILIES[name]
    monkeypatch.setitem(registry._FAMILIES, name, (narrow, init_weights))
    args = build_parser().parse_args([
        "--device", "cpu", "--synthetic", "--dataset", "cifar10",
        "--base_arch", "vit", "--img-size", "32", "-b", "2",
        "--sampling-size", "4", "--dropout", "1", "--max-iterations", "2",
        "--num-batches", "1", "--incremental-margin", "0.25",
        "--model_dir", str(tmp_path / "models"),
        "--results-root", str(tmp_path / "results")])
    cfg = config_from_args(args)
    assert (cfg.base_arch, cfg.defense.incremental,
            cfg.defense.incremental_margin) == ("vit", "auto", 0.25)
    m = run_experiment(cfg, verbose=False)
    assert built == [(10, 32)]
    assert m["evaluated_images"] == 2
    assert len(m["acc_pc"]) == len(m["certified_asr_pc"]) == 4
    assert 0 < m["forwards"]
    assert 0 < m["forward_equivalents"]
    assert 0 <= m["escalated"] <= 2 * 4
    assert len(m["attack_seconds"]) == len(m["certify_seconds"]) == 1
