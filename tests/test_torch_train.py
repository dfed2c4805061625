"""The port's victim training (`dorpatch_tpu_torch.train`, the trainable
family check and bare-model builder of `models.registry`, and
`data.training_arrays`) against `dorpatch_tpu.train` on the CPU.

Tolerances:
- data arrays, `augment` and eval hit counts: exact;
- the learning-rate schedule: float32 rounding of optax's (rtol 1e-6);
- three train steps from the same flax init, batches and augment draws,
  each taken by the port from JAX's weights and Adam moments: loss within
  rtol 1e-5, accuracy exact; the updated parameters within rtol 1e-5 and
  atol 1e-6 wherever Adam's scale of the element is at least ADAM_FLOOR of
  its tensor's largest, elsewhere within the step's rate (Adam normalizes
  a gradient at rounding level into a full-size step in either
  framework);
- checkpoints: key sets and values exact against the JAX exporters;
  logits of the two packages' victims on each other's `.pth` within 1e-5.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dorpatch_tpu import data as jdata
from dorpatch_tpu import train as jtrain
from dorpatch_tpu.models import registry as jreg
from dorpatch_tpu.models.convert import export_cifar_resnet18, export_vit
from dorpatch_tpu.models.small import CifarResNet18 as JaxCifarResNet18
from dorpatch_tpu_torch import data as tdata
from dorpatch_tpu_torch import train as ttrain
from dorpatch_tpu_torch import utils as tutils
from dorpatch_tpu_torch.models import registry as treg
from dorpatch_tpu_torch.models.convert import from_flax_params, from_flax_vit
from dorpatch_tpu_torch.models.small import CifarResNet18

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
#: Adam divides each element's step by its gradient's running scale, so an
#: element whose gradient is at float32 rounding (the attention key bias,
#: whose gradient is zero in exact arithmetic: a shift shared by every key)
#: takes a step of rounding noise in either framework. Elements whose scale
#: is at least this share of their tensor's largest are held to PARAM_TOL;
#: the others only to the step's rate (measured: 0.2 of it at most)
ADAM_FLOOR = 1e-3
LOGIT_ATOL = 1e-5
#: a tiny run of either family: 10 steps of 24 images, 20 held-out images
TINY = dict(n_per_class_train=24, n_per_class_test=2, epochs=1,
            batch_size=24, warmup_steps=2, seed=1)


def _write_cifar10(root, seed, files=("data_batch_1", "data_batch_3",
                                      "test_batch")):
    base = os.path.join(root, "cifar10", "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(seed)
    for name in files:
        n = int(rng.integers(3, 9))
        d = {b"data": rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8),
             b"labels": rng.integers(0, 10, n).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)


@pytest.mark.parametrize("split", ["train", "test"])
def test_procedural_training_arrays_equal_jax(split):
    want = jdata.training_arrays("cifar10", "procedural", n_per_class=12,
                                 seed=7, split=split)
    got = tdata.training_arrays("cifar10", "procedural", n_per_class=12,
                                seed=7, split=split)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ttrain.quantize(got[0]),
                                  (want[0] * 255).astype(np.uint8))


@pytest.mark.parametrize("split", ["train", "test"])
def test_disk_training_arrays_equal_jax(tmp_path, split):
    _write_cifar10(str(tmp_path), 3)
    want = jdata.training_arrays("cifar10", "disk", str(tmp_path),
                                 split=split)
    got = tdata.training_arrays("cifar10", "disk", str(tmp_path), split=split)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("args,match", [
    (("imagenet", "disk"), "cifar only"),
    (("cifar10", "disk", "data/", 1500, 224), "native-32px"),
    (("cifar10", "nope"), "unknown training data source"),
])
def test_training_arrays_guards_raise_as_jax(args, match):
    for fn in (jdata.training_arrays, tdata.training_arrays):
        with pytest.raises(ValueError, match=match):
            fn(*args)


def _jax_draws(key, n):
    """`dorpatch_tpu.train._augment`'s crop offsets and flips for `key`."""
    kc, kf = jax.random.split(key)
    off = np.array(jax.random.randint(kc, (n, 2), 0, 9))
    flip = np.array(jax.random.bernoulli(kf, 0.5, (n, 1, 1, 1)))
    return torch.as_tensor(off), torch.as_tensor(flip.reshape(n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_equals_jax_bit_for_bit(seed):
    n = 16
    imgs = np.random.default_rng(seed).uniform(
        0, 1, (n, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jtrain._augment(key, jnp.asarray(imgs)))
    off, flip = _jax_draws(key, n)
    got = ttrain.augment(torch.as_tensor(imgs), off, flip)
    np.testing.assert_array_equal(got.numpy(), want)
    # a pure gather: uint8 images move to the same places
    u8 = ttrain.quantize(imgs)
    np.testing.assert_array_equal(
        ttrain.augment(torch.as_tensor(u8), off, flip).numpy(),
        ttrain.quantize(got.numpy()))


def test_draw_augment_ranges_and_seed():
    gen = tutils.generator(5, torch.device("cpu"))
    off, flip = ttrain.draw_augment(gen, 4096)
    assert off.shape == (4096, 2) and flip.dtype == torch.bool
    assert set(off.unique().tolist()) == set(range(9))
    assert 0.45 < float(flip.float().mean()) < 0.55
    again = ttrain.draw_augment(tutils.generator(5, torch.device("cpu")),
                                4096)
    assert torch.equal(off, again[0]) and torch.equal(flip, again[1])


@pytest.mark.parametrize("total,warmup", [(300, 100), (100, 100), (40, 100),
                                          (50, 0)])
def test_lr_schedule_equals_optax(total, warmup):
    """Every count of the run and past its end, including the
    `max(total, warmup + 1)` edge where the run is not longer than its
    warmup."""
    cfg = ttrain.TrainConfig(warmup_steps=warmup)
    want = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, warmup, max(total, warmup + 1))
    lr_at = ttrain.lr_schedule(cfg, total)
    counts = range(total + 5)
    np.testing.assert_allclose([lr_at(c) for c in counts],
                               [float(want(c)) for c in counts],
                               rtol=1e-6, atol=1e-12)
    assert lr_at(0) == 0.0 or warmup == 0


def _families(arch):
    """(flax module, port module, flax -> port converter) of a trainable
    family; the CIFAR ResNet-18 at one block a stage."""
    if arch == "cifar_resnet18":
        return (JaxCifarResNet18(num_classes=10, stage_sizes=(1, 1, 1, 1)),
                CifarResNet18(10, (1, 1, 1, 1)), from_flax_params)
    return (jreg.build_bare_model("cifar_vit", 10),
            treg.build_bare_model("cifar_vit", 10, 32), from_flax_vit)


def _well_determined(nu):
    """Per tensor, the elements whose Adam scale sqrt(nu) is at least
    ADAM_FLOOR of the tensor's largest."""
    out = {}
    for k, v in nu.items():
        r = np.sqrt(v.numpy())
        out[k] = r >= ADAM_FLOOR * r.max()
    return out


def _load_jax_state(tnet, opt, to_torch, params, opt_state, count):
    """The port's model and AdamW state set to JAX's params and Adam
    moments after `count` updates."""
    tnet.load_state_dict(to_torch(params))
    adam = opt_state[0]
    mu, nu = to_torch(adam.mu), to_torch(adam.nu)
    for name, p in tnet.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].clone(),
                        "exp_avg_sq": nu[name].clone()}


@pytest.mark.parametrize("arch", ["cifar_resnet18", "cifar_vit"])
def test_three_train_steps_equal_jax(arch):
    """Three steps from the same flax init, batches and augment draws
    (warmup 2, so that steps 2 and 3 move the weights), each step taken by
    the port from JAX's weights and Adam moments: JAX's loss, accuracy and
    updated weights, and after the steps its held-out hit count."""
    b, total = 8, 100
    jcfg = jtrain.TrainConfig(arch=arch, batch_size=b, warmup_steps=2)
    tcfg = ttrain.TrainConfig(arch=arch, batch_size=b, warmup_steps=2)
    fnet, tnet, to_torch = _families(arch)
    tx = jtrain._make_optimizer(jcfg, total)
    init, step_fn, eval_fn = jtrain.make_train_programs(jcfg, fnet, tx, 10)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    opt_state = tx.init(params)
    opt = ttrain.make_optimizer(tcfg, tnet)
    lr_at = ttrain.lr_schedule(tcfg, total)
    imgs, labels = tdata.procedural_arrays("cifar10", 4, 32, seed=11)
    imgs = ttrain.quantize(imgs)

    def host(tree):
        return to_torch(jax.tree_util.tree_map(np.asarray, tree))

    for step in range(3):
        x, y = imgs[step * b:(step + 1) * b], labels[step * b:(step + 1) * b]
        key = jax.random.PRNGKey(100 + step)
        if step:
            _load_jax_state(tnet, opt, host, params, opt_state, step)
        else:
            tnet.load_state_dict(host(params))
        before = host(params)
        params, opt_state, jloss, jacc = step_fn(
            params, opt_state, key, jnp.asarray(x), jnp.asarray(y))
        off, flip = _jax_draws(key, b)
        loss, acc = ttrain.train_step(
            tnet, opt, lr_at(step), torch.as_tensor(x), torch.as_tensor(y),
            off, flip, tcfg.label_smoothing)
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss), \
            step
        assert float(acc) == float(jacc), step
        want, got = host(params), tnet.state_dict()
        sure = _well_determined(host(opt_state[0].nu))
        for k, w in want.items():
            g, w = got[k].numpy(), w.numpy()
            np.testing.assert_allclose(g[sure[k]], w[sure[k]], **PARAM_TOL,
                                       err_msg=f"step {step} {k}")
            assert np.abs(g - w).max() <= lr_at(step), (step, k)
            assert step == 0 or not torch.equal(got[k], before[k]), k
    xe, ye = imgs[3 * b:], labels[3 * b:]
    assert int(ttrain.eval_hits(tnet, torch.as_tensor(xe),
                                torch.as_tensor(ye))) == int(
        eval_fn(params, jnp.asarray(xe), jnp.asarray(ye)))


@pytest.mark.parametrize("arch", ["cifar_resnet18", "cifar_vit"])
def test_checkpoints_equal_jax_export_and_cross_load(tmp_path, arch):
    """The port's `.pth` holds the JAX exporter's keys and values; each
    package's `get_model` loads the other's `.pth` and gives its logits."""
    fnet = jreg.build_bare_model(arch, 10)
    params = jax.jit(fnet.init)(jax.random.PRNGKey(3),
                                jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, np.shape(a)).astype(
            np.float32), params)
    to_torch = from_flax_params if arch == "cifar_resnet18" else from_flax_vit
    tnet = treg.build_bare_model(arch, 10, 32)
    tnet.load_state_dict(to_torch(params))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    path = ttrain.save_victim_checkpoint(tnet, port_dir, "cifar10", arch)
    assert path == jreg.checkpoint_path(port_dir, "cifar10", arch)
    saved = torch.load(path, weights_only=True)["state_dict"]
    exported = (export_cifar_resnet18 if arch == "cifar_resnet18"
                else export_vit)(params)
    assert set(saved) == set(exported)
    for k, v in exported.items():
        assert saved[k].dtype == torch.float32
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)
    jtrain.save_victim_checkpoint(params, jax_dir, "cifar10", arch)

    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    jv = jreg.get_model("cifar10", arch, port_dir, 32)
    tv = treg.get_model("cifar10", arch, jax_dir, 32, device="cpu")
    assert jv.from_checkpoint and tv.from_checkpoint
    assert not any(p.requires_grad for p in tv.model.parameters())
    assert not tv.model.training
    with torch.no_grad():
        got = tv.apply(torch.as_tensor(x)).numpy()
    want = np.asarray(jv.apply(jv.params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_cli_writes_the_checkpoint_at_the_contract_path(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "dorpatch_tpu_torch.train", "--device", "cpu",
         "--arch", "cifar_vit", "--epochs", "1", "--n-per-class", "10",
         "--batch-size", "50", "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    path = treg.checkpoint_path(str(tmp_path), "cifar10", "cifar_vit")
    assert path.endswith("cifar10/cifar_vit_cutout2_128_cifar10.pth")
    assert f"saved {path}" in out.stderr and "'steps': 2" in out.stderr
    victim = treg.get_model("cifar10", "cifar_vit", str(tmp_path), 32,
                            device="cpu")
    assert victim.from_checkpoint


@pytest.mark.parametrize("arch", ["resnetv2", "vit", "resmlp",
                                  "cifar_resmlp"])
def test_untrainable_families_raise(arch):
    for check in (jtrain._trainable_arch, treg.trainable_arch):
        with pytest.raises(ValueError, match="not trainable offline"):
            check(arch)
    with pytest.raises(ValueError, match="not trainable offline"):
        ttrain.train_victim(ttrain.TrainConfig(arch=arch), device="cpu")
    with pytest.raises(ValueError, match="not trainable offline"):
        ttrain.save_victim_checkpoint(torch.nn.Linear(1, 1), "/nonexistent",
                                      arch=arch)


def test_trainable_names_and_bare_model():
    assert [treg.trainable_arch(a) for a in
            ("cifar_resnet18", "resnet18", "cifar_vit")] == \
        [jtrain._trainable_arch(a) for a in
         ("cifar_resnet18", "resnet18", "cifar_vit")]
    with pytest.raises(ValueError, match="unknown architecture"):
        treg.trainable_arch("mlp_mixer")
    m = treg.build_bare_model("cifar_resnet18", 10, 32, seed=2)
    assert m.training and all(p.requires_grad for p in m.parameters())
    again = treg.build_bare_model("cifar_resnet18", 10, 32, seed=2)
    for v1, v2 in zip(m.state_dict().values(), again.state_dict().values()):
        assert torch.equal(v1, v2)


def test_sub_batch_dataset_raises():
    for fn, cfg in ((jtrain.train_victim, jtrain.TrainConfig),
                    (ttrain.train_victim, ttrain.TrainConfig)):
        kwargs = {"device": "cpu"} if fn is ttrain.train_victim else {}
        with pytest.raises(ValueError, match="not enough data"):
            fn(cfg(n_per_class_train=1, batch_size=128), log=lambda *a: None,
               **kwargs)


def test_train_config_defaults_equal_jax():
    want = {f.name: f.default for f in dataclasses.fields(jtrain.TrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ttrain.TrainConfig)}
    assert got == want
    # the CLI's defaults are the config's
    cfg = ttrain.config_from_args(ttrain.build_parser().parse_args([]))
    assert cfg == ttrain.TrainConfig()
