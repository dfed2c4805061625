"""The port's numerics setup and `dorpatch_tpu_torch.repeat` on the CPU:
`configure_numerics` pins full float32 and deterministic cuDNN, and
`repeat.py`'s victims are the main paths `chip_smoke.py` runs."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dorpatch_tpu_torch import repeat, utils
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.models import get_model

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def numerics():
    """Restore the global backend flags a test changes."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    yield
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


def test_configure_numerics_pins_f32_and_deterministic_cudnn(numerics):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    utils.configure_numerics()
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_repeat_parser_defaults_and_choices():
    args = repeat.build_parser().parse_args([])
    assert (args.base_arch, args.steps, args.trials) == ("resnetv2", 5,
                                                         repeat.TRIALS)
    args = repeat.build_parser().parse_args(["--base_arch", "vit",
                                             "--steps", "20",
                                             "--trials", "50"])
    assert (args.base_arch, args.steps, args.trials) == ("vit", 20, 50)
    with pytest.raises(SystemExit):
        repeat.build_parser().parse_args(["--base_arch", "resmlp"])


@pytest.mark.parametrize("path,arch", [("CIFAR_ARGV", "resnet18"),
                                       ("RN50_ARGV", "resnetv2"),
                                       ("VIT_ARGV", "vit")])
def test_repeat_victims_are_chip_smoke_main_paths(path, arch):
    cfg = config_from_args(build_parser().parse_args(
        getattr(_chip_smoke(), path)))
    assert cfg.base_arch == arch
    assert repeat.VICTIMS[arch] == repeat.Victim(cfg.dataset, cfg.img_size,
                                                 cfg.batch_size)
    assert (cfg.attack.sampling_size, cfg.attack.dropout, cfg.seed) == \
        (repeat.SAMPLING_SIZE, repeat.DROPOUT, repeat.SEED)
    assert set(repeat.VICTIMS) == {"resnet18", "resnetv2", "vit"}


def test_repeat_size_and_batch_flags_take_the_480_main_path():
    """`--img-size 480 --batch 1` is the victim of `chip_smoke.py`'s RN50
    480 paths; without them the size and batch are the victim's 224
    path's."""
    cfg = config_from_args(build_parser().parse_args(
        _chip_smoke().RN50_480_ARGV))
    args = repeat.build_parser().parse_args(["--img-size", "480",
                                             "--batch", "1"])
    assert (cfg.base_arch, cfg.img_size, cfg.batch_size) == \
        (args.base_arch, args.img_size, args.batch) == ("resnetv2", 480, 1)
    assert (cfg.attack.sampling_size, cfg.attack.dropout) == \
        (repeat.SAMPLING_SIZE, repeat.DROPOUT)
    args = repeat.build_parser().parse_args([])
    assert args.img_size is None and args.batch is None


def test_attack_steps_repeat_and_compare_finds_a_difference():
    """Two runs from one seed on the CPU are bit-equal step by step, and
    `compare` names the first step where a run differs."""
    victim = get_model("cifar10", "resnet18", "/nonexistent", 8,
                       device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 1, (1, 8, 8, 3)), dtype=torch.float32)
    runs = [repeat.attack_steps(victim, x, 2) for _ in range(2)]
    assert len(runs[0]) == 2
    assert repeat.compare("cpu", *runs) == dict(first_step=None, max_abs=0.0)
    bent = [runs[1][0], tuple(t + (i == 1) * 1e-3
                              for i, t in enumerate(runs[1][1]))]
    rec = repeat.compare("bent", runs[0], bent)
    assert rec["first_step"] == 2
    assert rec["max_abs"] == pytest.approx(1e-3, rel=1e-3)


def test_victim_repeat_counts_calls_that_differ_from_the_first():
    """On the CPU every call of the victim's gradient equals the first."""
    victim = get_model("cifar10", "resnet18", "/nonexistent", 8,
                       device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).uniform(
        0, 1, (1, 8, 8, 3)), dtype=torch.float32)
    rec = repeat.victim_repeat(victim, x, "cpu", 3)
    assert rec == dict(logits=0.0, logits_differing=0, input_grad=0.0,
                       input_grad_differing=0)
