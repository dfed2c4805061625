"""Victim training: give the main path a victim that classifies.

Port of `dorpatch_tpu.train`: trains `cifar_resnet18` or `cifar_vit` on
the procedural labeled task (`data.training_arrays`; or the CIFAR pickle
batches with `--data-source disk`) and exports the weights as a `.pth`
under the PatchCleanser checkpoint naming contract, which
`models.registry.get_model` loads (and so does the JAX package's).

- The data stay on the device as uint8 (cast per batch as `x / 255`); the
  epoch order is `np.random.default_rng(seed).permutation`, the JAX
  package's, so the batches are its batches.
- `augment` (reflect-pad 4, a random crop, a horizontal flip with p 0.5)
  is a pure function of the images and its draws; the draws come from a
  `torch.Generator` on the device seeded with `seed`.
- The optimizer is optax's `adamw` on `warmup_cosine_decay_schedule(0,
  lr, warmup_steps, max(total, warmup + 1))`, read at the step count
  before its increment (the first update has lr 0), with weight decay on
  every parameter: `torch.optim.AdamW`, whose decay `p * (1 - lr * wd)`
  comes before the Adam step where optax adds `wd * p` to it (the same
  math in another rounding order).
- The loss is cross-entropy with label smoothing, averaged over the batch,
  on `(x - 0.5) / 0.5`, the frame `get_model` folds into the victim.
- One host sync an epoch (its mean batch accuracy), none a step.

On the card, `utils.configure_numerics` (TF32 off, deterministic cuDNN)
makes a run repeat bit for bit.

Run:  python -m dorpatch_tpu_torch.train --out pretrained_models/
      python -m dorpatch_tpu_torch.train --arch cifar_vit --n-per-class 1000
      python -m dorpatch_tpu_torch.train --device cpu --epochs 1 \\
          --n-per-class 24 --batch-size 48

`--telemetry-dir DIR` writes the run-telemetry contract of a results dir
there (`run.json`, `events.jsonl` with a `train.epoch` span an epoch and
a `train.eval` span, `heartbeat_0.jsonl`), as the JAX package's does;
`python -m dorpatch_tpu_torch.observe.report DIR` renders it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dorpatch_tpu_torch import data as data_lib
from dorpatch_tpu_torch import observe, utils
from dorpatch_tpu_torch.models import registry

#: reflect padding of the random crop; offsets are drawn in [0, 2 * PAD]
PAD = 4
#: held-out images a forward in the evaluation
EVAL_CHUNK = 500


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    dataset: str = "cifar10"
    # trainable victim families: "cifar_resnet18" (conv) and "cifar_vit"
    # (transformer), both 32 px (registry.TRAINABLE)
    arch: str = "cifar_resnet18"
    img_size: int = 32
    n_per_class_train: int = 1500
    n_per_class_test: int = 200
    batch_size: int = 128
    epochs: int = 12
    lr: float = 3e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    label_smoothing: float = 0.1
    seed: int = 0
    # "procedural" (the generated task) or "disk" (CIFAR batches under
    # data_dir): data.training_arrays
    data_source: str = "procedural"
    data_dir: str = "data/"


def _log(msg: str) -> None:
    observe.log(msg, file=sys.stderr)


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Source indices of reflect padding (the edge not repeated)."""
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def augment(images: torch.Tensor, offsets: torch.Tensor,
            flips: torch.Tensor) -> torch.Tensor:
    """Pad-4 reflect, crop and flip, as one gather: image i is cropped at
    `offsets[i] = (row, col)` in `[0, 2 * PAD]` of its padded copy and
    mirrored left to right where `flips[i]`. `images` NHWC of any type."""
    n, h, w, _ = images.shape
    dev = images.device
    rows = _reflect(offsets[:, :1] + torch.arange(h, device=dev) - PAD, h)
    cols = _reflect(offsets[:, 1:] + torch.arange(w, device=dev) - PAD, w)
    cols = torch.where(flips[:, None], cols.flip(1), cols)
    return images[torch.arange(n, device=dev)[:, None, None],
                  rows[:, :, None], cols[:, None, :]]


def draw_augment(gen: torch.Generator, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`augment`'s draws for `n` images on the generator's device: crop
    offsets `[n, 2]` uniform in `[0, 2 * PAD]` and flips with p 0.5."""
    offsets = torch.randint(0, 2 * PAD + 1, (n, 2), generator=gen,
                            device=gen.device)
    flips = torch.rand(n, generator=gen, device=gen.device) < 0.5
    return offsets, flips


def lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """optax's `warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(total_steps, warmup_steps + 1))` as a function of the update
    count (0 for the first update), in optax's float32 operations."""
    f32 = np.float32
    warmup = cfg.warmup_steps
    decay = f32(max(total_steps, warmup + 1) - warmup)
    peak = f32(cfg.lr)

    def lr_at(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(count) / f32(warmup)
            return float(-peak * frac + peak)
        t = min(f32(count - warmup), decay)
        return float(peak * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t
                                                         / decay))))

    return lr_at


def make_optimizer(cfg: TrainConfig,
                   model: torch.nn.Module) -> torch.optim.AdamW:
    """optax's `adamw` defaults (b1 0.9, b2 0.999, eps 1e-8) with
    `cfg.weight_decay` on every parameter; `train_step` sets the rate."""
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               lr: float, x_u8: torch.Tensor, y: torch.Tensor,
               offsets: torch.Tensor, flips: torch.Tensor,
               label_smoothing: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update at rate `lr` on the uint8 batch `x_u8` augmented by
    (`offsets`, `flips`); returns the loss and the batch accuracy as
    device scalars (no host sync)."""
    set_rate(opt, lr)
    return update(model, opt, x_u8, y, offsets, flips, label_smoothing)


def set_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """The rate of the next `update` (optax keeps its schedule in the
    optimizer state; here it is the param groups' `lr`)."""
    for group in opt.param_groups:
        group["lr"] = lr


def update(model: torch.nn.Module, opt: torch.optim.Optimizer,
           x_u8: torch.Tensor, y: torch.Tensor, offsets: torch.Tensor,
           flips: torch.Tensor,
           label_smoothing: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """`train_step` at the rate already set on `opt` (`set_rate`)."""
    x = augment(x_u8.float() / 255.0, offsets, flips)
    logits = model(registry.normalize(x))
    loss = F.cross_entropy(logits, y, label_smoothing=label_smoothing)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), (logits.argmax(-1) == y).float().mean()


@torch.no_grad()
def eval_hits(model: torch.nn.Module, x_u8: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Correct predictions on the uint8 batch, a device scalar."""
    logits = model(registry.normalize(x_u8.float() / 255.0))
    return (logits.argmax(-1) == y).sum()


def make_train_programs(cfg: TrainConfig, model: torch.nn.Module,
                        opt: torch.optim.Optimizer):
    """The training programs, wrapped per the telemetry contract under the
    JAX package's names: "train.step" (`update` of the uint8 batch at the
    rate the loop set with `set_rate`; one input signature) and
    "train.eval_step" (`eval_hits`; two: the full chunk and the last). One
    constructor shared by the training loop and the program auditor
    (`analysis/entrypoints.py`). The JAX package's "train.init" has no
    program here: eager torch initializes the parameters in the module's
    constructor."""
    def step(x_u8, y, offsets, flips):
        return update(model, opt, x_u8, y, offsets, flips,
                      cfg.label_smoothing)

    def eval_step(x_u8, y):
        return eval_hits(model, x_u8, y)

    return (observe.timed_first_call(step, "train.step", recompile_budget=1),
            observe.timed_first_call(eval_step, "train.eval_step",
                                     recompile_budget=2))


def quantize(images01: np.ndarray) -> np.ndarray:
    """[0,1] float images to uint8 as the JAX package stores them on the
    device: `(x * 255).astype(uint8)`, truncating."""
    return (images01 * 255).astype(np.uint8)


def train_victim(cfg: TrainConfig = TrainConfig(), device="cuda",
                 log=_log, telemetry_dir: Optional[str] = None
                 ) -> Tuple[torch.nn.Module, dict]:
    """Train the cfg.arch victim on `device` ("cuda" unless the caller asks
    for "cpu"); returns (model, report), report = {"test_acc",
    "train_acc", "steps", "seconds", "backend", "n_train", "n_test"}.
    `telemetry_dir` (optional) gets the run-telemetry contract of an
    experiment results dir: run.json, events.jsonl spans per epoch, a
    heartbeat file."""
    arch_name = registry.trainable_arch(cfg.arch)  # fail before telemetry
    dev = utils.resolve_device(device)
    telemetry = contextlib.ExitStack()
    if telemetry_dir:
        run_id = observe.new_run_id()
        observe.write_run_manifest(
            telemetry_dir, cfg, run_id=run_id,
            extra=observe.torch_environment())
        elog = telemetry.enter_context(observe.EventLog(
            os.path.join(telemetry_dir, observe.events_filename()),
            run_id=run_id))
        telemetry.enter_context(observe.active(elog))
        telemetry.enter_context(observe.Heartbeat(
            os.path.join(telemetry_dir, observe.heartbeat_filename()),
            get_phase=elog.current_path, run_id=run_id))
        telemetry.enter_context(observe.span("run"))
    # `with`, not a happy-path close: an exception must unwind the
    # heartbeat thread and the process-global active EventLog, or a later
    # run in the same process writes spans into this telemetry dir
    with telemetry:
        return _train_victim_impl(cfg, arch_name, dev, log)


def _train_victim_impl(cfg: TrainConfig, arch_name: str, dev: torch.device,
                       log) -> Tuple[torch.nn.Module, dict]:
    utils.configure_numerics()
    tr_x, tr_y = data_lib.training_arrays(
        cfg.dataset, cfg.data_source, cfg.data_dir,
        n_per_class=cfg.n_per_class_train, img_size=cfg.img_size,
        seed=1234, split="train")
    te_x, te_y = data_lib.training_arrays(
        cfg.dataset, cfg.data_source, cfg.data_dir,
        n_per_class=cfg.n_per_class_test, img_size=cfg.img_size,
        seed=1234, split="test")
    n_classes = int(tr_y.max()) + 1
    steps_per_epoch = len(tr_x) // cfg.batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"{len(tr_x)} training images < batch_size {cfg.batch_size}: "
            "not enough data for one step (partial dataset?)")
    total_steps = steps_per_epoch * cfg.epochs

    model = registry.build_bare_model(arch_name, n_classes, cfg.img_size,
                                      cfg.seed).to(dev)
    opt = make_optimizer(cfg, model)
    step_program, eval_program = make_train_programs(cfg, model, opt)
    lr_at = lr_schedule(cfg, total_steps)
    gen = utils.generator(cfg.seed, dev)
    dev_tr_x = torch.as_tensor(quantize(tr_x), device=dev)
    dev_tr_y = torch.as_tensor(tr_y, device=dev)
    dev_te_x = torch.as_tensor(quantize(te_x), device=dev)
    dev_te_y = torch.as_tensor(te_y, device=dev)

    rng = np.random.default_rng(cfg.seed)
    t0 = time.perf_counter()
    step = 0
    train_acc = 0.0
    for epoch in range(cfg.epochs):
        with observe.span("train.epoch", epoch=epoch + 1) as sp:
            order = torch.as_tensor(rng.permutation(len(tr_x)), device=dev)
            accs = []
            for i in range(steps_per_epoch):
                sel = order[i * cfg.batch_size:(i + 1) * cfg.batch_size]
                offsets, flips = draw_augment(gen, cfg.batch_size)
                set_rate(opt, lr_at(step))
                _, acc = step_program(dev_tr_x[sel], dev_tr_y[sel], offsets,
                                      flips)
                accs.append(acc)
                step += 1
            train_acc = float(torch.stack(accs).mean())
            sp["train_acc"] = round(train_acc, 4)
        log(f"epoch {epoch + 1}/{cfg.epochs}: train_acc={train_acc:.3f} "
            f"({time.perf_counter() - t0:.0f}s)")
    with observe.span("train.eval"):
        hits = sum(eval_program(dev_te_x[i:i + EVAL_CHUNK],
                                dev_te_y[i:i + EVAL_CHUNK])
                   for i in range(0, len(te_x), EVAL_CHUNK))
        acc = int(hits) / len(te_x)
    report = {
        "test_acc": acc,
        "train_acc": train_acc,
        "steps": step,
        "seconds": round(time.perf_counter() - t0, 1),
        "backend": dev.type,
        "n_train": len(tr_x),
        "n_test": len(te_x),
    }
    log(f"done: held-out acc={acc:.3f} ({report['seconds']}s on "
        f"{report['backend']})")
    return model, report


def save_victim_checkpoint(model: torch.nn.Module, out_dir: str,
                           dataset: str = "cifar10",
                           arch: str = "cifar_resnet18") -> str:
    """Write `{"state_dict": ...}` (float32 CPU tensors under timm's key
    names, the JAX package's export) at `registry.checkpoint_path`."""
    name = registry.trainable_arch(arch)
    path = registry.checkpoint_path(out_dir, dataset, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = {k: v.detach().to("cpu", torch.float32).clone()
          for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, path)
    return path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dorpatch_tpu_torch.train",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train: the GPU (default) or, on request, "
                        "the CPU")
    p.add_argument("--out", default="pretrained_models/",
                   help="model dir to export the checkpoint into")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--arch", default="cifar_resnet18",
                   choices=("cifar_resnet18", "resnet18", "cifar_vit"),
                   help="victim family to train (32px offline victims)")
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--n-per-class", type=int, default=1500)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-source", default="procedural",
                   choices=("procedural", "disk"),
                   help="disk = real CIFAR train batches under --data-dir")
    p.add_argument("--data-dir", default="data/")
    p.add_argument("--telemetry-dir", default="",
                   help="write run telemetry (run.json, events.jsonl, "
                        "heartbeat) here; readable by "
                        "`python -m dorpatch_tpu_torch.observe.report`")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(dataset=args.dataset, arch=args.arch,
                       epochs=args.epochs, batch_size=args.batch_size,
                       lr=args.lr, seed=args.seed,
                       n_per_class_train=args.n_per_class,
                       data_source=args.data_source, data_dir=args.data_dir)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    model, report = train_victim(config_from_args(args), device=args.device,
                                 telemetry_dir=args.telemetry_dir)
    path = save_victim_checkpoint(model, args.out, args.dataset, args.arch)
    _log(f"saved {path}; report={report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
