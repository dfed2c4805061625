"""One rank of the CPU mesh that `test_torch_parallel.py` holds against the
JAX package: four of these processes form a `(2, 2)` gloo process group
over a `FileStore`, run the port's sharded forms and meshed entry points
on inputs made from numpy seeds, and each pickles what it computed (and
the inputs) to `<out>/rank_<rank>.pkl`.

Usage: torch_mesh_ranks.py <rank> <world> <store file> <out dir>
"""

import dataclasses
import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

torch.set_num_threads(1)

from dorpatch_tpu_torch import masks as tmasks  # noqa: E402
from dorpatch_tpu_torch.attack import DorPatch  # noqa: E402
from dorpatch_tpu_torch.checkpoint import CarryCheckpointer  # noqa: E402
from dorpatch_tpu_torch.cli import build_parser, config_from_args  # noqa: E402
from dorpatch_tpu_torch.config import AttackConfig, DefenseConfig  # noqa: E402
from dorpatch_tpu_torch.defense import PatchCleanser  # noqa: E402
from dorpatch_tpu_torch.models import get_model  # noqa: E402
from dorpatch_tpu_torch.ops import masked_fill as tmf  # noqa: E402
from dorpatch_tpu_torch.ops import masked_kv_attn as tattn  # noqa: E402
from dorpatch_tpu_torch.ops import stem_fold as tsf  # noqa: E402
from dorpatch_tpu_torch.parallel import make_mesh, make_sharded_attack  # noqa: E402
from dorpatch_tpu_torch.parallel.multiproc import Process0Checkpointer  # noqa: E402
from dorpatch_tpu_torch.pipeline import run_experiment  # noqa: E402

#: the toy run_experiment of the meshed pipeline test
RUN_ARGV = ["--device", "cpu", "--synthetic", "--dataset", "cifar10",
            "--base_arch", "cifar_vit", "--img-size", "16", "-b", "2",
            "--max-iterations", "2", "--sampling-size", "4", "--dropout",
            "1", "--num-batches", "1"]
TRIGGER_CLASSES = 3


def rects(rng, s, k, size):
    """`[s, k, 4]` int32 rectangles inside a `size` image (some empty)."""
    r0 = rng.integers(0, size, (s, k))
    c0 = rng.integers(0, size, (s, k))
    r1 = np.minimum(size, r0 + rng.integers(0, size // 2, (s, k)))
    c1 = np.minimum(size, c0 + rng.integers(0, size // 2, (s, k)))
    return np.stack([r0, r1, c0, c1], axis=-1).astype(np.int32)


def fill_case(mesh, seed, b, s, size=16):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(b, size, size, 3)).astype(np.float32)
    rc = rects(rng, s, 2, size)
    g = rng.normal(size=(b, s, size, size, 3)).astype(np.float32)
    x = torch.tensor(imgs, requires_grad=True)
    with torch.enable_grad():
        out = tmf.sharded_masked_fill(x, torch.as_tensor(rc), 0.5, mesh)
        if mesh.divides(b, s):
            rows, cols = mesh.block(b, s)
        else:
            rows, cols = slice(0, b), slice(0, s)
        (gx,) = torch.autograd.grad(
            (out * torch.as_tensor(g)[rows, cols]).sum(), x)
    return dict(imgs=imgs, rects=rc, g=g, out=out.detach().numpy(),
                rows=(rows.start, rows.stop), cols=(cols.start, cols.stop),
                gx=gx.numpy())


def stem_case(mesh):
    """A 3x3/1 stem over 16 px images, the 0.12 radius's 36 windows: this
    rank's `[B/d, N/m]` block of the plain fold (what a rank folds; kernel
    C on the card)."""
    rng = np.random.default_rng(7)
    k, s, img, cout = 3, 1, 16, 8
    pads = ((1, 1), (1, 1))
    kern = rng.normal(0, 0.3, (k, k, 3, cout)).astype(np.float32)
    clean = rng.normal(0, 1, (4, img, img, cout)).astype(np.float32)
    u = rng.uniform(-1, 1, (4, img, img, 3)).astype(np.float32)
    singles, _ = tmasks.mask_sets(tmasks.geometry(img, 0.12))
    plan = tsf.plan_windows(singles, img, k, s, pads)
    rows, cols = mesh.block(4, len(plan))
    blk = tsf.fold_masked_stem(torch.as_tensor(kern),
                               torch.as_tensor(clean[rows]),
                               torch.as_tensor(u[rows]), plan[cols], (s, s),
                               pads)
    return dict(kern=kern, clean=clean, u=u, singles=singles, pads=pads,
                out=blk.numpy(), rows=(rows.start, rows.stop),
                cols=(cols.start, cols.stop))


def stem_family_case(mesh):
    """The CIFAR ResNet-18's stem-folded first round on the mesh and in one
    process (random weights from the seed, 16 px, 4 images)."""
    victim = get_model("cifar10", "resnet18", "/nonexistent", 16,
                       device="cpu")
    x = torch.as_tensor(np.random.default_rng(8).uniform(
        size=(4, 16, 16, 3)).astype(np.float32))
    singles, doubles = tmasks.mask_sets(tmasks.geometry(16, 0.12))
    k = max(singles.shape[1], doubles.shape[1])
    rc = np.concatenate([tmasks.pad_rects(singles, k),
                         tmasks.pad_rects(doubles, k)])
    eng = victim.incremental
    one = eng.build_family(rc, len(singles), 128, 0.5).phase1(x)
    sharded = eng.build_family(rc, len(singles), 128, 0.5,
                               mesh=mesh).phase1(x)
    return dict(one=[t.numpy() for t in one],
                mesh=[t.numpy() for t in sharded])


def attn_case(mesh):
    rng = np.random.default_rng(11)
    b, c, s, h, f, t = 4, 3, 5, 2, 8, 9

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ops = [normal(b, c, s, h, f) / np.sqrt(f), normal(b, c, s, h, f),
           normal(b, c, s, h, f), normal(b, t, h, f), normal(b, t, h, f)]
    clean_bias = np.where(rng.uniform(size=(b, c, t)) < 0.2, -1e9,
                          0.0).astype(np.float32)
    dirty_bias = np.where(rng.uniform(size=(b, c, s)) < 0.25, -1e9,
                          0.0).astype(np.float32)
    dirty_bias[:, :, 0] = 0.0
    ops = [o.astype(np.float32) for o in ops] + [clean_bias, dirty_bias]
    rows, _ = mesh.block(b, 2)
    out = tattn.masked_kv_attention_sharded(
        *(torch.as_tensor(o[rows]) for o in ops), mesh=mesh)
    return dict(ops=ops, out=out.numpy(), rows=(rows.start, rows.stop))


class Toy(nn.Module):
    """A small conv classifier, identical on every rank (seeded)."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.fc = nn.Linear(8 * 16, 4)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)

    def forward(self, x):
        z = F.relu(self.conv(x.permute(0, 3, 1, 2)))
        return self.fc(F.adaptive_avg_pool2d(z, 4).flatten(1))


def attack_case(mesh):
    cfg = AttackConfig(sampling_size=8, max_iterations=8, sweep_interval=4,
                       switch_iteration=4, failure_sampling_start=4,
                       dropout=1, patch_budget=0.15, basic_unit=4, lr=0.05)
    model = Toy()
    x = torch.as_tensor(np.random.default_rng(2).uniform(
        size=(2, 32, 32, 3)).astype(np.float32) * 0.2)
    out = {}
    for name, atk in (("one", DorPatch(model, 4, cfg)),
                      ("mesh", make_sharded_attack(model, 4, cfg, mesh))):
        r = atk.generate(x, seed=3)
        out[name] = dict(mask=r.adv_mask.numpy(), pattern=r.adv_pattern.numpy(),
                         y=r.y, targeted=r.targeted)
    return out


class Stop(RuntimeError):
    pass


def carry_case(mesh, root):
    """The toy sharded attack cut at stage 1's first block and resumed from
    its rank-0 snapshot (`Process0Checkpointer`), beside an uninterrupted
    run: the same patch."""
    cfg = AttackConfig(sampling_size=8, max_iterations=4, sweep_interval=2,
                       switch_iteration=2, failure_sampling_start=2,
                       dropout=1, patch_budget=0.15, basic_unit=4, lr=0.05)
    model = Toy()
    x = torch.as_tensor(np.random.default_rng(4).uniform(
        size=(2, 32, 32, 3)).astype(np.float32) * 0.2)
    whole = make_sharded_attack(model, 4, cfg, mesh).generate(x, seed=5)

    def make():
        return CarryCheckpointer(os.path.join(root, "carry"),
                                 fingerprint={"seed": 5})

    def cut(stage, step, info):
        if stage == 1:
            raise Stop()

    atk = make_sharded_attack(model, 4, cfg, mesh, on_block_end=cut,
                              checkpointer=Process0Checkpointer(make, mesh))
    try:
        atk.generate(x, seed=5)
    except Stop:
        pass
    ck = Process0Checkpointer(make, mesh)
    plain = ck.restore
    restored = []

    def restore(*args):
        got = plain(*args)
        restored.append(None if got is None else (got.stage, got.iteration))
        return got

    ck.restore = restore
    resumed = make_sharded_attack(model, 4, cfg, mesh,
                                  checkpointer=ck).generate(x, seed=5)
    return dict(whole=whole.adv_pattern.numpy(),
                resumed=resumed.adv_pattern.numpy(), restored=restored)


def torch_trigger(x):
    """`test_torch_defense.py`'s weightless 3-class trigger detector."""
    t1 = x[:, 4:8, 4:8, :].mean(dim=(1, 2, 3)) > 0.8
    t2 = x[:, 24:28, 24:28, :].mean(dim=(1, 2, 3)) > 0.8
    t3 = x[:, 4:8, 24:28, :].mean(dim=(1, 2, 3)) < 0.2
    cls = torch.where(t1 | t2, 1, torch.where(t3, 2, 0))
    return F.one_hot(cls, TRIGGER_CLASSES).float()


def trigger_batch():
    imgs = np.full((4, 32, 32, 3), 0.5, np.float32)
    imgs[1, 4:8, 4:8] = 1.0
    imgs[2, 4:8, 4:8] = 1.0
    imgs[2, 24:28, 24:28] = 1.0
    imgs[3, 4:8, 4:8] = 1.0
    imgs[3, 4:8, 24:28] = 0.0
    return imgs


def certify_case(mesh):
    pc = PatchCleanser(torch_trigger, tmasks.geometry(32, 0.1),
                       DefenseConfig(ratios=(0.1,), prune="exact"),
                       device="cpu", mesh=mesh)
    recs = pc.robust_predict(torch.as_tensor(trigger_batch()),
                             TRIGGER_CLASSES)
    return dict(x=trigger_batch(), records=[tuple(r) for r in recs])


def run_case(mesh, root, rank):
    cfg = config_from_args(build_parser().parse_args(
        RUN_ARGV + ["--results-root", os.path.join(root, "run_mesh"),
                    "--mesh-data", "2", "--mesh-mask", "2"]))
    got = dict(mesh=run_experiment(cfg, verbose=False))
    if rank == 0:
        got["one"] = run_experiment(dataclasses.replace(
            cfg, mesh_data=1, mesh_mask=1,
            results_root=os.path.join(root, "run_one")), verbose=False)
    return got


def main():
    rank, world, store_path, out = sys.argv[1:5]
    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(2, 2, device="cpu")
    res = {"rank": rank, "coords": mesh.coords,
           "fill": fill_case(mesh, 0, 4, 6),
           "fill_indivisible": fill_case(mesh, 1, 3, 5),
           "stem": stem_case(mesh), "stem_family": stem_family_case(mesh),
           "attn": attn_case(mesh), "attack": attack_case(mesh),
           "carry": carry_case(mesh, out),
           "certify": certify_case(mesh)}
    res["unsharded"] = dict(mesh.unsharded)
    res["run"] = run_case(mesh, out, rank)
    with open(os.path.join(out, f"rank_{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
