"""The attack and the defense bank on a mesh.

Port of `dorpatch_tpu.parallel.sharded`. The reference parallelises one
thing, the masked-image forward (`torch.nn.DataParallel`); here the same
decision, shard the wide masked batch and replicate everything else, is
taken once per process: each rank of the `(data, mask)` mesh fills and
forwards its block and the blocks are combined with `all_reduce`
(`parallel/mesh.py`).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from dorpatch_tpu_torch.attack import DorPatch
from dorpatch_tpu_torch.config import AttackConfig, DefenseConfig
from dorpatch_tpu_torch.defense import PatchCleanser, build_defenses
from dorpatch_tpu_torch.parallel.mesh import Mesh


def make_sharded_attack(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                        num_classes: int, config: AttackConfig, mesh: Mesh,
                        **kwargs) -> DorPatch:
    """A `DorPatch` whose EOT step and failure sweep shard over `mesh`;
    every rank passes it the whole batch."""
    return DorPatch(apply_fn, num_classes, config, mesh=mesh, **kwargs)


def make_sharded_defenses(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                          img_size: int, mesh: Mesh,
                          config: DefenseConfig = DefenseConfig(),
                          recompile_budget=None,
                          incremental=None) -> List[PatchCleanser]:
    """The 4-radius defense bank with every certification program sharded
    over `mesh` (phase 1 over the whole mesh, phase 2 shard-local, see
    `defense._PrunedPending._schedule_mesh`); `incremental` is the victim
    family's engine, whose programs take the mesh too."""
    return build_defenses(apply_fn, img_size, config,
                          incremental=incremental, device=mesh.device,
                          recompile_budget=recompile_budget, mesh=mesh)


__all__ = ["make_sharded_attack", "make_sharded_defenses"]
