"""The pipeline on a mesh: rank 0 owns the artifacts.

Port of `dorpatch_tpu.parallel.multiproc`. Every rank runs the same host
program on the same host values (data drawn from the config's seed, the
same target draws, the replicated per-image state), so every rank enters
every collective in the same order. A decision taken from the filesystem
must not diverge (rank 0 sees a cached patch, rank 1 does not: the ranks'
call sequences part and a collective hangs), so `Process0Store` writes on
rank 0 only and reads on rank 0 and broadcasts what it read over the
mesh's gloo group (span `bcast`). The PatchCleanser record cache is read
as absent, so every rank recomputes certification (records are cheap next
to the attack), while rank 0 still saves them for a later single-process
run. `Process0Checkpointer` does the same for the attack's carry
snapshots: rank 0 saves and restores, the restored carry is broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from dorpatch_tpu_torch import observe
from dorpatch_tpu_torch.checkpoint import CarryCheckpoint


def is_main(mesh=None) -> bool:
    """True on the rank that owns artifact writes and logging (every
    single-process run)."""
    return mesh is None or mesh.rank == 0


def _bcast(mesh, obj):
    """Rank 0's picklable `obj` on every rank, over the gloo group. A
    collective that one rank does not enter wedges the others here; the
    span's unclosed `begin` names the place."""
    with observe.span("bcast"):
        box = [obj if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=mesh.host_group)
        return box[0]


def shared_run_id(mesh, run_id: str) -> str:
    """Rank 0's per-attempt run id on every rank: one run, one attempt id
    across every rank's telemetry files."""
    return _bcast(mesh, run_id)


class Process0Store:
    """`ArtifactStore` for a mesh: writes on rank 0 only, reads on rank 0
    broadcast, so every rank takes the same resume decision."""

    def __init__(self, store, mesh):
        self.store = store
        self.mesh = mesh
        self.result_dir = store.result_dir

    def _read(self, fn, *args):
        return _bcast(self.mesh, fn(*args) if self.mesh.rank == 0 else None)

    def load_patch(self, batch_id: int):
        return self._read(self.store.load_patch, batch_id)

    def save_patch(self, batch_id: int, mask, pattern) -> None:
        if self.mesh.rank == 0:
            self.store.save_patch(batch_id, mask, pattern)

    def load_stage0(self, batch_id: int):
        return self._read(self.store.load_stage0, batch_id)

    def save_stage0(self, batch_id: int, mask, pattern) -> None:
        if self.mesh.rank == 0:
            self.store.save_stage0(batch_id, mask, pattern)

    def load_targets(self, batch_id: int):
        return self._read(self.store.load_targets, batch_id)

    def save_targets(self, batch_id: int, targets) -> None:
        if self.mesh.rank == 0:
            self.store.save_targets(batch_id, targets)

    def resolve_targets(self, batch_id: int, rederive):
        """`ArtifactStore.resolve_targets` with broadcast reads; a
        rederivation runs on every rank alike."""
        t = self.load_targets(batch_id)
        if t is not None:
            return np.asarray(t)
        s0 = self.load_stage0(batch_id)
        if s0 is None:
            raise FileNotFoundError(
                f"targeted resume for batch {batch_id} needs the recorded "
                "targets or the shared stage-0 artifacts on rank 0")
        return np.asarray(rederive(s0))

    def load_pc_records(self, batch_id: int):
        return None   # recomputed on every rank: the ranks stay in step

    def save_pc_records(self, batch_id: int, records) -> None:
        if self.mesh.rank == 0:
            self.store.save_pc_records(batch_id, records)


class Process0Checkpointer:
    """`checkpoint.CarryCheckpointer` for a mesh: `make()` builds it on rank
    0 only (its constructor deletes stale snapshots); saves and clears run
    there, and a restore is read there and broadcast (the carry's tensors
    on the CPU and its generator's state), so every rank resumes from the
    same block."""

    def __init__(self, make, mesh):
        self.mesh = mesh
        self.ck = make() if mesh.rank == 0 else None

    def save(self, stage, iteration, state, stage0_mask=None,
             stage0_pattern=None) -> None:
        if self.ck is not None:
            self.ck.save(stage, iteration, state, stage0_mask,
                         stage0_pattern)

    def restore(self, state_template: Any, stage0_template=None
                ) -> Optional[CarryCheckpoint]:
        got = None
        if self.ck is not None:
            r = self.ck.restore(state_template, stage0_template)
            if r is not None:
                fields = {
                    f.name: (v.get_state() if isinstance(v, torch.Generator)
                             else v.cpu())
                    for f in dataclasses.fields(r.state)
                    for v in (getattr(r.state, f.name),)}
                s0 = (None if r.stage0_mask is None
                      else (r.stage0_mask.cpu(), r.stage0_pattern.cpu()))
                got = (r.stage, r.iteration, fields, s0)
        got = _bcast(self.mesh, got)
        if got is None:
            return None
        stage, iteration, fields, s0 = got
        out = {}
        for f in dataclasses.fields(state_template):
            like = getattr(state_template, f.name)
            if isinstance(like, torch.Generator):
                gen = torch.Generator(device=like.device)
                gen.set_state(fields[f.name])
                out[f.name] = gen
            else:
                out[f.name] = fields[f.name].to(like.device)
        dev = state_template.adv_mask.device
        return CarryCheckpoint(
            stage=stage, iteration=iteration,
            state=type(state_template)(**out),
            stage0_mask=None if s0 is None else s0[0].to(dev),
            stage0_pattern=None if s0 is None else s0[1].to(dev))

    def clear(self) -> None:
        if self.ck is not None:
            self.ck.clear()

    def close(self) -> None:
        if self.ck is not None:
            self.ck.close()


__all__ = ["is_main", "shared_run_id", "Process0Store",
           "Process0Checkpointer"]
