"""The `(data, mask)` mesh as a grid of processes.

Port of `dorpatch_tpu.parallel.mesh`. Torch has no GSPMD, so a mesh is one
process a rank, launched with

    torchrun --nproc-per-node N -m dorpatch_tpu_torch ... \\
        --mesh-data D --mesh-mask M            # N = D * M

Rank `r` sits at `(r // M, r % M)`: `data` splits the images, `mask` the
rectangle sets (the EOT samples, the failure sweep's universe, the
certification's masks). Every rank holds the whole image batch and the
whole per-image state (patch, generator, failure set, records); only the
wide masked batch is split. Each rank computes its block of a
`[images, masks]` table and the blocks are combined with one `all_reduce`
(sum) over zero-initialised full-size float64 buffers, so each entry is
owned by one rank and comes back exactly (no `all_gather`: gloo cannot do
it on CUDA tensors).

Backend: NCCL when every rank of a host has a card of its own; gloo on the
CPU and when ranks share a card (NCCL refuses two ranks on one device).
The kernels run on the card either way. Host objects (the artifact reads
of `multiproc.Process0Store`) go over a gloo group: a
`broadcast_object_list` on an NCCL group needs the current device set.

Every rank must enter every collective in the same order; the process
group carries a `timeout`, so a rank that took another branch fails the
run instead of hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MASK_AXIS = "mask"

#: seconds a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class Mesh:
    """This rank's view of a `(data, mask)` mesh: its coordinates and
    device, the world group (every collective of the port is over the
    world: a block's entries are owned by one rank, so no axis needs its
    own group) and the host-object group. `unsharded` counts the table
    calls and fills the mesh did not divide (run whole, see `block`), by
    what ran them."""

    shape: Dict[str, int]
    rank: int
    coords: Tuple[int, int]
    device: torch.device
    backend: str
    group: Any = None            # the world (None: the default group)
    host_group: Any = None       # gloo, for host objects
    owns_group: bool = False     # `make_mesh` initialised the process group
    unsharded: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MASK_AXIS]

    def divides(self, b: int, s: int) -> bool:
        """True when the data axis divides `b` images and the mask axis
        `s` masks."""
        return (b % self.shape[DATA_AXIS] == 0
                and s % self.shape[MASK_AXIS] == 0)

    def block(self, b: int, s: int, what: str = "table"
              ) -> Tuple[slice, slice]:
        """This rank's block of a `[b, s]` table: its data coordinate's
        contiguous image rows and its mask coordinate's mask columns. A
        shape the mesh does not divide runs whole on rank 0 (the other
        ranks own nothing of it), counted under `what`."""
        if self.divides(b, s):
            d, m = self.coords
            bl, sl = b // self.shape[DATA_AXIS], s // self.shape[MASK_AXIS]
            return slice(d * bl, (d + 1) * bl), slice(m * sl, (m + 1) * sl)
        self.note_unsharded(what)
        n = 1 if self.rank == 0 else 0
        return slice(0, b * n), slice(0, s * n)

    def note_unsharded(self, what: str) -> None:
        self.unsharded[what] = self.unsharded.get(what, 0) + 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the world, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, parts: Sequence[torch.Tensor], b: int, s: int,
               where: Tuple[slice, slice]) -> List[torch.Tensor]:
        """The full `[b, s]` tables of this rank's blocks `parts` (each
        `[rows, cols]` at `where`, from `block`): one `all_reduce` of a
        zero float64 buffer; every rank gets every table, in the parts'
        types (int32 and float32 round-trip float64 exactly)."""
        rows, cols = where
        buf = torch.zeros((len(parts), b, s), dtype=torch.float64,
                          device=self.device)
        for i, p in enumerate(parts):
            if p.numel():
                buf[i, rows, cols] = p.to(torch.float64)
        self.all_reduce(buf)
        return [buf[i].to(p.dtype) for i, p in enumerate(parts)]

    def tables(self, b: int, s: int, run: Callable, dtypes: Sequence,
               what: str = "table") -> List[torch.Tensor]:
        """Tables `[b, s]` of `dtypes` computed in blocks: `run(rows,
        cols)` returns this rank's block of each (`block`; not called on
        an empty one), and the blocks are gathered."""
        rows, cols = self.block(b, s, what)
        if rows.stop > rows.start and cols.stop > cols.start:
            parts = run(rows, cols)
        else:
            parts = [torch.zeros((0, 0), dtype=dt, device=self.device)
                     for dt in dtypes]
        return self.gather(parts, b, s, (rows, cols))

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    def close(self) -> None:
        """Leave the process group if `make_mesh` joined it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()

    def describe(self) -> dict:
        """The mesh for `run.json` and the console."""
        return {"data": self.shape[DATA_AXIS], "mask": self.shape[MASK_AXIS],
                "world_size": self.size, "rank": self.rank,
                "coords": list(self.coords), "backend": self.backend,
                "device": str(self.device)}


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _pick_device(device: str, local_rank: int) -> torch.device:
    """Pin this rank's card (`LOCAL_RANK % device_count`) before any CUDA
    call; "cpu" on request."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            f"device={device!r} but no CUDA device is available; pass "
            "device='cpu' (--device cpu) to run the mesh on the CPU")
    index = local_rank % n
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(data: int = 1, mask: int = -1, device: str = "cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The `(data, mask)` mesh over this process group's ranks.

    Joins the process group torchrun describes (`RANK`, `WORLD_SIZE`,
    `MASTER_ADDR`, ...) unless one is already initialised (tests make their
    own). `mask=-1` takes the ranks `data` leaves. `data * mask` must equal
    the world size: a world of one process cannot hold a larger mesh, and
    the error names torchrun."""
    local_rank = _env_int("LOCAL_RANK", _env_int("RANK", 0))
    dev = _pick_device(device, local_rank)
    world = (dist.get_world_size() if dist.is_initialized()
             else _env_int("WORLD_SIZE", 1))
    if mask == -1:
        if data < 1 or world % data:
            raise ValueError(f"{world} ranks not divisible by data={data}")
        mask = world // data
    if data < 1 or mask < 1 or data * mask != world:
        raise ValueError(
            f"mesh {data}x{mask} needs {data * mask} ranks, one process a "
            f"rank, and this process group has {world}: launch it with "
            f"`torchrun --nproc-per-node {data * mask} -m dorpatch_tpu_torch "
            f"... --mesh-data {data} --mesh-mask {mask}`")
    owns = not dist.is_initialized()
    if not owns:
        backend = str(dist.get_backend())
    else:
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        own_card = (dev.type == "cuda"
                    and local_world <= torch.cuda.device_count())
        backend = "nccl" if own_card else "gloo"
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    rank = dist.get_rank()
    host_group = (None if backend == "gloo" else dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=timeout_s)))
    return Mesh(shape={DATA_AXIS: data, MASK_AXIS: mask}, rank=rank,
                coords=(rank // mask, rank % mask), device=dev,
                backend=backend, host_group=host_group, owns_group=owns)
