"""Mesh parallelism over `torch.distributed`, the port of
`dorpatch_tpu.parallel`: the `(data, mask)` mesh as one process a rank
(`mesh.py`), the sharded attack and defense bank (`sharded.py`) and the
pipeline's rank-0 artifact IO (`multiproc.py`). Launch:

    torchrun --nproc-per-node 4 -m dorpatch_tpu_torch ... \\
        --mesh-data 2 --mesh-mask 2
"""

from dorpatch_tpu_torch.parallel import multiproc
from dorpatch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MASK_AXIS,
    Mesh,
    make_mesh,
)
from dorpatch_tpu_torch.parallel.sharded import (
    make_sharded_attack,
    make_sharded_defenses,
)

__all__ = [
    "DATA_AXIS",
    "MASK_AXIS",
    "Mesh",
    "make_mesh",
    "make_sharded_attack",
    "make_sharded_defenses",
    "multiproc",
]
