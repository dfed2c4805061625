"""AOT executable store: warm boot for serve and farm.

Port of `dorpatch_tpu.aot`. Deploy-time `python -m dorpatch_tpu_torch.aot
build` writes, for every production program, its baseline fingerprint and
interface hash with the environment (torch and CUDA versions, backend,
device topology, kernel sources) and how it materializes, plus the kernel
library as a sha-verified blob; boot-time `warm_boot` /
`FirstCallAotResolver` install each program's executable — a CUDA graph
captured for its call signature, bit-equal to its eager call — before
traffic. See README "AOT executable store".
"""

from dorpatch_tpu_torch.aot.boot import (  # noqa: F401
    AotBootError,
    AotDispatcher,
    FirstCallAotResolver,
    call_signature,
    warm_boot,
)
from dorpatch_tpu_torch.aot.store import (  # noqa: F401
    ExecutableStore,
    current_env,
    open_readonly,
    topology_hash,
)

__all__ = [
    "AotBootError",
    "AotDispatcher",
    "ExecutableStore",
    "FirstCallAotResolver",
    "call_signature",
    "current_env",
    "open_readonly",
    "topology_hash",
    "warm_boot",
]
