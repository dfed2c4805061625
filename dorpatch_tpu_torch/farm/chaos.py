"""The farm's view of the chaos harness (`dorpatch_tpu_torch.chaos`), under
the module name the JAX package's farm code and tests import from."""

from dorpatch_tpu_torch.chaos import (  # noqa: F401
    FARM_FAULTS,
    FAULTS,
    Chaos,
    SimulatedPreemption,
    fault_seed,
    parse_faults,
)

__all__ = ["FARM_FAULTS", "FAULTS", "Chaos", "SimulatedPreemption",
           "fault_seed", "parse_faults"]
