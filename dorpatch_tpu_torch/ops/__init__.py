"""Kernels of the port and their plain PyTorch versions.

Each wrapper launches its hand-written CUDA kernel (`csrc/*.cu`) for CUDA
tensors and runs its plain version for CPU tensors (`_backend.on_card`):
`masked_fill` (kernels A and B), `stem_fold` (kernel C) and `fused_gn`
(the GroupNorm+ReLU forward and backward).
"""

from dorpatch_tpu_torch.ops._backend import (launch_counts,
                                             reset_launch_counts,
                                             route_counts)

__all__ = ["launch_counts", "reset_launch_counts", "route_counts"]
