"""The kernels as `torch.library` ops, in the namespace `dorpatch_torch`.

Each kernel entry is one op of the dispatcher: `masked_fill_fwd` and
`masked_fill_bwd` (kernels A and B), `stem_fold` (C), `gn_relu_fwd` and
`gn_relu_bwd` (the GroupNorm+ReLU kernels D-G) and `masked_kv_attn` (H).
An op covers its kernel's bf16 form (the same op at the other dtype) and
its mesh form (a flag of the schema, which only names the launch count).

- The CPU kernel of an op is the plain PyTorch version.
- The CUDA kernel is the ctypes launch of the hand-written kernel
  (`ops/_build.py`); it raises when the kernel does not build or launch.
- The fake kernel gives each output's shape, dtype and memory format, so
  a trace on fake tensors (`torch.fx.experimental.proxy_tensor.make_fx`,
  the program auditor's) records the op as one node.

The schemas are defined here in Python, so the CPU has the ops without
`nvcc`. The registration is the plain `Library.define`/`Library.impl`
pair: a call goes from the dispatcher straight into the kernel's Python
function, with no wrapper layer of `torch.library.custom_op` between.
The kernel modules call their ops through `call`, inside the profiler's
gate (`observe.timing.KERNEL_GATE`).
"""

from __future__ import annotations

from typing import Callable

import torch

from dorpatch_tpu_torch.observe.timing import KERNEL_GATE

NAMESPACE = "dorpatch_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")

#: the ops, one a kernel entry, in the order of the kernels A-H
OP_NAMES = ("masked_fill_fwd", "masked_fill_bwd", "stem_fold", "gn_relu_fwd",
            "gn_relu_bwd", "masked_kv_attn")
#: op name -> its schema
SCHEMAS = {}


def define(schema: str, cpu: Callable, cuda: Callable,
           fake: Callable) -> Callable:
    """Define op `schema` ("name(args) -> returns") with its CPU, CUDA and
    fake kernels; returns the op's default overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    SCHEMAS[name] = schema
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def call(op: Callable, *args):
    """`op(*args)` inside the profiler's gate: a `torch.profiler` start or
    stop on another thread waits for it (`observe.timing.KernelGate`)."""
    with KERNEL_GATE:
        return op(*args)


def ops() -> list:
    """Every op of the namespace (each kernel module defines its own on
    import), as `(name, default overload)`."""
    from dorpatch_tpu_torch.ops import (fused_gn, masked_fill,  # noqa: F401
                                        masked_kv_attn, stem_fold)

    ns = getattr(torch.ops, NAMESPACE)
    return [(name, getattr(ns, name).default) for name in OP_NAMES]
