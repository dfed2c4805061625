"""dorpatch-tpu on PyTorch and CUDA: the DorPatch attack and PatchCleanser
certification for an NVIDIA H100.

A port of the JAX package `dorpatch_tpu`, module for module (`masks`,
`losses`, `attack`, `defense`, `ops/`, `models/`, ...). The TPU's Pallas
kernels become hand-written CUDA C++ kernels for `sm_90a`
(`dorpatch_tpu_torch/csrc/`), built with `nvcc` at first use and bound with
`ctypes`. Every kernel wrapper launches its kernel for a CUDA tensor and runs
its plain PyTorch version for a CPU tensor; nothing falls back silently.

Run:  python -m dorpatch_tpu_torch --synthetic --dataset imagenet \\
          --base_arch resnetv2 --img-size 224 ...

The package imports `torch` and `numpy` only: never `jax`, `flax` or
anything of `dorpatch_tpu`.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
