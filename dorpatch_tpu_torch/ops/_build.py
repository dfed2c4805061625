"""Build and bind the port's CUDA kernels.

Every `csrc/*.cu` is compiled with `nvcc` for `sm_90a` into an object (one
`nvcc` per source, all started together), the objects are linked into one
shared library with a plain C interface, and the library is loaded with
`ctypes`. The build happens at first use, into `build/dorpatch_kernels/` at
the root of the checkout (listed in `.gitignore`), under a name keyed by the
sources' hash, so an edited source rebuilds and an unchanged one loads.

Each C entry point returns `cudaGetLastError()` after its launch; `check`
turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dorpatch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: dynamic shared memory a block may take on Hopper
MAX_SMEM_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry points: name -> (argtypes, restype)
SIGNATURES = {
    "dp_masked_fill_fwd": ([_P] * 3 + [_I] * 6 + [_F] + [_I] * 5 + [_P], _I),
    "dp_masked_fill_bwd": ([_P] * 3 + [_I] * 9 + [_P], _I),
    "dp_masked_fill_fwd_bf16": ([_P] * 3 + [_I] * 6 + [_F] + [_I] * 6 + [_P],
                                _I),
    "dp_stem_fold_smem": ([_I] * 5, ctypes.c_longlong),
    "dp_stem_fold": ([_P, _P, _P, _P, _P, _P] + [_I] * 14 + [_P], _I),
    "dp_stem_fold_bf16_smem": ([_I] * 6, ctypes.c_longlong),
    "dp_stem_fold_bf16": ([_P] * 6 + [_I] * 18 + [_P], _I),
    "dp_gn_onepass_smem": ([_I] * 4, ctypes.c_longlong),
    "dp_gn_fwd_split_clusters": ([_I] * 2, _I),
    "dp_gn_relu_fwd": ([_P] * 6 + [_I] * 4 + [_F] + [_I] * 4 + [_P], _I),
    "dp_gn_relu_bwd": ([_P] * 13 + [_I] * 8 + [_P], _I),
    "dp_gn_onepass_smem_bf16": ([_I] * 4, ctypes.c_longlong),
    "dp_gn_relu_fwd_bf16": ([_P] * 6 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
                            _I),
    "dp_gn_relu_bwd_bf16": ([_P] * 13 + [_I] * 8 + [_P], _I),
    "dp_masked_kv_attn": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "dp_masked_kv_attn_bf16": ([_P] * 8 + [_I] * 11 + [_P], _I),
    "dp_masked_kv_attn_bf16_smem": ([_I] * 6, ctypes.c_longlong),
    "dp_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (ptxas register and shared-memory report)
build_log = ""


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built with it at first use")


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library of the current sources lives once built."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdorpatch_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile and link the library unless it exists; returns its path."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp_so)] + [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().dp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
