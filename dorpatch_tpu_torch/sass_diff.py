"""Whether this checkout's kernels compile to the same machine code as
another checkout's.

    python dorpatch_tpu_torch/sass_diff.py --tree DIR
    python dorpatch_tpu_torch/sass_diff.py --tree DIR --changed NAME...

Builds the kernel library of both checkouts (`ops/_build.py`), disassembles
each with `cuobjdump -sass` and compares every kernel of DIR's library with
this checkout's kernel of the same instantiation, instruction by
instruction (addresses, encodings and symbol names left out). A kernel
templated since DIR's version matches on its float32 instantiation
(`fill_fwd<4, false>` against `fill_fwd<float, 4, false>`). Prints SAME or
DIFF per kernel and exits 1 if any differs or is missing. `--changed`
names kernels that a change is expected to alter or remove: a name (every
instantiation of it, e.g. `gn_bwd_dx`) or a name with its first template
argument (`stem_fold<__nv_bfloat16>`, `fill_fwd<uint16_t>`: those
instantiations only); they print CHANGED (or SAME) and do not fail the
run. Kernels only this checkout has print NEW. Needs
`nvcc` and `cuobjdump` (the CUDA toolkit); no GPU.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from typing import Dict, List


def library(root: str) -> str:
    """Build `root`'s kernel library in its own process; returns its
    path."""
    out = subprocess.run(
        [sys.executable, "-c", "from dorpatch_tpu_torch.ops import _build; "
         "print(_build.build())"], cwd=root, check=True,
        capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def kernels(so: str) -> Dict[str, List[str]]:
    """Mangled kernel name (the anonymous namespace's hash, 8 hex digits,
    left out) -> its SASS instructions."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    out: Dict[str, List[str]] = {}
    body: List[str] = []
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}",
                          "", m.group(1))
            body = out.setdefault(name, [])
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(.*?);", line)
        if m:
            body.append(re.sub(r"_ZN\w+", "SYM", m.group(1)))
    return out


def counterpart(name: str, ours: Dict[str, List[str]]):
    """Our kernel of `name`'s instantiation: the same name, or the float
    instantiation of a kernel templated on its element type since (a new
    first template argument `f`, before any it had)."""
    if name in ours:
        return name
    m = re.match(r"(_ZN\d+[a-z_]\w*?)([IE])(.*)$", name)
    if m is None:
        return None
    stem, kind, rest = m.groups()
    head = stem + ("If" + rest.split("EEEv")[0] + "EEEv" if kind == "I"
                   else "IfEEv")
    return next((c for c in ours if c.startswith(head)), None)


#: the mangled form of the first template arguments `--changed` takes
MANGLED_TYPES = {"float": "f", "uint16_t": "t",
                 "__nv_bfloat16": "13__nv_bfloat16"}


def named(mangled: str, names) -> bool:
    """Whether a mangled kernel name is an instantiation of one of
    `names`: the identifier after a digit (its length) and before its
    template arguments or parameters; for `name<type>`, an instantiation
    whose first template argument is `type`."""
    for n in names:
        base, _, arg = n.partition("<")
        if arg:
            pattern = rf"[0-9]{base}I{MANGLED_TYPES[arg.rstrip('>')]}"
        else:
            pattern = rf"[0-9]{base}[IE]"
        if re.search(pattern, mangled):
            return True
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", required=True,
                   help="the other checkout (e.g. the parent, unpacked "
                        "with git archive)")
    p.add_argument("--changed", nargs="*", default=[], metavar="NAME",
                   help="kernels expected to differ or go")
    args = p.parse_args(argv)
    here = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir))
    theirs = kernels(library(os.path.abspath(args.tree)))
    ours = kernels(library(here))
    differ = changed = 0
    matched = set()
    for name, body in sorted(theirs.items()):
        mine = counterpart(name, ours)
        matched.add(mine)
        same = mine is not None and ours[mine] == body
        expected = not same and named(name, args.changed)
        changed += expected
        differ += not same and not expected
        print(f"{'SAME' if same else 'CHANGED' if expected else 'DIFF'} "
              f"{name} ({len(body)} instructions; ours {mine})", flush=True)
    for name in sorted(set(ours) - matched):
        print(f"NEW {name} ({len(ours[name])} instructions)", flush=True)
    print(f"{len(theirs) - differ - changed} of {len(theirs)} kernels of "
          f"{args.tree} compile to the same instructions here, {changed} "
          f"changed as expected ({' '.join(args.changed) or 'none named'}),"
          f" {differ} differ or are missing ({len(ours)} kernels here)",
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
