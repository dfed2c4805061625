"""Time `chip_smoke.py`'s main paths of one checkout, path by path.

    python tools/smoke_ab.py [--tree DIR] [--paths LABEL,...]

Imports `chip_smoke` and `dorpatch_tpu_torch` from the checkout at DIR
(default: this one; a parent unpacked with `git archive` to hold a change
against it) and drives the main paths named by `--paths` through that
checkout's own `chip_smoke.main_path` and flags (each kernel of a path
must launch, as in the script). Prints the script's lines for each path,
then one JSON line: per path, the wall, attack and certify seconds. To
compare two checkouts, run parent, change, change, parent in one chip
call: the machine's host speed drifts between calls. Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

#: label -> (argv, required kernels, GroupNorm split shares at, audit
#: fill), by the names `chip_smoke.main` gives them
PATHS = {
    "CIFAR": ("CIFAR_ARGV", "CIFAR_KERNELS", None, None),
    "RN50": ("RN50_ARGV", "RN50_KERNELS", 224, None),
    "ViT": ("VIT_ARGV", "VIT_KERNELS", None, None),
    "CIFAR bf16": ("CIFAR_ARGV+", "CIFAR_BF16_KERNELS", None,
                   "masked_fill_fwd_bf16"),
    "RN50 bf16": ("RN50_ARGV+", "RN50_BF16_KERNELS", 224,
                  "masked_fill_fwd_bf16"),
    "ViT bf16": ("VIT_BF16_ARGV", "VIT_BF16_KERNELS", None, None),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    p.add_argument("--paths", default=",".join(PATHS))
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from dorpatch_tpu_torch import utils

    if not torch.cuda.is_available():
        print("smoke_ab: no CUDA device is available", file=sys.stderr)
        return 2
    dev = utils.resolve_device("cuda")
    utils.configure_numerics()
    out = {}
    for label in args.paths.split(","):
        argv_name, kernels, at, audit = PATHS[label]
        path_argv = getattr(cs, argv_name.rstrip("+"))
        if argv_name.endswith("+"):
            path_argv = path_argv + cs.BF16_FLAGS
        shares = cs.gn_split_shares(at) if at else None
        t0 = time.perf_counter()
        m, _, _ = cs.main_path(torch, dev, label, path_argv,
                               getattr(cs, kernels), shares, audit)
        out[label] = dict(phase_s=time.perf_counter() - t0,
                          wall_s=m["wall_s"],
                          attack_s=m.get("attack_seconds"),
                          certify_s=m.get("certify_seconds"))
    print(json.dumps({"tree": tree, "device": torch.cuda.get_device_name(0),
                      "paths": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
