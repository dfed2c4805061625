"""Stress `POST /profile`: profiler captures while a service serves batches.

    python tools/profile_stress.py [--tree DIR] [--captures N] [--bare N]

Boots the port's `CertifiedInferenceService` (ResNetV2-50x1 at 224, the
bf16 certify bank, 2 replicas, buckets 1 and 8, random weights: the
`chip_smoke.py` serve path whose capture once killed the process) from
the checkout at DIR (default: this one). It first serves `--bare` batches
of 8 requests from 8 threads with no capture (their seconds are the
served batch's latency, to hold one checkout against another), then
serves such batches while this thread takes `--duration-ms` captures back
to back, as the HTTP front-end's handler does, until `--captures` have
been taken. Prints one line a batch; a native crash ends the process
(exit 139 or 134), so the last line says how many captures succeeded.
Needs a CUDA device.
"""

import argparse
import os
import sys
import tempfile
import threading
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    p.add_argument("--captures", type=int, default=64)
    p.add_argument("--bare", type=int, default=2)
    p.add_argument("--duration-ms", type=float, default=1000.0)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np

    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.serve import CertifiedInferenceService

    flags = ["--synthetic", "--dataset", "imagenet", "--base_arch",
             "resnetv2", "--img-size", "224", "--serve-max-batch", "8",
             "--serve-deadline-ms", "60000", "--serve-replicas", "2",
             "--certify-dtype", "bfloat16"]
    rng = np.random.default_rng(0)
    imgs = np.kron(rng.uniform(0, 1, (8, 4, 4, 3)).astype(np.float32),
                   np.ones((1, 56, 56, 1), np.float32))
    with tempfile.TemporaryDirectory() as root:
        cfg = config_from_args(build_parser().parse_args(
            flags + ["--results-root", root, "--serve-port", "0"]))
        t0 = time.perf_counter()
        svc = CertifiedInferenceService.from_config(cfg)
        svc.start()
        print(f"{tree}: started in {time.perf_counter() - t0:.1f} s",
              flush=True)
        taken, i = 0, 0
        while i < args.bare or taken < args.captures:
            res = [None] * 8

            def one(k, i=i, res=res):
                res[k] = svc.predict(imgs[k], deadline_ms=60000,
                                     trace_id=f"s{i}_{k}")

            ths = [threading.Thread(target=one, args=(k,)) for k in range(8)]
            t0 = time.perf_counter()
            for t in ths:
                t.start()
            n = 0
            if i >= args.bare:
                time.sleep(0.3)
                while (any(t.is_alive() for t in ths)
                       and taken < args.captures):
                    n += bool(svc.capture_profile(args.duration_ms))
                    taken += 1
            for t in ths:
                t.join()
            ok = sum(type(r).__name__ == "PredictResult" for r in res)
            print(f"{tree} batch {i}: {time.perf_counter() - t0:.2f} s, "
                  f"answers ok {ok}, captures {n} (taken {taken} of "
                  f"{args.captures})", flush=True)
            i += 1
        svc.stop()
    print(f"{tree}: {taken} captures in {i} batches, no crash", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
