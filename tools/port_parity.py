#!/usr/bin/env python
"""Port parity on a trained victim: the port attacks on the card, both
packages certify the same patches.

The port-side twin of `tools/parity_flagship.py`, in two steps:

1. `card` (on the H100, imports no JAX): trains `cifar_resnet18` with
   `python -m dorpatch_tpu_torch.train` (the JAX `train.py` defaults),
   then runs the port's main path through `python -m dorpatch_tpu_torch`
   on the procedural task's first 8 held-out images at the default
   `sampling_size` and `dropout` for `--max-iterations` (1200: the switch
   at 500 and the failure-biased sampling from 1000 both run at their
   defaults), with `--carry-checkpoints` so a cut run resumes. The victim
   and the results tree land under `--out`.
2. `compare` (on the CPU, imports both packages): copies the port tree's
   patch and target files (`adv_mask_*`, `adv_pattern_*`, `targets_*`)
   into a fresh tree WITHOUT the `adv_PC_*` certification cache, certifies
   them with the JAX package's pipeline on the same `.pth`, and writes the
   15 rows of `parity_rows` (the port's summary against the JAX one) as
   JSON.

Usage:
  python tools/port_parity.py card --out results/port_parity
  python tools/port_parity.py compare --port-root results/port_parity/port \\
      --model-dir results/port_parity/victim \\
      --out artifacts/port_parity_cifar_1200.json
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # runnable from any directory, like the other tools

#: the parity run: the procedural task's first 8 held-out images, every
#: attack and defense setting at its default but the iteration count
CARD_ARGV = ["--data-source", "procedural", "--dataset", "cifar10",
             "--base_arch", "resnet18", "--img-size", "32", "-b", "8",
             "--num-batches", "1", "--carry-checkpoints"]
RADII = ("1.5%", "3%", "6%", "12%")


def load_summary(results_root: str):
    """(summary dict, its path) of the one run under `results_root`."""
    hits = sorted(glob.glob(os.path.join(results_root, "**", "summary.json"),
                            recursive=True))
    if len(hits) != 1:
        raise FileNotFoundError(
            f"expected one summary.json under {results_root}, found "
            f"{len(hits)}")
    with open(hits[0]) as fh:
        return json.load(fh), hits[0]


def stage_tree(port_root: str, jax_root: str) -> int:
    """Copy the port tree's patch and target `.pt` files (the stage-0
    patches beside them too; never the `adv_PC_*` records, which would
    hand the JAX pipeline the port's own certification) into a fresh
    `jax_root`. Returns the files staged."""
    if os.path.isdir(jax_root):
        shutil.rmtree(jax_root)
    n = 0
    for src in glob.glob(os.path.join(port_root, "**", "*.pt"),
                         recursive=True):
        name = os.path.basename(src)
        if not name.startswith(("adv_mask_", "adv_pattern_", "targets_")):
            continue
        dst = os.path.join(jax_root, os.path.relpath(src, port_root))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(src, dst)
        n += 1
    return n


def jax_config(config_path: str, results_root: str, model_dir: str):
    """The JAX package's config of the port run recorded at `config_path`:
    the fields both packages have, with the staged tree as results root
    and the victim's directory as model dir."""
    from dorpatch_tpu import config as jcfg

    with open(config_path) as fh:
        rec = json.load(fh)

    def known(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in names}

    d = known(jcfg.ExperimentConfig, rec)
    for key, cls in (("attack", jcfg.AttackConfig),
                     ("defense", jcfg.DefenseConfig)):
        d[key] = known(cls, rec.get(key, {}))
    for key in list(d):
        if isinstance(d[key], dict) and key not in ("attack", "defense"):
            d.pop(key)   # serve, farm, recert, gateway: not read here
    d.update(results_root=results_root, model_dir=model_dir)
    return jcfg.config_from_dict(d)


def parity_rows(port_m: dict, jax_m: dict) -> list:
    """The 15 metrics of `parity_flagship.parity_rows`, port against JAX,
    `delta` = port - JAX."""
    rows = [{"metric": "evaluated_images",
             "port": port_m.get("evaluated_images"),
             "jax": jax_m.get("evaluated_images"),
             "delta": (port_m.get("evaluated_images", 0)
                       - jax_m.get("evaluated_images", 0))}]
    for key in ("clean_accuracy", "robust_accuracy"):
        rows.append({"metric": key, "port": port_m[key], "jax": jax_m[key],
                     "delta": round(port_m[key] - jax_m[key], 4)})
    for key in ("acc_pc", "certified_acc_pc", "certified_asr_pc"):
        for r, pv, jv in zip(RADII, port_m[key], jax_m[key]):
            rows.append({"metric": f"{key}@{r}", "port": pv, "jax": jv,
                         "delta": round(pv - jv, 4), "raw_delta": pv - jv})
    return rows


def compare(port_root: str, model_dir: str, out: str) -> dict:
    """Certify the port tree's patches with the JAX package on the CPU (in
    the staging tree `<port_root>_jax`) and write the parity report to
    `out`."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    from dorpatch_tpu.pipeline import run_experiment

    port_m, port_path = load_summary(port_root)
    jax_root = os.path.normpath(port_root) + "_jax"
    staged = stage_tree(port_root, jax_root)
    if staged == 0:
        raise FileNotFoundError(f"no patch files under {port_root}")
    cfg = jax_config(os.path.join(os.path.dirname(port_path), "config.json"),
                     jax_root, model_dir)
    t0 = time.perf_counter()
    jax_m = run_experiment(cfg, verbose=False)
    rows = parity_rows(port_m, jax_m)
    report = {
        "port_summary": os.path.relpath(port_path, ROOT),
        "victim": os.path.relpath(model_dir, ROOT),
        "staged_files": staged,
        "max_iterations": cfg.attack.max_iterations,
        "jax_certify_seconds_cpu": round(time.perf_counter() - t0, 1),
        "port_report": port_m.get("report"),
        "jax_report": jax_m.get("report"),
        "rows": rows,
        "nonzero": [r["metric"] for r in rows if r["delta"] != 0],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(report, fh, indent=1, default=float)
    return report


def card(out: str, max_iterations: int) -> dict:
    """Train the victim and run the port's attack and certification on the
    card; returns the timings, also written to `<out>/card.json`."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    victim, port = os.path.join(out, "victim"), os.path.join(out, "port")
    info = {"max_iterations": max_iterations, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    print(info["card"], flush=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "dorpatch_tpu_torch.train",
                    "--out", victim], env=env, check=True)
    info["train_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "dorpatch_tpu_torch", *CARD_ARGV,
                    "--max-iterations", str(max_iterations),
                    "--model_dir", victim,
                    "--results-root", port], env=env, check=True)
    info["experiment_s"] = round(time.perf_counter() - t0, 2)
    summary, _ = load_summary(port)
    info.update(attack_seconds=summary.get("attack_seconds"),
                certify_seconds=summary.get("certify_seconds"),
                report=summary.get("report"))
    with open(os.path.join(out, "card.json"), "w") as fh:
        json.dump(info, fh, indent=1)
    print(json.dumps(info), flush=True)
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("card", help="train and attack with the port")
    c.add_argument("--out", default=os.path.join("results", "port_parity"))
    c.add_argument("--max-iterations", type=int, default=1200)
    m = sub.add_parser("compare", help="certify the port's patches with "
                       "the JAX package and compare")
    m.add_argument("--port-root", required=True)
    m.add_argument("--model-dir", required=True)
    m.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "card":
        card(args.out, args.max_iterations)
        return 0
    report = compare(args.port_root, args.model_dir, args.out)
    print(json.dumps({"nonzero": report["nonzero"], "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
