"""Command line of the port: the flags of `dorpatch_tpu.cli` that this
slice runs, plus `--device`.

Run:  python -m dorpatch_tpu_torch --synthetic --dataset imagenet \\
          --base_arch resnetv2 --img-size 224 --max-iterations 20 -b 2
      python -m dorpatch_tpu_torch --synthetic --dataset cifar10 \\
          --base_arch resnet18 --img-size 32 --max-iterations 20 -b 8
      python -m dorpatch_tpu_torch --synthetic --dataset imagenet \\
          --base_arch vit --img-size 224 --max-iterations 20 -b 2
      python -m dorpatch_tpu_torch --synthetic --base_arch resnetv2 \\
          --img-size 224 -b 2 --compute-dtype bfloat16 --certify-dtype bfloat16
"""

from __future__ import annotations

import argparse

from dorpatch_tpu_torch.config import (AttackConfig, DefenseConfig,
                                       ExperimentConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DorPatch on PyTorch/CUDA: distributed occlusion-robust "
        "adversarial patches vs PatchCleanser certification")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the GPU (default) or, on request, "
                        "the CPU with the kernels' plain versions")
    p.add_argument("--dataset", "-d", default="imagenet",
                   choices=["cifar10", "imagenet", "cifar100"])
    p.add_argument("--model_dir", default="pretrained_models/")
    p.add_argument("--base_arch", "-ba", default="resnetv2",
                   choices=["resnetv2", "resnet18", "cifar_resnet18", "vit",
                            "cifar_vit"])
    p.add_argument("--targeted", "-t", action="store_true")
    p.add_argument("--patch_budget", type=float, default=0.12)
    p.add_argument("-b", "--batch-size", type=int, default=1)
    p.add_argument("--dropout", type=int, default=2, choices=[0, 1, 2])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (no dataset on disk needed)")
    p.add_argument("--data-source", default="auto",
                   choices=["auto", "synthetic", "procedural"],
                   help="image stream: 'procedural' = the learnable "
                        "generated task with genuine labels; 'auto' follows "
                        "--synthetic")
    p.add_argument("--num-batches", type=int, default=10)
    p.add_argument("--max-iterations", type=int, default=5000)
    p.add_argument("--sampling-size", type=int, default=128)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--results-root", default="results")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="EOT forward+backward precision (carry stays float32)")
    p.add_argument("--certify-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="certification sweep precision (the defense's "
                        "compute_dtype): 'bfloat16' runs the masked "
                        "forwards - phase-1 tables, pair audits, rows, "
                        "and the incremental engines - in bf16 with f32 "
                        "logit/margin readouts; images whose evaluated "
                        "entries come within --incremental-margin of the "
                        "argmax boundary re-certify through the f32 "
                        "exhaustive sweep, so verdicts never weaken")
    p.add_argument("--prune", default="exact", choices=["off", "exact"],
                   help="certification scheduling: 'exact' (default) runs "
                        "the two-phase pruned path with verdicts identical "
                        "to 'off', the exhaustive 666-forward sweep")
    p.add_argument("--incremental", default="auto",
                   choices=["auto", "token", "token-exact", "stem", "off"],
                   help="incremental masked forwards on the pruned path: "
                        "'auto' picks per family, 'stem' for conv victims "
                        "(the first round folded into the conv stem, "
                        "kernel C on the card) and 'token-exact' for ViT "
                        "victims (token-pruned forwards over a clean KV "
                        "cache, kernel H on the card, re-certifying "
                        "through the exhaustive sweep every image whose "
                        "read entries come within --incremental-margin of "
                        "the decision boundary); plain 'token' skips that "
                        "re-certification; 'off' runs full masked "
                        "forwards")
    p.add_argument("--incremental-margin", type=float, default=0.5,
                   help="token-exact escalation threshold: the top-2 logit "
                        "gap below which a token-pruned entry is "
                        "distrusted and its image re-certified "
                        "exhaustively")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        dataset=args.dataset,
        model_dir=args.model_dir,
        base_arch=args.base_arch,
        batch_size=args.batch_size,
        num_batches=args.num_batches,
        seed=args.seed,
        device=args.device,
        results_root=args.results_root,
        synthetic_data=args.synthetic,
        data_source=args.data_source,
        img_size=args.img_size,
        attack=AttackConfig(patch_budget=args.patch_budget,
                            targeted=args.targeted,
                            max_iterations=args.max_iterations,
                            dropout=args.dropout,
                            sampling_size=args.sampling_size,
                            compute_dtype=args.compute_dtype),
        defense=DefenseConfig(prune=args.prune,
                              incremental=args.incremental,
                              incremental_margin=args.incremental_margin,
                              compute_dtype=args.certify_dtype),
    )


def main(argv=None):
    cfg = config_from_args(build_parser().parse_args(argv))
    from dorpatch_tpu_torch.pipeline import run_experiment

    return run_experiment(cfg)


if __name__ == "__main__":
    main()
