#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`dorpatch_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. prints the environment and the card (nvidia-smi name, power limit);
   exits nonzero without a CUDA device;
2. builds the CUDA kernels from `dorpatch_tpu_torch/csrc` (nvcc, sm_90a);
3. holds every kernel against its plain PyTorch version on the card at the
   main paths' shapes and times both (median over REPS warmed
   repetitions; a repetition replays a CUDA graph of INNER calls,
   bracketed by synchronizes, so host launch cost is not counted):
   kernels A and B at the CIFAR path's shapes, at the 224 paths' and at
   the 480 paths' (A exact at S = 128, 126 and 63; B against float64
   autograd and bit for bit on a repeat; both timed at the attack step's
   S = 128 beside the plain versions and one-call PyTorch yardsticks),
   kernel C at CIFAR's stem, the GroupNorm+ReLU forward and backward at
   every (HW, C) of the RN50 victim at 224 with the attack step's N = 256
   (one-pass route) and at 480 with its N = 128 (forward one-pass, over
   clusters of 8 at stage 1; the stage-1 backward split) (route, time,
   bytes bound, plain and library times and calls per forward printed per
   shape, and launches x (time - bound) summed over a forward's 49 calls),
   and at one slab of the split route (GN_SPLIT_SLAB), each against
   float64 and repeated bit for bit, kernel E (the forward split route)
   forced at the three 480 stage-1 shapes beside kernel D there, kernel C
   at RN50's 7x7/2 stem at 224 and at 480, and kernel H (the masked-KV
   attention) at the
   ViT-B/16 token engine's phase-1 chunk and pair-audit chunk of the 0.12
   radius, against its plain version in float64 (and bit for bit against
   itself), with `F.scaled_dot_product_attention` timed beside it; kernel
   C's bound is its bytes (its operations printed beside), kernel H's the
   least time of a float32-accurate tensor-core design (three TF32 products
   each) against its bytes (the FFMA operations bound printed beside);
   then the bf16 forms against their plain versions on the same bf16
   inputs, in bf16 ulps, each timed beside its plain bf16 version and a
   bf16 library call, bounds at 2 bytes an element and 989 TFLOP/s: A at
   the bank's chunks (S = 36, 63) at 32, 224 and 480 px, C at the stems of
   the victims' cast copies (RN50's at 224 and 480), D/F at
   [256,3136,256] and [256,49,2048], E/G at GN_SPLIT_SLAB, D with F or G
   at every (HW, C) at 480 and E forced at its stage-1 shapes (the
   GroupNorm forms also against float64,
   within the float32 gates plus half a bf16 ulp), H at the ViT-B/16
   bank's phase-1 and pair-audit chunks; and A and A's bf16 form at
   K = 3, the n_patch=2 sweep's chunk of triples at 32 px (exact);
4. runs fifteen main paths through their user entry point, the CLI, each
   with every kernel's launch count set to 0 just before and read just
   after, prints its seconds, forwards, escalations, the certification's
   schedule (pair audits, minority rows) and peak device memory, and
   fails if a kernel of that path was not launched, if a GroupNorm
   kernel's launches took the split route at another share than its
   shapes' plans give (`gn_split_shares`: none at 224; at 480 the
   backward of the 11 stage-1 calls of every 49), or, on the conv bf16
   paths, if A's bf16 form did not launch exactly when a pair audit was
   scheduled:
   - CIFAR: `--synthetic --dataset cifar10 --base_arch resnet18
     --img-size 32 -b 8 --sampling-size 128 --dropout 2 --max-iterations
     10 --num-batches 1` (full-width CIFAR ResNet-18; kernels A, B, C);
   - RN50: `--synthetic --dataset imagenet --base_arch resnetv2
     --img-size 224 -b 2 --sampling-size 128 --dropout 2 --max-iterations
     10 --num-batches 1` (ResNetV2-50x1 BiT at full depth and width;
     kernels A, B, C and the GroupNorm+ReLU forward and backward);
   - ViT: the same flags with `--base_arch vit` and `--max-iterations
     10` (ViT-B/16 at full depth and width; kernels A, B and H);
   random weights from the seed, certification at the four radii with
   prune="exact", incremental="auto" (-> stem for the conv victims,
   -> token-exact for the ViT); then the same three runs with
   `--compute-dtype bfloat16 --certify-dtype bfloat16` (the bf16 attack
   fills at float32 (A, B) and runs the victim's bf16 copy (D, F on RN50);
   the bf16 bank fills bf16 images (A's bf16 form) and runs C's and H's
   bf16 forms);
   - RN50 480 and RN50 480 bf16: ResNetV2-50x1 at BiT's 480 px
     fine-tuning resolution, `--img-size 480 -b 1 --max-iterations 10`,
     the other flags as RN50's, without and with the bf16 flags (the
     backward of the stage-1 slabs takes kernel G, in float32 and in
     bf16);
   - ResMLP and ResMLP bf16: RN50's flags with `--base_arch resmlp
     --max-iterations 10` (ResMLP-24 at full depth and width; kernels A
     and B, the mixer engine's gathers and cuBLAS matmuls, A in
     escalations);
   - CIFAR n_patch=2 and its bf16 twin: CIFAR's flags with `-b 2
     --defense-n-patch 2` (the exhaustive sweep of 630 + 22680 masks a
     radius, kernel A at K = 3; the bf16 bank keeps the float32 sweep);
   - RN50 consensus and its bf16 twin: RN50's flags with `--prune
     consensus`, whose records are then held against the RN50 runs' (same
     prediction, every certificate kept, at most the forwards);
   - CIFAR disk, where Pillow is installed: CIFAR's flags without
     `--synthetic` and with `--max-iterations 10`, reading a seeded CIFAR-10 `test_batch` it writes into
     a temporary `--data_dir`, streamed (the default `stream_depth` 2)
     and again through the synchronous input path, which must give the
     same report and patch (each main path prints its `data` spans'
     seconds);
   and prints A's and B's launches x (time - bound) per path; then runs
   RN50 at 224 in float32, 10 iterations a stage in blocks of 5, once
   uninterrupted and once with `--carry-checkpoints --hang-timeout 300`,
   interrupted from the block callback at stage 1's first block and run
   again over the same results dir, which must resume from the snapshot,
   run stage 1's last block and save the uninterrupted run's patch bit
   for bit,
   with its telemetry files written, its snapshots cleared and A-D and F
   launched in the resumed run (`rn50_carry_phase`; the snapshot saves'
   ms and bytes printed);
5. computes the RN50 victim's input gradient on one masked batch 10
   times and runs the RN50 attack's first 5 steps twice from one seed,
   in float32 and in bf16, and fails unless every gradient equals the
   first and the patches are bit-equal (`repeat.victim_repeat`,
   `repeat.attack_steps`; without cuDNN determinism the float32 gradient
   differs in almost every call); then remat (`remat_phase`): one attack
   step of RN50 at 224 (float32 and bf16) and of ViT-B/16 (float32), 2
   images, `--sampling-size 128`, with remat off and under each policy,
   loss and both gradients bit-equal (`torch.equal`), kernel D's
   statistics recomputed in the backward bit-equal to the forward's,
   peak memory, ms and GroupNorm launches a step printed; one step of
   RN50 at 480 px with 1 image without remat and with 2 under each
   policy that fits (REMAT_480_POLICIES); and the slice's path, RN50 at
   480 px with 2 images a batch and `--remat on` through the CLI
   (RN50_480_B2_ARGV, 10 iterations; it does not fit without remat),
   whose certification records must equal those of certifying its patch
   again with remat off (the 480 px kernel records carry its launches as
   `remat_launches`);
6. certifies one radius both ways on each conv victim (stem fold = kernel
   C, and full masked forwards = kernel A) and asserts the first-round
   tables agree wherever both top-2 margins exceed 1e-3; on RN50 also
   holds the victim's logits with the GroupNorm kernels against its plain
   GroupNorm (argmax equal wherever the top-2 margin exceeds 1e-3); on the
   ViT (as seeded, and with one class's head bias raised so that images
   clear the escalation margin) holds the token engine's first-round logits with
   kernel H against the engine with the plain attention (1e-4) and
   against full masked forwards (predictions equal wherever both margins
   exceed `incremental_margin`), and asserts that "token-exact" gives every
   image the (prediction, certification) of incremental="off"; and runs
   the bf16 certify bank on RN50 and ViT-B/16 at 224, as seeded and
   lifted, and lifted on RN50 at 480, requiring every image's verdict to
   equal incremental="off" in float32, the bank's bf16 kernels to launch
   (A's bf16 form in the pair audits) and, lifted, an image to stay
   unescalated; holds "consensus" against "exact" on the lifted RN50, in
   float32 and in the bf16 bank (an image must stop after the first
   round); and cross-checks the ResMLP mixer engine like the token engine
   (first round against full forwards above `incremental_margin`;
   "mixer-exact" f32 and bf16-bank verdicts equal incremental="off"),
   gated with every layerscale at 0.1, plain and with class 0's head bias
   raised, and measured ungated on the victim as built (the JAX init's
   layerscales of 1, where the engine's drift can exceed the margin);
7. trains both trainable victims on the card through `train.py`'s flags
   into a temporary model dir (`cifar_resnet18` at the JAX package's
   defaults: 1404 steps; `cifar_vit` as the JAX package's own run,
   `--n-per-class 1000 --lr 1e-3`: 936 steps, at seeds 0, 1 and 2), prints
   steps/s, seconds and held-out accuracy, and fails if the mean held-out
   accuracy over the seeds is below TRAIN_MIN_ACC;
   then trains each for 20 steps twice from one seed and fails unless
   every weight is bit-equal;
8. runs the main path through the CLI on each trained victim
   (TRAINED_ARGV: the procedural task's held-out images, the stage switch
   at iteration 10 and failure-biased sampling from 15), in float32 and
   with both bf16 flags, failing unless the victim was loaded from its
   checkpoint, the switch was evaluated and masks were drawn from the
   failure set; and repeats the stem-fold, token-engine and bf16-bank
   cross-checks of 6 on the trained weights (the token engine's largest
   logit drift over unescalated images printed beside the 0.5 margin);
   runs the trained CIFAR path (10 iterations) with `--sanitize`, whose
   events.jsonl must hold `sanitize.enabled` and the programs' budgets and
   no exceeded budget, then plants two NaNs in its attack, one made by an
   aten op and one inside kernel A (a NaN fill), each of which must raise
   `FloatingPointError` naming the op, or the kernel (`sanitize_phase`);
   and holds the trained CIFAR ResNet-18's `.pth` and an RN50 `.pth`
   written from the port's random init to the timm key contract through
   `python -m dorpatch_tpu_torch.models.verify`, with the card's logits
   within 1e-4 of the CPU's and every argmax equal (`verify_phase`);
9. runs the attack-sweep farm (`farm_phase`, `python -m
   dorpatch_tpu_torch.farm` worker processes over one farm directory) on
   the CIFAR ResNet-18 trained in 7: 4 jobs (patch budget 0.06 and 0.12,
   float32 and bfloat16 attack and certify bank; batch 8 at 32 px,
   `--sampling-size 128 --dropout 2`, 20 iterations, a snapshot every 5,
   the stage switch at 10, failure-biased sampling from 15); a worker
   with `--chaos crash_block --crash-mode kill` SIGKILLs itself at its
   seeded block while one with `--chaos ckpt_raise,enospc_events` fails a
   job's snapshot save and its event log's disk; two healthy workers
   drain the farm. It fails unless every job ends done, the killed job
   shows attempts 2, reclaims 1 and a resume from an iteration above 0,
   its patch equals an uninterrupted `run_sweep` of the point in this
   process bit for bit, the ckpt_raise job ends done at attempts 2, and
   the draining workers launched A, B, C and the bf16 forms of C and A
   (their `metrics.json`; the kernels line gives the CIFAR records their
   `farm_launches`); it prints the fleet report, per-job seconds, the
   reclaim latency, the iterations the resume saved and the CIFAR
   snapshot saves' ms and bytes;
10. serves (`serve_phase`): holds the serve paths' kernels at their shapes
   (A, C, D and their bf16 forms at RN50's bucket of 8 at 224, A and C at
   CIFAR's, H's bf16 form at ViT-B/16's batch of 1), then runs
   `dorpatch_tpu_torch.serve`'s service and HTTP front-end in this
   process on each serving path and sends it requests over HTTP from
   stdlib clients: RN50 at 224 (`--serve-max-batch 8`, buckets 1 and 8,
   8 requests at concurrency 8) with 1 and 2 replicas in float32, with 2
   in the bf16 bank; the CIFAR ResNet-18 trained in 7 with 2 replicas
   and `--chaos wedge_dispatch` at concurrency 16 (replica 0 wedges its
   first batch: the supervisor must fail its requests over and restart
   it); ViT-B/16's
   bf16 bank at batch 1 (2 requests). Each path fails unless every answer
   is ok inside its deadline, equals the port's `robust_predict` on the
   same images in the same batches, no program ran a shape its warmup did
   not, `GET /metrics` counts what the clients sent and the path's
   kernels launched (`serve_path`); it prints, beside the card's name and
   power limit, the warmup seconds per replica, the latency percentiles,
   images/s, batch occupancy and forwards per image;
11. runs the certified fleet on the CIFAR ResNet-18 trained in 7
   (`fleet_phase`, the JAX package's `tools/recert_smoke.py` and
   `tools/gateway_smoke.py` on the card): a recert generation (two bf16
   jobs, batch 8, 10 iterations) through `recert run` in this process, the
   same spec SIGKILLed after its submit with its state file torn in a
   second process and resumed here to a byte-identical baseline (both
   drains launching A, B and the bf16 forms of C and A); a planted
   regression that `recert check` names under DP400, a strict boot that
   refuses it with no victim built and no kernel launched, a warn boot
   that serves and answers 503 on `GET /robustness`; then two `python -m
   dorpatch_tpu_torch.serve` backends booted strict behind an in-process
   gateway, 24 requests through it while `kill_backend` SIGKILLs one
   (every answer once, equal to `robust_predict`), a canary rolled back
   by `poison_canary`, and `python -m dorpatch_tpu_torch.observe.report
   --fleet` reconciling client, gateway and backends with no orphaned
   trace (the kernels line gives the CIFAR records their
   `recert_launches`, the CIFAR serve records their `fleet_launches`);
12. prints the total seconds, the per-kernel JSON line (the serve paths'
   records last), the nvidia-smi line and, last,
   `{"ok": true, "device": {...}}`.

Any failed phase raises: the script then exits nonzero and prints no
result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
#: float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_TF32_FLOPS = 495e12             # dense, tensor cores
PEAK_BF16_FLOPS = 989e12             # dense, tensor cores

INNER, REPS = 20, 15                 # calls per timed graph, timed graphs

TOL_B = dict(rtol=1e-5, atol=1e-6)   # summation order over S
TOL_C = 1e-4                         # summation order of the delta conv
# GroupNorm+ReLU against the float64 plain versions: f32 rounding of a few
# flops per element (the group statistics are summed in float64); dscale and
# dbias sum N*HW terms per channel from per-thread f32 partials. Gate flips of
# pre-activations within GN_NEAR of 0 are allowed for by
# `fused_gn.gate_flip_bounds`, and those elements are left out of dx.
TOL_GN = dict(rtol=1e-5, atol=1e-5)
TOL_GN_PARAMS = dict(rtol=1e-5, atol=1e-3)
GN_NEAR = 1e-5
#: GroupNorm slabs of the RN50 attack step: N = 2 images x 128 masks at
#: every (HW, C) of the victim; [N, HW, C] of a slab whose one-group chunk
#: fits no cluster of CTAs (the split route, both directions); and the
#: widest stage-1 slab of the attack step at 480 px, 1 image x 128 masks
#: (forward one-pass over a cluster of 8, backward split), whose records
#: stand for the 480 px sweep in the kernels line
GN_N = 256
GN_SPLIT_SLAB = (4, 256 * 256, 64)
GN_480_SLAB = (128, 120 * 120, 256)
# kernel H against its plain version in float64: float32 rounding of the
# logits (64-term dots), the exp-sum over T+1+S keys and the weighted sum;
# the engine's logits with kernel H and with the plain attention after 12
# blocks of it
TOL_H = dict(rtol=1e-5, atol=1e-5)
TOL_H_LOGITS = 1e-4

#: the attack's depth of every untrained main path (their f32 and bf16
#: runs), cut from 20 (CIFAR, RN50 and what derives from them: since PR
#: 17; ViT, RN50 480, ResMLP: since PR 15) to keep the script within its
#: time: every kernel of a path launches in each iteration and in the
#: certification
SHORT_ITERATIONS = 10
CIFAR_ARGV = ["--synthetic", "--dataset", "cifar10", "--base_arch",
              "resnet18", "--img-size", "32", "-b", "8",
              "--sampling-size", "128", "--dropout", "2",
              "--max-iterations", str(SHORT_ITERATIONS), "--num-batches",
              "1"]
RN50_ARGV = ["--synthetic", "--dataset", "imagenet", "--base_arch",
             "resnetv2", "--img-size", "224", "-b", "2",
             "--sampling-size", "128", "--dropout", "2",
             "--max-iterations", str(SHORT_ITERATIONS), "--num-batches",
             "1"]


def _iterations(argv, n):
    """`argv` with `--max-iterations n`."""
    i = argv.index("--max-iterations")
    return argv[:i + 1] + [str(n)] + argv[i + 2:]


VIT_ARGV = _iterations([a if a != "resnetv2" else "vit" for a in RN50_ARGV],
                       SHORT_ITERATIONS)
#: ResNetV2-50x1 at BiT's 480 px fine-tuning resolution, 1 image a batch
RN50_480_ARGV = ["--synthetic", "--dataset", "imagenet", "--base_arch",
                 "resnetv2", "--img-size", "480", "-b", "1",
                 "--sampling-size", "128", "--dropout", "2",
                 "--max-iterations", str(SHORT_ITERATIONS),
                 "--num-batches", "1"]
#: the bf16 paths: the same runs with the bf16 attack and certify bank
BF16_FLAGS = ["--compute-dtype", "bfloat16", "--certify-dtype", "bfloat16"]
#: ResMLP-24 (24 blocks, D 384, 196 tokens) at 224, RN50's other flags
RESMLP_ARGV = _iterations(
    [a if a != "resnetv2" else "resmlp" for a in RN50_ARGV],
    SHORT_ITERATIONS)
#: the n_patch=2 defense bank (630 pairs, 22680 triples a radius, the
#: exhaustive sweep) on the CIFAR ResNet-18, 2 images a batch
CIFAR_NP2_ARGV = [a if a != "8" else "2" for a in CIFAR_ARGV] + [
    "--defense-n-patch", "2"]
CONSENSUS = ["--prune", "consensus"]
#: the CIFAR path without --synthetic: the disk source over --data_dir
CIFAR_DISK_ARGV = _iterations([a for a in CIFAR_ARGV if a != "--synthetic"],
                              SHORT_ITERATIONS)
CIFAR_KERNELS = ("masked_fill_fwd", "masked_fill_bwd", "stem_fold")
#: the count each record's launches are read from: kernels A and B at 224,
#: kernel C at RN50's stem and kernel H at the pair audit's shape count as
#: their kernel; the GroupNorm records by their route
COUNT_OF = {"stem_fold_rn50": "stem_fold",
            "masked_fill_fwd_224": "masked_fill_fwd",
            "masked_fill_bwd_224": "masked_fill_bwd",
            "masked_kv_attn_pairs": "masked_kv_attn",
            "gn_relu_fwd": "gn_relu_fwd/one_pass",
            "gn_relu_bwd": "gn_relu_bwd/one_pass",
            "gn_relu_fwd_split": "gn_relu_fwd/split",
            "gn_relu_bwd_split": "gn_relu_bwd/split",
            "masked_fill_fwd_480": "masked_fill_fwd",
            "masked_fill_bwd_480": "masked_fill_bwd",
            "stem_fold_480": "stem_fold",
            "gn_relu_fwd_480": "gn_relu_fwd/one_pass",
            "gn_relu_bwd_split_480": "gn_relu_bwd/split",
            "masked_fill_fwd_bf16_224": "masked_fill_fwd_bf16",
            "stem_fold_bf16_rn50": "stem_fold_bf16",
            "gn_relu_fwd_bf16": "gn_relu_fwd_bf16/one_pass",
            "gn_relu_bwd_bf16": "gn_relu_bwd_bf16/one_pass",
            "gn_relu_fwd_bf16_49x2048": "gn_relu_fwd_bf16/one_pass",
            "gn_relu_bwd_bf16_49x2048": "gn_relu_bwd_bf16/one_pass",
            "gn_relu_fwd_bf16_split": "gn_relu_fwd_bf16/split",
            "gn_relu_bwd_bf16_split": "gn_relu_bwd_bf16/split",
            "masked_fill_fwd_bf16_480": "masked_fill_fwd_bf16",
            "stem_fold_bf16_480": "stem_fold_bf16",
            "gn_relu_fwd_bf16_480": "gn_relu_fwd_bf16/one_pass",
            "gn_relu_bwd_bf16_split_480": "gn_relu_bwd_bf16/split",
            "masked_kv_attn_bf16_pairs": "masked_kv_attn_bf16",
            "masked_fill_fwd_k3": "masked_fill_fwd",
            "masked_fill_fwd_bf16_k3": "masked_fill_fwd_bf16",
            **{f"gn_relu_fwd{k}_split_480x{c}": f"gn_relu_fwd{k}/split"
               for k in ("", "_bf16") for c in (64, 128, 256)}}
RN50_KERNELS = CIFAR_KERNELS + ("gn_relu_fwd", "gn_relu_bwd")
VIT_KERNELS = ("masked_fill_fwd", "masked_fill_bwd", "masked_kv_attn")
#: the bf16 paths' kernels: the attack fills at float32 (A, B) and runs the
#: victim's bf16 copy (D, F on RN50); the bank fills bf16 images (A's bf16
#: form) and runs the engines in bf16 (C, H)
CIFAR_BF16_KERNELS = ("masked_fill_fwd", "masked_fill_bwd",
                      "masked_fill_fwd_bf16", "stem_fold_bf16")
RN50_BF16_KERNELS = CIFAR_BF16_KERNELS + ("gn_relu_fwd_bf16",
                                          "gn_relu_bwd_bf16")
VIT_BF16_KERNELS = ("masked_fill_fwd", "masked_fill_bwd",
                    "masked_kv_attn_bf16")
#: the bf16 bank's fill (A's bf16 form) fills only the pair audits' images
#: (its minority rows are filled by the rows program's own lerp): at 480 px
#: it must launch exactly when the run scheduled a pair audit
#: (`main_path`'s `audit_fill`), which the seeded image's table may not
#: need; the lifted 480 px bank check runs it
RN50_480_BF16_KERNELS = tuple(k for k in RN50_BF16_KERNELS
                              if k != "masked_fill_fwd_bf16")
GN_KERNELS = ("gn_relu_fwd", "gn_relu_bwd", "gn_relu_fwd_bf16",
              "gn_relu_bwd_bf16")
#: the ResMLP paths' kernels: the attack's fills (A, B); the mixer engine
#: is gathers and cuBLAS matmuls (no TPU kernel), and its escalations, the
#: float32 exhaustive sweep, fill with A. The n_patch=2 paths: A and B in
#: the attack, A (K = 3) in the float32 exhaustive sweep, which their bf16
#: bank keeps as the JAX package does
MIXER_KERNELS = ("masked_fill_fwd", "masked_fill_bwd")
NP2_KERNELS = ("masked_fill_fwd", "masked_fill_bwd")
#: victim training (`python -m dorpatch_tpu_torch.train`) at the JAX
#: package's defaults (12 epochs, batch 128, lr 3e-3, warmup 100):
#: cifar_resnet18 at 1500 images a class (1404 steps); cifar_vit with the
#: flags of the JAX package's own cifar_vit run (`tools/flagship_vit_leg.sh`:
#: 1000 images a class, 936 steps, lr 1e-3). Held out, the JAX package's
#: CPU runs reached 0.609 and 0.613; TRAIN_MIN_ACC is the bar of the mean
#: over TRAIN_SEEDS. cifar_vit's held-out accuracy spreads over 0.52-0.65
#: from seed to seed (its accuracy on augmented images stays at 0.59-0.60),
#: so its bar is the mean of three seeds; seed 0 is the checkpoint
TRAIN_ARGV = {"cifar_resnet18": [],
              "cifar_vit": ["--n-per-class", "1000", "--lr", "1e-3"]}
TRAIN_SEEDS = {"cifar_resnet18": (0,), "cifar_vit": (0, 1, 2)}
TRAIN_MIN_ACC = 0.55
#: the repeat check: two one-epoch runs of 20 steps of 128 from one seed
TRAIN_REPEAT_ARGV = ["--epochs", "1", "--n-per-class", "256"]
#: the main path on the trained victims: the first 8 held-out images of the
#: procedural task, with the attack's stage switch (at 10) and its
#: failure-biased sampling (from 15) inside the 20 iterations
TRAINED_ARGV = ["--data-source", "procedural", "--dataset", "cifar10",
                "--img-size", "32", "-b", "8", "--sampling-size", "128",
                "--dropout", "2", "--max-iterations", "20",
                "--switch-iteration", "10", "--sweep-interval", "5",
                "--failure-sampling-start", "15", "--num-batches", "1"]
#: A's bf16 form fills only pair audits, which a trained victim's bank may
#: not schedule (`main_path`'s `audit_fill` holds it to them)
TRAINED_CIFAR_BF16_KERNELS = tuple(k for k in CIFAR_BF16_KERNELS
                                   if k != "masked_fill_fwd_bf16")
#: the serving paths (`python -m dorpatch_tpu_torch.serve`'s flags, run in
#: this process through `CertifiedInferenceService.from_config` and
#: `HttpFrontend` so that the launch counts hold the kernels): RN50 at 224
#: with the (1, 8) buckets, SERVE_RN50_REQUESTS requests at closed-loop
#: concurrency SERVE_CONCURRENCY over HTTP, with 1 and 2 replicas on the
#: card in float32, with 2 in the bf16 bank; the trained CIFAR ResNet-18
#: with 2 replicas and the wedge_dispatch failover drill (replica 0 wedges
#: its first batch; stale after SERVE_STALE_S), SERVE_REQUESTS requests at
#: concurrency 16: two full batches wait at once and each replica takes
#: one (at 8 the clients wait for each batch, and replica 1 may take them
#: all); ViT-B/16's bf16 bank
#: at batch 1, SERVE_VIT_REQUESTS requests at concurrency 2. Replicas beat
#: only at batch boundaries, so the stale window must outlast a healthy
#: batch: a trained CIFAR batch of 8 takes 2.6 s (service p50 on the card) and
#: longer while the restarted replica 0 warms up beside it on the card; at
#: a 3 s window replica 1 was once declared wedged too, and the requests
#: re-dispatched to it failed twice
SERVE_STALE_S = 6.0
SERVE_RN50_ARGV = ["--synthetic", "--dataset", "imagenet", "--base_arch",
                   "resnetv2", "--img-size", "224", "--serve-max-batch", "8",
                   "--serve-deadline-ms", "60000"]
SERVE_VIT_ARGV = [a if a != "resnetv2" else "vit" for a in SERVE_RN50_ARGV
                  ][:-4] + ["--serve-max-batch", "1", "--serve-deadline-ms",
                            "60000", "--certify-dtype", "bfloat16"]
SERVE_CIFAR_ARGV = ["--dataset", "cifar10", "--base_arch", "resnet18",
                    "--img-size", "32", "--serve-max-batch", "8",
                    "--serve-deadline-ms", "60000", "--serve-replicas", "2",
                    "--serve-replica-stale-s", str(SERVE_STALE_S),
                    "--serve-restart-backoff-base", "0.5",
                    "--chaos", "wedge_dispatch"]
CERTIFY_BF16 = ["--certify-dtype", "bfloat16"]
SERVE_REQUESTS, SERVE_CONCURRENCY, SERVE_VIT_REQUESTS = 16, 8, 2
#: the RN50 serve runs' requests: one full batch at concurrency 8
SERVE_RN50_REQUESTS = 8
#: the RN50 2-replica runs' `POST /profile` capture (seconds) of one more
#: batch served after the measured traffic: the device's busy share of a
#: served batch
SERVE_PROFILE_S = 2.0
#: the serve paths' kernels: phase 1 folds the stem (C), the pair audits
#: fill with A, every RN50 forward runs D; the bf16 bank runs their bf16
#: forms, its escalations (the float32 exhaustive sweep) A and D, and the
#: clean forward D; the ViT bank runs H's bf16 form. A (or its bf16 form)
#: must launch exactly when a pair audit was scheduled, and float32 A in
#: the RN50 bf16 bank exactly when an image escalated (`serve_path`)
#: the RN50 224 --carry-checkpoints check: 10 iterations a stage in
#: blocks of 5, so that stage 1 has a block left after its first; the
#: watchdog (s) must outlast the longest block, its first call included
RN50_CARRY_ITERATIONS = 10
RN50_CARRY_ARGV = _iterations(RN50_ARGV, RN50_CARRY_ITERATIONS) + [
    "--sweep-interval", "5"]
RN50_CARRY_HANG_S = 300
#: the farm (`farm_phase`): the trained CIFAR ResNet-18, batch 8 at 32
#: px, its attack with the stage switch at 10, failure-biased sampling
#: from 15 and a snapshot every 5 iterations; one grid point a job, one
#: radius (0.06) certified a point
FARM_ATTACK = {"sampling_size": 128, "dropout": 2, "max_iterations": 20,
               "sweep_interval": 5, "switch_iteration": 10,
               "failure_sampling_start": 15}
FARM_BUDGETS = [0.06, 0.12]
FARM_SWEEP = {"defense_ratio": 0.06}
#: lease TTL (s): above the longest block, a worker's first call included,
#: with two workers on the card; the reclaim waits it out
FARM_TTL = 15.0
FARM_PROC_TIMEOUT = 300
#: the draining workers' kernels: A, B in every step, C in the float32
#: jobs' phase 1, C's and A's bf16 forms in the bf16 jobs' bank
FARM_KERNELS = ("masked_fill_fwd", "masked_fill_bwd", "stem_fold",
                "stem_fold_bf16", "masked_fill_fwd_bf16")
#: the certified fleet (`fleet_phase`): a recert generation of two jobs
#: (patch budget 0.06 and 0.12) on the trained CIFAR ResNet-18, batch 8,
#: 10 iterations (the stage switch at 5, failure-biased sampling from 8, a
#: snapshot every 5), bf16 attack and certify bank, one radius (0.06), on
#: the procedural task's held-out images
RECERT_ATTACK = {"sampling_size": 128, "dropout": 2, "max_iterations": 10,
                 "sweep_interval": 5, "switch_iteration": 5,
                 "failure_sampling_start": 8, "compute_dtype": "bfloat16"}
RECERT_BUDGETS = [0.06, 0.12]
#: the recert drain's kernels: A and B in every attack step, C's and A's
#: bf16 forms in the bf16 bank
RECERT_KERNELS = ("masked_fill_fwd", "masked_fill_bwd", "stem_fold_bf16",
                  "masked_fill_fwd_bf16")
#: points a planted regression lifts one baseline entry by (tolerance 2)
RECERT_PLANT = 30.0
#: the fleet's serve processes: the trained CIFAR ResNet-18, one replica,
#: batches of 1 (a lone request flushes at once: the clients are closed
#: loops at concurrency 1, so a SIGKILLed backend's books hold exactly the
#: requests it answered); FLEET_REQUESTS through the gateway over
#: FLEET_IMAGES held-out images, FLEET_POST more after the rollback,
#: FLEET_DIRECT to the warn-mode service in this process (the latency of a
#: backend without the gateway)
FLEET_SERVE_ARGV = ["--dataset", "cifar10", "--base_arch", "resnet18",
                    "--img-size", "32", "--serve-max-batch", "1",
                    "--serve-deadline-ms", "60000", "--serve-replicas", "1",
                    "--data-source", "procedural"]
FLEET_REQUESTS, FLEET_IMAGES, FLEET_POST, FLEET_DIRECT = 24, 12, 4, 8
FLEET_BOOT_S = 300
#: the backends' kernels: C in phase 1 of every certification
FLEET_KERNELS = ("stem_fold",)
SERVE_KERNELS = {"RN50": ("stem_fold", "gn_relu_fwd"),
                 "RN50 bf16": ("stem_fold_bf16", "gn_relu_fwd_bf16",
                               "gn_relu_fwd"),
                 "CIFAR": ("stem_fold",),
                 "ViT bf16": ("masked_kv_attn_bf16",)}


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _device_ms(fn, inner: int = INNER, reps: int = REPS) -> float:
    """Median device milliseconds of one `fn()` call: a CUDA graph of
    `inner` calls is replayed `reps` times, each replay bracketed by
    synchronizes and timed with CUDA events (`gn_bench.device_ms`)."""
    from dorpatch_tpu_torch.gn_bench import device_ms

    return device_ms(fn, inner, reps)


def _bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """(least milliseconds, what bounds it) for the bytes a call must move
    and the operations it must do."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fill_phase(torch, dev, b, size, suffix=""):
    """Kernels A and B at one main path's image shape: A exact against its
    plain version at the attack step's S = 128, the sweep's chunk of 126
    and the pair audit's chunk of 63; B within TOL_B of float64 autograd
    of the plain version and bit-equal on a repeat, at S = 128; both timed
    at S = 128 beside the plain versions and the one-call PyTorch
    yardsticks (`fill_bench.yardsticks`). Returns the two records."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.fill_bench import (bwd_bytes, fill_inputs,
                                               kept_load_share, kept_share,
                                               yardsticks)
    from dorpatch_tpu_torch.ops import masked_fill as mf

    fill = 0.5
    label = f"[B={b},S=128,K=2,{size}x{size}x3]"
    for s in (126, 63, 128):
        imgs, rects, g = fill_inputs(torch, dev, b, size, s, seed=s)
        got = mf.masked_fill_fwd_kernel(imgs, rects, fill)
        want = mf.masked_fill_reference(imgs, rects, fill)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel A differs from its plain version "
                                 f"at [B={b},S={s},{size}x{size}x3]")
    a_err = float((got - want).abs().max())
    del got, want
    hwc = size * size * 3
    s, k = rects.shape[0], rects.shape[1]
    keep = masks_lib.rasterize(rects, size)
    plain_b, lib_a, lib_b = yardsticks(torch, imgs, keep, g, fill)
    a_ms = _device_ms(lambda: mf.masked_fill_fwd_kernel(imgs, rects, fill))
    a_plain = _device_ms(lambda: mf.masked_fill_reference(imgs, rects, fill))
    a_lib = _device_ms(lib_a)
    bound, by = _bound(4 * b * hwc + 16 * s * k + 4 * b * s * hwc, 0.0)
    plan = mf.fwd_plan(b, s, size, size, 3)
    rec_a = dict(name="masked_fill_fwd" + suffix, route="cuda",
                 source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                 replaces="dorpatch_tpu/ops/masked_fill.py:53",
                 launches=0, max_abs_err=a_err, ms=a_ms, plain_ms=a_plain,
                 bound_ms=bound, bound_by=by, library_ms=a_lib)
    print(f"kernel A masked_fill_fwd {label} ({plan}): exact at S=128, 126 "
          f"and 63, {a_ms * 1e3:.2f} us (plain {a_plain * 1e3:.2f} us, "
          f"torch.where on a rasterized keep-mask {a_lib * 1e3:.2f} us; "
          f"bound {bound * 1e3:.2f} us by {by}, {bound / a_ms:.0%} of it)",
          flush=True)

    # B against autograd of the plain version in float64: the f32 autograd
    # sums 128 signed unit-variance terms with its own rounding (reported
    # beside it), which alone can exceed atol 1e-6
    def plain_grad(dtype):
        x = imgs.to(dtype).requires_grad_(True)
        (gx,) = torch.autograd.grad(
            mf.masked_fill_reference(x, rects, fill), x, g.to(dtype))
        return gx.float()

    want = plain_grad(torch.float64)
    got = mf.masked_fill_bwd_kernel(rects, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL_B)
    if not torch.equal(mf.masked_fill_bwd_kernel(rects, g), got):
        raise AssertionError(f"kernel B {label} does not repeat bit for bit")
    b_err = float((got - want).abs().max())
    b_err32 = float((got - plain_grad(torch.float32)).abs().max())
    del got, want
    b_ms = _device_ms(lambda: mf.masked_fill_bwd_kernel(rects, g))
    b_plain = _device_ms(plain_b)
    b_lib = _device_ms(lib_b)
    # B needs g only where keep is 1: its bound counts those bytes and
    # adds; the bound over all of g is printed beside it
    need, whole = bwd_bytes(g.shape, k, keep)
    share = kept_share(keep)
    bound, by = _bound(need, b * s * hwc * share, PEAK_F64_FLOPS)
    whole_ms = whole / PEAK_BYTES_PER_S * 1e3
    rec_b = dict(name="masked_fill_bwd" + suffix, route="cuda",
                 source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                 replaces="dorpatch_tpu/ops/masked_fill.py:66",
                 launches=0, max_abs_err=b_err, ms=b_ms, plain_ms=b_plain,
                 bound_ms=bound, bound_by=by, library_ms=b_lib)
    print(f"kernel B masked_fill_bwd {label} "
          f"({mf.bwd_plan(b, s, size, size, 3)}): max_abs_err {b_err:.3g} "
          f"vs float64 autograd of the plain version (rtol {TOL_B['rtol']}, "
          f"atol {TOL_B['atol']}), {b_err32:.3g} vs float32 autograd, "
          f"repeats bit for bit; {b_ms * 1e3:.2f} us (plain where+sum "
          f"{b_plain * 1e3:.2f} us, einsum on a keep-mask {b_lib * 1e3:.2f} "
          f"us; bound {bound * 1e3:.2f} us by {by}, {bound / b_ms:.0%} of "
          f"it, for the {share:.1%} of g that is kept; over all of g "
          f"{whole_ms * 1e3:.2f} us; the kernel makes "
          f"{kept_load_share(keep):.1%} of g's 16-byte loads)", flush=True)
    del imgs, g, keep, plain_b, lib_a, lib_b
    torch.cuda.empty_cache()
    return [rec_a, rec_b]


def kernel_phases(torch, dev):
    """Kernels A, B and C against their plain versions at the CIFAR main
    path's shapes. Returns the per-kernel records (launches filled in
    later)."""
    out = fill_phase(torch, dev, 8, 32)
    # -- C: stem fold, one phase-1 chunk (3 masks) of the 0.12 radius on
    #    the full-width CIFAR ResNet-18 stem --
    out.append(stem_fold_phase(torch, dev, "cifar10", "resnet18", 32, 8,
                               "stem_fold"))
    return out


def stem_fold_phase(torch, dev, dataset, arch, size, b, name,
                    dtype=None):
    """Kernel C on one phase-1 chunk of the 0.12 radius (the chunk the
    engine takes by the stem's inflation), against the plain fold and
    against the stem conv of the masked batch (`stem_bench.stem_case`).
    With `dtype` bfloat16, C's bf16 form on the victim's bf16 copy: within
    one ulp of the output and one of the delta of the plain bf16 fold,
    plus twice the error bound of a float32 sum of the delta's products
    (`stem_bench.stem_gate`: the two sum the delta in float32 in other
    orders, and where it cancels to near 0 they may round it an ulp or
    more apart), bit-equal on a repeat; its gap to the bf16 conv of the
    masked batch is printed, not held (that conv rounds once where the
    fold rounds twice)."""
    from dorpatch_tpu_torch import stem_bench as sb
    from dorpatch_tpu_torch.ops import stem_fold as sf

    import torch.nn.functional as F

    case = sb.stem_case(torch, dev, dataset, arch, size, b,
                        dtype or torch.float32)
    args = sb.kernel_args(case)
    with torch.no_grad():
        got = sf.fold_masked_stem_kernel(*args)
        want = sb.plain(case)
        torch.cuda.synchronize()
        c_err, bad, sums_note = sb.stem_gate(torch, case, got, want)
        del want
        if case.bf16:
            if bad or not torch.equal(sf.fold_masked_stem_kernel(*args),
                                      got):
                raise AssertionError(f"kernel C ({name}): {bad} elements "
                                     f"beyond an ulp of the output and of "
                                     f"the delta and the float32 sums' "
                                     f"error bound (max_abs_err {c_err}), "
                                     "or no bit-equal repeat")
        elif bad:
            raise AssertionError(f"kernel C ({name}) max_abs_err {c_err} > "
                                 f"{TOL_C}")
        # the fold's algebra: the same activations as the stem conv of the
        # masked images
        lib = F.conv2d(case.xm, case.w_oihw, None, case.s).permute(0, 2, 3, 1)
        lib_err = float((lib.reshape(got.shape).float()
                         - got.float()).abs().max())
        del lib
        if not case.bf16 and not lib_err <= TOL_C:
            raise AssertionError(f"kernel C ({name}) vs conv of the masked "
                                 f"batch: {lib_err} > {TOL_C}")
        c_ms = _device_ms(lambda: sf.fold_masked_stem_kernel(*args))
        # the plain fold with its occlusion windows already on the card (a
        # host-to-device copy cannot be captured in a CUDA graph)
        case.part = [pw._replace(occ=torch.as_tensor(pw.occ, device=dev))
                     for pw in case.part]
        c_plain = _device_ms(lambda: sb.plain(case))
        c_lib = _device_ms(lambda: F.conv2d(case.xm, case.w_oihw, None,
                                            case.s))
    nbytes, flops, bytes_ms, ops_ms, _ = sb.bounds(case)
    bound, by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
        (ops_ms, "operations")
    peak = PEAK_BF16_FLOPS if case.bf16 else PEAK_F32_FLOPS
    _, h, w, cout = case.clean.shape
    tol = ("1 ulp of the output and of the delta + 2 gamma_n sum |w x|"
           if case.bf16 else f"atol {TOL_C}")
    print(f"kernel C {name} [B={b},N={case.n},{h}x{w}x{cout}, k={case.k} "
          f"s={case.s}, OH/OW {case.oh}/{case.ow}, {str(case.dtype)[6:]}]: "
          f"max_abs_err {c_err:.3g} ({tol}{sums_note}; vs conv of the masked "
          f"batch {lib_err:.3g}), {c_ms * 1e3:.2f} us (plain "
          f"{c_plain * 1e3:.2f} us, conv2d of the masked batch "
          f"{c_lib * 1e3:.2f} us, {c_lib / c_ms:.2f}x the kernel's time; "
          f"bound {bound * 1e3:.2f} us by {by}: {nbytes / 1e6:.2f} MB; "
          f"operations bound {ops_ms * 1e3:.2f} us, {flops / 1e9:.3f} GFLOP "
          f"at {peak / 1e12:.0f} TFLOP/s)", flush=True)
    del case, args, got
    torch.cuda.empty_cache()
    return dict(name=name, route="cuda",
                source="dorpatch_tpu_torch/csrc/stem_fold.cu",
                replaces="dorpatch_tpu/ops/stem_fold.py:214",
                launches=0, max_abs_err=c_err, ms=c_ms, plain_ms=c_plain,
                bound_ms=bound, bound_by=by, library_ms=c_lib)


def _gn_step(x):
    """Samples a chunk of the held comparisons (a group's statistics are
    per sample; the float64 intermediates of a chunk stay near a GB)."""
    return max(1, (1 << 27) // x[0].numel())


def _gn_fwd_held(torch, x, s, b, y, mean, rstd, sl, out):
    """Adds one chunk `sl` of samples of a forward to `out` (`_gn_held`'s
    forward keys): y against float64 within TOL_GN (plus half a bf16 ulp
    for bf16), the statistics' errors, and for bf16 also against the plain
    bf16 version on the same inputs within one ulp + 1e-5."""
    from dorpatch_tpu_torch.ops import fused_gn as fgn

    g, bf16 = 32, x.dtype == torch.bfloat16
    at, rt = TOL_GN["atol"], TOL_GN["rtol"]
    x64 = x[sl].double()
    m64, r64 = fgn.gn_stats_reference(x64, g)
    out["stat"] = max(out["stat"],
                      float((mean[sl].double() - m64).abs().max()),
                      float(((rstd[sl].double() - r64) / r64).abs().max()))
    want = fgn.gn_relu_reference(x64, s.double(), b.double())
    err = (y[sl].double() - want).abs()
    half = 0.5 * _ulp16(torch, want).double() if bf16 else 0.0
    out["fwd"] = max(out["fwd"], float(err.max()))
    out["bad"] += int((~(err <= at + rt * want.abs() + half)).sum())
    del x64, want, err, half
    if not bf16:
        return
    m32, r32 = fgn.gn_stats_reference(x[sl], g)
    out["stat16"] = max(out["stat16"], float((mean[sl] - m32).abs().max()),
                        float(((rstd[sl] - r32) / r32).abs().max()))
    want = fgn.gn_relu_reference(x[sl], s, b)
    err = (y[sl].float() - want.float()).abs()
    out["fwd16"] = max(out["fwd16"], float(err.max()))
    out["bad16"] += int((~(err <= _ulp16(torch, want) + 1e-5)).sum())


def _gn_held(torch, x, dy, s, b, y, mean, rstd, dx, ds, db):
    """How far one slab's kernel outputs lie from the plain versions, in
    chunks of samples (`_gn_step`): against float64 within
    TOL_GN (dscale/dbias TOL_GN_PARAMS), plus, for bf16 y and dx, half a
    bf16 ulp (their one rounding); for bf16 also against the plain bf16
    versions on the same inputs within one ulp + 1e-5 (the statistics
    within 1e-5). Elements whose pre-activation lies within GN_NEAR of 0
    are left out of dx, and the moves their gate flips allow
    (`fused_gn.gate_flip_bounds`) are added to the tolerances. Returns the
    largest errors and the counts of elements out of tolerance."""
    from dorpatch_tpu_torch.ops import fused_gn as fgn

    g, bf16 = 32, x.dtype == torch.bfloat16
    at, rt = TOL_GN["atol"], TOL_GN["rtol"]
    out = dict(fwd=0.0, stat=0.0, dx=0.0, flip=0.0, near=0, bad=0, fwd16=0.0,
               stat16=0.0, dx16=0.0, bad16=0)
    params = [torch.zeros_like(ds, dtype=torch.float64) for _ in range(4)]
    params16 = [torch.zeros_like(ds) for _ in range(4)]
    s64, b64 = s.double(), b.double()
    step = _gn_step(x)

    def half_ulp(t):
        return 0.5 * _ulp16(torch, t).double() if bf16 else 0.0

    for i in range(0, x.shape[0], step):
        sl = slice(i, i + step)
        _gn_fwd_held(torch, x, s, b, y, mean, rstd, sl, out)
        x64, dy64 = x[sl].double(), dy[sl].double()
        m64, r64 = fgn.gn_stats_reference(x64, g)
        wdx, wds, wdb = fgn.gn_relu_backward_reference(x64, dy64, s64, b64,
                                                       m64, r64, g)
        near, dx_b, ds_b, db_b = fgn.gate_flip_bounds(x64, dy64, s64, b64,
                                                      m64, r64, g, GN_NEAR)
        err = (dx[sl].double() - wdx).abs()
        out["bad"] += int((~(err <= at + rt * wdx.abs() + dx_b
                             + half_ulp(wdx)) & ~near).sum())
        out["dx"] = max(out["dx"], float(err[~near].max()))
        out["flip"] = max(out["flip"], float(dx_b.max()))
        out["near"] += int(near.sum())
        for acc, part in zip(params, (wds, wdb, ds_b, db_b)):
            acc += part
        del x64, dy64, wdx, near, dx_b, err
        if not bf16:
            continue
        wdx, wds, wdb = fgn.gn_relu_backward_reference(
            x[sl], dy[sl], s, b, mean[sl], rstd[sl], g)
        near, dx_b, ds_b, db_b = fgn.gate_flip_bounds(
            x[sl], dy[sl], s, b, mean[sl], rstd[sl], g, GN_NEAR)
        err = (dx[sl].float() - wdx.float()).abs()
        out["bad16"] += int((~(err <= _ulp16(torch, wdx) + 1e-5 + dx_b)
                             & ~near).sum())
        out["dx16"] = max(out["dx16"], float(err[~near].max()))
        for acc, part in zip(params16, (wds, wdb, ds_b, db_b)):
            acc += part
        del err, wdx, near, dx_b
    out["bad16"] += int(not out["stat16"] <= 1e-5)
    out["param"] = out["param16"] = 0.0
    for key, ref in (("", params), ("16", params16 if bf16 else None)):
        if ref is None:
            continue
        for got, want, bnd in ((ds, ref[0], ref[2]), (db, ref[1], ref[3])):
            err = (got.to(want.dtype) - want).abs()
            out["param" + key] = max(out["param" + key], float(err.max()))
            out["bad" + key] += int((~(err <= TOL_GN_PARAMS["atol"]
                                       + TOL_GN_PARAMS["rtol"] * want.abs()
                                       + bnd)).sum())
    return out


def gn_slab(torch, dev, gen, n, hw, c, calls=0, dtype=None, suffix=""):
    """The GroupNorm+ReLU forward and backward kernels at one [n, hw, c]
    slab of `dtype` (float32 by default, or bfloat16: the bf16 forms), on
    the routes `fused_gn.gn_plan` takes: held to the plain versions as
    `_gn_held` says, a repeated call bit-equal, and timed as the victim
    calls them (no parameter cotangents) beside the plain versions and
    PyTorch's group norm of the same type (which leaves out the ReLU).
    Returns the forward and backward records, named by direction, type,
    route ("_split") and `suffix`."""
    from dorpatch_tpu_torch import ops
    from dorpatch_tpu_torch.ops import fused_gn as fgn

    import torch.nn.functional as F

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    side = math.isqrt(hw)
    shape = (n, side, side, c)
    g = 32

    def rand(*size):
        return torch.randn(size, generator=gen, device=dev)

    x = (rand(*shape) + 0.5 * rand(c)).to(dtype)
    s, b = 1 + 0.2 * rand(c), 0.3 * rand(c)
    dy = rand(*shape).to(dtype)
    label = f"[{n},{hw},{c}]" + (" bf16" if bf16 else "")
    isz = x.element_size()
    routes = {d: fgn.gn_plan(d, n, hw, c, g, isz) for d in ("fwd", "bwd")}
    kind = "_bf16" if bf16 else ""

    ops.reset_launch_counts()
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b)
    dx, ds, db = fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd)
    torch.cuda.synchronize()
    again = fgn.gn_relu_fwd_kernel(x, s, b) + \
        fgn.gn_relu_bwd_kernel(x, dy, s, b, mean, rstd)
    if not all(torch.equal(p, q)
               for p, q in zip(again, (y, mean, rstd, dx, ds, db))):
        raise AssertionError(f"GN {label} does not repeat bit for bit")
    del again
    launched = ops.route_counts()
    want_routes = {f"gn_relu_{d}{kind}/{routes[d].route}": 2
                   for d in ("fwd", "bwd")}
    if launched != want_routes:
        raise AssertionError(f"GN {label}: routes launched {launched}, "
                             f"planned {want_routes}")
    held = _gn_held(torch, x, dy, s, b, y, mean, rstd, dx, ds, db)
    vs16 = (f"; vs plain bf16: y {held['fwd16']:.3g}, stats "
            f"{held['stat16']:.3g}, dx {held['dx16']:.3g}, dscale/dbias "
            f"{held['param16']:.3g} (1 ulp + 1e-5; {held['bad16']} out)"
            if bf16 else "")
    print(f"GN {label}: vs float64: forward max_abs_err {held['fwd']:.3g} "
          f"(atol {TOL_GN['atol']}, rtol {TOL_GN['rtol']}"
          f"{' + half a bf16 ulp' if bf16 else ''}), stats err "
          f"{held['stat']:.3g}; backward dx max_abs_err {held['dx']:.3g} "
          f"over the elements not within {GN_NEAR} of the gate "
          f"({held['near']} near-zero pre-activations left out, flip bound "
          f"up to {held['flip']:.3g}), dscale/dbias max_abs_err "
          f"{held['param']:.3g} (atol {TOL_GN_PARAMS['atol']}, rtol "
          f"{TOL_GN_PARAMS['rtol']}); {held['bad']} out{vs16}; both "
          f"repeat bit for bit", flush=True)
    if held["bad"] or held["bad16"]:
        raise AssertionError(f"GN {label}: {held['bad']} elements out of "
                             f"tolerance of float64, {held['bad16']} of the "
                             "plain bf16 versions")

    fwd_ms = _device_ms(lambda: fgn.gn_relu_fwd_kernel(x, s, b), 5, 7)
    fwd_plain = _device_ms(lambda: fgn.gn_relu_reference(x, s, b), 5, 7)
    xv = x.permute(0, 3, 1, 2)
    sl, bl = s.to(dtype), b.to(dtype)
    fwd_lib = _device_ms(lambda: F.group_norm(xv, g, sl, bl, 1e-5), 5, 7)
    bwd_ms = _device_ms(lambda: fgn.gn_relu_bwd_kernel(
        x, dy, s, b, mean, rstd, params=False), 5, 7)
    bwd_plain = _device_ms(lambda: fgn.gn_relu_backward_reference(
        x, dy, s, b, mean, rstd, g), 5, 7)
    # PyTorch's group norm backward takes NCHW-contiguous tensors
    xc, dyc = xv.contiguous(), dy.permute(0, 3, 1, 2).contiguous()
    _, lmean, lrstd = torch.ops.aten.native_group_norm(
        xc, sl, bl, n, c, hw, g, 1e-5)
    bwd_lib = _device_ms(lambda: torch.ops.aten.native_group_norm_backward(
        dyc, xc, lmean, lrstd, sl, n, c, hw, g, [True, False, False]), 5, 7)
    del xc, dyc
    slab = float(isz) * n * hw * c
    small = 4.0 * (2 * c + 2 * n * g)
    bounds = {"fwd": _bound(2 * slab + small, 8.0 * n * hw * c),
              "bwd": _bound(3 * slab + small, 12.0 * n * hw * c)}
    lib_name = "bf16 " if bf16 else ""
    pf, pb = routes["fwd"], routes["bwd"]
    print(f"GN {label} ({calls} calls per RN50 forward): forward route "
          f"{pf.route} (width {pf.width}, cluster {pf.cluster}, smem "
          f"{pf.smem}) {fwd_ms * 1e3:.2f} us (bound "
          f"{bounds['fwd'][0] * 1e3:.2f} us by {bounds['fwd'][1]}, plain "
          f"{fwd_plain * 1e3:.2f} us, {lib_name}F.group_norm without the "
          f"ReLU {fwd_lib * 1e3:.2f} us); backward route {pb.route} (width "
          f"{pb.width}, cluster {pb.cluster}, smem {pb.smem}) "
          f"{bwd_ms * 1e3:.2f} us (bound {bounds['bwd'][0] * 1e3:.2f} us by "
          f"{bounds['bwd'][1]}, plain {bwd_plain * 1e3:.2f} us, {lib_name}"
          f"native_group_norm_backward on NCHW copies, without the ReLU "
          f"{bwd_lib * 1e3:.2f} us)", flush=True)
    lines = {("fwd", "one_pass"): "115", ("bwd", "one_pass"): "135",
             ("fwd", "split"): "159", ("bwd", "split"): "278"}
    errs = {"fwd": max(held["fwd16"], held["stat16"]) if bf16
            else max(held["fwd"], held["stat"]),
            "bwd": max(held["dx16"], held["param16"]) if bf16
            else max(held["dx"], held["param"])}
    times = {"fwd": (fwd_ms, fwd_plain, fwd_lib),
             "bwd": (bwd_ms, bwd_plain, bwd_lib)}
    recs = []
    for d in ("fwd", "bwd"):
        route = routes[d].route
        recs.append(dict(
            name=f"gn_relu_{d}{kind}" + ("_split" if route == "split"
                                          else "") + suffix,
            route="cuda", source="dorpatch_tpu_torch/csrc/fused_gn.cu",
            replaces="dorpatch_tpu/ops/fused_gn.py:" + lines[d, route],
            launches=0, max_abs_err=errs[d], ms=times[d][0],
            plain_ms=times[d][1], bound_ms=bounds[d][0],
            bound_by=bounds[d][1], library_ms=times[d][2]))
    del x, dy, y, dx, xv
    torch.cuda.empty_cache()
    return recs


def gn_sweep(torch, dev, gen, img_size, dtype=None):
    """The GroupNorm+ReLU kernels (of `dtype`, float32 by default) at every
    (HW, C) of the RN50 victim at `img_size` (`gn_bench.rn50_gn_calls`),
    at the attack step's N (`gn_bench.STEP_N`), each held and timed by
    `gn_slab`. Every forward must take the one-pass route; so must every
    backward but those of the shapes whose one-group chunk of x and dy fits
    no cluster: at 480 px the 14400-row stage-1 shapes, which take the
    split route. Prints launches x (time - bound) summed over a forward's
    49 calls. Returns {(HW, C): (forward record, backward record)}."""
    from dorpatch_tpu_torch.gn_bench import STEP_N, rn50_gn_calls

    bf16 = dtype == torch.bfloat16
    kind = "_bf16" if bf16 else ""
    suffix = "" if img_size == 224 else f"_{img_size}"
    recs, over = {}, [0.0, 0.0]
    for (hw, c), calls in sorted(rn50_gn_calls(img_size).items(),
                                 key=lambda kv: (-kv[0][0], kv[0][1])):
        fwd, bwd = gn_slab(torch, dev, gen, STEP_N[img_size], hw, c, calls,
                           dtype, suffix)
        split = "_split" if img_size == 480 and hw == 14400 else ""
        if (fwd["name"], bwd["name"]) != (f"gn_relu_fwd{kind}{suffix}",
                                          f"gn_relu_bwd{kind}{split}{suffix}"):
            raise AssertionError(f"RN50 {img_size} px GN shape ({hw}, {c}) "
                                 f"took the routes of {fwd['name']}, "
                                 f"{bwd['name']}")
        over[0] += calls * (fwd["ms"] - fwd["bound_ms"])
        over[1] += calls * (bwd["ms"] - bwd["bound_ms"])
        recs[(hw, c)] = (fwd, bwd)
    print(f"GN{' bf16' if bf16 else ''} over the 49 calls of an RN50 forward "
          f"at {img_size} px, N={STEP_N[img_size]}: forward {over[0]:.4f} ms "
          f"over its bytes bound, backward {over[1]:.4f} ms", flush=True)
    return recs


def gn_split_forward(torch, dev, gen, n, hw, c, dtype, one_pass):
    """Kernel E (the forward split route) forced on one [n, hw, c] slab of
    `dtype` whose plan is the one-pass route (RN50's 480 px stage-1 shapes,
    which kernel D takes), with `fused_gn.split_plan`'s chunks and
    clusters: held to the plain versions as `_gn_held` holds a forward,
    within TOL_GN (bf16: one ulp) of kernel D's y on the same inputs, a
    repeated call bit-equal, and timed beside the plain version and
    PyTorch's group norm. `one_pass` is kernel D's record of the same
    shape (`gn_slab`), whose time is printed beside E's. Returns E's
    record, named "gn_relu_fwd[_bf16]_split_480x{c}"."""
    from dorpatch_tpu_torch.ops import fused_gn as fgn

    import torch.nn.functional as F

    bf16 = dtype == torch.bfloat16
    side = math.isqrt(hw)
    shape = (n, side, side, c)

    def rand(*size):
        return torch.randn(size, generator=gen, device=dev)

    x = (rand(*shape) + 0.5 * rand(c)).to(dtype)
    s, b = 1 + 0.2 * rand(c), 0.3 * rand(c)
    label = f"[{n},{hw},{c}]" + (" bf16" if bf16 else "")
    isz = x.element_size()
    if fgn.gn_plan("fwd", n, hw, c, 32, isz).route != "one_pass":
        raise AssertionError(f"GN {label}: the forward plan is not D's")
    split = fgn.GNPlan("split", *fgn.split_plan("fwd", n, hw, c, 32, isz), 0)
    y, mean, rstd = fgn.gn_relu_fwd_kernel(x, s, b, plan=split)
    y1, m1, r1 = fgn.gn_relu_fwd_kernel(x, s, b)
    torch.cuda.synchronize()
    again = fgn.gn_relu_fwd_kernel(x, s, b, plan=split)
    if not all(torch.equal(p, q) for p, q in zip(again, (y, mean, rstd))):
        raise AssertionError(f"GN {label} split forward does not repeat")
    del again
    out = dict(fwd=0.0, stat=0.0, bad=0, fwd16=0.0, stat16=0.0, bad16=0)
    step = _gn_step(x)
    for i in range(0, n, step):
        _gn_fwd_held(torch, x, s, b, y, mean, rstd, slice(i, i + step), out)
    out["bad16"] += int(not out["stat16"] <= 1e-5)
    d_err = float((y.float() - y1.float()).abs().max())
    tol = _ulp16(torch, y1) if bf16 else TOL_GN["rtol"] * y1.float().abs()
    d_bad = int((~((y.float() - y1.float()).abs()
                   <= tol + TOL_GN["atol"])).sum())
    del y1, m1, r1
    print(f"GN {label} forward on the split route (kernel E, width "
          f"{split.width}, cluster {split.cluster}): vs float64 max_abs_err "
          f"{out['fwd']:.3g}, stats err {out['stat']:.3g}; "
          + (f"vs plain bf16 {out['fwd16']:.3g}, stats {out['stat16']:.3g}; "
             if bf16 else "")
          + f"vs kernel D {d_err:.3g} ({out['bad']} + {out['bad16']} + "
          f"{d_bad} out); repeats bit for bit", flush=True)
    if out["bad"] or out["bad16"] or d_bad:
        raise AssertionError(f"GN {label} split forward out of tolerance")
    ms = _device_ms(lambda: fgn.gn_relu_fwd_kernel(x, s, b, plan=split), 5, 7)
    plain = _device_ms(lambda: fgn.gn_relu_reference(x, s, b), 5, 7)
    xv = x.permute(0, 3, 1, 2)
    sl, bl = s.to(dtype), b.to(dtype)
    lib = _device_ms(lambda: F.group_norm(xv, 32, sl, bl, 1e-5), 5, 7)
    bound = one_pass["bound_ms"]
    print(f"GN {label}: kernel E {ms * 1e3:.2f} us, kernel D (its plan) "
          f"{one_pass['ms'] * 1e3:.2f} us, bound {bound * 1e3:.2f} us, "
          f"split 3-pass floor {1.5 * bound * 1e3:.2f} us, plain "
          f"{plain * 1e3:.2f} us, library {lib * 1e3:.2f} us", flush=True)
    del x, xv, y
    torch.cuda.empty_cache()
    return dict(
        name=f"gn_relu_fwd{'_bf16' if bf16 else ''}_split_480x{c}",
        route="cuda", source="dorpatch_tpu_torch/csrc/fused_gn.cu",
        replaces="dorpatch_tpu/ops/fused_gn.py:159", launches=0,
        max_abs_err=max(out["fwd16"], out["stat16"]) if bf16
        else max(out["fwd"], out["stat"]),
        ms=ms, plain_ms=plain, bound_ms=bound, bound_by=one_pass["bound_by"],
        library_ms=lib)


def gn_split_480(torch, dev, gen, at480, dtype=None):
    """Kernel E forced at RN50's three 480 px stage-1 shapes (N = 128),
    beside kernel D's records of them (`gn_sweep`'s `at480`)."""
    from dorpatch_tpu_torch.gn_bench import STEP_N

    dtype = dtype or torch.float32
    return [gn_split_forward(torch, dev, gen, STEP_N[480], hw, c, dtype,
                             at480[(hw, c)][0])
            for hw, c in sorted(at480) if hw == 14400]


def gn_phases(torch, dev):
    """The GroupNorm+ReLU kernels at every (HW, C) of the RN50 victim at
    224 (N = 256, the attack step's 2 images x 128 masks; one-pass route),
    at GN_SPLIT_SLAB on the split route, and at every (HW, C) at 480 (N =
    128; the stage-1 backward split), with kernel E forced at the three
    480 stage-1 shapes (`gn_split_480`). Returns the records of the
    largest 224 slab [256, 3136, 256], and those of the split slab, of the
    widest 480 slab GN_480_SLAB and of E at 480."""
    gen = torch.Generator(device=dev).manual_seed(3)
    at224 = gn_sweep(torch, dev, gen, 224)
    split = gn_slab(torch, dev, gen, *GN_SPLIT_SLAB)
    if [r["name"] for r in split] != ["gn_relu_fwd_split",
                                      "gn_relu_bwd_split"]:
        raise AssertionError(f"GN slab {GN_SPLIT_SLAB} did not take the "
                             "split route")
    at480 = gn_sweep(torch, dev, gen, 480)
    return (list(at224[(3136, 256)]), split + list(at480[GN_480_SLAB[1:]])
            + gn_split_480(torch, dev, gen, at480))


def gn_phases_bf16(torch, dev):
    """Kernels D-G in bf16: D and F at RN50's largest slab at 224 and its
    widest, at the attack step's N = 256; E and G at GN_SPLIT_SLAB; and
    every (HW, C) at 480 (D, over clusters of 8 at stage 1, and F or G),
    and E forced at the 480 stage-1 shapes. Returns the 224 records, and
    those of the split slab, of GN_480_SLAB and of E at 480."""
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    at224 = (gn_slab(torch, dev, gen, GN_N, 3136, 256, 3, bf)
             + gn_slab(torch, dev, gen, GN_N, 49, 2048, 3, bf, "_49x2048"))
    split = gn_slab(torch, dev, gen, *GN_SPLIT_SLAB, dtype=bf)
    names = [r["name"] for r in at224 + split]
    if names != ["gn_relu_fwd_bf16", "gn_relu_bwd_bf16",
                 "gn_relu_fwd_bf16_49x2048", "gn_relu_bwd_bf16_49x2048",
                 "gn_relu_fwd_bf16_split", "gn_relu_bwd_bf16_split"]:
        raise AssertionError(f"GN bf16 slabs took the routes of {names}")
    at480 = gn_sweep(torch, dev, gen, 480, bf)
    return at224, (split + list(at480[GN_480_SLAB[1:]])
                   + gn_split_480(torch, dev, gen, at480, bf))


def attn_phase(torch, dev, dtype=None, images=None, suffix=""):
    """Kernel H at the ViT-B/16 token engine's two shapes of the 0.12
    radius (2 images, or `images`; T+1 = 197 tokens, 12 heads of 64;
    `attn_bench.SHAPES`): the phase-1 chunk (all 36 first-round masks) and
    the first pair-audit chunk (64 of the 630 pairs). The biases are the
    engine's own: the stale clean columns of the masks' token sets and the
    duplicate dirty slots of their padding. Held against the plain version
    in float64 and timed beside the plain f32 version and
    `F.scaled_dot_product_attention` over the concatenated clean and dirty
    keys with the biases as its mask. With
    `dtype` bfloat16, H's bf16 form on the same inputs rounded to bf16:
    against its plain version on them within one ulp of the output plus
    2^-8 of the largest |v| (the kernel rounds the weights to bf16 for
    P.V), within the JAX package's 0.06 of the float32 plain version on
    the float32 inputs, timed beside the plain bf16 version and bf16
    SDPA; its bound is one bf16 product at 989 TFLOP/s."""
    import numpy as np

    import torch.nn.functional as F

    from dorpatch_tpu_torch import attn_bench
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    bf16 = dtype == torch.bfloat16
    rng = np.random.default_rng(6 if bf16 else 4)
    tag = "_bf16" if bf16 else ""
    recs = []
    for name, (_, kind, c) in zip(("masked_kv_attn" + tag + suffix,
                                   "masked_kv_attn" + tag + "_pairs"
                                   + suffix),
                                  attn_bench.SHAPES):
        args32 = attn_bench.engine_case(torch, dev, kind, c, rng,
                                        images or attn_bench.B)
        b, c, s, h, f = args32[0].shape
        t1 = args32[3].shape[1]
        args = tuple(a.bfloat16() for a in args32) if bf16 else args32
        got = mka.masked_kv_attention_kernel(*args)
        torch.cuda.synchronize()
        err32 = float((got.float() - mka.masked_kv_attention_reference(
            *args32)).abs().max())
        if bf16:
            want = mka.masked_kv_attention_reference(*args)
            vmax = max(float(args32[2].abs().max()),
                       float(args32[4].abs().max()))
            e = (got.float() - want.float()).abs()
            bad = int((e > _ulp16(torch, want) + 2.0 ** -8 * vmax).sum())
            err = float(e.max())
            del e
            if bad or err32 > 0.06:
                raise AssertionError(f"kernel H ({name}): {bad} elements out "
                                     f"of tolerance (max {err}), {err32} "
                                     "from float32")
            tol = (f"vs plain bf16 (1 ulp + 2^-8 x {vmax:.3g}), {err32:.3g} "
                   f"vs float32 plain (bar 0.06)")
        else:
            want = mka.masked_kv_attention_reference(
                *(a.double() for a in args))
            err = float((got.double() - want).abs().max())
            torch.testing.assert_close(got.double(), want, **TOL_H)
            tol = (f"vs float64 plain (rtol {TOL_H['rtol']}, atol "
                   f"{TOL_H['atol']}), {err32:.3g} vs f32 plain")
        if not torch.equal(mka.masked_kv_attention_kernel(*args), got):
            raise AssertionError(f"kernel H ({name}) does not repeat bit for "
                                 "bit")
        del want
        # the library yardstick: one SDPA call over [B*C, H, T+1+S, f]
        # keys and values, concatenated outside the timing
        qs, ks, vs, mask = attn_bench.sdpa_inputs(torch, args)
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                 scale=1.0)
        lib_err = float((lib_out.float() - got.permute(0, 1, 3, 2, 4)
                         .reshape(b * c, h, s, f).float()).abs().max())
        ms = _device_ms(lambda: mka.masked_kv_attention_kernel(*args))
        plain = _device_ms(lambda: mka.masked_kv_attention_reference(*args))
        lib = _device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=1.0))
        bound, by, nbytes, flops = attn_bench.bound(args)
        ffma_bound, _ = _bound(0.0, flops)
        products = (f"{flops / 1e9:.3f} GFLOP in bf16 at "
                    f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s" if bf16 else
                    f"{flops / 1e9:.3f} GFLOP x 3 TF32 products at "
                    f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = (f"; {mka.bf16_plan(b, c, s, h, t1, f, sms)}" if bf16
                else "")
        print(f"kernel H {name} [B={b},C={c},S={s},H={h},f={f},T+1={t1}]: "
              f"max_abs_err {err:.3g} {tol}, {lib_err:.3g} vs SDPA; "
              f"{ms * 1e3:.2f} us (plain {plain * 1e3:.2f} us, SDPA "
              f"{lib * 1e3:.2f} us, {lib / ms:.2f}x the kernel's time; bound "
              f"{bound * 1e3:.2f} us by {by}: {products}, {nbytes / 1e6:.1f} "
              f"MB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; FFMA operations "
              f"bound {ffma_bound * 1e3:.2f} us){plan}", flush=True)
        recs.append(dict(name=name, route="cuda",
                         source="dorpatch_tpu_torch/csrc/masked_kv_attn.cu",
                         replaces="dorpatch_tpu/ops/masked_kv_attn.py:56",
                         launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by, library_ms=lib))
        del args, args32, got, qs, ks, vs, lib_out
        torch.cuda.empty_cache()
    return recs


def attn_classes(routes, kernel, size=224, patch=16):
    """Kernel H's launches on one ViT main path by shape class, from its
    launches by dirty rows S (`ops.route_counts`, "kernel/S<S>") and the S
    of each default radius's singles and pairs tables: (phase-1 chunks,
    pair audits and second-round rows (the rows program takes the combined
    table, whose S is the pairs'), launches by S). A launch at an S of
    neither raises."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.config import DEFAULT_RATIOS
    from dorpatch_tpu_torch.models import vit

    single, pair = set(), set()
    for r in DEFAULT_RATIOS:
        singles, doubles = masks_lib.mask_sets(masks_lib.geometry(size, r))
        single.add(vit.build_tables(singles, size, patch).idx.shape[1])
        pair.add(vit.build_tables(doubles, size, patch).idx.shape[1])
    by_s = {int(k.rsplit("/S", 1)[1]): v for k, v in routes.items()
            if k.startswith(kernel + "/S")}
    if set(by_s) - single - pair or single & pair:
        raise AssertionError(f"{kernel} launched at dirty rows {by_s}, the "
                             f"tables have {sorted(single)} (singles) and "
                             f"{sorted(pair)} (pairs)")
    return (sum(by_s.get(s, 0) for s in single),
            sum(by_s.get(s, 0) for s in pair), dict(sorted(by_s.items())))


def gn_split_shares(img_size):
    """{GroupNorm kernel count: the share of its launches that take the
    split route} for the RN50 victim at `img_size`: the calls per forward
    (`gn_bench.rn50_gn_calls`) whose shape `fused_gn.gn_plan` sends to the
    split route, over all 49 (the plan does not depend on N)."""
    from fractions import Fraction

    from dorpatch_tpu_torch.gn_bench import rn50_gn_calls
    from dorpatch_tpu_torch.ops import fused_gn as fgn

    calls = rn50_gn_calls(img_size)
    total = sum(calls.values())
    return {f"gn_relu_{d}{kind}": Fraction(sum(
        n for (hw, c), n in calls.items()
        if fgn.gn_plan(d, 1, hw, c, 32, isz).route == "split"), total)
        for d in ("fwd", "bwd") for kind, isz in (("", 4), ("_bf16", 2))}


def _span_seconds(result_dir, name):
    """Summed `dur_s` of the `name` spans in a results dir's events.jsonl."""
    total = 0.0
    with open(os.path.join(result_dir, "events.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("kind") == "span" and rec.get("name") == name:
                total += rec["dur_s"]
    return total


#: each main path's saved patch (mask, pattern) of batch 0, by label
PATCHES = {}


def main_path(torch, dev, label, argv, required, shares=None,
              audit_fill=None, trained=False, edit=None, inspect=None):
    """One main path through the CLI entry point, with the launch counts
    set to 0 just before and read just after; every kernel in `required`
    must have launched. Of each GroupNorm kernel's launches, the share in
    `shares` (`gn_split_shares`; 0 where absent) must have taken the split
    route (so more than 0 of a kernel that launched with a share above 0)
    and the rest the one-pass route.
    Prints the seconds, forwards, escalations, the certification's
    schedule (images that ran the pair audit, minority rows) and the peak
    of device memory. `audit_fill` names the kernel that fills the pair
    audits' images and nothing else on the path (A's bf16 form in the bf16
    bank of a conv victim): it must have launched exactly when a pair audit
    was scheduled. A `trained` path must load its victim from the
    checkpoint (`get_model` draws random weights without one), evaluate the
    attack's stage switch and draw masks from the failure set; it prints
    both. `edit` maps the parsed config (e.g. to another `stream_depth`);
    `inspect` is called with the results dir before it is removed.
    Prints the seconds the run's `data` spans took (the input path), and
    keeps the patch of batch 0 in `PATCHES[label]`. Returns (metrics,
    launch and route counts of the run, the first batch's certification
    records: per image, one per radius)."""
    from dorpatch_tpu_torch import attack, defense, ops, pipeline
    from dorpatch_tpu_torch.artifacts import ArtifactStore, results_path
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.pipeline import run_experiment

    shares = shares or {}
    sched = dict(pair_audits=0, rows=0)
    seen = dict(victims=[], switches=0, fail_draws=[])
    plain = (defense.schedule_round2, pipeline.get_model,
             attack.majority_incorrect_label, attack.DorPatch._sample_indices)

    def schedule(*args, **kwargs):
        need_pairs, row_list = plain[0](*args, **kwargs)
        sched["pair_audits"] += int(need_pairs.sum())
        sched["rows"] += len(row_list)
        return need_pairs, row_list

    def get_model(*args, **kwargs):
        seen["victims"].append(plain[1](*args, **kwargs))
        return seen["victims"][-1]

    def majority(*args, **kwargs):
        seen["switches"] += 1
        return plain[2](*args, **kwargs)

    def sample(self, gen, failed, step):
        idx, from_fail = plain[3](self, gen, failed, step)
        seen["fail_draws"].append(from_fail.sum())
        return idx, from_fail

    def hook(fns):
        (defense.schedule_round2, pipeline.get_model,
         attack.majority_incorrect_label,
         attack.DorPatch._sample_indices) = fns

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        cfg = config_from_args(build_parser().parse_args(
            argv + ["--results-root", root]))
        if edit is not None:
            cfg = edit(cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        hook((schedule, get_model, majority, sample) if trained
             else (schedule,) + plain[1:])
        try:
            t0 = time.perf_counter()
            m = run_experiment(cfg, verbose=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            hook(plain)
        counts = ops.launch_counts()
        routes = ops.route_counts()
        store = ArtifactStore(results_path(cfg))
        records = store.load_pc_records(0)
        PATCHES[label] = store.load_patch(0)
        data_s = _span_seconds(store.result_dir, "data")
        if inspect is not None:
            inspect(store.result_dir)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} main path: {wall:.2f} s wall; attack seconds "
          f"{m.get('attack_seconds')}; certify seconds "
          f"{m.get('certify_seconds')}; forwards {m.get('forwards')} of "
          f"{m.get('forwards_exhaustive')} exhaustive, forward equivalents "
          f"{m.get('forward_equivalents')}, escalated (image, radius) "
          f"records {m.get('escalated')}; certification schedule over the "
          f"radii: {sched['pair_audits']} pair audits (images), "
          f"{sched['rows']} minority rows; peak device memory {peak:.2f} "
          f"GiB; data spans {data_s:.4f} s (stream depth "
          f"{cfg.stream_depth}); launches {counts}; routes and shape "
          f"classes {routes}", flush=True)
    for name in required:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} main path")
    if trained:
        loaded = [v.from_checkpoint for v in seen["victims"]]
        draws = int(sum(int(d) for d in seen["fail_draws"]))
        print(f"{label}: victim from checkpoint {loaded}; stage switch "
              f"evaluated {seen['switches']} times; {draws} masks drawn "
              f"from the failure set over {len(seen['fail_draws'])} steps",
              flush=True)
        if loaded != [True] or not seen["switches"] or not draws:
            raise AssertionError(f"{label} main path: from checkpoint "
                                 f"{loaded}, stage switch evaluated "
                                 f"{seen['switches']} times, {draws} "
                                 f"failure-set draws")
    if audit_fill and (counts[audit_fill] > 0) != (sched["pair_audits"] > 0):
        raise AssertionError(f"{label} main path: {audit_fill} launched "
                             f"{counts[audit_fill]} times for "
                             f"{sched['pair_audits']} pair audits")
    for name in GN_KERNELS:
        one = routes.get(f"{name}/one_pass", 0)
        two = routes.get(f"{name}/split", 0)
        share = shares.get(name, 0)
        if not (one + two == counts[name] and two == share * counts[name]):
            raise AssertionError(f"{label} main path: {name} took routes "
                                 f"{routes}, launches {counts[name]}, split "
                                 f"share wanted {share}")
    vals = ([m["clean_accuracy"], m["robust_accuracy"]] + m["acc_pc"]
            + m["certified_acc_pc"] + m["certified_asr_pc"])
    if (m["evaluated_images"] < 1 or len(m["acc_pc"]) != 4
            or not all(math.isfinite(v) for v in vals)):
        raise AssertionError(f"malformed {label} main-path metrics: {m}")
    return m, {**counts, **routes}, records


def trained_victim(dataset, arch, model_dir, size, dev):
    """The victim random from seed 0 (`model_dir` None), or loaded from the
    checkpoint in `model_dir`, which must hold one."""
    from dorpatch_tpu_torch.models import get_model

    victim = get_model(dataset, arch, model_dir or "/nonexistent", size,
                       seed=0, device=dev)
    if bool(model_dir) != victim.from_checkpoint:
        raise AssertionError(f"{arch}: from_checkpoint "
                             f"{victim.from_checkpoint} with model_dir "
                             f"{model_dir}")
    return victim


def cross_check(torch, dev, dataset, arch, size, b, model_dir=None,
                source="synthetic"):
    """One radius certified both ways on the card: the stem fold (kernel C)
    and full masked forwards (kernel A) give the same first-round table
    wherever both top-2 margins exceed 1e-3. The victim is random from the
    seed, or the one trained into `model_dir` (`trained_victim`), on the
    first batch of the `source` stream. Returns the victim and the
    images."""
    from dorpatch_tpu_torch import data
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry

    victim = trained_victim(dataset, arch, model_dir, size, dev)
    x_np, _ = next(data.dataset_batches(dataset, b, size, 1234,
                                        source=source))
    x = torch.as_tensor(x_np, device=dev)
    pc = PatchCleanser(victim.apply, geometry(size, 0.12), DefenseConfig(),
                       incremental_engine=victim.incremental, device=dev)
    with torch.no_grad():
        p_stem, m_stem = pc._phase1_incr(x)
        p_off, m_off = pc._phase1(x, with_margins=True)
    sure = torch.minimum(m_stem, m_off) > 1e-3
    bad = int(((p_stem != p_off) & sure).sum())
    n_sure = int(sure.sum())
    rec_stem = pc.robust_predict(x, victim.num_classes, incremental="stem")
    rec_off = pc.robust_predict(x, victim.num_classes, incremental="off")
    same = sum((a.prediction, a.certification) == (b.prediction,
                                                   b.certification)
               for a, b in zip(rec_stem, rec_off))
    print(f"cross-check {arch} {size}px r=0.12"
          f"{' (trained)' if model_dir else ''}: preds_1 stem vs off: {bad} "
          f"disagreements among {n_sure} of {sure.numel()} entries with "
          f"margin > 1e-3 (largest margin gap "
          f"{float((m_stem - m_off).abs().max()):.3g}); verdicts equal for "
          f"{same}/{len(rec_stem)} images", flush=True)
    if bad:
        raise AssertionError(f"stem-fold and full-forward first-round tables "
                             f"disagree on {bad} confident entries")
    return victim, x


def gn_logits_check(torch, dev, victim, x):
    """The RN50 victim's logits with the GroupNorm kernels against its plain
    GroupNorm on the card, on the images and their 36 single-masked copies
    of the 0.12 radius: argmax equal wherever the top-2 margin exceeds
    1e-3."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch import ops, utils
    from dorpatch_tpu_torch.ops import masked_fill as mf

    singles, _ = masks_lib.mask_sets(masks_lib.geometry(x.shape[1], 0.12))
    with torch.no_grad():
        xs = torch.cat([x, mf.masked_fill(x, singles, 0.5).reshape(
            (-1,) + tuple(x.shape[1:]))])
        ops.reset_launch_counts()
        got = victim.apply(xs)
        launched = ops.launch_counts()["gn_relu_fwd"]
        victim.model.set_gn_impl("plain")
        try:
            want = victim.apply(xs)
        finally:
            victim.model.set_gn_impl("auto")
    p_got, m_got = utils.preds_margins(got)
    p_want, m_want = utils.preds_margins(want)
    sure = torch.minimum(m_got, m_want) > 1e-3
    bad = int(((p_got != p_want) & sure).sum())
    print(f"RN50 logits, GN kernels ({launched} forward launches) vs plain "
          f"GroupNorm on {xs.shape[0]} images: max_abs_err "
          f"{float((got - want).abs().max()):.3g}; {bad} argmax "
          f"disagreements among {int(sure.sum())} with margin > 1e-3; "
          f"{len(set(p_want.tolist()))} distinct classes", flush=True)
    if bad or launched != 49:
        raise AssertionError(f"GN kernel logits: {bad} confident argmax "
                             f"disagreements, {launched} launches (want 49)")


def vit_cross_check(torch, dev, b, lift, dataset="imagenet", arch="vit",
                    size=224, model_dir=None, source="synthetic",
                    strict=True):
    """The ViT-B/16 victim at 224 (or `arch` at `size`, random or trained
    into `model_dir`, on the first batch of `source`) and the 0.12 radius on
    the card, with its head bias of class 0 raised by `lift` (a random
    victim's top-2 margins
    are mostly below `incremental_margin`, so unlifted nearly every image
    escalates; the lift widens the margins without changing the engine's
    logit drift, a difference of logits):
    - the token engine's first-round logits with kernel H against the same
      engine with the plain attention: within TOL_H_LOGITS, argmax equal
      wherever the margin exceeds 1e-3;
    - its first-round predictions against full masked forwards (kernel A):
      equal wherever both margins exceed `incremental_margin`;
    - "token-exact" certification gives every image the (prediction,
      certification) of incremental="off"; prints how many images
      escalated and the largest logit gap to the full forwards over the
      images that did not. Not `strict`: the engine's contract as it
      states it, verdicts equal wherever its drift stays below
      `incremental_margin`: an image may differ only where its
      first-round logits drift from the full forwards' by at least the
      margin (printed per image).
    Returns the images whose first-round drift reaches the margin."""
    from dorpatch_tpu_torch import data, ops, utils
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry, mask_sets
    from dorpatch_tpu_torch.models import vit
    from dorpatch_tpu_torch.ops import masked_fill as mf
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    cfg = DefenseConfig()
    victim = trained_victim(dataset, arch, model_dir, size, dev)
    victim.model.head.bias[0] += lift
    x_np, _ = next(data.dataset_batches(dataset, b, size, 1234,
                                        source=source))
    x = torch.as_tensor(x_np, device=dev)
    pc = PatchCleanser(victim.apply, geometry(size, 0.12), cfg,
                       incremental_engine=victim.incremental, device=dev)
    eng, table = victim.incremental, pc._incr_family.first
    singles, _ = mask_sets(pc.spec)
    m = singles.shape[0]

    def per_image(t):
        return t[None].expand((b,) + t.shape)

    with torch.no_grad():
        patches, cls0, kcs, vcs = eng._clean(x)

        def first_round():
            return eng._chunk(patches, cls0, kcs, vcs, per_image(table.idx),
                              per_image(table.keep),
                              per_image(table.slot_bias), cfg.mask_fill)

        ops.reset_launch_counts()
        lg_tok = first_round()
        launched = ops.launch_counts()["masked_kv_attn"]
        # the same engine with the plain attention on the card, for this
        # comparison only
        vit.masked_kv_attention = mka.masked_kv_attention_reference
        try:
            lg_plain = first_round()
        finally:
            vit.masked_kv_attention = mka.masked_kv_attention
        xm = mf.masked_fill(x, torch.as_tensor(singles, device=dev),
                            cfg.mask_fill)
        lg_full = victim.apply(xm.reshape(-1, size, size, 3)).reshape(
            b, m, -1)
    p_tok, m_tok = utils.preds_margins(lg_tok)
    p_plain, m_plain = utils.preds_margins(lg_plain)
    p_full, m_full = utils.preds_margins(lg_full)
    kern_err = float((lg_tok - lg_plain).abs().max())
    kern_bad = int(((p_tok != p_plain)
                    & (torch.minimum(m_tok, m_plain) > 1e-3)).sum())
    sure = torch.minimum(m_tok, m_full) > cfg.incremental_margin
    full_bad = int(((p_tok != p_full) & sure).sum())

    rec_tok = pc.robust_predict(x, victim.num_classes,
                                incremental="token-exact")
    esc = pc.last_min_margin < cfg.incremental_margin
    margins = [round(float(v), 4) for v in pc.last_min_margin]
    rec_off = pc.robust_predict(x, victim.num_classes, incremental="off")
    differ = [i for i, (a, o) in enumerate(zip(rec_tok, rec_off))
              if (a.prediction, a.certification)
              != (o.prediction, o.certification)]
    kept = torch.as_tensor(~esc, device=dev)
    gap = (float((lg_tok - lg_full)[kept].abs().max()) if bool(kept.any())
           else None)
    drift = (lg_tok - lg_full).abs().amax(dim=(1, 2)).tolist()
    drifting = {i for i, d in enumerate(drift)
                if d >= cfg.incremental_margin}
    unexplained = [i for i in differ if strict or i not in drifting]
    print(f"{arch} cross-check {size}px r=0.12"
          f"{' (trained)' if model_dir else ''}, class-0 bias +{lift}: "
          f"kernel H vs "
          f"plain-attention engine logits max_abs_err {kern_err:.3g} "
          f"(atol {TOL_H_LOGITS}; {launched} launches), {kern_bad} argmax "
          f"disagreements with margin > 1e-3; token vs full forwards: "
          f"{full_bad} disagreements among {int(sure.sum())} of "
          f"{sure.numel()} first-round entries with both margins > "
          f"{cfg.incremental_margin}; escalated {int(esc.sum())} of {b} "
          f"images (min margins {margins}); largest token-vs-full logit "
          f"gap over the images not escalated {gap} (per image "
          f"{[round(d, 4) for d in drift]}); verdicts token-exact vs off "
          f"differ for images {differ}", flush=True)
    if kern_err > TOL_H_LOGITS or kern_bad or launched != eng.module.depth:
        raise AssertionError(f"kernel H engine logits: max_abs_err "
                             f"{kern_err}, {kern_bad} confident argmax "
                             f"disagreements, {launched} launches")
    if full_bad or unexplained:
        raise AssertionError(f"token engine vs full forwards: {full_bad} "
                             f"confident first-round disagreements, "
                             f"verdicts differ for images {differ} (drift "
                             f"at the margin: {sorted(drifting)})")
    return drifting


def consensus_check(label, exact, consensus) -> None:
    """The consensus run's records against the "exact" run's, image by
    image and radius by radius (the attack repeats bit for bit, so both
    certify the same patched images): the same prediction, certified
    wherever "exact" certifies, and at most its forwards."""
    pairs = [(e, c) for er, cr in zip(exact, consensus)
             for e, c in zip(er, cr)]
    bad = [i for i, (e, c) in enumerate(pairs)
           if e.prediction != c.prediction
           or (e.certification and not c.certification)
           or c.forwards > e.forwards]
    print(f"{label}: consensus vs exact over {len(pairs)} (image, radius) "
          f"records: forwards {sum(c.forwards for _, c in pairs)} vs "
          f"{sum(e.forwards for e, _ in pairs)}, certified "
          f"{sum(c.certification for _, c in pairs)} vs "
          f"{sum(e.certification for e, _ in pairs)}, round-1 stops "
          f"{sum(c.forwards == len(c.preds_1) for _, c in pairs)}; records "
          f"out of contract {bad}", flush=True)
    if bad or len(exact) != len(consensus) or not pairs:
        raise AssertionError(f"{label}: consensus records {bad} break the "
                             f"contract against exact")


def write_cifar_disk(torch, dev, root, n=8, seed=1234):
    """A CIFAR-10 `test_batch` pickle of `n` seeded random images under
    `root/cifar10/cifar-10-batches-py`, labelled with the CIFAR path's
    seeded victim's own predictions on the disk source's transform (so
    every image passes the correctness filter)."""
    import os
    import pickle

    import numpy as np

    from dorpatch_tpu_torch import data
    from dorpatch_tpu_torch.models import get_model

    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8)
    imgs = flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = np.stack([data._pil_resize_center_crop(im, 32) for im in imgs])
    victim = get_model("cifar10", "resnet18", "pretrained_models/", 32,
                       device=dev)
    with torch.no_grad():
        labels = victim.apply(torch.as_tensor(x, device=dev)).argmax(-1)
    base = os.path.join(root, "cifar10", "cifar-10-batches-py")
    os.makedirs(base)
    with open(os.path.join(base, "test_batch"), "wb") as f:
        pickle.dump({b"data": flat, b"labels": labels.cpu().tolist()}, f)


def mixer_cross_check(torch, dev, b, lift, layerscale=None, gate=True):
    """The ResMLP-24 victim at 224 and the 0.12 radius on the card, its head
    bias of class 0 raised by `lift` and, with `layerscale`, every block's
    ls1 and ls2 set to it:
    - the mixer engine's first-round predictions against full masked
      forwards (kernel A), where both margins exceed `incremental_margin`;
    - "mixer-exact" certification, float32 and in the bf16 bank, against
      incremental="off" in float32: every image's (prediction,
      certification).
    With `gate` any disagreement fails; without it (the victim as the main
    path builds it, at the JAX package's layerscale init of 1) they are
    printed as measured."""
    from dorpatch_tpu_torch import data
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry
    from dorpatch_tpu_torch.models import get_model

    size, cfg = 224, DefenseConfig()
    victim = get_model("imagenet", "resmlp", "/nonexistent", size, seed=0,
                       device=dev)
    with torch.no_grad():
        victim.model.head.bias[0] += lift
        if layerscale is not None:
            for block in victim.model.blocks:
                block.ls1.fill_(layerscale)
                block.ls2.fill_(layerscale)
    x_np, _ = next(data.synthetic_batches("imagenet", b, size, 1234))
    x = torch.as_tensor(x_np, device=dev)
    spec = geometry(size, 0.12)
    pc = PatchCleanser(victim.apply, spec, cfg,
                       incremental_engine=victim.incremental, device=dev)
    with torch.no_grad():
        p_mix, m_mix = pc._phase1_incr(x)
        p_full, m_full = pc._phase1(x, with_margins=True)
    sure = torch.minimum(m_mix, m_full) > cfg.incremental_margin
    full_bad = int(((p_mix != p_full) & sure).sum())
    rec_mix = pc.robust_predict(x, victim.num_classes)
    esc = int((pc.last_min_margin < cfg.incremental_margin).sum())
    rec_off = pc.robust_predict(x, victim.num_classes, incremental="off")
    pc16 = PatchCleanser(victim.apply, spec,
                         DefenseConfig(compute_dtype="bfloat16"),
                         incremental_engine=victim.incremental, device=dev)
    rec16 = pc16.robust_predict(x, victim.num_classes)
    esc16 = int((pc16.last_min_margin < cfg.incremental_margin).sum())

    def differ(recs):
        return [i for i, (a, o) in enumerate(zip(recs, rec_off))
                if (a.prediction, a.certification)
                != (o.prediction, o.certification)]

    d32, d16 = differ(rec_mix), differ(rec16)
    ls = "the JAX init (1)" if layerscale is None else layerscale
    print(f"ResMLP cross-check 224px r=0.12, layerscales {ls}, class-0 bias "
          f"+{lift}: mixer vs full forwards {full_bad} first-round "
          f"disagreements among {int(sure.sum())} of {sure.numel()} entries "
          f"with both margins > {cfg.incremental_margin} (margins "
          f"{float(m_full.min()):.4g}..{float(m_full.max()):.4g}; largest "
          f"margin gap {float((m_mix - m_full).abs().max()):.4g});"
          f" escalated {esc} (bf16 bank {esc16}) of {b} images; verdicts "
          f"mixer-exact vs off differ for images {d32}, bf16 bank vs off "
          f"{d16}; forwards {[r.forwards for r in rec_mix]} / bf16 "
          f"{[r.forwards for r in rec16]}" + ("" if gate else
                                              " (measured, not gated)"),
          flush=True)
    if gate and (full_bad or d32 or d16):
        raise AssertionError(f"mixer engine vs full forwards: {full_bad} "
                             f"confident first-round disagreements, "
                             f"verdicts differ for images {d32} (f32), "
                             f"{d16} (bf16 bank)")
    return full_bad, d32, d16


def fill_overhead(counts, records) -> None:
    """Launches of A and B on each main path in `records` and launches x
    (time - bound) at the path's image shape (`records[label]`: the A and
    B records at that shape)."""
    parts = []
    for label, recs in records.items():
        for rec in recs:
            kernel = COUNT_OF.get(rec["name"], rec["name"])
            n = counts[label][kernel]
            parts.append(f"{label} {kernel} {n} x ({rec['ms']:.5f} - "
                         f"{rec['bound_ms']:.5f}) = "
                         f"{n * (rec['ms'] - rec['bound_ms']):.3f} ms")
    print("A/B launches x (time - bound): " + "; ".join(parts), flush=True)


def repeat_check(torch, dev, steps: int = 5,
                 compute_dtype: str = "float32") -> None:
    """Under `utils.configure_numerics`, on the RN50 main path's victim
    (ResNetV2-50x1 at 224, 2 images, sampling size 128, dropout 2) at the
    attack's `compute_dtype`: the logits and input gradient of one masked
    batch, `repeat.TRIALS` times, must all equal the first call's; the
    attack's first `steps` stage-0 steps, twice from one seed, must give
    bit-equal patches and step metrics."""
    from dorpatch_tpu_torch import data, repeat
    from dorpatch_tpu_torch.models import get_model

    spec = repeat.VICTIMS["resnetv2"]
    victim = get_model(spec.dataset, "resnetv2", "/nonexistent",
                       spec.img_size, device=dev)
    x_np, _ = next(data.synthetic_batches(spec.dataset, spec.batch,
                                          spec.img_size, repeat.SEED))
    x = torch.as_tensor(x_np, device=dev)
    grads = repeat.victim_repeat(victim, x, f"repeat: RN50 victim, "
                                 f"{compute_dtype}", repeat.TRIALS,
                                 compute_dtype)
    if grads["logits_differing"] or grads["input_grad_differing"]:
        raise AssertionError(f"the RN50 victim's gradient does not repeat: "
                             f"{grads}")
    runs = [repeat.attack_steps(victim, x, steps,
                                compute_dtype=compute_dtype)
            for _ in range(2)]
    rec = repeat.compare(f"repeat: RN50 attack, {compute_dtype}, {steps} "
                         f"steps twice from seed {repeat.SEED}", *runs)
    if rec["first_step"] is not None:
        raise AssertionError(f"the RN50 attack does not repeat: {rec}")



# ------------------------------------------------------------- bf16 forms
#
# Each bf16 kernel against its plain version in bf16 on the same inputs, in
# bf16 ulps (`_ulp16`: the spacing of bf16 numbers at |x|, 8 significant
# bits), and timed beside the plain bf16 version and a bf16 library call;
# bounds at 2 bytes an element and, for products, the bf16 tensor-core rate.


def _ulp16(torch, x):
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def fill_phase_bf16(torch, dev, b, size, suffix="", dtype=None):
    """Kernel A's bf16 form (the bf16 bank's fill) at one path's image
    shape: exact against its plain version at the bank's phase-1 chunk
    (S = 36) and pair-audit chunk (S = 63), timed at S = 63. With `dtype`
    float32, kernel A itself the same way (the serve paths' pair audits)."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.fill_bench import fill_inputs
    from dorpatch_tpu_torch.ops import masked_fill as mf

    dtype = dtype or torch.bfloat16
    item = 2 if dtype == torch.bfloat16 else 4
    form = "bf16" if item == 2 else "float32"
    fill = 0.5
    for s in (36, 63):
        imgs, rects, _ = fill_inputs(torch, dev, b, size, s, seed=s)
        imgs = imgs.to(dtype)
        got = mf.masked_fill_fwd_kernel(imgs, rects, fill)
        want = mf.masked_fill_reference(imgs, rects, fill)
        torch.cuda.synchronize()
        if got.dtype != dtype or not torch.equal(got, want):
            raise AssertionError(f"kernel A ({form}) differs from its plain "
                                 f"version at [B={b},S={s},{size}px]")
    err = float((got.float() - want.float()).abs().max())
    del got, want
    keep = masks_lib.rasterize(rects, size)[None, :, :, :, None]
    s, k = rects.shape[0], rects.shape[1]
    hwc = size * size * 3
    ms = _device_ms(lambda: mf.masked_fill_fwd_kernel(imgs, rects, fill))
    plain = _device_ms(lambda: mf.masked_fill_reference(imgs, rects, fill))
    lib = _device_ms(lambda: torch.where(keep, imgs[:, None], fill))
    bound, by = _bound(item * b * hwc + 16 * s * k + item * b * s * hwc,
                       0.0)
    plan = mf.fwd_plan(b, s, size, size, 3, True, item)
    print(f"kernel A {form} masked_fill_fwd [B={b},S={s},K={k},{size}x{size}x3]"
          f" ({plan}): exact at S=36 and 63, {ms * 1e3:.2f} us (plain "
          f"{plain * 1e3:.2f} us, torch.where on a rasterized keep-mask "
          f"{lib * 1e3:.2f} us; bound {bound * 1e3:.2f} us by {by}, "
          f"{bound / ms:.0%} of it)", flush=True)
    del imgs, keep
    torch.cuda.empty_cache()
    return dict(name="masked_fill_fwd" + ("_bf16" if item == 2 else "")
                + suffix, route="cuda",
                source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                replaces="dorpatch_tpu/ops/masked_fill.py:53", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib)


def fill_phase_k3(torch, dev, b=2, size=32):
    """Kernel A and its bf16 form at the n_patch=2 sweep's shape: a chunk of
    S = 64 of the 0.12 radius's basic-major triples (K = 3 rectangles a
    mask) over the CIFAR path's `b` images, exact against the plain
    versions at that chunk and at a chunk of the pairs padded to K = 3,
    timed at the triples beside the plain version and `torch.where` on a
    rasterized keep-mask. Returns the two records."""
    import numpy as np

    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.defense import plan_chunks
    from dorpatch_tpu_torch.ops import masked_fill as mf

    fill = 0.5
    pairs, triples = masks_lib.mask_sets(masks_lib.geometry(size, 0.12, 2))
    _, s = plan_chunks(len(pairs) + len(triples), 64)
    rng = np.random.default_rng(3)
    imgs = torch.as_tensor(rng.uniform(0, 1, (b, size, size, 3)),
                           dtype=torch.float32, device=dev)
    chunks = [masks_lib.pad_rects(pairs[:s], 3),
              triples[rng.choice(len(triples), s, replace=False)]]
    out = []
    for dtype, name in ((torch.float32, "masked_fill_fwd_k3"),
                        (torch.bfloat16, "masked_fill_fwd_bf16_k3")):
        x = imgs.to(dtype)
        for part in chunks:
            rects = torch.as_tensor(part, dtype=torch.int32, device=dev)
            got = mf.masked_fill_fwd_kernel(x, rects, fill)
            want = mf.masked_fill_reference(x, rects, fill)
            torch.cuda.synchronize()
            if got.dtype != dtype or not torch.equal(got, want):
                raise AssertionError(f"kernel A ({dtype}) differs from its "
                                     f"plain version at K=3, [B={b},S={s},"
                                     f"{size}px]")
        err = float((got.float() - want.float()).abs().max())
        del got, want
        keep = masks_lib.rasterize(rects, size)[None, :, :, :, None]
        esz = 4 if dtype == torch.float32 else 2
        hwc = size * size * 3
        ms = _device_ms(lambda: mf.masked_fill_fwd_kernel(x, rects, fill))
        plain = _device_ms(lambda: mf.masked_fill_reference(x, rects, fill))
        lib = _device_ms(lambda: torch.where(keep, x[:, None], fill))
        bound, by = _bound(esz * b * hwc + 16 * s * 3 + esz * b * s * hwc,
                           0.0)
        print(f"kernel A {name} [B={b},S={s},K=3,{size}x{size}x3]: exact "
              f"at the triples and at the padded pairs, {ms * 1e3:.2f} us "
              f"(plain {plain * 1e3:.2f} us, torch.where on a rasterized "
              f"keep-mask {lib * 1e3:.2f} us; bound {bound * 1e3:.2f} us by "
              f"{by}, {bound / ms:.0%} of it)", flush=True)
        out.append(dict(name=name, route="cuda",
                        source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                        replaces="dorpatch_tpu/ops/masked_fill.py:53",
                        launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound, bound_by=by, library_ms=lib))
        del keep
    torch.cuda.empty_cache()
    return out


def bank_cross_check(torch, dev, arch, b, lift, size=224, dataset="imagenet",
                     model_dir=None, source="synthetic", drifting=()):
    """The bf16 certify bank at the 0.12 radius on the card, on the victim
    at `size` px (random, or trained into `model_dir`, on the first batch of
    `source`) with the head bias of class 0 raised by `lift` (as
    `vit_cross_check`): every image's (prediction, certification) must
    equal the float32 bank's with incremental="off"; the bank's bf16
    kernels must launch (on RN50 A's bf16 form, which fills only the pair
    audits' images, and the images the lift makes unanimous are audited;
    on the CIFAR ResNet-18 C's); with a lift, at least one image must stay
    unescalated. Images in `drifting` (a token engine's drift at the
    margin, `vit_cross_check`) are not held to "off". Prints the escalated
    count and the margins."""
    from dorpatch_tpu_torch import data, ops
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry

    victim = trained_victim(dataset, arch, model_dir, size, dev)
    head = victim.model.head["fc"] if arch == "resnetv2" else \
        victim.model.head
    with torch.no_grad():
        head.bias[0] += lift
    x_np, _ = next(data.dataset_batches(dataset, b, size, 1234,
                                        source=source))
    x = torch.as_tensor(x_np, device=dev)
    spec = geometry(size, 0.12)
    cfg = DefenseConfig(compute_dtype="bfloat16")
    pc = PatchCleanser(victim.apply, spec, cfg,
                       incremental_engine=victim.incremental, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec16 = pc.robust_predict(x, victim.num_classes)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    esc = int((pc.last_min_margin < cfg.incremental_margin).sum())
    margins = [round(float(v), 4) for v in pc.last_min_margin]
    pc32 = PatchCleanser(victim.apply, spec, DefenseConfig(),
                         incremental_engine=victim.incremental, device=dev)
    t0 = time.perf_counter()
    rec32 = pc32.robust_predict(x, victim.num_classes, incremental="off")
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    differ = [i for i, (a, o) in enumerate(zip(rec16, rec32))
              if (a.prediction, a.certification)
              != (o.prediction, o.certification)]
    unexplained = [i for i in differ if i not in drifting]
    print(f"bf16 bank {arch} {size}px r=0.12"
          f"{' (trained)' if model_dir else ''}, class-0 bias +{lift}: "
          f"escalated "
          f"{esc} of {b} images (min margins {margins}); forwards "
          f"{[r.forwards for r in rec16]} ({wall16:.2f} s; float32 "
          f"incremental=off {[r.forwards for r in rec32]}, {wall32:.2f} s); "
          f"verdicts differ for images {differ} (drift at the margin: "
          f"{sorted(drifting)}); launches {counts}", flush=True)
    want = {"vit": ("masked_kv_attn_bf16",),
            "cifar_vit": ("masked_kv_attn_bf16",),
            "resnet18": ("stem_fold_bf16",)}.get(
        arch, ("masked_fill_fwd_bf16", "stem_fold_bf16", "gn_relu_fwd_bf16"))
    missing = [k for k in want if not counts.get(k)]
    if unexplained or missing or (lift > 0 and esc == b):
        raise AssertionError(f"bf16 bank {arch}, lift {lift}: verdicts "
                             f"differ for images {differ}, kernels not "
                             f"launched {missing}, escalated {esc} of {b}")


def consensus_cross_check(torch, dev, b, lift, size=224):
    """prune="consensus" against "exact" at the 0.12 radius on the RN50
    victim at `size` px with the head bias of class 0 raised by `lift`, so
    that images are first-round unanimous, in float32 (stem fold) and in
    the bf16 bank: per image the same prediction, every exact certificate
    kept, at most the exact forwards, and at least one image stopped after
    the first round (the consensus certificate)."""
    from dorpatch_tpu_torch import data
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import PatchCleanser
    from dorpatch_tpu_torch.masks import geometry
    from dorpatch_tpu_torch.models import get_model

    victim = get_model("imagenet", "resnetv2", "/nonexistent", size, seed=0,
                       device=dev)
    with torch.no_grad():
        victim.model.head["fc"].bias[0] += lift
    x_np, _ = next(data.synthetic_batches("imagenet", b, size, 1234))
    x = torch.as_tensor(x_np, device=dev)
    for dtype in ("float32", "bfloat16"):
        recs = {}
        for prune in ("exact", "consensus"):
            pc = PatchCleanser(victim.apply, geometry(size, 0.12),
                               DefenseConfig(prune=prune,
                                             compute_dtype=dtype),
                               incremental_engine=victim.incremental,
                               device=dev)
            recs[prune] = pc.robust_predict(x, victim.num_classes)
        stops = sum(r.forwards == pc.num_first for r in recs["consensus"])
        label = f"consensus cross-check RN50 {size}px {dtype}, class-0 bias " \
                f"+{lift}"
        consensus_check(label, [[r] for r in recs["exact"]],
                        [[r] for r in recs["consensus"]])
        if not stops:
            raise AssertionError(f"{label}: no image stopped after the "
                                 f"first round")


def disk_phase(torch, dev) -> None:
    """The CIFAR path without --synthetic, reading a seeded CIFAR-10
    `test_batch` (`write_cifar_disk`) from a temporary --data_dir: all 8
    images evaluated, kernels A, B and C launched; then again with the
    synchronous input path (`stream_depth` 0), which must give the same
    report and patch (both print their `data` span seconds). Left out, and
    said so, where Pillow is not installed."""
    import importlib.util

    if importlib.util.find_spec("PIL") is None:
        print("CIFAR disk main path: left out, Pillow (PIL) is not "
              "installed on this machine", flush=True)
        return
    import dataclasses

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root:
        write_cifar_disk(torch, dev, root)
        m, _, _ = main_path(torch, dev, "CIFAR disk",
                            CIFAR_DISK_ARGV + ["--data_dir", root],
                            CIFAR_KERNELS)
        # the synchronous input path (stream_depth 0) beside the streamed
        # one: its `data` spans decode every batch in the loop
        m_sync, _, _ = main_path(
            torch, dev, "CIFAR disk sync", CIFAR_DISK_ARGV + [
                "--data_dir", root], CIFAR_KERNELS,
            edit=lambda c: dataclasses.replace(c, stream_depth=0))
    if m["evaluated_images"] != 8 or m["clean_accuracy"] != 100.0:
        raise AssertionError(f"CIFAR disk main path evaluated "
                             f"{m['evaluated_images']} of 8 images: {m}")
    if m_sync["report"] != m["report"] or any(
            not (a == b).all() for a, b in zip(PATCHES["CIFAR disk"],
                                                PATCHES["CIFAR disk sync"])):
        raise AssertionError("the streamed and the synchronous input paths "
                             "disagree")
    print(f"CIFAR disk main-path phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


def train_phase(torch, dev, out) -> None:
    """Both trainable victims trained on the card (TRAIN_ARGV) through
    `train.py`'s flags, seed 0 into `out`; the mean held-out accuracy over
    TRAIN_SEEDS must reach TRAIN_MIN_ACC. Then two 20-step runs of each
    from one seed must give bit-equal weights."""
    from dorpatch_tpu_torch import data, train, utils

    def augmented_acc(model, cfg):
        """Held-out accuracy on the held-out images augmented as in
        training (one seeded draw)."""
        x, y = data.training_arrays(cfg.dataset, cfg.data_source,
                                    cfg.data_dir, cfg.n_per_class_test,
                                    cfg.img_size, 1234, "test")
        x = torch.as_tensor(train.quantize(x), device=dev)
        x = train.augment(x, *train.draw_augment(utils.generator(1, dev),
                                                 len(x)))
        return int(train.eval_hits(model, x, torch.as_tensor(
            y, device=dev))) / len(y)

    def run(argv):
        cfg = train.config_from_args(train.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, report = train.train_victim(cfg, dev)
        return cfg, model, report, time.perf_counter() - t0

    for arch, extra in TRAIN_ARGV.items():
        accs = []
        for seed in TRAIN_SEEDS[arch]:
            cfg, model, rep, wall = run(["--arch", arch, "--out", out,
                                         "--seed", str(seed)] + extra)
            accs.append(rep["test_acc"])
            path = (train.save_victim_checkpoint(model, out, cfg.dataset,
                                                 arch) if seed == 0 else "")
            print(f"train {arch} (lr {cfg.lr}, seed {seed}): {rep['steps']} "
                  f"steps of {cfg.batch_size} in {rep['seconds']} s "
                  f"({rep['steps'] / rep['seconds']:.1f} steps/s; "
                  f"{wall:.1f} s with the data and the evaluation), held-out "
                  f"accuracy {rep['test_acc']:.4f} of {rep['n_test']} "
                  f"({augmented_acc(model, cfg):.4f} augmented), last "
                  f"epoch's train accuracy {rep['train_acc']:.4f} {path}",
                  flush=True)
        mean = sum(accs) / len(accs)
        print(f"train {arch}: held-out accuracy {accs}, mean {mean:.4f} "
              f"(bar {TRAIN_MIN_ACC})", flush=True)
        if mean < TRAIN_MIN_ACC:
            raise AssertionError(f"{arch} trained to {accs} held out, mean "
                                 f"below {TRAIN_MIN_ACC}")
    for arch in TRAIN_ARGV:
        runs = [run(["--arch", arch] + TRAIN_REPEAT_ARGV) for _ in range(2)]
        differ = [k for (k, a), (_, b) in zip(
            runs[0][1].state_dict().items(), runs[1][1].state_dict().items())
            if not torch.equal(a, b)]
        print(f"train repeat {arch}: {runs[0][2]['steps']} steps twice from "
              f"seed {runs[0][0].seed}: {len(differ)} of "
              f"{len(runs[0][1].state_dict())} tensors differ "
              f"({runs[0][2]['seconds']} s, {runs[1][2]['seconds']} s)",
              flush=True)
        if differ or runs[0][2]["steps"] != 20:
            raise AssertionError(f"training {arch} does not repeat: "
                                 f"{differ}")


def trained_phase(torch, dev, out) -> None:
    """The main path through the CLI on each victim trained into `out`,
    in float32 and with both bf16 flags (TRAINED_ARGV; `main_path` holds
    each to its checkpoint, the stage switch and the failure-set draws);
    then the cross-checks on the trained weights and the procedural task's
    held-out images: the stem fold against full forwards (CIFAR), the token
    engine against full forwards and "token-exact" against "off"
    (cifar_vit; held to the engine's contract as it states it: an image
    may differ only where the engine's drift reaches the escalation
    margin, which on these weights it does, in the JAX package too), and
    the bf16 bank against float32 "off" (both; cifar_vit's drifting images
    exempt)."""
    audit = "masked_fill_fwd_bf16"
    for label, arch, required, bf16_required, audit_fill in (
            ("trained CIFAR", "resnet18", CIFAR_KERNELS,
             TRAINED_CIFAR_BF16_KERNELS, audit),
            ("trained cifar_vit", "cifar_vit", VIT_KERNELS,
             VIT_BF16_KERNELS, None)):
        argv = TRAINED_ARGV + ["--base_arch", arch, "--model_dir", out]
        for suffix, flags, kernels, fill in (("", [], required, None),
                                             (" bf16", BF16_FLAGS,
                                              bf16_required, audit_fill)):
            t0 = time.perf_counter()
            _, counts, _ = main_path(torch, dev, label + suffix,
                                     argv + flags, kernels, audit_fill=fill,
                                     trained=True)
            if arch == "cifar_vit":
                kern = "masked_kv_attn" + ("_bf16" if flags else "")
                first, pairs, by_s = attn_classes(counts, kern, 32, 4)
                print(f"{label + suffix} kernel H ({kern}) launches by dirty "
                      f"rows S {by_s}: phase-1 chunks {first}, pair audits "
                      f"and second-round rows {pairs}", flush=True)
            print(f"{label + suffix} main-path phase: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kw = dict(model_dir=out, source="procedural")
    cross_check(torch, dev, "cifar10", "resnet18", 32, 8, **kw)
    drifting = vit_cross_check(torch, dev, 8, 0.0, "cifar10", "cifar_vit", 32,
                               strict=False, **kw)
    bank_cross_check(torch, dev, "resnet18", 8, 0.0, 32, "cifar10", **kw)
    bank_cross_check(torch, dev, "cifar_vit", 8, 0.0, 32, "cifar10",
                     drifting=drifting, **kw)
    print(f"trained cross-check phase: {time.perf_counter() - t0:.1f} s",
          flush=True)


# ------------------------------------------- carry checkpoints and farm


class _Interrupt(RuntimeError):
    """Raised from a block callback to cut a run short."""


class _TimedSaves:
    """Times every `CarryCheckpointer.save` in this process (the device
    synchronized first, so queued work is not counted) and sizes the
    snapshot it wrote: `records` of (ms, bytes)."""

    def __init__(self, torch):
        self.torch = torch
        self.records = []

    def __enter__(self):
        from dorpatch_tpu_torch import checkpoint

        self._cls = checkpoint.CarryCheckpointer
        self._real = real = self._cls.save
        timed = self

        def save(ck, stage, iteration, *args, **kwargs):
            timed.torch.cuda.synchronize()
            t0 = time.perf_counter()
            real(ck, stage, iteration, *args, **kwargs)
            ms = (time.perf_counter() - t0) * 1e3
            step = os.path.join(ck.directory,
                                str(stage * 10_000_000 + iteration))
            timed.records.append((ms, sum(
                os.path.getsize(os.path.join(step, f))
                for f in os.listdir(step))))

        self._cls.save = save
        return self

    def __exit__(self, *exc):
        self._cls.save = self._real

    def summary(self):
        if not self.records:
            return "no saves"
        ms = sorted(r[0] for r in self.records)
        return (f"{len(ms)} saves, median {ms[len(ms) // 2]:.3f} ms "
                f"(min {ms[0]:.3f}, max {ms[-1]:.3f}), "
                f"{self.records[-1][1]} bytes each")


def rn50_carry_phase(torch, dev) -> None:
    """RN50 at 224 in float32 with blocks of 5 iterations
    (`RN50_CARRY_ARGV`): first uninterrupted, for the reference patch;
    then with `--carry-checkpoints --hang-timeout RN50_CARRY_HANG_S`,
    interrupted from the block callback at stage 1's first block (after
    the block's snapshot), and run again over the same results dir. The
    second run must resume from that snapshot (stage 1's init skipped,
    its draws inside the restored generator), run stage 1's last block
    and save the reference patch bit for bit; the telemetry files must be
    there (run.json chaining both attempts), the watchdog must stay quiet,
    the snapshots must be cleared on success, and A, B, C, D and F must
    launch in the resumed run alone. Prints the snapshot saves' ms and
    bytes."""
    from dorpatch_tpu_torch import observe, ops
    from dorpatch_tpu_torch.artifacts import ArtifactStore, results_path
    from dorpatch_tpu_torch.checkpoint import CarryCheckpointer
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.pipeline import run_experiment

    real = observe.AttackMetricsLogger.on_block_end

    def interrupt(logger, stage, step, info):
        real(logger, stage, step, info)
        if stage == 1:
            raise _Interrupt(f"cut at stage {stage}, iteration {step}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_carry_") as root, \
            _TimedSaves(torch) as saves:
        t0 = time.perf_counter()
        ref_cfg = config_from_args(build_parser().parse_args(
            RN50_CARRY_ARGV + ["--results-root",
                               os.path.join(root, "reference")]))
        run_experiment(ref_cfg, verbose=False)
        want = ArtifactStore(results_path(ref_cfg)).load_patch(0)
        reference = time.perf_counter() - t0
        cfg = config_from_args(build_parser().parse_args(
            RN50_CARRY_ARGV + ["--carry-checkpoints", "--hang-timeout",
                               str(RN50_CARRY_HANG_S), "--results-root",
                               os.path.join(root, "carry")]))
        out = results_path(cfg)
        t0 = time.perf_counter()
        observe.AttackMetricsLogger.on_block_end = interrupt
        try:
            run_experiment(cfg, verbose=False)
            raise AssertionError("the RN50 carry run was not interrupted")
        except _Interrupt:
            pass
        finally:
            observe.AttackMetricsLogger.on_block_end = real
        cut = time.perf_counter() - t0
        info = CarryCheckpointer(
            os.path.join(out, "carry_0")).latest_step_info()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        m = run_experiment(cfg, verbose=False)
        torch.cuda.synchronize()
        resumed = time.perf_counter() - t0
        counts = ops.launch_counts()
        got = ArtifactStore(out).load_patch(0)
        files = set(os.listdir(out))
        with open(os.path.join(out, "run.json")) as fh:
            chain = json.load(fh).get("previous_run_ids", [])
        left = os.listdir(os.path.join(out, "carry_0"))
    saved = (info.stage * RN50_CARRY_ITERATIONS + info.iteration
             if info else 0)
    print(f"RN50 carry check (--carry-checkpoints, --max-iterations "
          f"{RN50_CARRY_ITERATIONS}, --sweep-interval 5): "
          f"reference run {reference:.2f} s; interrupted after stage 1's "
          f"first block in {cut:.2f} s; snapshot (stage, iteration) "
          f"{(info.stage, info.iteration) if info else None}; resumed run "
          f"{resumed:.2f} s (attack seconds {m.get('attack_seconds')}, "
          f"certify {m.get('certify_seconds')}); iterations saved "
          f"{saved}; carry "
          f"snapshots: {saves.summary()}; resumed run's launches {counts}",
          flush=True)
    if info is None or (info.stage, info.iteration) != (1, 5):
        raise AssertionError(f"RN50 carry snapshot: {info}")
    if not all((a == b).all() for a, b in zip(got, want)):
        raise AssertionError("the resumed RN50 patch differs from the "
                             "uninterrupted run's")
    need = {"run.json", "events.jsonl", "metrics.jsonl", "heartbeat_0.jsonl"}
    if need - files or len(chain) != 1 or left:
        raise AssertionError(f"RN50 carry telemetry: files {sorted(files)}, "
                             f"previous run ids {chain}, left {left}")
    for name in RN50_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the "
                                 "resumed RN50 carry run")


def _farm_specs(model_dir):
    """The farm grid (FARM_BUDGETS x float32/bfloat16) as two specs of
    one farm: an axis cannot pair `attack.compute_dtype` with
    `defense.compute_dtype`, so each dtype's half carries its certify
    dtype in its base and its attack dtype as a one-value axis (the job
    ids name both)."""
    base = {"dataset": "cifar10", "base_arch": "resnet18", "img_size": 32,
            "batch_size": 8, "data_source": "procedural",
            "model_dir": model_dir, "attack": FARM_ATTACK}
    return [{"base": dict(base, defense={"compute_dtype": dtype}),
             "axes": {"attack.patch_budget": FARM_BUDGETS,
                      "attack.compute_dtype": [dtype]},
             "sweep": FARM_SWEEP, "max_attempts": 3}
            for dtype in ("float32", "bfloat16")]


def _farm_worker(farm, worker_id, *extra):
    return [sys.executable, "-m", "dorpatch_tpu_torch.farm", "work", farm,
            "--worker-id", worker_id, "--lease-ttl", str(FARM_TTL),
            "--heartbeat-interval", "0.5", "--poll-interval", "0.5",
            "--backoff-base", "0.5", "--backoff-cap", "2.0", *extra]


def _run_workers(farm, workers):
    """Start every worker of `workers` ({id: extra args}) at once and wait
    for all; returns {id: (exit code, output tail)}. A worker still
    running at FARM_PROC_TIMEOUT is killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {w: subprocess.Popen(_farm_worker(farm, w, *extra), cwd=root,
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for w, extra in workers.items()}
    out = {}
    try:
        for w, p in procs.items():
            text, _ = p.communicate(timeout=FARM_PROC_TIMEOUT)
            out[w] = (p.returncode, text[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def farm_phase(torch, dev, out) -> dict:
    """The attack-sweep farm on the CIFAR ResNet-18 trained into `out`
    (`python -m dorpatch_tpu_torch.farm`, worker processes over one farm
    directory): the 4-job grid of `_farm_specs`; a worker with
    `--chaos crash_block --crash-mode kill` SIGKILLs itself at its seeded
    block (after the block's snapshot) while a worker with `--chaos
    ckpt_raise,enospc_events` fails one job's snapshot save (ENOSPC) and
    loses its event log's disk; then two healthy workers drain the farm,
    one reclaiming the killed job once its lease (FARM_TTL) goes stale and
    resuming it from the snapshot. Gates: every job done; the killed job
    at attempts 2, reclaims 1, resumed from an iteration above 0, its
    patch bit-equal to an uninterrupted `run_sweep` of the same point in
    this process; the ckpt_raise job done at attempts 2; kernels A, B, C
    and the bf16 forms of C and A launched by the draining workers (their
    `metrics.json`). Prints the phase wall, per-job seconds, the reclaim
    latency, the iterations the resume saved, the fleet report, and the
    control run's snapshot saves (ms, bytes). Returns the draining
    workers' launches by kernel."""
    import dataclasses

    import numpy as np

    from dorpatch_tpu_torch.checkpoint import CarryCheckpointer
    from dorpatch_tpu_torch.farm.queue import JobQueue
    from dorpatch_tpu_torch.farm.report import (format_fleet_report,
                                                summarize_fleet)
    from dorpatch_tpu_torch.farm.worker import job_config
    from dorpatch_tpu_torch.observe import heartbeat_filename, last_beat
    from dorpatch_tpu_torch.sweep import run_sweep

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_farm_") as tmp:
        farm = os.path.join(tmp, "farm")
        jq = JobQueue(farm)
        for spec in _farm_specs(out):
            jq.submit_spec(spec)
        ids = jq.job_ids()
        t0 = time.perf_counter()
        first = _run_workers(farm, {
            "wKill": ["--chaos", "crash_block", "--crash-mode", "kill",
                      "--max-jobs", "1"],
            "wChaos": ["--chaos", "ckpt_raise,enospc_events",
                       "--max-jobs", "1"]})
        t_first = time.perf_counter() - t0
        if first["wKill"][0] != -9 or first["wChaos"][0] != 0:
            raise AssertionError(f"farm chaos workers: {first}")
        marked = {f: [j for j in ids if os.path.exists(os.path.join(
            jq.job_dir(j), f"chaos_{f}.fired"))]
            for f in ("crash_block", "ckpt_raise", "enospc_events")}
        killed = marked["crash_block"][0]
        dead = last_beat(os.path.join(farm, "workers", "wKill",
                                      heartbeat_filename(0)))
        t0 = time.perf_counter()
        drain = _run_workers(farm, {"wA": [], "wB": []})
        t_drain = time.perf_counter() - t0
        if any(rc != 0 for rc, _ in drain.values()):
            raise AssertionError(f"farm drain workers: {drain}")
        jobs = {j: jq.read_job(j) for j in ids}
        rows = {}
        for j in ids:
            with open(os.path.join(jq.job_dir(j), "results",
                                   "rows.jsonl")) as fh:
                rows[j] = [json.loads(line) for line in fh]
        launches = {}
        for w in ("wA", "wB"):
            with open(os.path.join(farm, "workers", w,
                                   "metrics.json")) as fh:
                snap = json.load(fh)["metrics"]
            for series in snap.get("kernel_launches_total",
                                   {}).get("series", []):
                k = series["labels"]["kernel"]
                launches[k] = launches.get(k, 0) + int(series["value"])
        fleet = summarize_fleet(farm)
        print(format_fleet_report(fleet), flush=True)

        # the uninterrupted control of the killed point, with its own
        # snapshots timed
        t0 = time.perf_counter()
        cfg = dataclasses.replace(job_config(jobs[killed]), device="cuda")
        control = os.path.join(tmp, "control")
        with _TimedSaves(torch) as saves:
            run_sweep(cfg, patch_budgets=(cfg.attack.patch_budget,),
                      densities=(cfg.attack.density,),
                      structureds=(cfg.attack.structured,),
                      defense_ratio=FARM_SWEEP["defense_ratio"],
                      verbose=False, result_dir=control,
                      checkpointer_factory=lambda point, params:
                      CarryCheckpointer(os.path.join(tmp, "control_ck")))
        t_control = time.perf_counter() - t0
        same = all((np.load(os.path.join(jq.job_dir(killed), "results",
                                         name))
                    == np.load(os.path.join(control, name))).all()
                   for name in ("point_000_mask.npy",
                                "point_000_pattern.npy"))
    wall = time.perf_counter() - t_phase
    k, row = jobs[killed], rows[killed][0]
    resumed = (row.get("resumed_from_stage"),
               row.get("resumed_from_iteration"))
    reclaim = (k.get("started_ts", 0.0) - dead["ts"]) if dead else None
    saved = ((resumed[0] or 0) * FARM_ATTACK["max_iterations"]
             + (resumed[1] or 0))
    per_job = {j: (jobs[j]["state"], jobs[j]["attempts"],
                   [r["seconds"] for r in rows[j]],
                   round(jobs[j].get("completed_ts", 0.0)
                         - jobs[j].get("started_ts", 0.0), 2))
               for j in ids}
    print(f"farm phase: {wall:.1f} s wall (chaos workers {t_first:.1f} s, "
          f"drain {t_drain:.1f} s, control {t_control:.1f} s); jobs "
          f"(state, attempts, sweep seconds, last attempt s): {per_job}; "
          f"killed {killed}: attempts {k['attempts']}, reclaims "
          f"{k.get('reclaims')}, resumed from (stage, iteration) {resumed}, "
          f"iterations saved {saved}, "
          f"reclaim latency {reclaim:.2f} s after the last beat (lease TTL "
          f"{FARM_TTL}); chaos markers {marked}; drain launches "
          f"{launches}; step time {fleet['step_time']}; control carry "
          f"snapshots (CIFAR, batch 8): {saves.summary()}; resumed patch "
          f"bit-equal to the control: {same}", flush=True)
    states = {j: job["state"] for j, job in jobs.items()}
    if set(states.values()) != {"done"} or len(ids) != 4:
        raise AssertionError(f"farm jobs lost: {states}")
    if (k["attempts"], k.get("reclaims")) != (2, 1) or not resumed[1]:
        raise AssertionError(f"killed job {killed}: {k}, row {row}")
    if not same:
        raise AssertionError("the crash-resumed farm patch differs from the "
                             "uninterrupted control run")
    raised = marked["ckpt_raise"]
    if (len(raised) != 1 or not marked["enospc_events"]
            or jobs[raised[0]]["attempts"] != 2
            or jobs[raised[0]]["failures"][0]["kind"] != "io"):
        raise AssertionError(f"ckpt_raise/enospc_events: {marked}, "
                             f"{[jobs[j] for j in raised]}")
    for name in FARM_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"farm's draining workers: {launches}")
    return launches


# ------------------------------------------------------------- serving


def serve_kernels(torch, dev):
    """The serve paths' kernels at their shapes, held and timed as above:
    at the RN50 serve bucket of 8 images at 224, A (float32 and bf16) at
    the pair audit's chunk (S = 63), C (float32 and bf16) at phase 1's
    chunk and D (float32 and bf16) at a pair-audit slab (8 x 63 images at
    (784, 512)); at the CIFAR bucket of 8, A and C; H's bf16 form at the
    ViT-B/16 bank's chunks with 1 image (the serve path's batch). Returns
    the records by path, launches filled in by `serve_phase`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rn50 = [fill_phase_bf16(torch, dev, 8, 224, "_serve_rn50",
                            torch.float32),
            stem_fold_phase(torch, dev, "imagenet", "resnetv2", 224, 8,
                            "stem_fold_serve_rn50"),
            gn_slab(torch, dev, gen, 8 * 63, 784, 512, 4,
                    suffix="_serve_rn50")[0]]
    rn50_bf16 = [fill_phase_bf16(torch, dev, 8, 224, "_serve_rn50"),
                 stem_fold_phase(torch, dev, "imagenet", "resnetv2", 224, 8,
                                 "stem_fold_bf16_serve_rn50",
                                 torch.bfloat16),
                 gn_slab(torch, dev, gen, 8 * 63, 784, 512, 4,
                         torch.bfloat16, "_serve_rn50")[0]]
    cifar = [fill_phase_bf16(torch, dev, 8, 32, "_serve_cifar",
                             torch.float32),
             stem_fold_phase(torch, dev, "cifar10", "resnet18", 32, 8,
                             "stem_fold_serve_cifar")]
    return {"RN50": rn50, "RN50 bf16": rn50_bf16, "CIFAR": cifar,
            "ViT bf16": attn_phase(torch, dev, torch.bfloat16, 1,
                                   "_serve_vit")}


def _serve_images(size, n, seed):
    """Seeded smooth random images (`tools/loadgen.py`'s), NHWC in [0, 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (n, 4, 4, 3)).astype(np.float32)
    return np.kron(base, np.ones((1, size // 4, size // 4, 1), np.float32))


def _closed_loop(url, images, concurrency, deadline_ms, tag="r"):
    """SERVE_CONCURRENCY stdlib clients over `images`, each request with
    its own X-Trace-Id (`tag` + its index): [(HTTP status, answer, client
    seconds)]."""
    import threading
    import urllib.error
    import urllib.request

    out = [None] * len(images)
    nxt, lock = [0], threading.Lock()

    def one(i):
        body = json.dumps({"image": images[i].tolist()}).encode()
        req = urllib.request.Request(
            url + "/predict", data=body, headers={
                "Content-Type": "application/json",
                "X-Trace-Id": f"{tag}{i}"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                    req, timeout=deadline_ms / 1e3 + 60) as r:
                code, ans = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, ans = e.code, json.loads(e.read())
        out[i] = (code, ans, time.perf_counter() - t0)

    def worker():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(images):
                return
            one(i)

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=deadline_ms / 1e3 + 120)
    if any(t.is_alive() for t in threads) or None in out:
        raise AssertionError("a serve client did not get its answer")
    return out


def _get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _busy_share(trace_path, window_s):
    """(device busy share, kernels) of a `torch.profiler` Chrome trace:
    the union of its CUDA kernel, memcpy and memset intervals over the
    capture's `window_s` seconds."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return min(1.0, busy / (window_s * 1e6)), len(spans)


def serve_path(torch, dev, label, argv, images, required, smi,
               concurrency=SERVE_CONCURRENCY, drill=False, profile_s=0.0,
               ref_cache=None):
    """One serving path: `CertifiedInferenceService.from_config` on the
    CLI flags `argv` and `HttpFrontend` on a free port, in this process;
    `images` sent over HTTP by `_closed_loop`, with the launch counts set
    to 0 just before the first request and read just after the last
    answer. Fails unless every answer is ok inside its deadline; every
    replica's per-program signature counts after the traffic equal those
    after its warmup; `serve_requests_total` and `serve_batch_images_total`
    on `GET /metrics` equal the client's count; every kernel in `required`
    launched, A (or its bf16 form) exactly when a pair audit was
    scheduled, and, in the RN50 bf16 bank, A exactly when an image
    escalated; and every answer (per radius prediction and certificate,
    the clean prediction, the forwards summed over the radii) equals the
    port's `robust_predict` on the same images in the same batches (the
    `serve.batch` spans of the service's events.jsonl name each batch's
    requests), on a bank built apart from the service's. A `drill` run
    (chaos wedge_dispatch on replica 0) must also write the
    serve.replica.{sick,quarantine,restart} events, replica 0 wedged and
    then restarted, and answer every request once. With `profile_s`, one
    more batch of the first images is served after the measured traffic
    (its own trace ids), and a client asks `POST /profile` for that many
    seconds once it runs: the device's busy share of the capture is
    printed (the rest is the share of a served batch the host holds the
    card idle). `ref_cache` keeps the reference's answers by bank and
    batch across paths that serve the same images. Prints,
    beside the card, the warmup seconds per replica, the latency
    percentiles, images/s, batch occupancy and forwards per image. Returns
    the launch counts."""
    import threading
    import urllib.request

    from dorpatch_tpu_torch import data, defense, ops
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.observe import parse_exposition
    from dorpatch_tpu_torch.serve import CertifiedInferenceService, HttpFrontend

    n = len(images)
    sched = dict(pair_audits=0, rows=0)
    plain, lock = defense.schedule_round2, threading.Lock()

    def schedule(*args, **kwargs):
        need_pairs, row_list = plain(*args, **kwargs)
        with lock:
            sched["pair_audits"] += int(need_pairs.sum())
            sched["rows"] += len(row_list)
        return need_pairs, row_list

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
        cfg = config_from_args(build_parser().parse_args(
            argv + ["--results-root", root, "--serve-port", "0"]))
        deadline_ms = cfg.serve.deadline_ms
        t0 = time.perf_counter()
        svc = CertifiedInferenceService.from_config(cfg)
        svc.start()
        start_s = time.perf_counter() - t0

        def counts_of_banks():
            return [svc._bank_trace_counts(r.clean, r.defenses)
                    for r in svc._pool.replicas]

        warm = counts_of_banks()
        defense.schedule_round2 = schedule
        try:
            with HttpFrontend(svc, "127.0.0.1", 0) as fe:
                url = f"http://127.0.0.1:{fe.port}"
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                answers = _closed_loop(url, images, concurrency, deadline_ms)
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                counts, routes = ops.launch_counts(), ops.route_counts()
                metrics = parse_exposition(_get(url + "/metrics")[1])
                if drill:
                    t1 = time.perf_counter()
                    while time.perf_counter() - t1 < 120:
                        snap = svc.stats()["replicas"][0]
                        if (snap["state"], snap["generation"]) == \
                                ("healthy", 1):
                            break
                        time.sleep(0.2)
                health = json.loads(_get(url + "/healthz")[1])
                stats = svc.stats()
                prof = {}
                if profile_s:

                    def capture():
                        time.sleep(2.0)     # the batch is on the card
                        req = urllib.request.Request(
                            url + "/profile", data=json.dumps(
                                {"duration_ms": profile_s * 1e3}).encode(),
                            headers={"Content-Type": "application/json"})
                        with urllib.request.urlopen(req, timeout=300) as r:
                            prof.update(json.loads(r.read()))

                    profiler = threading.Thread(target=capture)
                    profiler.start()
                    extra = _closed_loop(url, images[:SERVE_CONCURRENCY],
                                         concurrency, deadline_ms, "p")
                    profiler.join(timeout=300)
                    if any(c != 200 for c, _, _ in extra):
                        raise AssertionError(f"{label} serve path: the "
                                             f"profiled batch answered {extra}")
        finally:
            defense.schedule_round2 = plain
        after = counts_of_banks()
        svc.stop()
        with open(f"{root}/serve/events.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        busy = None
        if profile_s:
            if prof.get("status") != "ok":
                raise AssertionError(f"{label} serve path: POST /profile "
                                     f"answered {prof}")
            from dorpatch_tpu_torch.observe import timing

            busy = _busy_share(f"{prof['dir']}/{timing.TRACE_FILE}",
                               profile_s)
    # -- every answer ok, inside its deadline, once --
    bad = [(i, c, a.get("status")) for i, (c, a, _) in enumerate(answers)
           if c != 200 or a.get("status") != "ok"
           or a["latency_ms"] > deadline_ms or a["trace_id"] != f"r{i}"]
    if bad:
        raise AssertionError(f"{label} serve path: answers not ok: {bad}")
    if after != warm:
        raise AssertionError(f"{label} serve path: signatures after the "
                             f"traffic {after} != after warmup {warm}")
    by_status = {dict(k).get("status"): v for k, v in
                 metrics.get("serve_requests_total", {}).items()}
    images_total = sum(metrics.get("serve_batch_images_total", {}).values())
    if by_status != {"ok": float(n)} or images_total != n:
        raise AssertionError(f"{label} serve path: /metrics counts "
                             f"{by_status}, {images_total} batch images for "
                             f"{n} client requests")
    # -- the reference: robust_predict on each served batch --
    batches = [e for e in events if e.get("kind") == "span"
               and e.get("name") == "serve.batch"
               and e["traces"][0].startswith("r")]
    served = sorted(t for e in batches for t in e["traces"])
    if served != sorted(f"r{i}" for i in range(n)):
        raise AssertionError(f"{label} serve path: batches served {served}")
    cache = {} if ref_cache is None else ref_cache
    bank, escalated, mismatch = None, 0, []
    with torch.no_grad():
        for e in batches:
            idx = [int(t[1:]) for t in e["traces"]]
            key = (cfg.base_arch, cfg.img_size, cfg.model_dir, cfg.defense,
                   tuple(idx))
            if key not in cache:
                if bank is None:
                    bank = defense.build_defenses(
                        svc.apply_fn, cfg.img_size, cfg.defense,
                        incremental=svc._incremental_engine, device=dev)
                x = torch.as_tensor(images[idx], device=dev)
                recs = [d.robust_predict(x, svc.num_classes,
                                         bucket_sizes=svc.bucket_sizes)
                        for d in bank]
                esc = sum(int((d.last_min_margin
                               < cfg.defense.incremental_margin).sum())
                          for d in bank if d.last_min_margin is not None)
                clean = svc.apply_fn(data.pad_to_bucket(
                    x, e["bucket"])).argmax(dim=-1).cpu().numpy()
                cache[key] = esc, [
                    ([(r.prediction, bool(r.certification))
                      for r in (rs[pos] for rs in recs)], int(clean[pos]),
                     sum(int(rs[pos].forwards) for rs in recs))
                    for pos in range(len(idx))]
            esc, wants = cache[key]
            escalated += esc
            for i, want in zip(idx, wants):
                a = answers[i][1]
                got = ([(v["prediction"], v["certified"])
                        for v in a["verdicts"]], a["clean_prediction"],
                       a["certify_forwards"])
                if got != want:
                    mismatch.append((i, got, want))
    del bank
    torch.cuda.empty_cache()
    if mismatch:
        raise AssertionError(f"{label} serve path: answers differ from "
                             f"robust_predict: {mismatch}")
    # -- the kernels --
    need = list(required)
    bf16 = cfg.defense.compute_dtype == "bfloat16"
    audit = "masked_fill_fwd_bf16" if bf16 else "masked_fill_fwd"
    if cfg.base_arch != "vit" and \
            (counts[audit] > 0) != (sched["pair_audits"] > 0):
        raise AssertionError(f"{label} serve path: {audit} launched "
                             f"{counts[audit]} times for "
                             f"{sched['pair_audits']} pair audits")
    if bf16 and cfg.base_arch == "resnetv2" and \
            (counts["masked_fill_fwd"] > 0) != (escalated > 0):
        raise AssertionError(f"{label} serve path: masked_fill_fwd launched "
                             f"{counts['masked_fill_fwd']} times for "
                             f"{escalated} escalated (image, radius) records")
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} serve path")
    # -- the drill --
    names = [e.get("name") for e in events]
    if drill:
        sick = [e for e in events if e.get("name") == "serve.replica.sick"]
        if (not sick or sick[0]["cause"] != "wedged"
                or sick[0]["replica"] != 0
                or "serve.replica.quarantine" not in names
                or "serve.replica.restart" not in names
                or stats["failover"]["redispatched"] < 1
                or health["replicas"]["healthy"] != 2):
            raise AssertionError(f"{label} failover drill: sick {sick}, "
                                 f"events {sorted(set(names) - {None})}, "
                                 f"failover {stats['failover']}, health "
                                 f"{health}")
    # -- the numbers: each replica's boot warmup (a restart warms again
    #    after its replica's start event) --
    warm_sum = {}
    for i, e in enumerate(events):
        if e.get("name") in ("serve.warmup", "serve.warmup_pruned") and \
                i < _first_start(events, e["replica"]):
            warm_sum[e["replica"]] = round(
                warm_sum.get(e["replica"], 0.0) + e["dur_s"], 3)
    lat = sorted(a[2] * 1e3 for a in answers)

    def pct(q):
        return lat[max(0, min(n - 1, math.ceil(q * n) - 1))]

    cf = stats["certify_forwards"]
    print(f"{label} serve path ({cfg.serve.replicas} replica"
          f"{'s' if cfg.serve.replicas > 1 else ''}, buckets "
          f"{list(svc.bucket_sizes)}, {n} requests at concurrency "
          f"{concurrency}; {smi}): start {start_s:.1f} s, warmup s per "
          f"replica {warm_sum}; client latency p50/p95/p99 "
          f"{pct(0.5):.0f}/{pct(0.95):.0f}/{pct(0.99):.0f} ms (server "
          f"{stats['latency_ms']}); {n / wall:.2f} images/s over "
          f"{wall:.2f} s; {stats['batches']} batches, occupancy "
          f"{stats['occupancy']}; forwards per image {cf['per_request']} "
          f"(forward equivalents {cf['forward_equivalents_per_request']}, "
          f"prune rate {cf['prune_rate']}); {sched['pair_audits']} pair "
          f"audits, {sched['rows']} minority rows, {escalated} escalated "
          f"(image, radius) records; failover {stats.get('failover')}; "
          + (f"device busy {busy[0]:.3f} of a {profile_s:g} s torch.profiler "
             f"capture ({busy[1]} kernels and copies); " if busy and busy[1]
             else "device busy share not measured (the capture holds no "
             "device event); " if busy else "")
          + f"launches {counts}; routes {routes}", flush=True)
    return counts


def _first_start(events, replica):
    """Index of `replica`'s first serve.replica.start event: its warmup
    events before it are its boot warmup (a restart warms again later)."""
    for i, e in enumerate(events):
        if e.get("name") == "serve.replica.start" and \
                e.get("replica") == replica:
            return i
    return len(events)


def serve_phase(torch, dev, out, smi):
    """The serving paths (SERVE_*), each held by `serve_path`: RN50 at 224
    with 1 and 2 replicas in float32, with 2 in the bf16 bank; the CIFAR
    ResNet-18 trained into `out` with 2 replicas and the wedge_dispatch
    drill; ViT-B/16's bf16 bank at batch 1. Returns the serve paths'
    kernel records with their launches (from the 2-replica runs)."""
    from dorpatch_tpu_torch import data

    t0 = time.perf_counter()
    recs = serve_kernels(torch, dev)
    print(f"serve kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    rn50 = _serve_images(224, SERVE_RN50_REQUESTS, 1234)
    counts, ref_cache = {}, {}
    for label, flags, reps in (("RN50", [], (1, 2)),
                               ("RN50 bf16", CERTIFY_BF16, (2,))):
        for replicas in reps:
            t0 = time.perf_counter()
            counts[label] = serve_path(
                torch, dev, label, SERVE_RN50_ARGV + flags + [
                    "--serve-replicas", str(replicas)], rn50,
                SERVE_KERNELS[label], smi,
                profile_s=SERVE_PROFILE_S if replicas == 2 else 0.0,
                ref_cache=ref_cache)
            print(f"{label} serve phase ({replicas} replicas): "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    held_out, _ = data.procedural_arrays("cifar10", 3, 32, 1234, "test")
    counts["CIFAR"] = serve_path(
        torch, dev, "trained CIFAR", SERVE_CIFAR_ARGV + [
            "--model_dir", out, "--data-source", "procedural"],
        held_out[:SERVE_REQUESTS], SERVE_KERNELS["CIFAR"], smi,
        concurrency=2 * SERVE_CONCURRENCY, drill=True)
    print(f"trained CIFAR serve phase (failover drill): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts["ViT bf16"] = serve_path(
        torch, dev, "ViT bf16", SERVE_VIT_ARGV,
        _serve_images(224, SERVE_VIT_REQUESTS, 99),
        SERVE_KERNELS["ViT bf16"], smi, concurrency=2)
    print(f"ViT bf16 serve phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    out_recs = []
    for path, rs in recs.items():
        for rec in rs:
            name = rec["name"].replace("_serve_rn50", "").replace(
                "_serve_cifar", "").replace("_serve_vit", "")
            rec["launches"] = counts[path][
                name.replace("_pairs", "")]
            out_recs.append(rec)
    return out_recs


# ------------------------------------------------------------- the fleet


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _recert(*argv):
    """`python -m dorpatch_tpu_torch.recert` in this process: (exit code,
    stdout, stderr)."""
    import contextlib
    import io

    from dorpatch_tpu_torch.recert.__main__ import main as recert_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = recert_main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _post(url, image, trace_id, deadline_ms):
    """One `POST /predict` of `image`: (answer, client seconds)."""
    import urllib.error
    import urllib.request

    body = json.dumps({"image": image.tolist(), "deadline_ms": deadline_ms,
                       "trace_id": trace_id}).encode()
    req = urllib.request.Request(url + "/predict", data=body, headers={
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=deadline_ms / 1e3 + 60) as r:
            ans = json.loads(r.read())
    except urllib.error.HTTPError as e:
        ans = json.loads(e.read())
    return ans, time.perf_counter() - t0


def _pcts(seconds):
    """p50/p95/p99 (nearest rank) of `seconds`, in ms."""
    lat = sorted(t * 1e3 for t in seconds)
    n = len(lat)
    return [round(lat[max(0, min(n - 1, math.ceil(q * n) - 1))], 1)
            for q in (0.5, 0.95, 0.99)]


def _spawn_backend(root, port, argv):
    """`python -m dorpatch_tpu_torch.serve` on `port`, telemetry under
    `root`/serve, output in `root`/backend.log."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    os.makedirs(root, exist_ok=True)
    log = open(os.path.join(root, "backend.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dorpatch_tpu_torch.serve", *argv,
         "--results-root", root, "--serve-port", str(port)],
        cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def _await_warm(proc, url, root, t0):
    """Seconds from `t0` until the backend at `url` answers warm."""
    while time.perf_counter() - t0 < FLEET_BOOT_S:
        if proc.poll() is not None:
            break
        try:
            code, body = _get(url + "/healthz")
            if code == 200 and json.loads(body).get("warm"):
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.2)
    with open(os.path.join(root, "backend.log")) as fh:
        tail = fh.read()[-3000:]
    raise AssertionError(f"fleet backend {url} never became warm (exit "
                         f"{proc.poll()}): {tail}")


def _stop_backend(proc):
    """SIGINT (a clean stop: the queue drains, metrics.json is written);
    the exit code."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def _launches_of(result_dir):
    """`kernel_launches_total` by kernel from a metrics.json."""
    path = os.path.join(result_dir, "metrics.json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        snap = json.load(fh)["metrics"]
    return {s["labels"]["kernel"]: int(s["value"]) for s in
            snap.get("kernel_launches_total", {}).get("series", [])}


def _event_ts(path, pred):
    with open(path) as fh:
        for line in fh:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if pred(e):
                return float(e["ts"])
    return None


def _recert_drain(torch, label, recert_dir, spec_path, baseline):
    """One `recert run --update-baseline` in this process (its farm
    worker on the card), with the launch counts set to 0 just before and
    read just after: (seconds, launches, per-job seconds)."""
    from dorpatch_tpu_torch import ops
    from dorpatch_tpu_torch.farm.queue import JobQueue
    from dorpatch_tpu_torch.recert.scheduler import RecertScheduler

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out, err = _recert("run", recert_dir, "--spec", spec_path,
                           "--baseline-file", baseline, "--update-baseline",
                           "--poll-interval", "0.1", "--lease-ttl", "30",
                           "--worker-id", "recert-fleet", "--device", "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if rc != 0:
        raise AssertionError(f"recert {label} run exited {rc}: {out[-2000:]} "
                             f"{err[-2000:]}")
    for name in RECERT_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"recert {label} drain: {launches}")
    _, farm_dir = RecertScheduler(recert_dir,
                                  baseline_file=baseline).latest_completed()
    jq = JobQueue(farm_dir)
    jobs = {j: jq.read_job(j) for j in jq.job_ids()}
    per_job = {j: round(job.get("completed_ts", 0.0)
                        - job.get("started_ts", 0.0), 2)
               for j, job in jobs.items()}
    if {job["state"] for job in jobs.values()} != {"done"} or \
            len(jobs) != len(RECERT_BUDGETS):
        raise AssertionError(f"recert {label} jobs: {jobs}")
    return wall, {k: v for k, v in launches.items() if v}, per_job


def fleet_phase(torch, dev, out, smi) -> dict:
    """The certified fleet on the CIFAR ResNet-18 trained into `out`,
    mirroring the JAX package's recert and gateway drills on the card.

    1. Recert, crash-resumed: a control generation (`recert run
       --update-baseline`, the RECERT_* spec, its farm worker in this
       process on the card); the same spec in a second process with
       `--chaos recert_kill_cycle,recert_torn_state` must die by SIGKILL
       right after submitting, its state file torn; a plain re-run of
       that directory in this process must resume generation 1 (no
       gen_0002) and write a baseline byte-identical to the control's.
       Both drains must launch A, B and the bf16 forms of C and A.
    2. The regression gate: one baseline entry lifted RECERT_PLANT points
       past its tolerance makes `recert check` exit 1 naming the cell
       under DP400; `--require-recert strict` then raises
       `RecertGateError` in `CertifiedInferenceService.from_config` with
       no victim built (`registry.get_model` counted) and no kernel
       launched; `warn` boots, answers FLEET_DIRECT requests over HTTP
       and answers 503 on `GET /robustness`, rendering the cell as
       regressed; with the entry restored `recert check` exits 0 on an
       "ok" verdict.
    3. The fleet: two `python -m dorpatch_tpu_torch.serve` processes
       (FLEET_SERVE_ARGV, `--require-recert strict` on the ok directory;
       the second with `--chaos kill_backend`) and a third, the canary,
       boot at once; an in-process `Gateway` fronts the first two.
       FLEET_REQUESTS closed-loop requests (concurrency 1) through it
       while backend 2 SIGKILLs itself: every answer ok, answered once,
       equal to the port's `robust_predict` on the same image (per radius
       prediction and certificate, the clean prediction, the forwards),
       some request re-dispatched, backend 2 ejected. The canary joins;
       `RollingDeploy` with `poison_canary` must roll back (the
       `gateway.rollback` event and counter, the canary drained, the
       stable weight restored), and FLEET_POST more requests must be
       answered by the stable backend.
    4. The report: `python -m dorpatch_tpu_torch.observe.report --fleet`
       over the client, the gateway and the three backends must exit 0
       (client == gateway == the sum of the backends, no orphaned trace
       id) and render the rollback; the recert directory's report is
       printed.

    Prints, beside the card, the generations' wall and per-job seconds,
    the strict refusal's seconds from construction to the raise, the
    gateway's client p50/p95/p99 beside the direct service's, the kill
    to ejection and the poisoned evaluation to rollback seconds. Returns
    {"recert": launches of both drains, "backends": the backends' kernel
    launches after warmup (their metrics.json)}."""
    import numpy as np

    from dorpatch_tpu_torch import data, defense, ops
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.config import GatewayConfig
    from dorpatch_tpu_torch.gateway import Gateway, GatewayFrontend, \
        RollingDeploy
    from dorpatch_tpu_torch.gateway.membership import backend_name
    from dorpatch_tpu_torch.models import registry
    from dorpatch_tpu_torch.observe import MetricRegistry, labeled_values
    from dorpatch_tpu_torch.observe import report as report_mod
    from dorpatch_tpu_torch.recert.gate import RecertGateError
    from dorpatch_tpu_torch.recert.scheduler import RecertScheduler
    from dorpatch_tpu_torch.serve import CertifiedInferenceService, \
        HttpFrontend

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    held, _ = data.procedural_arrays("cifar10", 2, 32, 1234, "test")
    images = held[:FLEET_IMAGES]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        d = {k: os.path.join(tmp, k) for k in (
            "control", "chaos", "strict", "warn", "backend1", "backend2",
            "canary", "gateway", "client")}
        spec = {"base": {"dataset": "cifar10", "base_arch": "resnet18",
                         "img_size": 32, "batch_size": 8,
                         "data_source": "procedural", "model_dir": out,
                         "attack": RECERT_ATTACK,
                         "defense": {"compute_dtype": "bfloat16"}},
                "axes": {"attack.patch_budget": RECERT_BUDGETS},
                "sweep": {"defense_ratio": 0.06}, "max_attempts": 2}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        control_rb = os.path.join(tmp, "control_baseline.json")
        chaos_rb = os.path.join(tmp, "chaos_baseline.json")

        # -- 1. recert: control, killed, resumed --
        control_s, control_launches, control_jobs = _recert_drain(
            torch, "control", d["control"], spec_path, control_rb)
        with open(control_rb, "rb") as fh:
            control_bytes = fh.read()
        t0 = time.perf_counter()
        killed = subprocess.run(
            [sys.executable, "-m", "dorpatch_tpu_torch.recert", "run",
             d["chaos"], "--spec", spec_path, "--baseline-file", chaos_rb,
             "--update-baseline", "--device", "cuda", "--chaos",
             "recert_kill_cycle,recert_torn_state", "--crash-mode", "kill"],
            cwd=here, env=env, capture_output=True, text=True, timeout=300)
        killed_s = time.perf_counter() - t0
        state_path = os.path.join(d["chaos"], "recert_state.json")
        try:
            with open(state_path) as fh:
                json.load(fh)
            torn = False
        except (OSError, ValueError):
            torn = True
        if killed.returncode != -9 or not torn or os.path.exists(chaos_rb):
            raise AssertionError(
                f"recert chaos run: exit {killed.returncode} (want -9), "
                f"state torn {torn}, baseline written "
                f"{os.path.exists(chaos_rb)}: {killed.stderr[-2000:]}")
        resume_s, resume_launches, resume_jobs = _recert_drain(
            torch, "resume", d["chaos"], spec_path, chaos_rb)
        st = RecertScheduler(d["chaos"], baseline_file=chaos_rb).status()
        with open(chaos_rb, "rb") as fh:
            chaos_bytes = fh.read()
        gens = sorted(n for n in os.listdir(d["chaos"])
                      if n.startswith("gen_"))
        if (st["generation"], st["inflight"], gens) != (1, None,
                                                          ["gen_0001"]):
            raise AssertionError(f"the resume did not finish generation 1: "
                                 f"{st}, {gens}")
        if chaos_bytes != control_bytes:
            raise AssertionError(
                f"the crash-resumed baseline differs from the control's: "
                f"{chaos_bytes!r} != {control_bytes!r}")
        entries = json.loads(chaos_bytes)["entries"]
        if len(entries) != len(RECERT_BUDGETS) or \
                (st.get("verdict") or {}).get("status") != "ok":
            raise AssertionError(f"recert baseline {entries}, status {st}")
        print(f"fleet recert (batch 8, 10 iterations, bf16 attack and "
              f"certify; {smi}): control generation {control_s:.1f} s, jobs "
              f"{control_jobs} s; killed scheduler {killed_s:.1f} s (exit "
              f"{killed.returncode}, state torn); resume {resume_s:.1f} s, "
              f"jobs {resume_jobs} s; baselines byte-identical "
              f"({len(chaos_bytes)} bytes): {entries}; drain launches "
              f"control {control_launches}, resume {resume_launches}",
              flush=True)

        # -- 2. the regression gate --
        planted = sorted(entries)[0]
        data_rb = json.loads(chaos_bytes)
        data_rb["entries"][planted]["robust_accuracy"] += RECERT_PLANT
        with open(chaos_rb, "w") as fh:
            json.dump(data_rb, fh)
        rc, out_check, _ = _recert("check", d["chaos"], "--baseline-file",
                                   chaos_rb)
        if rc != 1 or "DP400" not in out_check or planted not in out_check:
            raise AssertionError(f"recert check on a planted regression: "
                                 f"exit {rc}, {out_check!r}")

        def serve_cfg(root, require):
            return config_from_args(build_parser().parse_args(
                FLEET_SERVE_ARGV + ["--model_dir", out, "--results-root",
                                    root, "--serve-port", "0",
                                    "--recert-dir", d["chaos"],
                                    "--require-recert", require]))

        built, plain_get = [], registry.get_model

        def counting_get(*args, **kwargs):
            built.append(args)
            return plain_get(*args, **kwargs)

        registry.get_model = counting_get
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            CertifiedInferenceService.from_config(
                serve_cfg(d["strict"], "strict"))
            refused = None
        except RecertGateError as e:
            refused = str(e)
        finally:
            registry.get_model = plain_get
        refuse_s = time.perf_counter() - t0
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        if refused is None or "failing" not in refused or built or launched:
            raise AssertionError(f"strict boot on a failing verdict: "
                                 f"refused {refused!r}, victims built "
                                 f"{len(built)}, launches {launched}")
        warn_cfg = serve_cfg(d["warn"], "warn")
        svc = CertifiedInferenceService.from_config(warn_cfg).start()
        try:
            with HttpFrontend(svc, "127.0.0.1", 0) as fe:
                url = f"http://127.0.0.1:{fe.port}"
                direct = [_post(url, images[i % FLEET_IMAGES], f"d{i}",
                                warn_cfg.serve.deadline_ms)
                          for i in range(FLEET_DIRECT)]
                code, body = _get(url + "/robustness")
        finally:
            svc.stop()
        robust = json.loads(body)
        cell = (robust.get("cells") or {}).get(planted, {})
        if (code, robust.get("status"), cell.get("status")) != (
                503, "failing", "regressed") or any(
                a.get("status") != "ok" for a, _ in direct):
            raise AssertionError(f"warn boot: /robustness {code} {robust}, "
                                 f"answers {[a for a, _ in direct]}")
        with open(chaos_rb, "wb") as fh:
            fh.write(chaos_bytes)
        rc, out_check, _ = _recert("check", d["chaos"], "--baseline-file",
                                   chaos_rb)
        verdict = RecertScheduler(d["chaos"],
                                  baseline_file=chaos_rb).status()["verdict"]
        if rc != 0 or verdict["status"] != "ok":
            raise AssertionError(f"recert check after the restore: exit "
                                 f"{rc}, verdict {verdict}")
        print(f"fleet regression gate: check exit 1 naming {planted} under "
              f"DP400; strict refusal {refuse_s * 1e3:.1f} ms from "
              f"construction to RecertGateError (0 victims built, 0 "
              f"launches); warn served {FLEET_DIRECT} requests, "
              f"/robustness 503 with the cell regressed; restored: check "
              f"exit 0, verdict ok", flush=True)

        # -- 3. the fleet --
        ports = [_free_port() for _ in range(3)]
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        fleet_argv = FLEET_SERVE_ARGV + ["--model_dir", out, "--recert-dir",
                                         d["chaos"], "--require-recert",
                                         "strict"]
        roots = [d["backend1"], d["backend2"], d["canary"]]
        t0 = time.perf_counter()
        procs = [_spawn_backend(roots[0], ports[0], fleet_argv),
                 _spawn_backend(roots[1], ports[1], fleet_argv
                                + ["--chaos", "kill_backend"]),
                 _spawn_backend(roots[2], ports[2], fleet_argv)]
        try:
            boots = [round(_await_warm(p, u, r, t0), 1)
                     for p, u, r in zip(procs, urls, roots)]
            names = [backend_name(u) for u in urls]
            cfg = GatewayConfig(
                backends=tuple(urls[:2]), probe_interval_s=0.3,
                probe_jitter=0.1, fail_threshold=2, ok_threshold=1,
                inflight_cap=32, dispatch_retries=2,
                canary_steps=(0.5, 1.0), canary_hold_s=0.4,
                chaos="poison_canary")
            gateway = Gateway(cfg, result_dir=d["gateway"])
            client = MetricRegistry()
            m_client = client.counter(
                "loadgen_requests_total",
                help="client-side attempts by terminal status")
            answers = []
            with gateway, GatewayFrontend(gateway, port=0) as gfe:
                gw_url = f"http://127.0.0.1:{gfe.port}"
                t1 = time.perf_counter()
                while gateway.healthz()["routable"] != 2:
                    if time.perf_counter() - t1 > 60:
                        raise AssertionError(f"the fleet never probed "
                                             f"healthy: {gateway.healthz()}")
                    time.sleep(0.1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for i in range(FLEET_REQUESTS):
                    answers.append((i % FLEET_IMAGES, *_post(
                        gw_url, images[i % FLEET_IMAGES], f"fl{i}", 60000.0)))
                    m_client.inc(status=str(answers[-1][1].get("status")))
                load_s = time.perf_counter() - t1
                try:
                    procs[1].wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass
                t1 = time.perf_counter()
                while gateway.registry.get(names[1]).snapshot()["state"] \
                        != "ejected":
                    if time.perf_counter() - t1 > 60:
                        raise AssertionError("the gateway never ejected "
                                             "the killed backend")
                    time.sleep(0.1)
                gateway.add_backend(urls[2])
                deploy = RollingDeploy(gateway, [names[2]]).run(
                    warm_timeout_s=60)
                snaps = {b.name: b.snapshot()
                         for b in gateway.registry.backends()}
                rollbacks = int(gateway.metrics.value(
                    "gateway_rollbacks_total"))
                for i in range(FLEET_POST):
                    answers.append((i, *_post(gw_url, images[i],
                                              f"post{i}", 60000.0)))
                    m_client.inc(status=str(answers[-1][1].get("status")))
            stops = [_stop_backend(procs[0]), _stop_backend(procs[2])]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        os.makedirs(d["client"])
        client.dump(os.path.join(d["client"], "metrics_client.json"))
        serve_dirs = [os.path.join(r, "serve") for r in roots]
        kill_marker = os.path.join(serve_dirs[1], "chaos_kill_backend.fired")
        gw_events = os.path.join(d["gateway"], "events.jsonl")
        t_kill = (os.path.getmtime(kill_marker)
                  if os.path.exists(kill_marker) else None)
        t_eject = _event_ts(gw_events, lambda e: e.get("name") ==
                            "gateway.membership" and e.get("backend") ==
                            names[1] and e.get("state") == "ejected")
        poison_marker = os.path.join(d["gateway"],
                                     "chaos_poison_canary.fired")
        t_poison = (os.path.getmtime(poison_marker)
                    if os.path.exists(poison_marker) else None)
        t_rollback = _event_ts(gw_events, lambda e: e.get("name") ==
                               "gateway.rollback")
        launches = {}
        for sd in serve_dirs:
            for k, v in _launches_of(sd).items():
                launches[k] = launches.get(k, 0) + v

        # -- 4. the report --
        fleet_dirs = [d["client"], d["gateway"], *serve_dirs]
        rep = subprocess.run(
            [sys.executable, "-m", "dorpatch_tpu_torch.observe.report",
             "--fleet", *fleet_dirs], cwd=here, env=env, capture_output=True,
            text=True, timeout=120)
        fleet = report_mod.summarize_fleet_dirs(fleet_dirs)
        rec_rep = subprocess.run(
            [sys.executable, "-m", "dorpatch_tpu_torch.observe.report",
             d["chaos"]], cwd=here, env=env, capture_output=True, text=True,
            timeout=120)
        print(rep.stdout, flush=True)
        print(rec_rep.stdout, flush=True)

        # -- the reference: robust_predict on each image, batch 1 --
        cfg_ref = serve_cfg(d["warn"], "off")
        victim = registry.get_model(cfg_ref.dataset, cfg_ref.base_arch,
                                    cfg_ref.model_dir, cfg_ref.img_size,
                                    device=dev)
        bank = defense.build_defenses(victim.apply, cfg_ref.img_size,
                                      cfg_ref.defense,
                                      incremental=victim.incremental,
                                      device=dev)
        want = {}
        with torch.no_grad():
            for i in sorted({i for i, _, _ in answers}):
                x = torch.as_tensor(images[i:i + 1], device=dev)
                recs = [b.robust_predict(x, victim.num_classes,
                                         bucket_sizes=(1,))[0]
                        for b in bank]
                want[i] = ([(r.prediction, bool(r.certification))
                            for r in recs],
                           int(victim.apply(x).argmax(dim=-1)[0]),
                           sum(int(r.forwards) for r in recs))
        del bank, victim
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    statuses = [a.get("status") for _, a, _ in answers]
    by_backend, retried, mismatch = {}, 0, []
    for i, a, _ in answers:
        g = a.get("gateway") or {}
        by_backend[g.get("backend")] = by_backend.get(g.get("backend"), 0) + 1
        retried += 1 if g.get("retries") else 0
        got = ([(v["prediction"], v["certified"]) for v in a["verdicts"]],
               a["clean_prediction"], a["certify_forwards"]) \
            if a.get("status") == "ok" else None
        if got != want[i]:
            mismatch.append((a.get("trace_id"), got, want[i]))
    client_counts = {k: int(v) for k, v in labeled_values(
        client.snapshot(), "loadgen_requests_total", "status").items()}
    gw_lat = [t for _, _, t in answers[:FLEET_REQUESTS]]
    svc_lat = [a["latency_ms"] / 1e3 for _, a, _ in answers[:FLEET_REQUESTS]
               if "latency_ms" in a]
    print(f"fleet phase ({smi}): {wall:.1f} s wall; backends warm in "
          f"{boots} s from their start (together); "
          f"{FLEET_REQUESTS} requests through the gateway in {load_s:.2f} s "
          f"({FLEET_REQUESTS / load_s:.2f} images/s at concurrency 1), "
          f"client latency p50/p95/p99 {_pcts(gw_lat)} ms (the backends' "
          f"service latency {_pcts(svc_lat)} ms), direct to the warn "
          f"service {_pcts([t for _, t in direct])} ms (its service "
          f"latency {_pcts([a['latency_ms'] / 1e3 for a, _ in direct])} "
          f"ms); answered by "
          f"{by_backend}, {retried} re-dispatched; kill to ejection "
          + (f"{t_eject - t_kill:.2f} s" if t_kill and t_eject else "n/a")
          + "; poisoned evaluation to rollback "
          + (f"{t_rollback - t_poison:.3f} s" if t_poison and t_rollback
             else "n/a")
          + f"; deploy {deploy}; backend exits {stops}; backend launches "
          f"after warmup {launches}", flush=True)
    if statuses != ["ok"] * (FLEET_REQUESTS + FLEET_POST):
        raise AssertionError(f"fleet requests lost or failed: {statuses}")
    if mismatch:
        raise AssertionError(f"fleet answers differ from robust_predict: "
                             f"{mismatch}")
    if t_kill is None or procs[1].returncode != -9 or retried < 1 or \
            by_backend.get(names[0], 0) < 1:
        raise AssertionError(f"kill_backend: marker {t_kill}, exit "
                             f"{procs[1].returncode}, re-dispatched "
                             f"{retried}, answered by {by_backend}")
    if (deploy["outcome"] != "rolled_back" or "DP400" not in
            deploy["reason"] or rollbacks != 1 or t_poison is None
            or snaps[names[2]]["state"] != "draining"
            or snaps[names[2]]["weight"] != 0.0
            or snaps[names[0]]["weight"] != 1.0
            or any((a.get("gateway") or {}).get("backend") == names[2]
                   for _, a, _ in answers)):
        raise AssertionError(f"canary rollback: {deploy}, rollbacks "
                             f"{rollbacks}, roster {snaps}")
    if stops != [0, 0]:
        raise AssertionError(f"backends' clean stop exited {stops}")
    if (rep.returncode != 0 or fleet["traces"]["orphans"]
            or not fleet["consistent"]
            or fleet["gateway"]["by_status"] != client_counts
            or fleet["gateway"]["rollbacks"] != 1
            or "gateway rollbacks: 1" not in rep.stdout
            or "orphaned traces: 0" not in rep.stdout
            or rec_rep.returncode != 0
            or "re-certification report" not in rec_rep.stdout):
        raise AssertionError(f"fleet report: exit {rep.returncode}, "
                             f"{fleet['checks']}, orphans "
                             f"{fleet['traces']['orphans'][:4]}, client "
                             f"{client_counts}; {rep.stdout[-2000:]} "
                             f"{rec_rep.stdout[-1000:]}")
    for name in FLEET_KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"fleet's backends: {launches}")
    recert = dict(control_launches)
    for k, v in resume_launches.items():
        recert[k] = recert.get(k, 0) + v
    return {"recert": recert, "backends": launches}


# ------------------------------------------------------------------ remat
#
# Remat (`--remat`, `--remat-policy`, `models/remat.py`) checkpoints each
# residual block of the victim under the attack's gradient forward: loss and
# gradients must be bit-equal with it on and off, and it must let RN50 at
# 480 px run a batch of 2, whose activations (about 90 GiB in float32) do
# not fit the card without it.

#: the slice's full-width path: RN50 at 480 px, 2 images a batch, remat on
RN50_480_B2_ARGV = (RN50_480_ARGV[:RN50_480_ARGV.index("-b") + 1] + ["2"]
                    + RN50_480_ARGV[RN50_480_ARGV.index("-b") + 2:]
                    + ["--remat", "on"])
#: the policies whose RN50 480 batch-2 step fits the card ("conv" keeps
#: every std-conv output of a block: it does not fit, dev run, PERF.md §5);
#: "dots" equals "full" on a conv victim
REMAT_480_POLICIES = ("full", "dots")


def _remat_grads(torch, atk, x, lvx, rects, state):
    """One EOT step's loss and both gradients (stage 0)."""
    m = state.adv_mask.detach().clone().requires_grad_(True)
    p = state.adv_pattern.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        total, _ = atk._loss_and_aux(m, p, x, lvx, rects, state, 0)
        g_mask, g_pattern = torch.autograd.grad(total, (m, p))
    return total.detach(), g_mask, g_pattern


def remat_step_check(torch, dev, label, arch, size, b, dtype, modes,
                     stats_check=False):
    """One attack step (stage 0, `sampling_size` 128, dropout 2, one
    injected draw) of `arch` at `size` px on `b` images in `dtype`, under
    each of `modes` (None: remat off; else the policy, remat on): loss and
    both gradients must equal the first mode's (`torch.equal`). Prints each
    mode's peak device memory, ms a step (the second of two calls) and
    GroupNorm forward/backward launches a step. `stats_check`: the
    GroupNorm statistics (mean, rstd) that kernel D recomputes in the
    backward under remat must equal the first forward's bit for bit."""
    from dorpatch_tpu_torch import losses, ops, utils
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.attack import DorPatch
    from dorpatch_tpu_torch.config import AttackConfig
    from dorpatch_tpu_torch.models import get_model
    from dorpatch_tpu_torch.ops import fused_gn

    victim = get_model("imagenet", arch, "/nonexistent", size, device=dev)
    x = torch.rand((b, size, size, 3), generator=utils.generator(1, dev),
                   device=dev)
    y = torch.argmax(victim.apply(x), -1)
    lvx = torch.mean(losses.local_variance(x)[0], dim=-1)
    base = AttackConfig(sampling_size=128, compute_dtype=dtype)
    universe = torch.as_tensor(masks_lib.dropout_universe(
        size, base.dropout, base.dropout_sizes), device=dev)
    idx = torch.randperm(universe.shape[0], generator=utils.generator(
        2, torch.device("cpu")))[:128].to(dev)
    rects = universe[idx]
    gn = "gn_relu_fwd" + ("_bf16" if dtype == "bfloat16" else "")
    gnb = gn.replace("fwd", "bwd")
    plain_fwd = fused_gn.gn_relu_fwd_kernel
    out, stats = {}, []

    def recording_fwd(xg, *args, **kwargs):
        y_, mean, rstd = plain_fwd(xg, *args, **kwargs)
        stats.append((tuple(xg.shape), float(xg.double().sum()),
                      mean.clone(), rstd.clone()))
        return y_, mean, rstd

    for mode in modes:
        cfg = AttackConfig(sampling_size=128, compute_dtype=dtype,
                           remat="off" if mode is None else "on",
                           remat_policy=mode or "full")
        atk = DorPatch(victim.apply, victim.num_classes, cfg)
        state = atk._init_state(utils.generator(0, dev), x, y, False,
                                universe.shape[0])
        _remat_grads(torch, atk, x, lvx, rects, state)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        stats.clear()
        if stats_check:
            fused_gn.gn_relu_fwd_kernel = recording_fwd
        try:
            t0 = time.perf_counter()
            res = _remat_grads(torch, atk, x, lvx, rects, state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            fused_gn.gn_relu_fwd_kernel = plain_fwd
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[mode] = res
        same = [torch.equal(a, c) for a, c in zip(out[modes[0]], res)]
        name = "off" if mode is None else mode
        print(f"remat {label}: {name}: peak {peak:.2f} GiB, {ms:.1f} ms a "
              f"step, {gn} {counts[gn]} and {gnb} {counts[gnb]} launches a "
              f"step; loss and gradients equal to "
              f"{modes[0] or 'off'}: {same}", flush=True)
        if not all(same):
            raise AssertionError(f"remat {label} {name}: loss and gradients "
                                 f"differ from {modes[0] or 'off'}: {same}")
        if stats_check and mode is not None:
            # a call whose input (shape, float64 sum) was seen before is
            # the backward's recomputation of that forward call
            fwd = {}
            for shape, key, mean, rstd in stats:
                fwd.setdefault((shape, key), (mean, rstd))
            bad = [i for i, (shape, key, mean, rstd) in enumerate(stats)
                   if not (torch.equal(fwd[(shape, key)][0], mean)
                           and torch.equal(fwd[(shape, key)][1], rstd))]
            print(f"remat {label}: {name}: {len(stats)} GroupNorm forward "
                  f"calls, {len(stats) - len(fwd)} recomputed in the "
                  f"backward, statistics differing from the first "
                  f"forward's: {bad}", flush=True)
            if bad or len(stats) == len(fwd):
                raise AssertionError(f"remat {label} {name}: recomputed "
                                     f"GroupNorm statistics {bad}, "
                                     f"{len(stats) - len(fwd)} recomputed")
    return out


def _records_equal(a, b) -> bool:
    import numpy as np

    return (a.prediction == b.prediction
            and bool(a.certification) == bool(b.certification)
            and np.array_equal(a.preds_1, b.preds_1)
            and np.array_equal(a.preds_2, b.preds_2)
            and a.forwards == b.forwards)


def remat_phase(torch, dev):
    """Remat on the card: one step of RN50 at 224 (float32 and bf16) and
    of ViT-B/16 (float32), batch 2, remat off and under each policy, loss
    and gradients bit-equal (`remat_step_check`); then the slice's path,
    RN50 at 480 px with 2 images a batch and `--remat on` through the CLI
    (`main_path`, 10 iterations), whose certification records must equal
    those of certifying its patch again in this process with remat off,
    and one step of it under each policy that fits beside the batch-1 step
    without remat. Returns the 480 px path's launch counts."""
    from dorpatch_tpu_torch import data, losses
    from dorpatch_tpu_torch.config import DefenseConfig
    from dorpatch_tpu_torch.defense import build_defenses
    from dorpatch_tpu_torch.models import get_model

    policies = (None, "full", "conv", "dots")
    for label, arch, dtype in (("RN50 224 f32", "resnetv2", "float32"),
                               ("RN50 224 bf16", "resnetv2", "bfloat16"),
                               ("ViT-B/16 224 f32", "vit", "float32")):
        remat_step_check(torch, dev, label, arch, 224, 2, dtype, policies,
                         stats_check=arch == "resnetv2")
        torch.cuda.empty_cache()
    remat_step_check(torch, dev, "RN50 480 f32 b1", "resnetv2", 480, 1,
                     "float32", (None,))
    remat_step_check(torch, dev, "RN50 480 f32 b2", "resnetv2", 480, 2,
                     "float32", REMAT_480_POLICIES)
    torch.cuda.empty_cache()

    label = "RN50 480 b2 remat"
    t0 = time.perf_counter()
    _, counts, records = main_path(torch, dev, label, RN50_480_B2_ARGV,
                                   RN50_KERNELS, gn_split_shares(480))
    print(f"{label} main-path phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    victim = get_model("imagenet", "resnetv2", "/nonexistent", 480,
                       device=dev)
    x_np, _ = next(data.synthetic_batches("imagenet", 2, 480, 1234))
    x = torch.as_tensor(x_np, device=dev)
    mask, pattern = (torch.as_tensor(a, device=dev) for a in PATCHES[label])
    adv_x = x + losses.l2_project(mask, pattern, x, 4.0)
    defenses = build_defenses(victim.apply, 480, DefenseConfig(),
                              incremental=victim.incremental, device=dev)
    with torch.no_grad():
        again = [list(r) for r in zip(*[
            d.robust_predict(adv_x, victim.num_classes,
                             bucket_sizes=data.batch_buckets(2))
            for d in defenses])]
    same = (len(again) == len(records) and all(
        _records_equal(a, b) for ra, rb in zip(again, records)
        for a, b in zip(ra, rb)))
    print(f"{label}: certification records equal to certifying its patch "
          f"with remat off: {same} ({len(records)} images)", flush=True)
    if not same:
        raise AssertionError(f"{label}: certification records differ")
    return counts


def sanitize_phase(torch, dev, out) -> None:
    """`--sanitize` on the trained CIFAR ResNet-18 through the CLI (10
    iterations): `sanitize.enabled` and the programs' budget events must
    be in its events.jsonl and no budget exceeded; then two NaNs planted
    in its attack, one made by an aten op (a victim wrapper's sqrt of a
    negative number) and one made inside kernel A (a NaN fill value), must
    each raise `FloatingPointError` naming the op, or the kernel."""
    from dorpatch_tpu_torch.analysis.sanitize import Sanitizer
    from dorpatch_tpu_torch.attack import DorPatch
    from dorpatch_tpu_torch.config import AttackConfig

    found = {}

    def inspect(result_dir):
        with open(os.path.join(result_dir, "events.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        found["names"] = sorted({r.get("name") for r in recs
                                 if r.get("kind") == "event"})
        found["budgets"] = {r["entry"]: r["budget"] for r in recs
                            if r.get("name") == "sanitize.budget"}
        found["compiles"] = sorted({r["name"] for r in recs
                                    if r.get("kind") == "compile"})

    label = "trained CIFAR sanitize"
    argv = _iterations(TRAINED_ARGV, SHORT_ITERATIONS) + [
        "--base_arch", "resnet18", "--model_dir", out]
    # the same run unsanitized first: what the sanitizer costs
    plain, _, _ = main_path(torch, dev, "trained CIFAR, 10 iterations",
                            argv, CIFAR_KERNELS)
    t0 = time.perf_counter()
    m, _, _ = main_path(torch, dev, label, argv + ["--sanitize"],
                        CIFAR_KERNELS, inspect=inspect)
    print(f"{label}: events {found['names']}; budgets {found['budgets']}; "
          f"compile records {found['compiles']}; "
          f"{time.perf_counter() - t0:.1f} s; attack and certify seconds "
          f"{m['attack_seconds']} {m['certify_seconds']} against "
          f"{plain['attack_seconds']} {plain['certify_seconds']} "
          f"unsanitized", flush=True)
    if ("sanitize.enabled" not in found["names"]
            or "sanitize.recompile_budget_exceeded" in found["names"]
            or found["budgets"].get("attack.step.stage0") != 8
            or found["budgets"].get("attack.sweep") != 8
            or not any(k.startswith("defense.") for k in found["budgets"])):
        raise AssertionError(f"{label}: sanitizer events {found}")

    victim = trained_victim("cifar10", "resnet18", out, 32, dev)
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator(dev).manual_seed(
        5), device=dev)
    y = torch.argmax(victim.apply(x), -1)

    def bad_victim(z):
        return victim.apply(z) * torch.sqrt(z.mean() - 1.0)

    base = AttackConfig(sampling_size=128, max_iterations=2)
    for what, atk, want in (
            ("an aten op", DorPatch(bad_victim, 10, base), "aten.sqrt"),
            ("kernel A", DorPatch(victim.apply, 10, AttackConfig(
                sampling_size=128, max_iterations=2,
                mask_fill=float("nan"))), "kernel masked_fill_fwd")):
        try:
            with Sanitizer():
                atk.generate(x, y=y, seed=1)
        except FloatingPointError as e:
            print(f"{label}: NaN planted in {what}: FloatingPointError: {e}",
                  flush=True)
            if want not in str(e):
                raise AssertionError(f"{label}: the NaN of {what} was "
                                     f"blamed elsewhere: {e}") from e
        else:
            raise AssertionError(f"{label}: the NaN of {what} raised nothing")


def verify_phase(torch, dev, out) -> None:
    """`python -m dorpatch_tpu_torch.models.verify` on the trained CIFAR
    ResNet-18's `.pth` and on an RN50 `.pth` written from the port's
    random init: keys clean against the timm contract, the card's logits
    within 1e-4 of the CPU's, argmax equal."""
    from dorpatch_tpu_torch.models import registry, verify

    with tempfile.TemporaryDirectory(prefix="chip_smoke_verify_") as tmp:
        rn50 = os.path.join(tmp, "resnetv2_50x1_bit_distilled_cutout2_128_"
                                 "imagenet.pth")
        model = registry.build_bare_model("resnetv2_50x1_bit_distilled",
                                          1000, 224, seed=0)
        torch.save({"state_dict": model.state_dict()}, rn50)
        del model
        cifar = registry.checkpoint_path(out, "cifar10", "cifar_resnet18")
        drift_keys = ("missing", "unexpected", "shape_drift")
        for path, arch, dataset, size in (
                (cifar, "resnet18", "cifar10", 32),
                (rn50, "resnetv2", "imagenet", 224)):
            rc = verify.main([path])
            report = verify.verify_checkpoint(path, arch, dataset,
                                              img_size=size)
            keys = verify.verify_keys(path, arch, dataset)
            print(f"verify {report['arch']}: exit {rc}; "
                  f"{json.dumps(report)}; key drift "
                  f"{[len(keys[k]) for k in drift_keys]}", flush=True)
            if (rc != 0 or report["max_abs_delta"] > 1e-4
                    or not report["argmax_agree"]):
                raise AssertionError(f"verify {path}: exit {rc}, {report}")


def main() -> int:
    import faulthandler

    import torch

    # a crash inside native code (the profiler, CUDA) prints every
    # thread's Python stack instead of a bare signal
    faulthandler.enable()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    start = time.perf_counter()
    smi = _smi()
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card: {smi}", flush=True)

    from dorpatch_tpu_torch import utils
    from dorpatch_tpu_torch.ops import _build

    dev = utils.resolve_device("cuda")
    utils.configure_numerics()
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    cifar_kernels = kernel_phases(torch, dev)
    rn50_kernels = fill_phase(torch, dev, 2, 224, "_224")
    rn50_kernels.append(stem_fold_phase(torch, dev, "imagenet", "resnetv2",
                                        224, 2, "stem_fold_rn50"))
    rn50_480 = fill_phase(torch, dev, 1, 480, "_480")
    rn50_480.append(stem_fold_phase(torch, dev, "imagenet", "resnetv2", 480,
                                    1, "stem_fold_480"))
    gn224, gn480 = gn_phases(torch, dev)
    rn50_kernels += gn224
    rn50_480 += gn480
    vit_kernels = attn_phase(torch, dev)
    print(f"kernel phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cifar_bf16 = [fill_phase_bf16(torch, dev, 8, 32),
                  stem_fold_phase(torch, dev, "cifar10", "resnet18", 32, 8,
                                  "stem_fold_bf16", torch.bfloat16)]
    rn50_bf16 = [fill_phase_bf16(torch, dev, 2, 224, "_224"),
                 stem_fold_phase(torch, dev, "imagenet", "resnetv2", 224,
                                 2, "stem_fold_bf16_rn50", torch.bfloat16)]
    rn50_480_bf16 = [fill_phase_bf16(torch, dev, 1, 480, "_480"),
                     stem_fold_phase(torch, dev, "imagenet", "resnetv2", 480,
                                     1, "stem_fold_bf16_480",
                                     torch.bfloat16)]
    gn224, gn480 = gn_phases_bf16(torch, dev)
    rn50_bf16 += gn224
    rn50_480_bf16 += gn480
    vit_bf16 = attn_phase(torch, dev, torch.bfloat16)
    np2_kernels = fill_phase_k3(torch, dev)
    print(f"bf16 kernel phases: {time.perf_counter() - t0:.1f} s",
          flush=True)

    fills, records_of = {}, {}
    at224, at480 = gn_split_shares(224), gn_split_shares(480)
    audit = "masked_fill_fwd_bf16"
    for label, argv, required, records, shares, audit_fill in (
            ("CIFAR", CIFAR_ARGV, CIFAR_KERNELS, cifar_kernels, None, None),
            ("RN50", RN50_ARGV, RN50_KERNELS, rn50_kernels, at224, None),
            ("ViT", VIT_ARGV, VIT_KERNELS, vit_kernels, None, None),
            ("CIFAR bf16", CIFAR_ARGV + BF16_FLAGS, CIFAR_BF16_KERNELS,
             cifar_bf16, None, audit),
            ("RN50 bf16", RN50_ARGV + BF16_FLAGS, RN50_BF16_KERNELS,
             rn50_bf16, at224, audit),
            ("ViT bf16", VIT_ARGV + BF16_FLAGS, VIT_BF16_KERNELS,
             vit_bf16, None, None),
            ("RN50 480", RN50_480_ARGV, RN50_KERNELS, rn50_480, at480, None),
            ("RN50 480 bf16", RN50_480_ARGV + BF16_FLAGS,
             RN50_480_BF16_KERNELS, rn50_480_bf16, at480, audit),
            ("ResMLP", RESMLP_ARGV, MIXER_KERNELS, [], None, None),
            ("ResMLP bf16", RESMLP_ARGV + BF16_FLAGS, MIXER_KERNELS, [],
             None, None),
            ("CIFAR n_patch=2", CIFAR_NP2_ARGV, NP2_KERNELS, np2_kernels[:1],
             None, None),
            ("CIFAR n_patch=2 bf16", CIFAR_NP2_ARGV + BF16_FLAGS,
             NP2_KERNELS, np2_kernels[1:], None, None),
            ("RN50 consensus", RN50_ARGV + CONSENSUS, RN50_KERNELS, [],
             at224, None),
            ("RN50 consensus bf16", RN50_ARGV + BF16_FLAGS + CONSENSUS,
             RN50_480_BF16_KERNELS, [], at224, audit)):
        t0 = time.perf_counter()
        _, counts, records_of[label] = main_path(
            torch, dev, label, argv, required, shares, audit_fill)
        for rec in records:
            rec["launches"] = counts.get(COUNT_OF.get(rec["name"],
                                                      rec["name"]), 0)
        fills[label] = counts
        if label.startswith("ViT"):
            kern = "masked_kv_attn" + ("_bf16" if "bf16" in label else "")
            first, pairs, by_s = attn_classes(counts, kern)
            print(f"{label} kernel H ({kern}) launches by dirty rows S "
                  f"{by_s}: phase-1 chunks {first}, pair audits and "
                  f"second-round rows {pairs}", flush=True)
        print(f"{label} main-path phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
    fill_overhead(fills, {"CIFAR": cifar_kernels[:2], "RN50": rn50_kernels[:2],
                          "ViT": rn50_kernels[:2], "RN50 480": rn50_480[:2],
                          "ResMLP": rn50_kernels[:2],
                          "CIFAR n_patch=2": np2_kernels[:1]})
    for label in ("RN50", "RN50 bf16"):
        consensus_check(label.replace("RN50", "RN50 consensus"),
                        records_of[label],
                        records_of[label.replace("RN50", "RN50 consensus")])
    disk_phase(torch, dev)
    t0 = time.perf_counter()
    rn50_carry_phase(torch, dev)
    print(f"RN50 carry phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        repeat_check(torch, dev, compute_dtype=dtype)
    print(f"repeat phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    remat_counts = remat_phase(torch, dev)
    # the 480 px records' launches on the batch-2 remat path beside theirs
    for rec in rn50_480:
        rec["remat_launches"] = remat_counts.get(
            COUNT_OF.get(rec["name"], rec["name"]), 0)
    print(f"remat phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cross_check(torch, dev, "cifar10", "resnet18", 32, 8)
    victim, x = cross_check(torch, dev, "imagenet", "resnetv2", 224, 4)
    gn_logits_check(torch, dev, victim, x)
    del victim, x
    for lift in (0.0, 4.0):
        vit_cross_check(torch, dev, 4, lift)
    mixer_cross_check(torch, dev, 4, 0.0, gate=False)
    for lift in (0.0, 4.0):
        mixer_cross_check(torch, dev, 4, lift, layerscale=0.1)
    print(f"cross-check phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for arch in ("resnetv2", "vit"):
        for lift in (0.0, 4.0):
            bank_cross_check(torch, dev, arch, 4, lift)
    bank_cross_check(torch, dev, "resnetv2", 2, 4.0, 480)
    consensus_cross_check(torch, dev, 4, 4.0)
    print(f"bf16 bank phase: {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_victims_") as out:
        t0 = time.perf_counter()
        train_phase(torch, dev, out)
        print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        trained_phase(torch, dev, out)
        print(f"trained-victim phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        sanitize_phase(torch, dev, out)
        verify_phase(torch, dev, out)
        print(f"sanitize and verify phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        farm = farm_phase(torch, dev, out)
        print(f"farm phase: {time.perf_counter() - t0:.1f} s", flush=True)
        # the farm runs the CIFAR shapes: its launches beside their records
        for rec in cifar_kernels + cifar_bf16:
            rec["farm_launches"] = farm.get(
                COUNT_OF.get(rec["name"], rec["name"]), 0)
        t0 = time.perf_counter()
        serve_kernels_recs = serve_phase(torch, dev, out, smi)
        print(f"serve phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        fleet = fleet_phase(torch, dev, out, smi)
        print(f"fleet phase: {time.perf_counter() - t0:.1f} s", flush=True)
        # the recert drain runs the CIFAR shapes (bf16), the backends the
        # CIFAR serve shapes: their launches beside those records
        for rec in cifar_kernels + cifar_bf16:
            rec["recert_launches"] = fleet["recert"].get(
                COUNT_OF.get(rec["name"], rec["name"]), 0)
        for rec in serve_kernels_recs:
            if rec["name"].endswith("_serve_cifar"):
                rec["fleet_launches"] = fleet["backends"].get(
                    rec["name"][:-len("_serve_cifar")], 0)

    print(f"chip_smoke total: {time.perf_counter() - start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": cifar_kernels + rn50_kernels + vit_kernels
                      + cifar_bf16 + rn50_bf16 + vit_bf16 + rn50_480
                      + rn50_480_bf16 + np2_kernels + serve_kernels_recs}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
