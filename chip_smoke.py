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
     2 --num-batches 1` (full-width CIFAR ResNet-18; kernels A, B, C);
   - RN50: `--synthetic --dataset imagenet --base_arch resnetv2
     --img-size 224 -b 2 --sampling-size 128 --dropout 2 --max-iterations
     2 --num-batches 1` (ResNetV2-50x1 BiT at full depth and width;
     kernels A, B, C and the GroupNorm+ReLU forward and backward);
   - ViT: the same flags with `--base_arch vit` and `--max-iterations
     2` (ViT-B/16 at full depth and width; kernels A, B and H);
   random weights from the seed, certification at the four radii with
   prune="exact", incremental="auto" (-> stem for the conv victims,
   -> token-exact for the ViT); then the same three runs with
   `--compute-dtype bfloat16 --certify-dtype bfloat16` (ViT's with
   `--max-iterations 2`; the bf16 attack
   fills at float32 (A, B) and runs the victim's bf16 copy (D, F on RN50);
   the bf16 bank fills bf16 images (A's bf16 form) and runs C's and H's
   bf16 forms);
   - RN50 480 and RN50 480 bf16: ResNetV2-50x1 at BiT's 480 px
     fine-tuning resolution, `--img-size 480 -b 1 --max-iterations 2`,
     the other flags as RN50's, without and with the bf16 flags (the
     backward of the stage-1 slabs takes kernel G, in float32 and in
     bf16);
   - ResMLP and ResMLP bf16: RN50's flags with `--base_arch resmlp
     --max-iterations 2` (ResMLP-24 at full depth and width; kernels A
     and B, the mixer engine's gathers and cuBLAS matmuls, A in
     escalations);
   - CIFAR n_patch=2 and its bf16 twin: CIFAR's flags with `-b 2
     --defense-n-patch 2` (the exhaustive sweep of 630 + 22680 masks a
     radius, kernel A at K = 3; the bf16 bank keeps the float32 sweep);
   - RN50 consensus and its bf16 twin: RN50's flags with `--prune
     consensus`, whose records are then held against the RN50 runs' (same
     prediction, every certificate kept, at most the forwards);
   - CIFAR disk, where Pillow is installed: CIFAR's flags without
     `--synthetic` and with `--max-iterations 2`, reading a seeded CIFAR-10 `test_batch` it writes into
     a temporary `--data_dir`, streamed (the default `stream_depth` 2)
     and again through the synchronous input path, which must give the
     same report and patch (each main path prints its `data` spans'
     seconds);
   and prints A's and B's launches x (time - bound) per path; then the
   mesh (`mesh_phase`): CIFAR in float32 and with both bf16 flags
   on a 2x2 mesh of 4 ranks, RN50 and ViT-B/16 on 2x1, the single-process
   paths' argv with `--mesh-data/--mesh-mask`, the ranks sharing the card
   over gloo (`python -m torch.distributed.run` of this script with
   `--mesh-worker`), each rank's launch counts set to 0 just before its
   path and read just after (every rank must launch its sharded forms);
   the first attack step's gradients within 1e-5 of one process's with
   cuDNN off (printed as configured too: cuDNN picks its algorithm by the
   batch), the records (verdicts, tables, forwards) equal to one process's
   certification of the same patch (the run's, where the patches are
   equal) but for entries under a 1e-3 margin, the whole-run patch
   difference printed; each sharded form (A, B's float64 form, C, H and
   the bf16 forms of A, C, H) held on every rank at its shard against its
   plain version and the single-device kernel, timed at the shard with
   the gloo all_reduce of the cotangent; and a one-rank NCCL group's
   sharded fill; then runs RN50 at 224 in float32, 6 iterations a stage in blocks of 3, once
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
   (RN50_480_B2_ARGV, 2 iterations; it does not fit without remat),
   whose certification records must equal those of certifying its patch
   again with remat off (the 480 px kernel records carry its launches as
   `remat_launches`);
6. (after 8's trained-victim paths, beside the AOT build of 9) certifies
   one radius both ways on each conv victim (stem fold = kernel
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
   defaults but TRAIN_EPOCHS epochs: 468 steps; `cifar_vit` as the JAX
   package's own run, `--n-per-class 1000 --lr 1e-3`, TRAIN_EPOCHS
   epochs: 312 steps, at seeds 0, 1 and 2), prints
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
9. builds an AOT executable store with `python -m dorpatch_tpu_torch.aot
   build --only ...` (AOT_BUILD_ONLY; in the background beside 6 and the
   sanitize and verify runs of 8), which must exit 0, as must `aot
   verify` on it; then runs the attack-sweep farm (`farm_phase`, `python -m
   dorpatch_tpu_torch.farm` worker processes over one farm directory) on
   the CIFAR ResNet-18 trained in 7: 4 jobs (patch budget 0.06 and 0.12,
   float32 and bfloat16 attack and certify bank; batch 8 at 32 px,
   `--sampling-size 128 --dropout 2`, 10 iterations, a snapshot every 5,
   the stage switch at 5, failure-biased sampling from 8); a worker
   with `--chaos crash_block --crash-mode kill` SIGKILLs itself at its
   seeded block while one with `--chaos ckpt_raise,enospc_events` fails a
   job's snapshot save and its event log's disk; two healthy workers
   drain the farm with `--aot-store` on the built store (read-only: the
   manifest must stay as it was; each writes its hits and misses to
   `aot.json`) and the killed job's rows must equal the control run's. It fails unless every job ends done, the killed job
   shows attempts 2, reclaims 1 and a resume from an iteration above 0,
   its patch equals an uninterrupted `run_sweep` of the point in this
   process bit for bit, the ckpt_raise job ends done at attempts 2, and
   the draining workers launched A, B, C and the bf16 forms of C and A
   (their `metrics.json`; the kernels line gives the CIFAR records their
   `farm_launches`); it prints the fleet report, per-job seconds, the
   reclaim latency, the iterations the resume saved and the CIFAR
   snapshot saves' ms and bytes;
10. serves (`serve_phase`): holds the serve paths' kernels at their shapes
   (A, C, D and their bf16 forms at RN50's bucket of 2 at 224, A and C at
   CIFAR's, H's bf16 form at ViT-B/16's batch of 1), then runs
   `dorpatch_tpu_torch.serve`'s service and HTTP front-end in this
   process on each serving path and sends it requests over HTTP from
   stdlib clients: RN50 at 224 (`--serve-max-batch 2`, buckets 1 and 2,
   2 requests at concurrency 8) with 2 replicas in float32, eager and
   booted `--aot auto` on an empty store (replica 0 misses and captures
   every program, replica 1 hits every one, the clean forward and the
   pruned certification's programs CUDA graphs; a warmup after the boot
   timed), each with a `POST /profile` capture of a served batch, with 2
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
   images/s, batch occupancy and forwards per image, and the graphed RN50
   run beside the eager one (p50, images/s, busy share, peak GiB);
11. runs the certified fleet on the CIFAR ResNet-18 trained in 7
   (`fleet_phase`, the JAX package's `tools/recert_smoke.py` and
   `tools/gateway_smoke.py` on the card): a recert generation (two bf16
   jobs, batch 8, 10 iterations) through `recert run` in this process, the
   same spec SIGKILLed after its submit with its state file torn in a
   second process and resumed here to a byte-identical baseline (both
   drains launching A, B and the bf16 forms of C and A); a planted
   regression that `recert check` names under DP400, a strict boot that
   refuses it with no victim built and no kernel launched, a warn boot
   that serves and answers 503 on `GET /robustness` (booted `--aot auto`
   on the fleet's empty store, which it writes); then two `python -m
   dorpatch_tpu_torch.serve` backends booted `--aot auto` on that store
   behind an in-process gateway, 12 requests through it while
   `kill_backend` SIGKILLs one (every answer once, equal to
   `robust_predict`), a canary booted `--aot strict` on the same store
   (0 misses, its kernel library from the store) rolled back by
   `poison_canary` and by DP305 (`aot verify` exits 0 on 9's store and 1
   on a copy with one fingerprint edited, whose findings feed the
   deploy's `finding_source`), a strict boot on an empty store that
   refuses before warmup, and `python -m dorpatch_tpu_torch.observe.report
   --fleet` reconciling client, gateway and backends with no orphaned
   trace (the kernels line gives the CIFAR records their
   `recert_launches`, the CIFAR serve records their `fleet_launches`);
12. the analysis slice (`start_gates` right after the build, so the gates
   run on the host's CPU beside the kernel phases, whose times are the
   card's, and `finish_gates` before the main paths, so that no host-timed
   phase shares the CPU with them; `analysis_phase` after the main
   paths): `python -m dorpatch_tpu_torch.analysis
   dorpatch_tpu_torch`, `--concurrency dorpatch_tpu_torch` and
   `--baseline check` on the card's installation, each of which must exit
   0; the host microseconds a call of kernel A at CIFAR [8,128] through
   its wrapper, its op `dorpatch_torch::masked_fill_fwd` and the direct
   launch under the op (`fill_bench.host_costs`); the RN50 bf16 attack
   step's ms at 224 beside PERF.md §5's; the main paths' walls; and a
   short CIFAR run (CAPTURE_ARGV) under `analysis.entrypoints.
   capture_entrypoints()` whose every program must trace on fake `cuda`
   and on fake `cpu` tensors to one fingerprint (`capture_check`; the
   kernels' ops each program holds printed). Every kernel above runs
   through its `torch.library` op (`ops/_library.py`);
13. prints the total seconds, the per-kernel JSON line (the serve paths'
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
#: runs) and of the mesh paths held to them, cut from 20 to 10, then to
#: 2, to keep the script within its time on slower card hosts: every
#: kernel of a path launches in each iteration and in the certification
SHORT_ITERATIONS = 2
#: the depth of the paths no other phase is held to (RN50 480 in both
#: dtypes and at batch 2 under remat, ResMLP, ViT bf16, CIFAR disk), cut
#: from 10 to make room for the mesh phase, then from 5
HEAVY_ITERATIONS = 2
#: the sanitized trained CIFAR run's depth: its programs' budget events
#: need the attack's stage switch (at 10) and a sweep
SANITIZE_ITERATIONS = 10
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


#: images of the 224 px cross-checks (stem fold, token and mixer engines,
#: the bf16 bank, consensus) against full forwards; cut from 4 to keep the
#: script within its time
CROSS_CHECK_BATCH = 2


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
                 "--max-iterations", str(HEAVY_ITERATIONS),
                 "--num-batches", "1"]
#: the bf16 paths: the same runs with the bf16 attack and certify bank
BF16_FLAGS = ["--compute-dtype", "bfloat16", "--certify-dtype", "bfloat16"]
#: ResMLP-24 (24 blocks, D 384, 196 tokens) at 224, RN50's other flags
RESMLP_ARGV = _iterations(
    [a if a != "resnetv2" else "resmlp" for a in RN50_ARGV],
    HEAVY_ITERATIONS)
VIT_BF16_ARGV = _iterations(VIT_ARGV, HEAVY_ITERATIONS) + BF16_FLAGS
#: the n_patch=2 defense bank (630 pairs, 22680 triples a radius, the
#: exhaustive sweep) on the CIFAR ResNet-18, 2 images a batch
CIFAR_NP2_ARGV = [a if a != "8" else "2" for a in CIFAR_ARGV] + [
    "--defense-n-patch", "2"]
CONSENSUS = ["--prune", "consensus"]
#: the CIFAR path without --synthetic: the disk source over --data_dir
CIFAR_DISK_ARGV = _iterations([a for a in CIFAR_ARGV if a != "--synthetic"],
                              HEAVY_ITERATIONS)
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
#: package's defaults (batch 128, lr 3e-3, warmup 100) but TRAIN_EPOCHS
#: epochs, cut from its 12 to keep the script within its time (the train
#: accuracy levels off at about 0.60 from the second epoch):
#: cifar_resnet18 at 1500 images a class (468 steps); cifar_vit with the
#: flags of the JAX package's own cifar_vit run (`tools/flagship_vit_leg.sh`:
#: 1000 images a class, lr 1e-3; 312 steps). Held out, the JAX package's
#: 12-epoch CPU runs reached 0.609 and 0.613; TRAIN_MIN_ACC is the bar of the mean
#: over TRAIN_SEEDS. cifar_vit's held-out accuracy spreads over 0.52-0.65
#: from seed to seed (its accuracy on augmented images stays at 0.59-0.60),
#: so its bar is the mean of three seeds; seed 0 is the checkpoint
TRAIN_EPOCHS = 4
TRAIN_ARGV = {"cifar_resnet18": ["--epochs", str(TRAIN_EPOCHS)],
              "cifar_vit": ["--n-per-class", "1000", "--lr", "1e-3",
                            "--epochs", str(TRAIN_EPOCHS)]}
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
#: with the (1, SERVE_RN50_BATCH) buckets, SERVE_RN50_REQUESTS requests at
#: closed-loop concurrency SERVE_CONCURRENCY over HTTP, with 2 replicas on
#: the card in float32, eager and booted from the AOT store, and with 2 in
#: the bf16 bank; the trained CIFAR ResNet-18
#: with 2 replicas and the wedge_dispatch failover drill (replica 0 wedges
#: its first batch; stale after SERVE_STALE_S), SERVE_REQUESTS requests at
#: concurrency 16: two full batches wait at once and each replica takes
#: one (at 8 the clients wait for each batch, and replica 1 may take them
#: all); ViT-B/16's bf16 bank
#: at batch 1 (one replica), SERVE_VIT_REQUESTS requests at concurrency 2.
#: Replicas beat
#: only at batch boundaries, so the stale window must outlast a healthy
#: batch: a trained CIFAR batch of 8 takes 2.6 s (service p50 on the card) and
#: longer while the restarted replica 0 warms up beside it on the card; at
#: a 3 s window replica 1 was once declared wedged too, and the requests
#: re-dispatched to it failed twice
SERVE_STALE_S = 6.0
#: the RN50 serve runs' largest bucket, cut from 8 to 2 to keep the
#: script within its time (each replica warms, or boots from the AOT store,
#: every bucket's programs)
SERVE_RN50_BATCH = 2
SERVE_RN50_ARGV = ["--synthetic", "--dataset", "imagenet", "--base_arch",
                   "resnetv2", "--img-size", "224", "--serve-max-batch",
                   str(SERVE_RN50_BATCH), "--serve-deadline-ms", "60000"]
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
SERVE_RN50_REQUESTS = SERVE_RN50_BATCH
#: the RN50 float32 2-replica runs' `POST /profile` capture (seconds) of
#: one more batch served after the measured traffic, asked for
#: SERVE_PROFILE_AFTER_S after that batch's requests are sent (it is on
#: the card then): the device's busy share of a served batch, eager and
#: replayed from CUDA graphs. Cut from 2 s after 2 s with the bucket of 8,
#: to fit inside a batch of SERVE_RN50_BATCH (the trace's export grows
#: with its length); the bf16 bank's capture was cut to keep the script
#: within its time
SERVE_PROFILE_S, SERVE_PROFILE_AFTER_S = 1.0, 0.5
#: the second RN50 float32 2-replica run boots `--aot auto` on an empty
#: store (`aot/`): replica 0 captures every program and writes the store,
#: replica 1 hits every entry; the clean forward and the pruned
#: certification's programs must be CUDA graphs
SERVE_AOT_GRAPHS = ("serve.clean_predict", "defense.phase1.stem",
                    "defense.pairs", "defense.rows")
#: the serve paths' kernels: phase 1 folds the stem (C), the pair audits
#: fill with A, every RN50 forward runs D; the bf16 bank runs their bf16
#: forms, its escalations (the float32 exhaustive sweep) A and D, and the
#: clean forward D; the ViT bank runs H's bf16 form. A (or its bf16 form)
#: must launch exactly when a pair audit was scheduled, and float32 A in
#: the RN50 bf16 bank exactly when an image escalated (`serve_path`)
#: the RN50 224 --carry-checkpoints check: 6 iterations a stage in
#: blocks of 3 (cut from 10 in blocks of 5 to keep the script within its
#: time), so that stage 1 has a block left after its first; the
#: watchdog (s) must outlast the longest block, its first call included
RN50_CARRY_ITERATIONS, RN50_CARRY_BLOCK = 6, 3
RN50_CARRY_ARGV = _iterations(RN50_ARGV, RN50_CARRY_ITERATIONS) + [
    "--sweep-interval", str(RN50_CARRY_BLOCK)]
RN50_CARRY_HANG_S = 300
#: the farm (`farm_phase`): the trained CIFAR ResNet-18, batch 8 at 32
#: px, its attack with the stage switch at 5, failure-biased sampling
#: from 8 and a snapshot every 5 iterations, 10 a stage (cut from 20 to
#: keep the script within its time; the crash still lands on a block with
#: one left); one grid point a job, one radius (0.06) certified a point
FARM_ATTACK = {"sampling_size": 128, "dropout": 2, "max_iterations": 10,
               "sweep_interval": 5, "switch_iteration": 5,
               "failure_sampling_start": 8}
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
FLEET_REQUESTS, FLEET_IMAGES, FLEET_POST, FLEET_DIRECT = 12, 6, 2, 4
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
    m["wall_s"] = wall
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
                              per_image(table.slot_bias), cfg.mask_fill,
                              eng._attn(None))

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
    """RN50 at 224 in float32 with blocks of RN50_CARRY_BLOCK iterations
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
          f"{RN50_CARRY_ITERATIONS}, --sweep-interval {RN50_CARRY_BLOCK}): "
          f"reference run {reference:.2f} s; interrupted after stage 1's "
          f"first block in {cut:.2f} s; snapshot (stage, iteration) "
          f"{(info.stage, info.iteration) if info else None}; resumed run "
          f"{resumed:.2f} s (attack seconds {m.get('attack_seconds')}, "
          f"certify {m.get('certify_seconds')}); iterations saved "
          f"{saved}; carry "
          f"snapshots: {saves.summary()}; resumed run's launches {counts}",
          flush=True)
    if info is None or (info.stage, info.iteration) != (1, RN50_CARRY_BLOCK):
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


# ------------------------------------------------------------ the AOT store
#
# `python -m dorpatch_tpu_torch.aot build` on the card: the baseline gate
# (every registry program traced on fake tensors, on the CPU), then the
# programs of AOT_BUILD_ONLY run once on the card at their audit shapes,
# each held to its trace (one key) and captured as a CUDA graph (or
# recorded eager, with the reason) into a store with the kernel library's
# blob. Started in the background after the trained-victim phase, beside
# the cross-checks, the bf16 bank's checks, sanitize and verify, whose
# times are not measurements; the farm reads it, the fleet verifies it
# (DP305).

AOT_BUILD_TIMEOUT_S = 900
#: the registry programs the build captures: the attack's (the farm's
#: workers resolve theirs by fingerprint) and the CIFAR certification's in
#: float32 and bfloat16 at the farm's defense ratio (FARM_SWEEP). The whole
#: registry (58 programs at audit shapes, which no serving boot and few of
#: the farm's calls hit) took 128-182 s of the card beside timed phases
AOT_BUILD_ONLY = ("attack.*", "defense.phase1.r0.06", "defense.pairs.r0.06",
                  "defense.rows.r0.06", "defense.phase1.bf16.r0.06",
                  "defense.pairs.bf16.r0.06", "defense.rows.bf16.r0.06")


def _aot(*argv, timeout=300):
    """`python -m dorpatch_tpu_torch.aot ARGV` in a subprocess: (exit code,
    stdout, stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "dorpatch_tpu_torch.aot",
                           *argv], cwd=here, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def start_aot_build(store):
    """`aot build --store store` started in the background."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log = open(store + ".log", "w")
    only = [a for g in AOT_BUILD_ONLY for a in ("--only", g)]
    proc = subprocess.Popen([sys.executable, "-m", "dorpatch_tpu_torch.aot",
                             "build", "--store", store, *only], cwd=here,
                            env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, time.perf_counter(), store


def aot_baseline(store) -> str:
    """The baselines.json records of the programs `store` holds, written
    beside it: what `aot verify` holds a store built with `--only`
    against (against the whole file, every program left out would be a
    DP305 absence)."""
    from dorpatch_tpu_torch.analysis import baseline

    path = store + ".baselines.json"
    if not os.path.exists(path):
        with open(os.path.join(store, "manifest.json")) as fh:
            names = set(json.load(fh)["entries"])
        data = baseline.load_baseline()
        data["entries"] = {n: e for n, e in data["entries"].items()
                           if n in names}
        with open(path, "w") as fh:
            fh.write(baseline.dump_baseline(data))
    return path


def finish_aot_build(build, smi) -> str:
    """Wait for the background build; it must exit 0, write every program
    of AOT_BUILD_ONLY keyed as a boot keys it, and `aot verify` exit 0 on
    its store against its programs' baseline records (`aot_baseline`). Prints the build's seconds, its entries by method,
    each eager entry's reason and the kernel blob's size. Returns the
    store."""
    proc, t0, store = build
    try:
        rc = proc.wait(timeout=AOT_BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    build_s = time.perf_counter() - t0
    with open(store + ".log") as fh:
        log = fh.read()
    vrc, _, verr = (_aot("verify", "--store", store, "--baseline-file",
                         aot_baseline(store)) if rc == 0 else (None, "", ""))
    lrc, listing, _ = _aot("ls", "--store", store, "--json")
    if rc != 0 or vrc != 0 or lrc != 0:
        raise AssertionError(f"aot build exit {rc}, verify exit {vrc}: "
                             f"{log[-3000:]} {verr[-2000:]}")
    manifest = json.loads(listing)
    # every selected program written, each keyed as a boot keys it (its
    # recorded call's fingerprint the trace's)
    import fnmatch

    from dorpatch_tpu_torch.analysis import baseline

    want = sorted(n for n in baseline.load_baseline()["entries"]
                  if any(fnmatch.fnmatch(n, g) for g in AOT_BUILD_ONLY))
    split = [n for n, e in manifest["entries"].items()
             if e.get("recorded_fingerprint")]
    if sorted(manifest["entries"]) != want or split:
        raise AssertionError(f"aot build wrote {sorted(manifest['entries'])}"
                             f" of {want}, recorded calls not their traces "
                             f"{split}: {log[-3000:]}")
    methods, eager = {}, {}
    for name, e in manifest["entries"].items():
        methods[e["method"]] = methods.get(e["method"], 0) + 1
        if e["method"] == "eager":
            eager[name] = (e.get("reason"), e.get("detail", "")[:90])
    first = sorted(((e["build_compile_s"], n) for n, e in
                    manifest["entries"].items()), reverse=True)[:3]
    print(f"aot build ({smi}): {build_s:.1f} s from its start, beside the "
          f"cross-check, bf16 bank, sanitize and verify phases (baseline "
          f"gate included); {len(manifest['entries'])} "
          f"programs, methods {methods}, eager entries {eager}; kernel "
          f"library blob {manifest['kernels']['payload_bytes']} bytes; "
          f"slowest first calls {first}; verify exit 0", flush=True)
    return store


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


def farm_phase(torch, dev, out, aot_store) -> dict:
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
    `metrics.json`). The draining workers read the AOT store `aot_store`
    (`--aot-store`, read-only): its manifest must be byte-identical after
    them, each must write its `aot.json`, and the resumed job's
    `rows.jsonl` must equal the control run's (which has no store) but for
    its seconds and resume point. Prints the phase wall, per-job seconds,
    the reclaim latency, the iterations the resume saved, the workers' AOT
    hits and misses, the fleet report, and the control run's snapshot
    saves (ms, bytes). Returns the draining workers' launches by
    kernel."""
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
        with open(os.path.join(aot_store, "manifest.json"), "rb") as fh:
            manifest = fh.read()
        t0 = time.perf_counter()
        drain = _run_workers(farm, {w: ["--aot-store", aot_store]
                                    for w in ("wA", "wB")})
        t_drain = time.perf_counter() - t0
        with open(os.path.join(aot_store, "manifest.json"), "rb") as fh:
            untouched = fh.read() == manifest
        aot_of = {}
        for w in ("wA", "wB"):
            with open(os.path.join(farm, "workers", w, "aot.json")) as fh:
                rec = json.load(fh)
            aot_of[w] = (rec["hits"], rec["misses"])
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
        timing = ("seconds", "resumed_from_stage", "resumed_from_iteration")
        with open(os.path.join(control, "rows.jsonl")) as fh:
            control_rows = [{k: v for k, v in json.loads(line).items()
                             if k not in timing} for line in fh]
        same_rows = control_rows == [
            {k: v for k, v in r.items() if k not in timing}
            for r in rows[killed]]
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
          f"bit-equal to the control: {same}; draining workers' AOT store "
          f"(hits, misses): {aot_of}, manifest untouched {untouched}, "
          f"resumed rows equal the control's {same_rows}", flush=True)
    states = {j: job["state"] for j, job in jobs.items()}
    if set(states.values()) != {"done"} or len(ids) != 4:
        raise AssertionError(f"farm jobs lost: {states}")
    if (k["attempts"], k.get("reclaims")) != (2, 1) or not resumed[1]:
        raise AssertionError(f"killed job {killed}: {k}, row {row}")
    if not same or not same_rows:
        raise AssertionError("the crash-resumed farm patch or rows differ "
                             "from the uninterrupted control run")
    if not untouched:
        raise AssertionError("a farm worker wrote the AOT store")
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
    at the RN50 serve bucket of SERVE_RN50_BATCH images at 224, A (float32
    and bf16) at the pair audit's chunk (S = 63), C (float32 and bf16) at
    phase 1's chunk and D (float32 and bf16) at a pair-audit slab
    (SERVE_RN50_BATCH x 63 images at (784, 512)); at the CIFAR bucket of
    8, A and C; H's bf16 form at the ViT-B/16 bank's chunks with 1 image
    (the serve path's batch). Returns the records by path, launches filled
    in by `serve_phase`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b = SERVE_RN50_BATCH
    rn50 = [fill_phase_bf16(torch, dev, b, 224, "_serve_rn50",
                            torch.float32),
            stem_fold_phase(torch, dev, "imagenet", "resnetv2", 224, b,
                            "stem_fold_serve_rn50"),
            gn_slab(torch, dev, gen, b * 63, 784, 512, 4,
                    suffix="_serve_rn50")[0]]
    rn50_bf16 = [fill_phase_bf16(torch, dev, b, 224, "_serve_rn50"),
                 stem_fold_phase(torch, dev, "imagenet", "resnetv2", 224, b,
                                 "stem_fold_bf16_serve_rn50",
                                 torch.bfloat16),
                 gn_slab(torch, dev, gen, b * 63, 784, 512, 4,
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
               ref_cache=None, aot=False):
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
    batch across paths that serve the same images. With `aot` the service
    boots `--aot auto` on an empty executable store: replica 0 must miss
    every program ("absent") and write it, replica 1 hit every one with no
    miss, and the programs named by SERVE_AOT_GRAPHS must be CUDA graphs
    (their replays count their kernels' launches). Prints, beside the
    card, the start and warmup seconds per replica (and each replica's AOT
    boot: seconds, methods, eager entries with their reasons, the kernel
    library's source), the latency percentiles, images/s, batch occupancy,
    forwards per image and the peak device memory, and with `aot` the
    seconds of a warmup run after the boot on replica 0. Returns the launch
    counts and those numbers."""
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
        aot_argv = (["--aot", "auto", "--aot-cache", f"{root}/aot_store"]
                    if aot else [])
        cfg = config_from_args(build_parser().parse_args(
            argv + aot_argv + ["--results-root", root, "--serve-port", "0"]))
        deadline_ms = cfg.serve.deadline_ms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc = CertifiedInferenceService.from_config(cfg)
        svc.start()
        start_s = time.perf_counter() - t0
        boots = [r.aot_stats for r in svc._pool.replicas]
        rewarm_s = None
        if aot:
            # the warmup a fully booted bank skips (its boot ran every
            # program at every shape), timed once on replica 0's graphs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.warmup()
            rewarm_s = time.perf_counter() - t0

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
                        time.sleep(SERVE_PROFILE_AFTER_S)
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
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
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
    # -- the AOT boots --
    if aot:
        b0, b1 = boots[0], boots[1]
        n_prog = len(b0["programs"])
        graphs = [p for p in b0["programs"]
                  if p.split("[")[0].rsplit(".r", 1)[0] in SERVE_AOT_GRAPHS]
        eager_graphs = sorted(set(graphs) & set(b0["eager"]))
        if (b0["builds"] != n_prog or b0["hits"]
                or b0["miss_reasons"] != {"absent": n_prog}
                or b1["hits"] != n_prog or b1["misses"]
                or sorted(b1["programs"]) != sorted(b0["programs"])
                or not graphs or eager_graphs):
            raise AssertionError(
                f"{label} serve path: AOT boots: replica 0 {b0}, replica 1 "
                f"{b1}; programs that must be CUDA graphs but are eager: "
                f"{ {p: b0['eager'][p] for p in eager_graphs} }")
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
          + f"peak device memory {peak_gib:.2f} GiB; "
          + (f"AOT boots (seconds, builds, hits, misses, methods, eager "
             f"entries, kernel library): " + "; ".join(
                 f"replica {i}: {b['boot_s']} s, {b['builds']}, {b['hits']},"
                 f" {b['misses']}, {b['methods']}, {b['eager']}, "
                 f"{b['kernels']}, saved {b['saved_s']} s"
                 for i, b in enumerate(boots))
             + f"; warmup after the full boot (replica 0, replays) "
             f"{rewarm_s:.2f} s; " if aot else "")
          + f"launches {counts}; routes {routes}", flush=True)
    return counts, {"p50_ms": pct(0.5), "images_s": n / wall,
                    "busy": busy[0] if busy and busy[1] else None,
                    "peak_gib": peak_gib, "start_s": start_s}


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
    with 2 replicas in float32, eager and then booted from an empty AOT
    store (its batches CUDA graphs; each run's served batch profiled, the
    two set side by side), with 2 in the bf16 bank; the CIFAR ResNet-18
    trained into `out` with 2 replicas and the wedge_dispatch drill;
    ViT-B/16's bf16 bank at batch 1 with one replica. Returns the serve
    paths' kernel records with their launches (from the RN50 graphed run,
    the bf16 bank's and the CIFAR drill's)."""
    from dorpatch_tpu_torch import data

    t0 = time.perf_counter()
    recs = serve_kernels(torch, dev)
    print(f"serve kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    rn50 = _serve_images(224, SERVE_RN50_REQUESTS, 1234)
    counts, ref_cache, numbers = {}, {}, {}
    for label, flags, graphed, profile_s in (
            ("RN50", [], False, SERVE_PROFILE_S),
            ("RN50", [], True, SERVE_PROFILE_S),
            ("RN50 bf16", CERTIFY_BF16, False, 0.0)):
        t0 = time.perf_counter()
        counts[label], numbers[label, graphed] = serve_path(
            torch, dev, label + (" AOT" if graphed else ""),
            SERVE_RN50_ARGV + flags + ["--serve-replicas", "2"], rn50,
            SERVE_KERNELS[label], smi, profile_s=profile_s,
            ref_cache=ref_cache, aot=graphed)
        print(f"{label}{' AOT' if graphed else ''} serve phase (2 "
              f"replicas): {time.perf_counter() - t0:.1f} s", flush=True)
    eager, graphs = numbers["RN50", False], numbers["RN50", True]
    print(f"RN50 float32 served, 2 replicas, bucket {SERVE_RN50_BATCH}, "
          f"one batch of {SERVE_RN50_REQUESTS} requests a run (one sample "
          f"each; {smi}), CUDA graphs against eager: client p50 "
          f"{graphs['p50_ms']:.0f} / {eager['p50_ms']:.0f} ms, "
          f"{graphs['images_s']:.3f} / {eager['images_s']:.3f} images/s, "
          f"device busy {graphs['busy']} / {eager['busy']} of a served "
          f"batch, start {graphs['start_s']:.1f} / {eager['start_s']:.1f} s, "
          f"peak device memory {graphs['peak_gib']:.2f} / "
          f"{eager['peak_gib']:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    held_out, _ = data.procedural_arrays("cifar10", 3, 32, 1234, "test")
    counts["CIFAR"], _ = serve_path(
        torch, dev, "trained CIFAR", SERVE_CIFAR_ARGV + [
            "--model_dir", out, "--data-source", "procedural"],
        held_out[:SERVE_REQUESTS], SERVE_KERNELS["CIFAR"], smi,
        concurrency=2 * SERVE_CONCURRENCY, drill=True)
    print(f"trained CIFAR serve phase (failover drill): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts["ViT bf16"], _ = serve_path(
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


def fleet_phase(torch, dev, out, smi, aot_store) -> dict:
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
       the second with `--chaos kill_backend`) and a third, the canary;
       an in-process `Gateway` fronts the first two. The warn service of
       step 2 boots `--aot auto` on the fleet's empty AOT store, which it
       writes (every program and the kernel library's blob); the three
       backends boot together on that store, the stable ones `--aot
       auto`, the canary `--aot strict`: each must hit every program with
       0 misses, its kernel library from the store. Meanwhile a strict
       boot on an empty store must refuse (`AotBootError`) before warmup.
       FLEET_REQUESTS closed-loop requests (concurrency 1) through it
       while backend 2 SIGKILLs itself: every answer ok, answered once,
       equal to the port's `robust_predict` on the same image (per radius
       prediction and certificate, the clean prediction, the forwards),
       some request re-dispatched, backend 2 ejected. The canary joins;
       `RollingDeploy` with `poison_canary` must roll back (the
       `gateway.rollback` event and counter, the canary drained, the
       stable weight restored) on the poisoned DP400 verdict and on the
       DP305 finding that `aot verify` reports on a copy of `aot_store`
       with one fingerprint edited (its `finding_source`; `aot verify`
       exits 0 on `aot_store` itself), and FLEET_POST more requests must
       be answered by the stable backend.
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

    import dataclasses
    import shutil

    from dorpatch_tpu_torch import data, defense, ops
    from dorpatch_tpu_torch.aot import AotBootError
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.config import AotConfig, GatewayConfig
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
        # the warn service boots `--aot auto` on the fleet's empty store:
        # it writes every program and the kernel library's blob there
        fleet_store = os.path.join(tmp, "aot_fleet")
        warn_cfg = dataclasses.replace(
            serve_cfg(d["warn"], "warn"),
            aot=AotConfig(cache_dir=fleet_store, mode="auto"))
        svc = CertifiedInferenceService.from_config(warn_cfg).start()
        warn_aot = svc.stats()["aot"]
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
                                         "strict", "--aot-cache",
                                         fleet_store]
        roots = [d["backend1"], d["backend2"], d["canary"]]
        t0 = time.perf_counter()
        procs = [_spawn_backend(roots[0], ports[0],
                                fleet_argv + ["--aot", "auto"]),
                 _spawn_backend(roots[1], ports[1], fleet_argv
                                + ["--aot", "auto", "--chaos",
                                   "kill_backend"]),
                 _spawn_backend(roots[2], ports[2],
                                fleet_argv + ["--aot", "strict"])]
        try:
            # -- the AOT store: DP305 on an edited copy, strict on empty --
            held = ["--baseline-file", aot_baseline(aot_store)]
            vrc, _, verr = _aot("verify", "--store", aot_store, *held)
            edited = os.path.join(tmp, "aot_edited")
            shutil.copytree(aot_store, edited)
            mpath = os.path.join(edited, "manifest.json")
            with open(mpath) as fh:
                manifest = json.load(fh)
            drifted = sorted(manifest["entries"])[0]
            manifest["entries"][drifted]["fingerprint"] = "0" * 16
            with open(mpath, "w") as fh:
                json.dump(manifest, fh)
            erc, eout, _ = _aot("verify", "--store", edited, *held,
                                "--format", "json")
            dp305 = [f"{r['rule']}: {r['message']}" for r in
                     (json.loads(line) for line in eout.splitlines() if line)]
            if vrc != 0 or erc != 1 or not dp305 or any(
                    not f.startswith(f"DP305: [{drifted}]") for f in dp305):
                raise AssertionError(f"aot verify: exit {vrc} on the store "
                                     f"({verr[-1000:]}), {erc} on the edited "
                                     f"copy: {dp305}")
            empty_cfg = config_from_args(build_parser().parse_args(
                FLEET_SERVE_ARGV + ["--model_dir", out, "--results-root",
                                    d["strict"], "--serve-port", "0", "--aot",
                                    "strict", "--aot-cache",
                                    os.path.join(tmp, "aot_empty")]))
            t_ref = time.perf_counter()
            svc = CertifiedInferenceService.from_config(empty_cfg)
            try:
                svc.start()
                refused_aot = None
            except AotBootError as e:
                refused_aot = str(e)
            aot_refuse_s = time.perf_counter() - t_ref
            with open(os.path.join(d["strict"], "serve",
                                   "events.jsonl")) as fh:
                warmed = [e for e in map(json.loads, fh) if str(
                    e.get("name", "")).startswith("serve.warmup")]
            if refused_aot is None or svc._warm or warmed:
                raise AssertionError(f"strict AOT boot on an empty store: "
                                     f"refused {refused_aot!r}, warmup events "
                                     f"{warmed}")
            del svc
            print(f"fleet AOT store ({smi}): verify exit 0 on the build's "
                  f"store, exit 1 on a copy with {drifted}'s fingerprint "
                  f"edited ({len(dp305)} DP305 finding(s)); strict boot on "
                  f"an empty store refused in {aot_refuse_s:.2f} s before "
                  f"warmup: {refused_aot[:160]}", flush=True)

            boots = [round(_await_warm(p, u, r, t0), 1)
                     for p, u, r in zip(procs, urls, roots)]
            aot_boots = [json.loads(_get(u + "/stats")[1])["aot"]
                         for u in urls]
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
                deploy = RollingDeploy(
                    gateway, [names[2]],
                    finding_source=lambda: dp305).run(warm_timeout_s=60)
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
          f"{boots} s from their start (together); AOT boots (mode, boot s, "
          f"builds, hits, misses, kernel library) of the warn service and "
          f"the backends: "
          + "; ".join(f"{b['mode']} {b['boot_s']} s {b['builds']} "
                      f"{b['hits']} {b['misses']} {b['kernels']}"
                      for b in [warn_aot] + aot_boots) + "; "
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
    n_prog = warn_aot["builds"]
    if (not n_prog or warn_aot["misses"] != n_prog or warn_aot["hits"]
            or [b["mode"] for b in aot_boots] != ["auto", "auto", "strict"]
            or [(b["hits"], b["misses"], b["kernels"]) for b in aot_boots]
            != [(n_prog, 0, "store")] * 3):
        raise AssertionError(f"fleet AOT boots: warn service {warn_aot}, "
                             f"backends {aot_boots}")
    if (deploy["outcome"] != "rolled_back" or "DP400" not in
            deploy["reason"] or "DP305" not in deploy["reason"]
            or not set(dp305) <= set(deploy["findings"])
            or rollbacks != 1 or t_poison is None
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
    # the forward kernels' op, as `fused_gn.GNRelu` calls it
    plain_fwd = fused_gn.gn_relu_fwd_op
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
            fused_gn.gn_relu_fwd_op = recording_fwd
        try:
            t0 = time.perf_counter()
            res = _remat_grads(torch, atk, x, lvx, rects, state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            fused_gn.gn_relu_fwd_op = plain_fwd
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
    (`main_path`, HEAVY_ITERATIONS), whose certification records must equal
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
    argv = _iterations(TRAINED_ARGV, SANITIZE_ITERATIONS) + [
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


#: the mesh phase (`mesh_phase`): ranks of a `(data, mask)` mesh that share
#: cuda:0 over gloo (NCCL refuses two ranks on one card), launched by
#: `python -m torch.distributed.run --standalone` running this script with
#: `--mesh-worker`. Each path is the single-process main path of the same
#: argv (its label in MESH_LAUNCHES), whose records and patch it is held to;
#: the kernel checks hold each sharded form at a rank's shard against its
#: plain version and against the single-device kernel on the whole shape.
#: (world, mesh, paths, kernel checks) a launch
MESH_LAUNCHES = (
    (4, (2, 2),
     (("CIFAR mesh", "CIFAR", CIFAR_ARGV, True),
      ("CIFAR bf16 mesh", "CIFAR bf16", CIFAR_ARGV + BF16_FLAGS, False)),
     (("fill", 8, 32, "_cifar"), ("fill_bf16", 8, 32, "_cifar"),
      ("stem", "cifar10", "resnet18", 32, 8, "_cifar", "float32"),
      ("stem", "cifar10", "resnet18", 32, 8, "_cifar", "bfloat16"))),
    (2, (2, 1),
     (("RN50 mesh", "RN50", RN50_ARGV, True),
      ("ViT mesh", "ViT", VIT_ARGV, True)),
     (("fill", 2, 224, "_224"), ("fill_bf16", 2, 224, "_224"),
      ("stem", "imagenet", "resnetv2", 224, 2, "_rn50", "float32"),
      ("stem", "imagenet", "resnetv2", 224, 2, "_rn50", "bfloat16"),
      ("attn", "float32"), ("attn", "bfloat16"))))
#: the sharded forms each mesh path must launch on every rank; the bf16
#: bank's fill only where the single-process path filled a pair audit
MESH_KERNELS = {
    "CIFAR mesh": ("masked_fill_fwd_mesh", "masked_fill_bwd_mesh",
                   "stem_fold_mesh"),
    "CIFAR bf16 mesh": ("masked_fill_fwd_mesh", "masked_fill_bwd_mesh",
                        "stem_fold_bf16_mesh"),
    "RN50 mesh": ("masked_fill_fwd_mesh", "masked_fill_bwd_mesh",
                  "stem_fold_mesh", "gn_relu_fwd", "gn_relu_bwd"),
    "ViT mesh": ("masked_fill_fwd_mesh", "masked_fill_bwd_mesh",
                 "masked_kv_attn_mesh")}
#: a launch's time limit (s): ranks start, build nothing (the library is
#: built), run their paths and checks
MESH_TIMEOUT_S = 400
#: a first-round flip between a mesh path's records and its single-process
#: path's is allowed only under this top-2 margin of the single-process
#: entry (`PERF.md` §2)
MESH_FLIP_MARGIN = 1e-3
#: first-step gradients vs one process, with cuDNN off: its algorithm
#: choice depends on the batch, and a rank's batch is a shard
TOL_STEP = 1e-5
#: calls per timed graph and timed graphs of the mesh phase's kernel times
#: (fewer than INNER, REPS: the phase's time is capped)
MESH_TIMING = (5, 5)
#: the record of the single-device kernel on the whole shape (timed by the
#: kernel phases) beside each sharded form's; the bf16 fill's whole shape
#: (S = 126) is timed in the mesh phase
WHOLE_OF = {"masked_fill_fwd_mesh_cifar": "masked_fill_fwd",
            "masked_fill_bwd_mesh_cifar": "masked_fill_bwd",
            "masked_fill_fwd_mesh_224": "masked_fill_fwd_224",
            "masked_fill_bwd_mesh_224": "masked_fill_bwd_224",
            "stem_fold_mesh_cifar": "stem_fold",
            "stem_fold_bf16_mesh_cifar": "stem_fold_bf16",
            "stem_fold_mesh_rn50": "stem_fold_rn50",
            "stem_fold_bf16_mesh_rn50": "stem_fold_bf16_rn50",
            "masked_kv_attn_mesh": "masked_kv_attn",
            "masked_kv_attn_mesh_pairs": "masked_kv_attn_pairs",
            "masked_kv_attn_bf16_mesh": "masked_kv_attn_bf16",
            "masked_kv_attn_bf16_mesh_pairs": "masked_kv_attn_bf16_pairs"}
MESH_SOURCES = {"fill": "dorpatch_tpu/ops/masked_fill.py:152",
                "stem": "dorpatch_tpu/ops/stem_fold.py:271",
                "attn": "dorpatch_tpu/ops/masked_kv_attn.py:110"}


def _host_ms(torch, fn, reps: int = 10) -> float:
    """Median host milliseconds of `fn()` between synchronizes (a
    collective: every rank calls it)."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def _timed_on_rank0(torch, mesh, fns):
    """Device ms of each of `fns` timed on rank 0 while the other ranks
    wait (the card is not shared during the timing); None elsewhere."""
    mesh.barrier()
    out = ([_device_ms(f, *MESH_TIMING) for f in fns] if mesh.rank == 0
           else None)
    mesh.barrier()
    return out


def _mesh_fill_check(torch, mesh, b, size, suffix, bf16):
    """A-mesh (and B-mesh) at a rank's `[B/d, S/m]` shard of the attack
    step's fill (S = 128; the bf16 bank's pair chunk S = 126): against the
    plain version at the shard and the single-device kernel on the whole
    shape (exact), the whole cotangent (after the all_reduce) against
    float64 autograd of the plain version and kernel B (TOL_B), the shard's
    float64 partial against the plain float64 sum; timed at the shard on
    rank 0 beside the plain version, `torch.where` and the single-device
    kernel on the whole shape, and the gloo all_reduce of the cotangent."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.fill_bench import (bwd_bytes, fill_inputs,
                                               kept_share, yardsticks)
    from dorpatch_tpu_torch.ops import masked_fill as mf

    fill, s = 0.5, (126 if bf16 else 128)
    imgs, rects, g = fill_inputs(torch, mesh.device, b, size, s, seed=s + 1)
    if bf16:
        imgs = imgs.bfloat16()
    rows, cols = mesh.block(b, s)
    xb, rb, gb = imgs[rows].contiguous(), rects[cols].contiguous(), \
        g[rows, cols].contiguous()
    hwc, k = size * size * 3, rects.shape[1]
    x = imgs.clone().requires_grad_(not bf16)
    with torch.enable_grad():
        blk = mf.sharded_masked_fill(x, rects, fill, mesh)
        gx = None if bf16 else torch.autograd.grad(blk, x, gb)[0]
    blk = blk.detach()
    whole = mf.masked_fill_fwd_kernel(imgs, rects, fill)[rows, cols]
    plain = mf.masked_fill_reference(xb, rb, fill)
    torch.cuda.synchronize()
    if not (torch.equal(blk, plain) and torch.equal(blk, whole)):
        raise AssertionError(f"sharded fill{suffix} differs from its plain "
                             "version or the single-device kernel A")
    tag = "_bf16" if bf16 else ""
    shard = f"[{xb.shape[0]} of {b} images, {rb.shape[0]} of {s} masks]"
    recs = []
    keep = None
    if not bf16:
        xd = imgs.double().requires_grad_(True)
        with torch.enable_grad():
            (want,) = torch.autograd.grad(
                mf.masked_fill_reference(xd, rects, fill), xd, g.double())
        torch.testing.assert_close(gx.double(), want, **TOL_B)
        b_err = float((gx.double() - want).abs().max())
        kern_b = float((gx - mf.masked_fill_bwd_kernel(rects, g)).abs().max())
        # the float64 form through its op: the block's sums at rows 0: of
        # a zero buffer of the block's rows
        part = mf.masked_fill_bwd_op(rb, gb, xb.shape[0], 0)
        keep = masks_lib.rasterize(rb, size)
        want_part = (gb.double() * keep[None, ..., None]).sum(1)
        part_err = float((part - want_part).abs().max())
        if part_err > 1e-9:
            raise AssertionError(f"kernel B's float64 form{suffix}: "
                                 f"{part_err} from the plain float64 sum")
        buf = torch.zeros((b, size, size, 3), dtype=torch.float64,
                          device=mesh.device)
        ar_ms = _host_ms(torch, lambda: mesh.all_reduce(buf))
        print(f"mesh rank {mesh.rank}: sharded fill{suffix} {shard}: exact "
              f"against the plain fill and kernel A; cotangent "
              f"{b_err:.3g} from float64 autograd, {kern_b:.3g} from kernel "
              f"B; B's float64 partial {part_err:.3g} from the plain sum; "
              f"all_reduce of [{b},{size},{size},3] float64 over "
              f"{mesh.backend}: {ar_ms:.3f} ms", flush=True)
    else:
        print(f"mesh rank {mesh.rank}: sharded bf16 fill{suffix} {shard}: "
              "exact against the plain fill and kernel A's bf16 form",
              flush=True)
    if keep is None:
        keep = masks_lib.rasterize(rb, size)
    plain_b, lib_a, lib_b = yardsticks(torch, xb, keep, gb, fill)
    fns = [lambda: mf.masked_fill_fwd_op(xb, rb, fill, True),
           lambda: mf.masked_fill_reference(xb, rb, fill), lib_a]
    if bf16:    # no record of the single-device kernel at this shape
        fns.append(lambda: mf.masked_fill_fwd_kernel(imgs, rects, fill))
    else:
        fns += [lambda: mf.masked_fill_bwd_op(rb, gb, xb.shape[0], 0),
                plain_b, lib_b]
    ms = _timed_on_rank0(torch, mesh, fns)
    if ms is None:
        return []
    bl, sl = xb.shape[0], rb.shape[0]
    isz = 2 if bf16 else 4
    bound, by = _bound(isz * bl * hwc + 16 * sl * k + isz * bl * sl * hwc,
                       0.0)
    recs.append(dict(name=f"masked_fill_fwd{tag}_mesh{suffix}", route="cuda",
                     source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                     replaces=MESH_SOURCES["fill"], launches=0,
                     max_abs_err=0.0, ms=ms[0], plain_ms=ms[1],
                     bound_ms=bound, bound_by=by, library_ms=ms[2],
                     shard=shard, whole_kernel_ms=ms[3] if bf16 else None))
    if not bf16:
        need, _ = bwd_bytes(gb.shape, k, keep)
        bound, by = _bound(need + 4 * bl * hwc,
                           bl * sl * hwc * kept_share(keep), PEAK_F64_FLOPS)
        recs.append(dict(name=f"masked_fill_bwd_mesh{suffix}", route="cuda",
                         source="dorpatch_tpu_torch/csrc/masked_fill.cu",
                         replaces=MESH_SOURCES["fill"], launches=0,
                         max_abs_err=b_err, ms=ms[3], plain_ms=ms[4],
                         bound_ms=bound, bound_by=by, library_ms=ms[5],
                         shard=shard, whole_kernel_ms=None,
                         all_reduce_ms=ar_ms))
    for r in recs:
        print(f"mesh kernel {r['name']} {shard}: {r['ms'] * 1e3:.2f} us a "
              f"shard (plain {r['plain_ms'] * 1e3:.2f}, library "
              f"{r['library_ms'] * 1e3:.2f}, bound {r['bound_ms'] * 1e3:.2f} "
              f"us by {r['bound_by']})", flush=True)
    return recs


def _mesh_stem_check(torch, mesh, dataset, arch, size, b, suffix, dtype):
    """C-mesh (C-bf16-mesh) on a rank's data block of one phase-1 chunk:
    against the plain fold of the block (`stem_bench.stem_gate`) and the
    single-device kernel on the whole batch (bit-equal rows); timed at the
    block on rank 0 beside the plain fold, conv2d of the masked block and
    the single-device kernel on the whole batch."""
    from types import SimpleNamespace

    import torch.nn.functional as F

    from dorpatch_tpu_torch import stem_bench as sb
    from dorpatch_tpu_torch.ops import stem_fold as sf

    dt = getattr(torch, dtype)
    case = sb.stem_case(torch, mesh.device, dataset, arch, size, b, dt)
    rows, _ = mesh.block(b, mesh.shape["mask"])
    blk = SimpleNamespace(**vars(case))
    for f in ("imgs", "clean", "u", "up"):
        setattr(blk, f, getattr(case, f)[rows].contiguous())
    blk.xm = case.xm.reshape((b, -1) + tuple(case.xm.shape[1:]))[rows] \
        .reshape((-1,) + tuple(case.xm.shape[1:]))
    args = sb.kernel_args(blk)
    with torch.no_grad():
        got = sf.fold_masked_stem_sharded(*args, mesh=mesh)
        whole = sf.fold_masked_stem_kernel(*sb.kernel_args(case))[rows]
        want = sb.plain(blk)
        torch.cuda.synchronize()
        err, bad, _ = sb.stem_gate(torch, blk, got, want)
        if bad or not torch.equal(got, whole):
            raise AssertionError(f"sharded stem fold{suffix} {dtype}: {bad} "
                                 f"elements out of C's gate (max {err}), or "
                                 "not equal to the single-device kernel")
        blk.part = [pw._replace(occ=torch.as_tensor(pw.occ,
                                                    device=mesh.device))
                    for pw in blk.part]
        ms = _timed_on_rank0(torch, mesh, [
            lambda: sf.fold_masked_stem_sharded(*args, mesh=mesh),
            lambda: sb.plain(blk),
            lambda: F.conv2d(blk.xm, blk.w_oihw, None, blk.s)])
    shard = f"[{blk.imgs.shape[0]} of {b} images, N={case.n}]"
    print(f"mesh rank {mesh.rank}: sharded stem fold{suffix} {dtype} "
          f"{shard}: max_abs_err {err:.3g} against the plain fold, equal to "
          "the single-device kernel's rows", flush=True)
    if ms is None:
        return []
    _, _, bytes_ms, ops_ms, _ = sb.bounds(blk)
    bound, by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
        (ops_ms, "operations")
    tag = "_bf16" if dtype == "bfloat16" else ""
    rec = dict(name=f"stem_fold{tag}_mesh{suffix}", route="cuda",
               source="dorpatch_tpu_torch/csrc/stem_fold.cu",
               replaces=MESH_SOURCES["stem"], launches=0, max_abs_err=err,
               ms=ms[0], plain_ms=ms[1], bound_ms=bound, bound_by=by,
               library_ms=ms[2], shard=shard, whole_kernel_ms=None)
    print(f"mesh kernel {rec['name']} {shard}: {ms[0] * 1e3:.2f} us a shard "
          f"(plain {ms[1] * 1e3:.2f}, conv2d {ms[2] * 1e3:.2f}, bound "
          f"{bound * 1e3:.2f} us by {by})", flush=True)
    return [rec]


def _mesh_attn_check(torch, mesh, dtype):
    """H-mesh (H-bf16-mesh) on a rank's data block of the ViT-B/16 engine's
    phase-1 and pair-audit chunks: against the plain version on the block
    (float64; the bf16 form within an ulp plus 2^-8 of the largest |v|)
    and the single-device kernel on the whole batch (bit-equal rows);
    timed on rank 0 beside the plain version, SDPA and the single-device
    kernel on the whole batch."""
    import numpy as np

    import torch.nn.functional as F

    from dorpatch_tpu_torch import attn_bench
    from dorpatch_tpu_torch.ops import masked_kv_attn as mka

    bf16 = dtype == "bfloat16"
    rng = np.random.default_rng(16)
    tag = "_bf16" if bf16 else ""
    recs = []
    for suffix, (_, kind, c) in zip(("", "_pairs"), attn_bench.SHAPES):
        args = attn_bench.engine_case(torch, mesh.device, kind, c, rng)
        if bf16:
            args = tuple(a.bfloat16() for a in args)
        b = args[0].shape[0]
        rows, _ = mesh.block(b, mesh.shape["mask"])
        blk = tuple(a[rows].contiguous() for a in args)
        got = mka.masked_kv_attention_sharded(*blk, mesh=mesh)
        whole = mka.masked_kv_attention_kernel(*args)[rows]
        if bf16:
            want = mka.masked_kv_attention_reference(*blk)
            vmax = max(float(blk[2].abs().max()), float(blk[4].abs().max()))
            e = (got.float() - want.float()).abs()
            bad = int((e > _ulp16(torch, want) + 2.0 ** -8 * vmax).sum())
            err = float(e.max())
        else:
            want = mka.masked_kv_attention_reference(
                *(a.double() for a in blk))
            err = float((got.double() - want).abs().max())
            bad = int((~torch.isclose(got.double(), want, **TOL_H)).sum())
        if bad or not torch.equal(got, whole):
            raise AssertionError(f"sharded kernel H{tag}{suffix}: {bad} "
                                 f"elements out of tolerance (max {err}), "
                                 "or not equal to the single-device kernel")
        qs, ks, vs, mask = attn_bench.sdpa_inputs(torch, blk)
        ms = _timed_on_rank0(torch, mesh, [
            lambda: mka.masked_kv_attention_sharded(*blk, mesh=mesh),
            lambda: mka.masked_kv_attention_reference(*blk),
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   attn_mask=mask, scale=1.0)])
        bb, cc, s, h, f = blk[0].shape
        shard = f"[{bb} of {b} images, C={cc}, S={s}]"
        print(f"mesh rank {mesh.rank}: sharded kernel H{tag}{suffix} "
              f"{shard}: max_abs_err {err:.3g} against the plain version, "
              "equal to the single-device kernel's rows", flush=True)
        if ms is not None:
            bound, by, _, _ = attn_bench.bound(blk)
            rec = dict(name=f"masked_kv_attn{tag}_mesh{suffix}",
                       route="cuda",
                       source="dorpatch_tpu_torch/csrc/masked_kv_attn.cu",
                       replaces=MESH_SOURCES["attn"], launches=0,
                       max_abs_err=err, ms=ms[0], plain_ms=ms[1],
                       bound_ms=bound, bound_by=by, library_ms=ms[2],
                       shard=shard, whole_kernel_ms=None)
            print(f"mesh kernel {rec['name']} {shard}: {ms[0] * 1e3:.2f} us "
                  f"a shard (plain {ms[1] * 1e3:.2f}, SDPA "
                  f"{ms[2] * 1e3:.2f}, bound {bound * 1e3:.2f} us by {by})",
                  flush=True)
            recs.append(rec)
        del args, blk, got, whole, want, qs, ks, vs, mask
        torch.cuda.empty_cache()
    return recs


def _step_grads(torch, atk, x, lvx, rects, state):
    """One EOT step's (stage 0) gradients with respect to the image (the
    perturbation `l2_project` returns), the mask and the pattern."""
    from dorpatch_tpu_torch import losses

    plain, seen = losses.l2_project, []

    def keep(*args, **kwargs):
        seen.append(plain(*args, **kwargs))
        return seen[-1]

    m = state.adv_mask.detach().clone().requires_grad_(True)
    p = state.adv_pattern.detach().clone().requires_grad_(True)
    losses.l2_project = keep
    try:
        with torch.enable_grad():
            total, _ = atk._loss_and_aux(m, p, x, lvx, rects, state, 0)
            return torch.autograd.grad(total, (seen[0], m, p))
    finally:
        losses.l2_project = plain


def _path_inputs(torch, argv, dev):
    """(config, victim, images) of a main path's first batch: the victim
    of `get_model` (random weights from the seed) and the synthetic batch,
    every image of which the pipeline keeps (its labels are the victim's
    own predictions)."""
    from dorpatch_tpu_torch import data
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.models import get_model

    cfg = config_from_args(build_parser().parse_args(argv))
    victim = get_model(cfg.dataset, cfg.base_arch, cfg.model_dir,
                       cfg.img_size, device=dev)
    x_np, _ = next(data.dataset_batches(cfg.dataset, cfg.batch_size,
                                        cfg.img_size, cfg.seed,
                                        source="synthetic"))
    return cfg, victim, torch.as_tensor(x_np, device=dev)


def _first_step(torch, mesh, cfg, victim, x):
    """The path's first attack step (stage 0, one seeded draw of the EOT
    sample) on the mesh and, on rank 0, in one process: the gradients with
    respect to the image, the mask and the pattern, with cuDNN off (its
    convolutions give an image the same result in a batch of any size, so
    what differs is the mesh's) and as configured (cuDNN picks its
    algorithm by the batch, and a rank's is a shard of one process's).
    Returns, on rank 0, {"off": largest |difference| with cuDNN off, "on":
    as configured, "native_one"/"native_mesh": each configured gradient's
    largest |difference| from the cuDNN-off one, "max": the largest |g|};
    None elsewhere."""
    from dorpatch_tpu_torch import losses, utils
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.attack import DorPatch

    dev = mesh.device
    with torch.no_grad():
        y = torch.argmax(victim.apply(x), -1)
    lvx = torch.mean(losses.local_variance(x)[0], dim=-1)
    universe = torch.as_tensor(masks_lib.dropout_universe(
        cfg.img_size, cfg.attack.dropout, cfg.attack.dropout_sizes),
        device=dev)
    idx = torch.randperm(universe.shape[0], generator=utils.generator(
        2, torch.device("cpu")))[:cfg.attack.sampling_size].to(dev)

    def grads(atk):
        state = atk._init_state(utils.generator(0, dev), x, y, False,
                                universe.shape[0])
        return _step_grads(torch, atk, x, lvx, universe[idx], state)

    def diff(a, b):
        return max(float((u - v).abs().max()) for u, v in zip(a, b))

    got, want = {}, {}
    try:
        for on in (False, True):
            torch.backends.cudnn.enabled = on
            got[on] = grads(DorPatch(victim.apply, victim.num_classes,
                                     cfg.attack, mesh=mesh))
            torch.cuda.synchronize()
            mesh.barrier()
            if mesh.rank == 0:
                want[on] = grads(DorPatch(victim.apply, victim.num_classes,
                                          cfg.attack))
            torch.cuda.empty_cache()
            mesh.barrier()
    finally:
        torch.backends.cudnn.enabled = True
    torch.cuda.empty_cache()
    if mesh.rank:
        return None
    return {"off": diff(got[False], want[False]),
            "on": diff(got[True], want[True]),
            "native_one": diff(want[True], want[False]),
            "native_mesh": diff(got[True], got[False]),
            "max": max(float(g.abs().max()) for g in want[False])}


def _one_process_records(torch, cfg, victim, x, root) -> None:
    """Where the mesh run's patch of batch 0 is not the one-process run's
    (`<root>/one_patch.npz`, written by `mesh_phase`), the single-process
    certification (the bank without a mesh) of that patch, pickled to
    `<root>/one.pkl`: what the meshed certification must give on the same
    images. Where the patches are equal the one-process run's records are
    that already."""
    import pickle

    import numpy as np

    from dorpatch_tpu_torch import data, losses
    from dorpatch_tpu_torch.artifacts import ArtifactStore, results_path
    from dorpatch_tpu_torch.defense import build_defenses

    patch = ArtifactStore(results_path(cfg)).load_patch(0)
    one = np.load(os.path.join(root, "one_patch.npz"))
    if all(np.array_equal(a, one[k]) for a, k in zip(patch, ("mask",
                                                            "pattern"))):
        return
    mask, pattern = (torch.as_tensor(a, device=x.device) for a in patch)
    adv = x + losses.l2_project(mask, pattern, x, cfg.attack.eps)
    bank = build_defenses(victim.apply, cfg.img_size, cfg.defense,
                          incremental=victim.incremental, device=x.device)
    with torch.no_grad():
        per = [d.robust_predict(adv, victim.num_classes,
                                bucket_sizes=data.batch_buckets(
                                    cfg.batch_size)) for d in bank]
    with open(os.path.join(root, "one.pkl"), "wb") as fh:
        pickle.dump([list(r) for r in zip(*per)], fh)


def mesh_worker(spec_path: str) -> int:
    """One rank of a mesh launch (`--mesh-worker SPEC`): the spec's paths
    through the CLI entry point (launch counts set to 0 just before and
    read just after each), their first attack step against one process,
    then the sharded kernels' checks; writes `rank_<rank>.json` beside the
    spec."""
    import torch

    from dorpatch_tpu_torch import ops, utils
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.parallel import make_mesh
    from dorpatch_tpu_torch.pipeline import run_experiment

    with open(spec_path) as fh:
        spec = json.load(fh)
    d, m = spec["mesh"]
    mesh = make_mesh(d, m)
    utils.configure_numerics()
    out = {"rank": mesh.rank, "mesh": mesh.describe(), "paths": {},
           "kernels": []}
    try:
        t_start = time.perf_counter()
        for label, argv, root, step in spec["paths"]:
            cfg = config_from_args(build_parser().parse_args(
                argv + ["--results-root", root, "--mesh-data", str(d),
                        "--mesh-mask", str(m)]))
            torch.cuda.synchronize()
            mesh.barrier()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = run_experiment(cfg, verbose=mesh.rank == 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res = {"wall": wall, "launches": ops.launch_counts(),
                   "routes": ops.route_counts(),
                   "unsharded": dict(mesh.unsharded),
                   "metrics": {k: got.get(k) for k in (
                       "report", "attack_seconds", "certify_seconds",
                       "forwards", "forwards_exhaustive", "escalated")}}
            mesh.barrier()              # rank 0 has saved the artifacts
            cfg0, victim, x = _path_inputs(torch, argv, mesh.device)
            if step:
                res["first_step_diff"] = _first_step(torch, mesh, cfg0,
                                                     victim, x)
            if mesh.rank == 0:
                _one_process_records(torch, cfg, victim, x, root)
            del victim
            torch.cuda.empty_cache()
            mesh.barrier()
            out["paths"][label] = res
            if mesh.rank == 0:
                print(f"mesh {label}: run {wall:.1f} s, with its checks "
                      f"{time.perf_counter() - t_start:.1f} s since the "
                      "launch's first path", flush=True)
        for check in spec["kernels"]:
            if mesh.rank == 0:
                print(f"mesh kernel checks: {check[0]} at "
                      f"{time.perf_counter() - t_start:.1f} s", flush=True)
            kind, rest = check[0], check[1:]
            if kind == "fill":
                out["kernels"] += _mesh_fill_check(torch, mesh, *rest, False)
            elif kind == "fill_bf16":
                out["kernels"] += _mesh_fill_check(torch, mesh, *rest, True)
            elif kind == "stem":
                out["kernels"] += _mesh_stem_check(torch, mesh, *rest)
            else:
                out["kernels"] += _mesh_attn_check(torch, mesh, *rest)
        with open(os.path.join(os.path.dirname(spec_path),
                               f"rank_{mesh.rank}.json"), "w") as fh:
            json.dump(out, fh)
        mesh.barrier()
    finally:
        mesh.close()
    return 0


def _all_records_equal(a, b) -> bool:
    """Per image and radius, `_records_equal`."""
    return len(a) == len(b) and all(
        len(ra) == len(rb) and all(_records_equal(x, y)
                                   for x, y in zip(ra, rb))
        for ra, rb in zip(a, b))


def _flips(torch, argv, patch, base, other):
    """The first-round and pair-table entries (both evaluated) where
    records `other` differ from `base`, each with `base`'s top-2 margin
    there (the victim's forward, at the bank's dtype, on the masked image
    of `patch`): [(image, radius, entry, margin)]."""
    import numpy as np

    from dorpatch_tpu_torch import losses, utils
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.defense import UNEVALUATED
    from dorpatch_tpu_torch.ops.masked_fill import masked_fill

    cfg, victim, x = _path_inputs(torch, argv, torch.device("cuda"))
    mask, pattern = (torch.as_tensor(a, device=x.device) for a in patch)
    dt = utils.compute_dtype(cfg.defense.compute_dtype)
    fwd = utils.forward_at(victim.apply, dt)
    adv = (x + losses.l2_project(mask, pattern, x, cfg.attack.eps)).to(dt)
    out = []
    for r, ratio in enumerate(cfg.defense.ratios):
        spec = masks_lib.geometry(cfg.img_size, ratio, cfg.defense.n_patch,
                                  cfg.defense.num_mask_per_axis)
        singles, doubles = masks_lib.mask_sets(spec)
        kk = max(singles.shape[1], doubles.shape[1])
        rects = np.concatenate([masks_lib.pad_rects(singles, kk),
                                masks_lib.pad_rects(doubles, kk)])
        for i, (a, c) in enumerate(zip(base, other)):
            ta = np.concatenate([a[r].preds_1, a[r].preds_2])
            tc = np.concatenate([c[r].preds_1, c[r].preds_2])
            both = (ta != UNEVALUATED) & (tc != UNEVALUATED)
            for j in np.nonzero(both & (ta != tc))[0]:
                xm = masked_fill(adv[i:i + 1], torch.as_tensor(
                    rects[j:j + 1], device=dev), cfg.defense.mask_fill)
                with torch.no_grad():
                    _, mg = utils.preds_margins(fwd(
                        xm.reshape((1,) + tuple(x.shape[1:]))))
                out.append((i, ratio, int(j), float(mg[0])))
    del victim
    torch.cuda.empty_cache()
    return out


def mesh_phase(torch, records_of, metrics_of, fills, whole_ms) -> list:
    """The mesh paths (MESH_LAUNCHES) through `torch.distributed.run`, each
    launch one command of `--mesh-worker` ranks sharing cuda:0 over gloo.
    Fails unless every rank launched its path's sharded kernels, every
    first step's gradients are within TOL_STEP of one process's, and each
    path's records (verdicts, tables, forwards) equal its single-process
    path's, but for table entries whose single-process margin is under
    MESH_FLIP_MARGIN (listed); prints each path's wall, attack and certify
    seconds beside the single-process path's and the whole-run patch
    difference (not held). Then the NCCL check. Returns the sharded
    kernels' records, their launches summed over every rank of every path
    of their launch, each with the single-device kernel's ms on the whole
    shape (`whole_ms`, by record name, WHOLE_OF)."""
    import pickle

    import numpy as np

    from dorpatch_tpu_torch.artifacts import ArtifactStore, results_path
    from dorpatch_tpu_torch.cli import build_parser, config_from_args

    here = os.path.dirname(os.path.abspath(__file__))
    recs = []
    torch.cuda.empty_cache()
    for world, (d, m), paths, kernels in MESH_LAUNCHES:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
            spec = {"mesh": [d, m], "kernels": kernels, "paths": [
                [label, argv, os.path.join(root, label.replace(" ", "_")),
                 step] for label, _, argv, step in paths]}
            spec_path = os.path.join(root, "spec.json")
            for label, single, _, _ in paths:
                path_root = os.path.join(root, label.replace(" ", "_"))
                os.makedirs(path_root)
                np.savez(os.path.join(path_root, "one_patch.npz"),
                         mask=PATCHES[single][0], pattern=PATCHES[single][1])
            with open(spec_path, "w") as fh:
                json.dump(spec, fh)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(world),
                 os.path.join(here, "chip_smoke.py"), "--mesh-worker",
                 spec_path], cwd=here, capture_output=True, text=True,
                timeout=MESH_TIMEOUT_S)
            launch_s = time.perf_counter() - t0
            lines = (proc.stdout + proc.stderr).splitlines()
            print("\n".join(ln for ln in lines if ln.startswith(
                ("mesh ", "[p0")) or "Error" in ln)[-12000:], flush=True)
            if proc.returncode != 0:
                print("\n".join(lines[-60:]), flush=True)
                raise AssertionError(f"mesh launch of {world} ranks exited "
                                     f"{proc.returncode}")
            ranks = []
            for r in range(world):
                with open(os.path.join(root, f"rank_{r}.json")) as fh:
                    ranks.append(json.load(fh))
            print(f"mesh launch {d}x{m}: {launch_s:.1f} s; backend "
                  f"{ranks[0]['mesh']['backend']}, devices "
                  f"{[r['mesh']['device'] for r in ranks]}", flush=True)
            totals = {}
            for label, single, argv, _ in paths:
                per = [r["paths"][label] for r in ranks]
                need = list(MESH_KERNELS[label])
                if fills[single].get("masked_fill_fwd_bf16", 0):
                    need.append("masked_fill_fwd_bf16_mesh")
                for r, p in enumerate(per):
                    miss = [k for k in need if p["launches"][k] <= 0]
                    if miss:
                        raise AssertionError(f"{label}: rank {r} did not "
                                             f"launch {miss}")
                for p in per:
                    for k, v in p["launches"].items():
                        totals[k] = totals.get(k, 0) + v
                path_root = os.path.join(root, label.replace(" ", "_"))
                cfg = config_from_args(build_parser().parse_args(
                    argv + ["--results-root", path_root]))
                store = ArtifactStore(results_path(cfg))
                meshed = store.load_pc_records(0)
                patch = store.load_patch(0)
                one_recs = records_of[single]      # the patches are equal
                if os.path.exists(os.path.join(path_root, "one.pkl")):
                    with open(os.path.join(path_root, "one.pkl"),
                              "rb") as fh:
                        one_recs = pickle.load(fh)
                same_run = _all_records_equal(records_of[single], meshed)
                same = _all_records_equal(one_recs, meshed)
                flips = [] if same else _flips(torch, argv, patch, one_recs,
                                               meshed)
                far = [f for f in flips if f[3] >= MESH_FLIP_MARGIN]
                pdiff = max(float(np.abs(a - c).max()) for a, c in
                            zip(patch, PATCHES[single]))
                step = per[0].get("first_step_diff")
                one, mm = metrics_of[single], per[0]["metrics"]
                print(f"{label} ({d}x{m}, {world} ranks): wall "
                      f"{per[0]['wall']:.2f} s (one process "
                      f"{one['wall_s']:.2f}); attack s "
                      f"{mm['attack_seconds']} ({one.get('attack_seconds')});"
                      f" certify s {mm['certify_seconds']} "
                      f"({one.get('certify_seconds')}); forwards "
                      f"{mm['forwards']} ({one.get('forwards')}); patch max "
                      f"|diff| from the one-process run's {pdiff:.3g} (not "
                      f"held); records equal to the one-process run's: "
                      f"{same_run}, to one process's certification of this "
                      f"patch: {same}; its table entries differing, with "
                      f"one process's margin: {flips}; first-step gradients "
                      f"(image, mask, pattern) max |diff| from one "
                      f"process's with cuDNN off and as configured, and "
                      f"each configured one's from cuDNN off: {step}; calls "
                      f"the mesh did not divide "
                      f"{[p['unsharded'] for p in per]}; report equal to "
                      f"the one-process run's: "
                      f"{mm['report'] == one['report']}", flush=True)
                if step is not None and not step["off"] <= TOL_STEP:
                    raise AssertionError(f"{label}: first-step gradients "
                                         f"{step} from one process's")
                if far or (not same and not flips):
                    raise AssertionError(
                        f"{label}: records differ from one process's "
                        f"certification of the same patch beyond margin "
                        f"{MESH_FLIP_MARGIN}: {far or flips}")
            for r in ranks[0]["kernels"]:
                r["launches"] = totals.get(
                    r["name"].split("_mesh")[0] + "_mesh", 0)
                if r["whole_kernel_ms"] is None:
                    r["whole_kernel_ms"] = whole_ms.get(WHOLE_OF[r["name"]])
                recs.append(r)
    nccl_check(torch)
    return recs


def nccl_check(torch) -> None:
    """A one-rank NCCL group on the card runs `sharded_masked_fill` once,
    its backward's all_reduce included: the installation's NCCL
    initialises and reduces. Forward exact against kernel A, cotangent
    within TOL_B of kernel B."""
    import torch.distributed as dist

    from dorpatch_tpu_torch.fill_bench import fill_inputs
    from dorpatch_tpu_torch.ops import masked_fill as mf
    from dorpatch_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1,
            device_id=dev)
        try:
            mesh = make_mesh(1, 1)
            imgs, rects, g = fill_inputs(torch, dev, 2, 32, 8, seed=5)
            x = imgs.clone().requires_grad_(True)
            with torch.enable_grad():
                out = mf.sharded_masked_fill(x, rects, 0.5, mesh)
                (gx,) = torch.autograd.grad(out, x, g)
            torch.cuda.synchronize()
            if not torch.equal(out, mf.masked_fill_fwd_kernel(imgs, rects,
                                                              0.5)):
                raise AssertionError("NCCL check: forward differs")
            torch.testing.assert_close(
                gx, mf.masked_fill_bwd_kernel(rects, g), **TOL_B)
            print(f"NCCL check: one-rank {mesh.backend} group on {dev}, "
                  f"NCCL {torch.cuda.nccl.version()}: sharded fill and its "
                  "all_reduce agree with kernels A and B", flush=True)
        finally:
            dist.destroy_process_group()


#: the analysis gates, run on the card's installation while the kernel
#: phases run (`start_gates`), collected before the main paths
#: (`finish_gates`): (name, arguments of `python -m
#: dorpatch_tpu_torch.analysis`)
ANALYSIS_GATES = (("lint", ["dorpatch_tpu_torch"]),
                  ("concurrency", ["--concurrency", "dorpatch_tpu_torch"]),
                  ("baseline", ["--baseline", "check"]))
#: the RN50 bf16 attack step of PERF.md §5 (`trace.py`, profiled), ms
RN50_BF16_STEP_MS = 73.55
#: the capture run (`capture_check`): CIFAR's flags at a short size, with
#: the certification's chunks large (a chunk loop runs in Python: each
#: chunk is a copy of the forward in a traced graph)
CAPTURE_ARGV = ["--synthetic", "--dataset", "cifar10", "--base_arch",
                "resnet18", "--img-size", "32", "-b", "2",
                "--sampling-size", "64", "--dropout", "1",
                "--max-iterations", "2", "--sweep-interval", "2",
                "--num-batches", "1"]
CAPTURE_CHUNK = 1024


def start_gates() -> dict:
    """Start the analysis gates (`ANALYSIS_GATES`) as subprocesses on the
    host's CPU: they trace on fake tensors and need no card. Returns
    name -> (start time, process, finish box)."""
    import atexit
    import threading

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    gates = {}
    for name, args in ANALYSIS_GATES:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dorpatch_tpu_torch.analysis"] + args,
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        box = {}

        def wait(proc=proc, box=box):
            box["out"] = proc.communicate()[0]
            box["t"] = time.perf_counter()

        th = threading.Thread(target=wait, daemon=True)
        th.start()
        gates[name] = (time.perf_counter(), proc, box, th)
        # a phase that fails before `finish_gates` leaves none running
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
    return gates


def finish_gates(gates: dict, timeout: float = 600.0) -> None:
    """Wait for the gates; each must exit 0. Prints each one's seconds
    and last line, and the seconds waited."""
    waited = time.perf_counter()
    failed = []
    for name, (t0, proc, box, th) in gates.items():
        th.join(timeout)
        if th.is_alive():
            proc.kill()
            th.join()
            failed.append(name)
        out = box.get("out") or ""
        last = out.strip().splitlines()[-1] if out.strip() else ""
        print(f"analysis gate {name}: exit {proc.returncode} in "
              f"{box.get('t', time.perf_counter()) - t0:.1f} s: {last}",
              flush=True)
        if proc.returncode != 0:
            print(out[-6000:], flush=True)
            failed.append(name)
    print(f"analysis gates: waited {time.perf_counter() - waited:.1f} s "
          "after the kernel phases", flush=True)
    if failed:
        raise AssertionError(f"analysis gates failed: {sorted(set(failed))}")


def dispatch_cost(torch, dev) -> dict:
    """Host microseconds to make one eager call of kernel A at the CIFAR
    step's shape [8, 128]: through the user's wrapper (`masked_fill`, the
    op and its autograd function), the kernel entry (the op) and the
    direct ctypes launch under it (`fill_bench.host_costs`)."""
    from dorpatch_tpu_torch.fill_bench import host_costs
    from dorpatch_tpu_torch.ops import masked_fill as mf

    with torch.no_grad():
        rec = host_costs(torch, mf, dev)
    rec["dispatch_us"] = rec["entry_us"] - rec["launch_us"]
    print(f"dispatch cost of kernel A at [8,128]: {rec['wrapper_us']:.2f} us "
          f"a call through masked_fill, {rec['entry_us']:.2f} through the "
          f"op dorpatch_torch::masked_fill_fwd, {rec['launch_us']:.2f} the "
          f"direct launch: the dispatcher adds {rec['dispatch_us']:.2f} us",
          flush=True)
    return rec


def _direct_launches(on: bool) -> None:
    """Route the fill's and the GroupNorm's autograd functions to their
    kernels' ctypes launches without the dispatcher (`on`), or back through
    their ops: the A/B of the op layer on a step."""
    from dorpatch_tpu_torch.ops import fused_gn as gn
    from dorpatch_tpu_torch.ops import masked_fill as mf

    saved = _direct_launches.__dict__.setdefault("ops", dict(
        fill_fwd=mf.masked_fill_fwd_op, fill_bwd=mf.masked_fill_bwd_op,
        gn_fwd=gn.gn_relu_fwd_op, gn_bwd=gn.gn_relu_bwd_op))
    if on:
        mf.masked_fill_fwd_op = mf._fwd_cuda
        mf.masked_fill_bwd_op = mf._bwd_cuda
        gn.gn_relu_fwd_op = gn._fwd_launch
        gn.gn_relu_bwd_op = gn._bwd_cuda
    else:
        mf.masked_fill_fwd_op = saved["fill_fwd"]
        mf.masked_fill_bwd_op = saved["fill_bwd"]
        gn.gn_relu_fwd_op = saved["gn_fwd"]
        gn.gn_relu_bwd_op = saved["gn_bwd"]


def rn50_bf16_step(torch, dev, steps: int = 5, pairs: int = 3) -> dict:
    """ms of one RN50 bf16 attack step at 224 (2 images, S = 128 over the
    dropout=2 universe, as `trace.py`'s attack_step; unprofiled, host clock
    around `steps` synchronized steps), through the kernels' ops and with
    the same launches called directly (`_direct_launches`), in `pairs`
    alternating pairs: medians, and the ops' share over the direct."""
    from dorpatch_tpu_torch import data, masks, utils
    from dorpatch_tpu_torch.attack import DorPatch
    from dorpatch_tpu_torch.config import AttackConfig
    from dorpatch_tpu_torch.losses import local_variance
    from dorpatch_tpu_torch.models import get_model

    victim = get_model("imagenet", "resnetv2", "/nonexistent", 224,
                       device=dev)
    x_np, _ = next(data.synthetic_batches("imagenet", 2, 224, 1234))
    x = torch.as_tensor(x_np, device=dev)
    with torch.no_grad():
        y = torch.argmax(victim.apply(x), -1)
    attack = DorPatch(victim.apply, victim.num_classes,
                      AttackConfig(sampling_size=128, dropout=2,
                                   compute_dtype="bfloat16"))
    universe = torch.as_tensor(masks.dropout_universe(224, 2), device=dev)
    lvx = torch.mean(local_variance(x)[0], dim=-1)
    state = attack._init_state(utils.generator(1234, dev), x, y, False,
                               universe.shape[0])

    def timed(direct: bool) -> float:
        nonlocal state
        _direct_launches(direct)
        try:
            state = attack._step(state, x, lvx, universe, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state = attack._step(state, x, lvx, universe, 0)
            torch.cuda.synchronize()
        finally:
            _direct_launches(False)
        return (time.perf_counter() - t0) / steps * 1e3

    for _ in range(2):
        state = attack._step(state, x, lvx, universe, 0)
    runs = {"ops": [], "direct": []}
    for i in range(pairs):
        for direct in ((False, True) if i % 2 == 0 else (True, False)):
            runs["direct" if direct else "ops"].append(timed(direct))
    out = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    out["ops_share"] = out["ops"] / out["direct"] - 1.0
    print(f"RN50 bf16 attack step at 224 (unprofiled, medians of {pairs} "
          f"runs of {steps} steps): {out['ops']:.2f} ms through the ops, "
          f"{out['direct']:.2f} ms with direct launches ({100 * out['ops_share']:+.2f}%); "
          f"runs {runs}; PERF.md §5's profiled step: {RN50_BF16_STEP_MS} ms",
          flush=True)
    return out


def capture_check(torch, dev) -> list:
    """A short CIFAR run on the card under `capture_entrypoints()`: every
    program it runs is recorded with its arguments, then traced on fake
    `cuda` and on fake `cpu` tensors; the two fingerprints must match and
    every program must trace. Prints each program's kernels' ops and the
    names whose fingerprints differ. Returns the captured names."""
    import dataclasses

    from dorpatch_tpu_torch.analysis import baseline
    from dorpatch_tpu_torch.analysis import entrypoints as ep_mod
    from dorpatch_tpu_torch.cli import build_parser, config_from_args
    from dorpatch_tpu_torch.pipeline import run_experiment

    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as root:
        cfg = config_from_args(build_parser().parse_args(
            CAPTURE_ARGV + ["--results-root", root]))
        cfg = dataclasses.replace(cfg, defense=dataclasses.replace(
            cfg.defense, chunk_size=CAPTURE_CHUNK))
        ep_mod.clear_entrypoints()
        with ep_mod.capture_entrypoints():
            run_experiment(cfg, verbose=False)
        torch.cuda.synchronize()
    eps = ep_mod.registered_entrypoints()
    if not eps:
        raise AssertionError("the capture run recorded no program")
    checks = baseline.device_fingerprints(eps, ("cuda", "cpu"))
    for c in checks:
        print(f"capture {c.name}: fake cuda {c.fingerprints['cuda']}, fake "
              f"cpu {c.fingerprints['cpu']}{'' if c.same else ' DIFFER'}; "
              f"kernels' ops {c.kernels}", flush=True)
    ep_mod.clear_entrypoints()
    bad = [c.name for c in checks if not c.same]
    print(f"capture: {len(checks)} programs, fingerprints differ on fake "
          f"cuda and fake cpu for {bad}", flush=True)
    if bad:
        raise AssertionError(f"fingerprints differ across devices: {bad}")
    return [c.name for c in checks]


def analysis_phase(torch, dev, walls) -> dict:
    """The analysis slice on the card (the gates ran beside the kernel
    phases): the dispatch cost of a kernel's op, the RN50 bf16 attack
    step, the main paths' walls and the capture check."""
    t0 = time.perf_counter()
    out = dict(dispatch=dispatch_cost(torch, dev),
               rn50_bf16_step=rn50_bf16_step(torch, dev))
    print("main-path walls (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in walls.items()), flush=True)
    out["captured"] = capture_check(torch, dev)
    print(f"analysis phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import faulthandler

    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2])
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
    gates = start_gates()

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
    finish_gates(gates)

    fills, records_of, metrics_of = {}, {}, {}
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
            ("ViT bf16", VIT_BF16_ARGV, VIT_BF16_KERNELS,
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
        metrics_of[label], counts, records_of[label] = main_path(
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
    analysis_phase(torch, dev,
                   {k: v["wall_s"] for k, v in metrics_of.items()})
    for label in ("RN50", "RN50 bf16"):
        consensus_check(label.replace("RN50", "RN50 consensus"),
                        records_of[label],
                        records_of[label.replace("RN50", "RN50 consensus")])
    t0 = time.perf_counter()
    mesh_kernels = mesh_phase(
        torch, records_of, metrics_of, fills,
        {r["name"]: r["ms"] for r in cifar_kernels + rn50_kernels
         + vit_kernels + cifar_bf16 + rn50_bf16 + vit_bf16})
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
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

    aot_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_aot_")
    aot_build = None
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_victims_") as out:
            t0 = time.perf_counter()
            train_phase(torch, dev, out)
            print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            trained_phase(torch, dev, out)
            print(f"trained-victim phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)

            # the AOT store's build runs in the background from here to the
            # farm, beside the phases that time nothing they record
            aot_build = start_aot_build(os.path.join(aot_tmp.name, "store"))
            t0 = time.perf_counter()
            cross_check(torch, dev, "cifar10", "resnet18", 32, 8)
            victim, x = cross_check(torch, dev, "imagenet", "resnetv2", 224,
                                    CROSS_CHECK_BATCH)
            gn_logits_check(torch, dev, victim, x)
            del victim, x
            for lift in (0.0, 4.0):
                vit_cross_check(torch, dev, CROSS_CHECK_BATCH, lift)
            mixer_cross_check(torch, dev, CROSS_CHECK_BATCH, 0.0, gate=False)
            for lift in (0.0, 4.0):
                mixer_cross_check(torch, dev, CROSS_CHECK_BATCH, lift,
                                  layerscale=0.1)
            print(f"cross-check phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t0 = time.perf_counter()
            for arch in ("resnetv2", "vit"):
                for lift in (0.0, 4.0):
                    bank_cross_check(torch, dev, arch, CROSS_CHECK_BATCH,
                                     lift)
            bank_cross_check(torch, dev, "resnetv2", 2, 4.0, 480)
            consensus_cross_check(torch, dev, CROSS_CHECK_BATCH, 4.0)
            print(f"bf16 bank phase: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t0 = time.perf_counter()
            sanitize_phase(torch, dev, out)
            verify_phase(torch, dev, out)
            print(f"sanitize and verify phase: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            aot_store = finish_aot_build(aot_build, smi)
            t0 = time.perf_counter()
            farm = farm_phase(torch, dev, out, aot_store)
            print(f"farm phase: {time.perf_counter() - t0:.1f} s", flush=True)
            # the farm runs the CIFAR shapes: its launches beside their records
            for rec in cifar_kernels + cifar_bf16:
                rec["farm_launches"] = farm.get(
                    COUNT_OF.get(rec["name"], rec["name"]), 0)
            t0 = time.perf_counter()
            serve_kernels_recs = serve_phase(torch, dev, out, smi)
            print(f"serve phase: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            fleet = fleet_phase(torch, dev, out, smi, aot_store)
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
    finally:
        if aot_build is not None and aot_build[0].poll() is None:
            aot_build[0].kill()
            aot_build[0].wait()
        aot_tmp.cleanup()

    print(f"chip_smoke total: {time.perf_counter() - start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": cifar_kernels + rn50_kernels + vit_kernels
                      + cifar_bf16 + rn50_bf16 + vit_bf16 + rn50_480
                      + rn50_480_bf16 + np2_kernels + mesh_kernels
                      + serve_kernels_recs}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
