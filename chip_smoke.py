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
     20 --num-batches 1` (full-width CIFAR ResNet-18; kernels A, B, C);
   - RN50: `--synthetic --dataset imagenet --base_arch resnetv2
     --img-size 224 -b 2 --sampling-size 128 --dropout 2 --max-iterations
     20 --num-batches 1` (ResNetV2-50x1 BiT at full depth and width;
     kernels A, B, C and the GroupNorm+ReLU forward and backward);
   - ViT: the same flags with `--base_arch vit` (ViT-B/16 at full depth
     and width; kernels A, B and H);
   random weights from the seed, certification at the four radii with
   prune="exact", incremental="auto" (-> stem for the conv victims,
   -> token-exact for the ViT); then the same three runs with
   `--compute-dtype bfloat16 --certify-dtype bfloat16` (the bf16 attack
   fills at float32 (A, B) and runs the victim's bf16 copy (D, F on RN50);
   the bf16 bank fills bf16 images (A's bf16 form) and runs C's and H's
   bf16 forms);
   - RN50 480 and RN50 480 bf16: ResNetV2-50x1 at BiT's 480 px
     fine-tuning resolution, `--img-size 480 -b 1`, the other flags as
     RN50's, without and with the bf16 flags (the backward of the stage-1
     slabs takes kernel G, in float32 and in bf16);
   - ResMLP and ResMLP bf16: RN50's flags with `--base_arch resmlp`
     (ResMLP-24 at full depth and width; kernels A and B, the mixer
     engine's gathers and cuBLAS matmuls, A in escalations);
   - CIFAR n_patch=2 and its bf16 twin: CIFAR's flags with `-b 2
     --defense-n-patch 2` (the exhaustive sweep of 630 + 22680 masks a
     radius, kernel A at K = 3; the bf16 bank keeps the float32 sweep);
   - RN50 consensus and its bf16 twin: RN50's flags with `--prune
     consensus`, whose records are then held against the RN50 runs' (same
     prediction, every certificate kept, at most the forwards);
   - CIFAR disk, where Pillow is installed: CIFAR's flags without
     `--synthetic`, reading a seeded CIFAR-10 `test_batch` it writes into
     a temporary `--data_dir`;
   and prints A's and B's launches x (time - bound) per path;
5. computes the RN50 victim's input gradient on one masked batch 10
   times and runs the RN50 attack's first 5 steps twice from one seed,
   in float32 and in bf16, and fails unless every gradient equals the
   first and the patches are bit-equal (`repeat.victim_repeat`,
   `repeat.attack_steps`; without cuDNN determinism the float32 gradient
   differs in almost every call);
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
9. prints the total seconds, the per-kernel JSON line, the nvidia-smi
   line and, last, `{"ok": true, "device": {...}}`.

Any failed phase raises: the script then exits nonzero and prints no
result line.
"""

from __future__ import annotations

import json
import math
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

CIFAR_ARGV = ["--synthetic", "--dataset", "cifar10", "--base_arch",
              "resnet18", "--img-size", "32", "-b", "8",
              "--sampling-size", "128", "--dropout", "2",
              "--max-iterations", "20", "--num-batches", "1"]
RN50_ARGV = ["--synthetic", "--dataset", "imagenet", "--base_arch",
             "resnetv2", "--img-size", "224", "-b", "2",
             "--sampling-size", "128", "--dropout", "2",
             "--max-iterations", "20", "--num-batches", "1"]
VIT_ARGV = [a if a != "resnetv2" else "vit" for a in RN50_ARGV]
#: ResNetV2-50x1 at BiT's 480 px fine-tuning resolution, 1 image a batch
RN50_480_ARGV = ["--synthetic", "--dataset", "imagenet", "--base_arch",
                 "resnetv2", "--img-size", "480", "-b", "1",
                 "--sampling-size", "128", "--dropout", "2",
                 "--max-iterations", "20", "--num-batches", "1"]
#: the bf16 paths: the same runs with the bf16 attack and certify bank
BF16_FLAGS = ["--compute-dtype", "bfloat16", "--certify-dtype", "bfloat16"]
#: ResMLP-24 (24 blocks, D 384, 196 tokens) at 224, RN50's other flags
RESMLP_ARGV = [a if a != "resnetv2" else "resmlp" for a in RN50_ARGV]
#: the n_patch=2 defense bank (630 pairs, 22680 triples a radius, the
#: exhaustive sweep) on the CIFAR ResNet-18, 2 images a batch
CIFAR_NP2_ARGV = [a if a != "8" else "2" for a in CIFAR_ARGV] + [
    "--defense-n-patch", "2"]
CONSENSUS = ["--prune", "consensus"]
#: the CIFAR path without --synthetic: the disk source over --data_dir
CIFAR_DISK_ARGV = [a for a in CIFAR_ARGV if a != "--synthetic"]
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


def attn_phase(torch, dev, dtype=None):
    """Kernel H at the ViT-B/16 token engine's two shapes of the 0.12
    radius (2 images; T+1 = 197 tokens, 12 heads of 64;
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
    for name, (_, kind, c) in zip(("masked_kv_attn" + tag,
                                   "masked_kv_attn" + tag + "_pairs"),
                                  attn_bench.SHAPES):
        args32 = attn_bench.engine_case(torch, dev, kind, c, rng)
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


def main_path(torch, dev, label, argv, required, shares=None,
              audit_fill=None, trained=False):
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
    both. Returns (metrics, launch and route counts of the run, the first
    batch's certification records: per image, one per radius)."""
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
        records = ArtifactStore(results_path(cfg)).load_pc_records(0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} main path: {wall:.2f} s wall; attack seconds "
          f"{m.get('attack_seconds')}; certify seconds "
          f"{m.get('certify_seconds')}; forwards {m.get('forwards')} of "
          f"{m.get('forwards_exhaustive')} exhaustive, forward equivalents "
          f"{m.get('forward_equivalents')}, escalated (image, radius) "
          f"records {m.get('escalated')}; certification schedule over the "
          f"radii: {sched['pair_audits']} pair audits (images), "
          f"{sched['rows']} minority rows; peak device memory {peak:.2f} "
          f"GiB; launches {counts}; routes and shape classes {routes}",
          flush=True)
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


def fill_phase_bf16(torch, dev, b, size, suffix=""):
    """Kernel A's bf16 form (the bf16 bank's fill) at one path's image
    shape: exact against its plain version at the bank's phase-1 chunk
    (S = 36) and pair-audit chunk (S = 63), timed at S = 63."""
    from dorpatch_tpu_torch import masks as masks_lib
    from dorpatch_tpu_torch.fill_bench import fill_inputs
    from dorpatch_tpu_torch.ops import masked_fill as mf

    fill = 0.5
    for s in (36, 63):
        imgs, rects, _ = fill_inputs(torch, dev, b, size, s, seed=s)
        imgs = imgs.bfloat16()
        got = mf.masked_fill_fwd_kernel(imgs, rects, fill)
        want = mf.masked_fill_reference(imgs, rects, fill)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.equal(got, want):
            raise AssertionError(f"kernel A (bf16) differs from its plain "
                                 f"version at [B={b},S={s},{size}px]")
    err = float((got.float() - want.float()).abs().max())
    del got, want
    keep = masks_lib.rasterize(rects, size)[None, :, :, :, None]
    s, k = rects.shape[0], rects.shape[1]
    hwc = size * size * 3
    ms = _device_ms(lambda: mf.masked_fill_fwd_kernel(imgs, rects, fill))
    plain = _device_ms(lambda: mf.masked_fill_reference(imgs, rects, fill))
    lib = _device_ms(lambda: torch.where(keep, imgs[:, None], fill))
    bound, by = _bound(2 * b * hwc + 16 * s * k + 2 * b * s * hwc, 0.0)
    plan = mf.fwd_plan(b, s, size, size, 3, True, 2)
    print(f"kernel A bf16 masked_fill_fwd [B={b},S={s},K={k},{size}x{size}x3]"
          f" ({plan}): exact at S=36 and 63, {ms * 1e3:.2f} us (plain "
          f"{plain * 1e3:.2f} us, torch.where on a rasterized keep-mask "
          f"{lib * 1e3:.2f} us; bound {bound * 1e3:.2f} us by {by}, "
          f"{bound / ms:.0%} of it)", flush=True)
    del imgs, keep
    torch.cuda.empty_cache()
    return dict(name="masked_fill_fwd_bf16" + suffix, route="cuda",
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
    images evaluated, kernels A, B and C launched. Left out, and said so,
    where Pillow is not installed."""
    import importlib.util

    if importlib.util.find_spec("PIL") is None:
        print("CIFAR disk main path: left out, Pillow (PIL) is not "
              "installed on this machine", flush=True)
        return
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root:
        write_cifar_disk(torch, dev, root)
        m, _, _ = main_path(torch, dev, "CIFAR disk",
                            CIFAR_DISK_ARGV + ["--data_dir", root],
                            CIFAR_KERNELS)
    if m["evaluated_images"] != 8 or m["clean_accuracy"] != 100.0:
        raise AssertionError(f"CIFAR disk main path evaluated "
                             f"{m['evaluated_images']} of 8 images: {m}")
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


def main() -> int:
    import torch

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
    for dtype in ("float32", "bfloat16"):
        repeat_check(torch, dev, compute_dtype=dtype)
    print(f"repeat phase: {time.perf_counter() - t0:.1f} s", flush=True)

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

    print(f"chip_smoke total: {time.perf_counter() - start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": cifar_kernels + rn50_kernels + vit_kernels
                      + cifar_bf16 + rn50_bf16 + vit_bf16 + rn50_480
                      + rn50_480_bf16 + np2_kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
