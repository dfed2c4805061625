"""Two-group masked-KV attention, the token-pruned ViT engine's inner loop.

For each (image, mask entry), the S dirty tokens' queries attend to the
image's clean key/value cache (with an additive -1e9 on the stale rows at
the dirty positions) and to the entry's S freshly projected keys/values
(with -1e9 on duplicate padding slots), through one max-stabilized softmax
over both groups. On the card a hand-written kernel (`csrc/masked_kv_attn.cu`,
kernel H of the JAX package: 3xTF32 tensor-core products and an online
softmax) does it without writing logits or probabilities to memory;
`masked_kv_attention_reference` is the plain version, which a CPU tensor
takes. Port of `dorpatch_tpu.ops.masked_kv_attn`.

bf16 operands (the bf16 certify bank's token engine) take kernel H's bf16
form: one bf16 tensor-core product per tile with float32 accumulation, the
softmax in float32, the weights rounded to bf16 for the weighted sum, the
output in bf16. It stages the clean group (where it fits) and, a phase of
entries at a time, the dirty groups in shared memory; `bf16_plan` sizes
the blocks and phases. The plain version computes in float32 from the bf16 values and
rounds the output once, as the JAX kernel does.

Each launch counts under its kernel and under its shape class
`f"S{S}"` (`ops.route_counts()`): the dirty rows per entry, which tell the
token engine's phase-1 chunks from its pair audits and second-round rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from dorpatch_tpu_torch.ops import _backend, _build

#: head widths the kernel is built for (ViT-B/16: 64, `cifar_vit`: 32)
HEAD_DIMS = (32, 64)
#: the bf16 form (`csrc/masked_kv_attn.cu`): warps of a block at most
#: (kWarps), query rows of a work item (kRows), dirty slots of a block
#: (kMaxSlotPhases), and blocks an SM at most (its launch bounds)
MAX_WARPS = 8
ITEM_ROWS = 16
MAX_SLOTS = 2
BF16_BLOCKS_PER_SM = 2
#: shared memory of an SM, 1 KB of it reserved per block
SM_SMEM_BYTES = 233472


class Bf16Plan(NamedTuple):
    """How the bf16 form runs one shape: `entries` mask entries a block,
    staged `per_phase` at a time, `warps` warps a block, the clean group
    staged in shared memory (`clean` 1) or read from device memory (0),
    `smem` bytes of dynamic shared memory."""
    entries: int
    per_phase: int
    warps: int
    clean: int
    smem: int


def bf16_smem(t: int, s: int, f: int, per_phase: int, slots: int,
              clean: int = 1) -> int:
    """The bf16 form's shared-memory carve (`dp_masked_kv_attn_bf16_smem`):
    the clean K and V `[T, f]` where `clean`, and `slots` dirty slots, each
    the K and V `[S, f]` of `per_phase` entries, all bf16; and per slot the
    entries' float32 clean and dirty biases, each padded to whole 32-key
    steps."""
    def padded(n):
        return -(-n // 32) * 32

    return (2 * f * (2 * t * clean + 2 * slots * per_phase * s)
            + 4 * slots * per_phase * (padded(t) + padded(s)))


def bf16_plan(b: int, c: int, s: int, h: int, t: int, f: int,
              sms: int) -> Bf16Plan:
    """The bf16 form's blocks for `[B, C, S, H, f]` queries and `T` clean
    keys on a card of `sms` SMs. A phase takes as many entries as give
    each warp one 16-row item (8 // ceil(S/16), at least 1); a block G
    entries, the G of the fewest waves x (phases + 1), the block's serial
    work with the clean group's staging counted as one phase (ties: the
    smaller G), with two blocks an SM where their shared memory fits. A
    clean group that fits no block with one entry's dirty group is read
    from device memory; a shape whose dirty group alone does not fit
    raises."""
    tiles = -(-s // ITEM_ROWS)
    per = max(1, MAX_WARPS // tiles)
    for clean in (1, 0):
        best = None
        for g in range(1, c + 1):
            e = min(per, g)
            phases = -(-g // e)
            smem = bf16_smem(t, s, f, e, min(MAX_SLOTS, phases), clean)
            if smem > _build.MAX_SMEM_BYTES:
                continue
            per_sm = max(1, min(BF16_BLOCKS_PER_SM,
                                SM_SMEM_BYTES // (smem + 1024)))
            blocks = -(-c // g) * b * h
            waves = -(-blocks // (sms * per_sm))
            cost = waves * (phases + 1)
            if best is None or cost < best[0]:
                best = (cost, Bf16Plan(g, e, min(MAX_WARPS, e * tiles),
                                       clean, smem))
        if best is not None:
            return best[1]
    raise ValueError(f"kernel H's bf16 form stages S={s} dirty rows of "
                     f"{f} bf16 in shared memory: "
                     f"{bf16_smem(t, s, f, 1, 1, 0)} bytes exceed a "
                     f"block's {_build.MAX_SMEM_BYTES}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def masked_kv_attention_reference(q, kd, vd, kc, vc, clean_bias, dirty_bias):
    """The einsum composition the kernel replaces (q pre-scaled):
    `q/kd/vd [B, C, S, H, f]`, `kc/vc [B, T, H, f]`, `clean_bias [B, C, T]`,
    `dirty_bias [B, C, S]` -> `[B, C, S, H, f]`. Inputs narrower than
    float32 are computed in float32 and the output rounded to their type."""
    dt = q.dtype
    acc = torch.promote_types(dt, torch.float32)
    q, kd, vd, kc, vc, clean_bias, dirty_bias = (
        x.to(acc) for x in (q, kd, vd, kc, vc, clean_bias, dirty_bias))
    t = kc.shape[1]
    wc = torch.einsum("bcshf,bthf->bchst", q, kc) \
        + clean_bias[:, :, None, None, :]
    wd = torch.einsum("bcshf,bcthf->bchst", q, kd) \
        + dirty_bias[:, :, None, None, :]
    w = torch.softmax(torch.cat([wc, wd], dim=-1), dim=-1)
    return (torch.einsum("bchst,bthf->bcshf", w[..., :t], vc)
            + torch.einsum("bchst,bcthf->bcshf", w[..., t:], vd)).to(dt)


def masked_kv_attention_kernel(q, kd, vd, kc, vc, clean_bias, dirty_bias,
                               plan: Optional[Bf16Plan] = None):
    """Kernel H on CUDA tensors (all float32, or all bf16 for its bf16
    form; contiguous, the shapes of `masked_kv_attention_reference`).
    `plan` (bf16 only) defaults to `bf16_plan`'s; another is for measuring
    other blocks."""
    args = dict(q=q, kd=kd, vd=vd, kc=kc, vc=vc, clean_bias=clean_bias,
                dirty_bias=dirty_bias)
    bf16 = q.dtype == torch.bfloat16
    for name, t in args.items():
        _backend.require(t, name, torch.bfloat16 if bf16 else torch.float32,
                         {"kc": 4, "vc": 4, "clean_bias": 3,
                          "dirty_bias": 3}.get(name, 5))
    b, c, s, h, f = q.shape
    t = kc.shape[1]
    if (tuple(kd.shape) != tuple(q.shape) or tuple(vd.shape) != tuple(q.shape)
            or tuple(kc.shape) != (b, t, h, f)
            or tuple(vc.shape) != (b, t, h, f)
            or tuple(clean_bias.shape) != (b, c, t)
            or tuple(dirty_bias.shape) != (b, c, s)
            or any(x.device != q.device for x in args.values())):
        raise ValueError("masked-KV attention shapes do not agree: "
                         + ", ".join(f"{k} {tuple(v.shape)}"
                                     for k, v in args.items()))
    if f not in HEAD_DIMS:
        raise ValueError(f"head width {f} not built (kernel H takes "
                         f"{HEAD_DIMS})")
    if any(x.data_ptr() % 16 for x in (q, kd, vd, kc, vc)):
        raise ValueError("kernel H copies K/V 16 bytes at a time and reads "
                         "q 4 to 8 bytes at a time: q, kd, vd, kc and vc "
                         "must be 16-byte aligned")
    ptrs = [a.data_ptr() for a in (q, kd, vd, kc, vc, clean_bias,
                                    dirty_bias)]
    lib = _build.library()
    out = torch.empty_like(q)
    name = "masked_kv_attn_bf16" if bf16 else "masked_kv_attn"
    stream = _backend.stream_handle(q)
    if bf16:
        plan = plan or bf16_plan(b, c, s, h, t, f,
                                 _sm_count(q.device.index or 0))
    _backend.count_launch(name, f"S{s}")
    if bf16:
        status = lib.dp_masked_kv_attn_bf16(*ptrs, out.data_ptr(), b, c, s,
                                            h, f, t, *plan, stream)
    else:
        status = lib.dp_masked_kv_attn(*ptrs, out.data_ptr(), b, c, s, h, f,
                                       t, stream)
    _build.check(status, name)
    return out


def masked_kv_attention(q, kd, vd, kc, vc, clean_bias, dirty_bias):
    """The attention read of one token-engine block. CUDA tensors run
    kernel H; CPU tensors run the plain version."""
    if _backend.on_card(q):
        return masked_kv_attention_kernel(
            *(x.contiguous() for x in (q, kd, vd, kc, vc, clean_bias,
                                       dirty_bias)))
    return masked_kv_attention_reference(q, kd, vd, kc, vc, clean_bias,
                                         dirty_bias)
