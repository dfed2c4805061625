"""Two-group masked-KV attention, the token-pruned ViT engine's inner loop.

For each (image, mask entry), the S dirty tokens' queries attend to the
image's clean key/value cache (with an additive -1e9 on the stale rows at
the dirty positions) and to the entry's S freshly projected keys/values
(with -1e9 on duplicate padding slots), through one max-stabilized softmax
over both groups. On the card a hand-written kernel (`csrc/masked_kv_attn.cu`,
kernel H of the JAX package: 3xTF32 tensor-core products and an online
softmax) does it without writing logits or probabilities to memory;
`masked_kv_attention_reference` is the plain version, which a CPU tensor
takes. Port of `dorpatch_tpu.ops.masked_kv_attn`
for float32 (bf16 comes with the bf16 bank).
"""

from __future__ import annotations

import torch

from dorpatch_tpu_torch.ops import _backend, _build

#: head widths the kernel is built for (ViT-B/16: 64, `cifar_vit`: 32)
HEAD_DIMS = (32, 64)


def masked_kv_attention_reference(q, kd, vd, kc, vc, clean_bias, dirty_bias):
    """The einsum composition the kernel replaces (q pre-scaled):
    `q/kd/vd [B, C, S, H, f]`, `kc/vc [B, T, H, f]`, `clean_bias [B, C, T]`,
    `dirty_bias [B, C, S]` -> `[B, C, S, H, f]`."""
    t = kc.shape[1]
    wc = torch.einsum("bcshf,bthf->bchst", q, kc) \
        + clean_bias[:, :, None, None, :]
    wd = torch.einsum("bcshf,bcthf->bchst", q, kd) \
        + dirty_bias[:, :, None, None, :]
    w = torch.softmax(torch.cat([wc, wd], dim=-1), dim=-1)
    return torch.einsum("bchst,bthf->bcshf", w[..., :t], vc) \
        + torch.einsum("bchst,bcthf->bcshf", w[..., t:], vd)


def masked_kv_attention_kernel(q, kd, vd, kc, vc, clean_bias, dirty_bias):
    """Kernel H on CUDA tensors (float32, contiguous, the shapes of
    `masked_kv_attention_reference`)."""
    args = dict(q=q, kd=kd, vd=vd, kc=kc, vc=vc, clean_bias=clean_bias,
                dirty_bias=dirty_bias)
    for name, t in args.items():
        _backend.require(t, name, torch.float32,
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
        raise ValueError("kernel H copies the clean K/V 16 bytes at a time "
                         "and reads q, kd and vd 8 bytes at a time: q, kd, "
                         "vd, kc and vc must be 16-byte aligned")
    lib = _build.library()
    out = torch.empty_like(q)
    _backend.count_launch("masked_kv_attn")
    _build.check(lib.dp_masked_kv_attn(
        q.data_ptr(), kd.data_ptr(), vd.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), clean_bias.data_ptr(), dirty_bias.data_ptr(),
        out.data_ptr(), b, c, s, h, f, t, _backend.stream_handle(q)),
        "masked_kv_attn")
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
