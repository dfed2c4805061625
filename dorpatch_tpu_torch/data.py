"""Input data: the shape-bucket math and the generated image streams.

- `batch_buckets`, `bucket_batch`, `bucket_plan`, `pad_to_bucket`: the fixed
  batch-size ladder the certification worklists dispatch through.
- `synthetic_batches`: smooth random images with random labels, the same
  images as `dorpatch_tpu.data.synthetic_batches` for the same seed. The
  resize is PIL's bilinear filter reimplemented in numpy (PIL is not a
  dependency of the port).
- `procedural_arrays` / `procedural_batches`: the learnable generated task
  with genuine labels.
- `training_arrays`: a whole split for victim training (`train.py`), from
  the procedural task or the CIFAR pickle batches.
- the disk source: `_load_cifar` (the CIFAR-10/100 pickle batches),
  `_imagenet_val_entries` (an ImageNet-style `val/<class>/<image>` tree) and
  the eval transform `_pil_resize_center_crop`, the JAX package's loaders.
  They need Pillow, imported when the disk source is read, never when this
  module is imported; without it the disk source raises an `ImportError`.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from dorpatch_tpu_torch.config import NUM_CLASSES


def batch_buckets(max_batch: int) -> Tuple[int, ...]:
    """Fixed batch-size buckets up to `max_batch`: 1, 8, 32, 128, ... (x4
    past 8), e.g. 32 -> (1, 8, 32)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = {1, int(max_batch)}
    b = 8
    while b < max_batch:
        out.add(b)
        b *= 4
    return tuple(sorted(out))


def bucket_batch(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n."""
    for b in sorted(buckets):
        if b >= n:
            return int(b)
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{max(buckets)} (buckets {tuple(sorted(buckets))})")


def bucket_plan(n: int, buckets: Sequence[int]):
    """Greedy cover of `n` items by bucket-shaped calls:
    `[(offset, count, bucket), ...]`, full buckets largest-first, then one
    padded tail (a single padded call wins slot ties)."""
    bs = sorted(int(b) for b in buckets)
    plan = []
    pos = 0
    while n - pos >= bs[-1]:
        plan.append((pos, bs[-1], bs[-1]))
        pos += bs[-1]
    rem = n - pos
    if not rem:
        return plan
    greedy, gpos, grem = [], pos, rem
    while grem:
        full = [b for b in bs if b <= grem and b > bs[0]]
        if full:
            b = max(full)
            greedy.append((gpos, b, b))
            gpos, grem = gpos + b, grem - b
        else:
            greedy.append((gpos, grem, bucket_batch(grem, bs)))
            grem = 0
    single_bucket = bucket_batch(rem, bs)
    if single_bucket <= sum(b for _, _, b in greedy):
        plan.append((pos, rem, single_bucket))
    else:
        plan.extend(greedy)
    return plan


def pad_to_bucket(arr: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad axis 0 up to `bucket` rows by repeating the first row."""
    n = int(arr.shape[0])
    if n >= bucket:
        return arr
    fill = arr[:1].expand((bucket - n,) + tuple(arr.shape[1:]))
    return torch.cat([arr, fill], dim=0)


# ------------------------------------------------ PIL-exact bilinear resize

_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """`[out, in]` int64 fixed-point weights of PIL's bilinear resampling
    (`precompute_coeffs` + `normalize_coeffs_8bpc` of libImaging/Resample.c,
    box = the whole input)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    mat = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        total = sum(ws)
        for x, w in enumerate(ws):
            if total != 0.0:
                w /= total
            k = w * (1 << _PRECISION_BITS)
            mat[xx, x + xmin] = int(k - 0.5) if w < 0 else int(k + 0.5)
    return mat


def _resample_axis(img: np.ndarray, mat: np.ndarray, axis: int) -> np.ndarray:
    acc = np.tensordot(img.astype(np.int64), mat, axes=([axis], [1]))
    acc = np.moveaxis(acc, -1, axis) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_bilinear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 `[h, w, C]` -> `[out_h, out_w, C]`, bit-identical to
    `PIL.Image.resize((out_w, out_h), Image.BILINEAR)` (horizontal pass
    first, uint8 between the passes)."""
    h, w = img.shape[:2]
    if out_w != w:
        img = _resample_axis(img, _bilinear_coeffs(w, out_w), 1)
    if out_h != h:
        img = _resample_axis(img, _bilinear_coeffs(h, out_h), 0)
    return img


def _resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of the short side to size/0.875, center crop, [0,1]."""
    resize_to = int(size / 0.875)
    h, w = img.shape[:2]
    scale = resize_to / min(w, h)
    img = _resize_bilinear(img, max(1, round(w * scale)),
                           max(1, round(h * scale)))
    h, w = img.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    img = img[top:top + size, left:left + size]
    return np.asarray(img, dtype=np.float32) / 255.0


def synthetic_batches(dataset: str, batch_size: int, img_size: int,
                      seed: int = 1234) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic synthetic stream: smooth random images (so TV losses
    see structure) with random labels."""
    rng = np.random.default_rng(seed)
    n_classes = NUM_CLASSES[dataset]
    while True:
        low = rng.uniform(0, 1, (batch_size, 8, 8, 3)).astype(np.float32)
        imgs = np.stack([_resize_center_crop((lo * 255).astype(np.uint8),
                                             img_size) for lo in low])
        labels = rng.integers(0, n_classes, batch_size)
        yield imgs, labels.astype(np.int64)


def procedural_arrays(dataset: str, n_per_class: int, img_size: int = 32,
                      seed: int = 1234, split: str = "train"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Procedurally generated labeled images (NHWC [0,1], int64): class =
    (orientation bucket x {linear, radial}) of a sinusoidal grating with
    random phase, frequency, center, colors, background gradient and
    noise. Splits draw from disjoint seed streams."""
    n_classes = NUM_CLASSES[dataset]
    if n_classes > 20:
        raise ValueError(
            f"procedural task supports <= 20 classes, got {n_classes} "
            f"({dataset!r}); use dataset='cifar10'")
    n_orient = (n_classes + 1) // 2
    rng = np.random.default_rng([seed, {"train": 0, "test": 1}[split]])
    n = n_classes * n_per_class
    labels = np.repeat(np.arange(n_classes), n_per_class).astype(np.int64)
    rng.shuffle(labels)
    u, v = np.meshgrid(np.linspace(0.0, 1.0, img_size, dtype=np.float32),
                       np.linspace(0.0, 1.0, img_size, dtype=np.float32),
                       indexing="xy")
    imgs = np.empty((n, img_size, img_size, 3), np.float32)
    for i0 in range(0, n, 512):
        lab = labels[i0:i0 + 512]
        m = lab.shape[0]
        theta = (lab % n_orient) * (np.pi / n_orient) + rng.normal(0.0, 0.06, m)
        ct, st = np.cos(theta)[:, None, None], np.sin(theta)[:, None, None]
        radial = (lab >= n_orient)[:, None, None]
        cx = rng.uniform(0.3, 0.7, (m, 1, 1)).astype(np.float32)
        cy = rng.uniform(0.3, 0.7, (m, 1, 1)).astype(np.float32)
        du, dv = u[None] - cx, v[None] - cy
        s_lin = u[None] * ct + v[None] * st
        s_rad = np.sqrt((du * ct + dv * st) ** 2
                        + 3.0 * (-du * st + dv * ct) ** 2)
        s = np.where(radial, s_rad, s_lin)
        freq = rng.uniform(3.5, 6.5, (m, 1, 1))
        phase = rng.uniform(0.0, 2 * math.pi, (m, 1, 1))
        t = np.cos(2 * np.pi * freq * s + phase)[..., None]
        gain = rng.uniform(0.25, 0.45, (m, 1, 1, 3))
        base = rng.uniform(0.35, 0.65, (m, 1, 1, 3))
        w = rng.normal(0.0, 1.0, (m, 2, 1, 1, 1))
        bg = 0.08 * (w[:, 0] * u[None, ..., None] + w[:, 1] * v[None, ..., None])
        out = base + gain * t + bg + rng.normal(0.0, 0.07, t.shape)
        imgs[i0:i0 + 512] = np.clip(out, 0.0, 1.0)
    return imgs, labels


def procedural_batches(dataset: str, batch_size: int, img_size: int,
                       seed: int = 1234, split: str = "test",
                       n_per_class: int = 100
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled batches of the procedural task's held-out split."""
    imgs, labels = procedural_arrays(dataset, n_per_class, img_size, seed,
                                     split)
    order = np.random.default_rng(seed).permutation(len(imgs))
    for i in range(0, len(order), batch_size):
        sel = order[i:i + batch_size]
        yield imgs[sel], labels[sel]


# ------------------------------------------------------------ disk source


def _pil():
    """PIL's `Image` module, or an `ImportError` that says what needs it."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(
            "the disk data source needs Pillow (PIL) to decode and resize "
            "images; install Pillow or use --synthetic / --data-source "
            "procedural") from err
    return Image


def _pil_resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """PIL bilinear resize of the short side to size/0.875, center crop,
    [0,1] float32: the disk source's eval transform."""
    image = _pil()
    resize_to = int(size / 0.875)
    pil = image.fromarray(img)
    w, h = pil.size
    scale = resize_to / min(w, h)
    pil = pil.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                     image.BILINEAR)
    w, h = pil.size
    left, top = (w - size) // 2, (h - size) // 2
    pil = pil.crop((left, top, left + size, top + size))
    return np.asarray(pil, dtype=np.float32) / 255.0


def _load_cifar(data_dir: str, name: str, split: str = "test"):
    """uint8 NHWC images and int64 labels from the standard pickle batches:
    `<data_dir>/cifar10/cifar-10-batches-py/{test_batch,data_batch_1..5}`
    or `<data_dir>/cifar100/cifar-100-python/{test,train}`. Missing
    cifar10 train batches are skipped (at least one must exist)."""
    if name == "cifar10":
        base = os.path.join(data_dir, name, "cifar-10-batches-py")
        if split == "train":
            paths = [p for i in range(1, 6) if os.path.exists(
                p := os.path.join(base, f"data_batch_{i}"))]
            if not paths:
                raise FileNotFoundError(f"no data_batch_* under {base}")
        else:
            paths = [os.path.join(base, "test_batch")]
        label_key = b"labels"
    else:
        base = os.path.join(data_dir, name, "cifar-100-python")
        paths = [os.path.join(base, "train" if split == "train" else "test")]
        label_key = b"fine_labels"
    imgs, labels = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(d[label_key])
    return np.concatenate(imgs), np.asarray(labels, np.int64)


def _imagenet_val_entries(data_dir: str):
    """`[(path, class index)]` of `<data_dir>/imagenet/val/<class>/<file>`,
    classes and files in sorted order."""
    root = os.path.join(data_dir, "imagenet", "val")
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    entries = []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            entries.append((os.path.join(cdir, fname), ci))
    return entries


def disk_batches(dataset: str, data_dir: str, batch_size: int,
                 img_size: int = 224, seed: int = 1234
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled eval-split batches from `data_dir` (the test split of
    CIFAR, ImageNet's val folder), NHWC float32 in [0,1]: the order is
    `default_rng(seed).permutation`, each image resized and center-cropped
    by `_pil_resize_center_crop`."""
    image = _pil()
    rng = np.random.default_rng(seed)
    if dataset in ("cifar10", "cifar100"):
        imgs, labels = _load_cifar(data_dir, dataset)
        order = rng.permutation(len(imgs))
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            batch = np.stack([_pil_resize_center_crop(imgs[j], img_size)
                              for j in sel])
            yield batch, labels[sel]
    elif dataset == "imagenet":
        entries = _imagenet_val_entries(data_dir)
        order = rng.permutation(len(entries))
        for i in range(0, len(order), batch_size):
            batch, labs = [], []
            for j in order[i:i + batch_size]:
                path, lab = entries[j]
                img = np.asarray(image.open(path).convert("RGB"))
                batch.append(_pil_resize_center_crop(img, img_size))
                labs.append(lab)
            yield np.stack(batch), np.asarray(labs, np.int64)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")


def training_arrays(dataset: str, source: str, data_dir: str = "data/",
                    n_per_class: int = 1500, img_size: int = 32,
                    seed: int = 1234, split: str = "train"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-split arrays for victim training: NHWC float32 [0,1] and
    int64. source="procedural" generates the labeled task; source="disk"
    loads the CIFAR pickle batches (`_load_cifar`; the train split is
    `data_batch_1..5` / `train`) at their native 32 px, with no resize or
    crop (no Pillow needed)."""
    if source == "procedural":
        return procedural_arrays(dataset, n_per_class, img_size, seed, split)
    if source == "disk":
        if dataset not in ("cifar10", "cifar100"):
            raise ValueError(
                f"disk training data supports cifar only, got {dataset!r}")
        if img_size != 32:
            raise ValueError("disk cifar training is native-32px only")
        imgs, labels = _load_cifar(data_dir, dataset, split)
        return imgs.astype(np.float32) / 255.0, labels
    raise ValueError(f"unknown training data source {source!r}")


def dataset_batches(dataset: str, batch_size: int, img_size: int = 224,
                    seed: int = 1234, source: str = "synthetic",
                    data_dir: str = "/home/data/data"
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The evaluation stream: "disk" (`disk_batches` over `data_dir`),
    "synthetic" or "procedural"."""
    if source == "synthetic":
        return synthetic_batches(dataset, batch_size, img_size, seed)
    if source == "procedural":
        return procedural_batches(dataset, batch_size, img_size, seed,
                                  split="test")
    if source == "disk":
        _pil()
        return disk_batches(dataset, data_dir, batch_size, img_size, seed)
    raise ValueError(f"unknown data source {source!r}")
