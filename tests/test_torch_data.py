"""The port's disk source (`dorpatch_tpu_torch.data`) against
`dorpatch_tpu.data` on the CPU, array-equal, on datasets the tests write
into `tmp_path`: CIFAR-10 and CIFAR-100 pickle batches (test split, and
the train split with a partial set of CIFAR-10 batches) and an
ImageNet-style `val/<class>/<image>` folder of PNG and JPEG files of
several sizes; the stream's order, resize and labels; the Pillow
condition; and `run_experiment` reading CIFAR-10 from disk."""

import os
import pickle
import sys

import numpy as np
import pytest

from dorpatch_tpu import data as jdata
from dorpatch_tpu_torch import data as tdata
from dorpatch_tpu_torch.cli import build_parser, config_from_args
from dorpatch_tpu_torch.config import resolved_data_source


def _write_cifar(root, name, n, seed, files=None):
    """Random uint8 CIFAR pickles under `root/<name>/...`: CIFAR-10's
    `test_batch` and the train `data_batch_<i>` of `files`, or CIFAR-100's
    `test` and `train`. Returns the written directory."""
    rng = np.random.default_rng(seed)
    if name == "cifar10":
        base = os.path.join(root, name, "cifar-10-batches-py")
        parts = ["test_batch"] + [f"data_batch_{i}" for i in (files or ())]
        key, classes = b"labels", 10
    else:
        base = os.path.join(root, name, "cifar-100-python")
        parts, key, classes = ["test", "train"], b"fine_labels", 100
    os.makedirs(base, exist_ok=True)
    for part in parts:
        d = {b"data": rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8),
             key: rng.integers(0, classes, n).tolist()}
        with open(os.path.join(base, part), "wb") as f:
            pickle.dump(d, f)
    return base


def _write_imagenet(root, seed):
    """`root/imagenet/val/<class>/<file>`: 3 classes, 2-3 images each, of
    several sizes and aspect ratios, PNG (one grayscale) and JPEG."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    sizes = [(40, 60), (64, 48), (37, 37), (80, 50), (50, 90), (33, 70),
             (45, 45), (58, 39)]
    k = 0
    for ci, cname in enumerate(["n01", "n02", "n03"]):
        cdir = os.path.join(root, "imagenet", "val", cname)
        os.makedirs(cdir)
        for j in range(2 + (ci == 1)):
            h, w = sizes[k]
            k += 1
            if k == 3:
                img = Image.fromarray(rng.integers(0, 256, (h, w),
                                                   dtype=np.uint8), "L")
            else:
                img = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                                   dtype=np.uint8))
            img.save(os.path.join(cdir, f"img{j}.{'jpg' if j else 'png'}"))
    # a stray file beside the classes is not a class
    with open(os.path.join(root, "imagenet", "val", "README"), "w") as f:
        f.write("not a class")


def _stream(mod, dataset, root, batch, size, seed):
    if mod is jdata:
        it = jdata.dataset_batches(dataset, str(root), batch, size, seed,
                                   source="disk")
    else:
        it = tdata.dataset_batches(dataset, batch, size, seed, source="disk",
                                   data_dir=str(root))
    return list(it)


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == np.float32 and gy.dtype == np.int64
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
@pytest.mark.parametrize("split", ["test", "train"])
def test_load_cifar_equals_jax(tmp_path, name, split):
    """Both splits, array-equal; CIFAR-10's train split from a partial set
    of batches (1 and 3 of 5)."""
    _write_cifar(tmp_path, name, 7, 1, files=(1, 3))
    got = tdata._load_cifar(str(tmp_path), name, split)
    want = jdata._load_cifar(str(tmp_path), name, split)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == ((14 if (name, split) == ("cifar10", "train")
                             else 7), 32, 32, 3)


def test_load_cifar_train_needs_a_batch(tmp_path):
    _write_cifar(tmp_path, "cifar10", 3, 2)
    with pytest.raises(FileNotFoundError, match="data_batch"):
        tdata._load_cifar(str(tmp_path), "cifar10", "train")


@pytest.mark.parametrize("name,size,batch,seed", [("cifar10", 32, 4, 1234),
                                                  ("cifar10", 224, 3, 7),
                                                  ("cifar100", 48, 5, 3)])
def test_cifar_disk_stream_equals_jax(tmp_path, name, size, batch, seed):
    """The shuffled test split through PIL's bilinear resize to
    int(size / 0.875) and center crop, batch for batch, with a ragged
    last batch."""
    _write_cifar(tmp_path, name, 11, seed)
    got = _stream(tdata, name, tmp_path, batch, size, seed)
    _assert_streams_equal(got, _stream(jdata, name, tmp_path, batch, size,
                                       seed))
    assert got[0][0].shape == (batch, size, size, 3)
    assert sum(len(y) for _, y in got) == 11


@pytest.mark.parametrize("size,batch", [(32, 3), (224, 2)])
def test_imagenet_disk_stream_equals_jax(tmp_path, size, batch):
    _write_imagenet(tmp_path, 5)
    entries = tdata._imagenet_val_entries(str(tmp_path))
    assert entries == jdata._imagenet_val_entries(str(tmp_path))
    assert [lab for _, lab in entries] == [0, 0, 1, 1, 1, 2, 2]
    got = _stream(tdata, "imagenet", tmp_path, batch, size, 9)
    _assert_streams_equal(got, _stream(jdata, "imagenet", tmp_path, batch,
                                       size, 9))
    assert got[0][0].shape == (batch, size, size, 3)


def test_disk_source_without_pillow_names_it(tmp_path, monkeypatch):
    """Without Pillow the disk source raises an ImportError naming it, when
    the stream is asked for; there is no fallback."""
    _write_cifar(tmp_path, "cifar10", 3, 4)
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tdata.dataset_batches("cifar10", 2, 32, source="disk",
                              data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="unknown data source"):
        tdata.dataset_batches("cifar10", 2, 32, source="hdf5")


@pytest.fixture()
def one_torch_thread():
    """`run_experiment` runs many small ops: one intra-op thread keeps them
    from contending with the other test processes' threads."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_default_source_is_disk_and_reads_data_dir(tmp_path, monkeypatch,
                                                   one_torch_thread):
    """With neither --synthetic nor --data-source the pipeline reads
    --data_dir: `run_experiment` on a CIFAR-10 test batch written into
    `tmp_path` (its labels the seeded victim's own predictions, so every
    image passes the correctness filter), a shallow ResNet-18 at 16 px."""
    import torch

    from dorpatch_tpu_torch.models import registry
    from dorpatch_tpu_torch.models.small import CifarResNet18
    from dorpatch_tpu_torch.pipeline import run_experiment

    _, init_weights = registry._FAMILIES["cifar_resnet18"]
    monkeypatch.setitem(
        registry._FAMILIES, "cifar_resnet18",
        (lambda n: CifarResNet18(num_classes=n, stage_sizes=(1, 1, 1, 1)),
         init_weights))
    base = _write_cifar(tmp_path / "data", "cifar10", 4, 6)
    args = build_parser().parse_args([
        "--device", "cpu", "--dataset", "cifar10", "--base_arch",
        "resnet18", "--img-size", "16", "-b", "2", "--sampling-size", "4",
        "--dropout", "1", "--max-iterations", "1", "--num-batches", "1",
        "--data_dir", str(tmp_path / "data"),
        "--model_dir", str(tmp_path / "models"),
        "--results-root", str(tmp_path / "results")])
    cfg = config_from_args(args)
    assert resolved_data_source(cfg) == "disk"
    assert cfg.data_dir == str(tmp_path / "data")
    victim = registry.get_model("cifar10", "resnet18", cfg.model_dir, 16,
                                device="cpu")
    imgs, _ = tdata._load_cifar(cfg.data_dir, "cifar10")
    x = np.stack([tdata._pil_resize_center_crop(im, 16) for im in imgs])
    with torch.no_grad():
        preds = victim.apply(torch.as_tensor(x)).argmax(-1).numpy()
    with open(os.path.join(base, "test_batch"), "rb") as f:
        d = pickle.load(f, encoding="bytes")
    d[b"labels"] = preds.tolist()
    with open(os.path.join(base, "test_batch"), "wb") as f:
        pickle.dump(d, f)
    m = run_experiment(cfg, verbose=False)
    assert m["evaluated_images"] == 2
    assert len(m["acc_pc"]) == 4 and m["clean_accuracy"] == 100.0


# ------------------------------------------------ the streaming input path


def _numbered_batches(n, delay=0.0):
    import time

    for i in range(n):
        if delay:
            time.sleep(delay)
        yield (np.full((2, 4, 4, 3), i, np.float32),
               np.full((2,), i, np.int64))


def test_stream_batches_order_preserved():
    """16 batches through the worker thread, with producer jitter: every
    batch arrives, in order."""
    import time

    def jittery():
        for i, item in enumerate(_numbered_batches(16)):
            time.sleep(0.002 if i % 3 else 0.0)
            yield item

    got = [int(y[0]) for _x, y in tdata.stream_batches(jittery(), depth=2)]
    assert got == list(range(16))


def test_stream_batches_propagates_loader_error():
    """A loader crash mid-stream surfaces at the consumer, after the
    batches that preceded it."""
    def broken():
        yield from _numbered_batches(3)
        raise RuntimeError("disk ate the shard")

    seen = []
    with pytest.raises(RuntimeError, match="disk ate the shard"):
        for _x, y in tdata.stream_batches(broken(), depth=2):
            seen.append(int(y[0]))
    assert seen == [0, 1, 2]


def test_stream_batches_clean_shutdown_midstream():
    """Closing the generator after a few batches stops the worker thread
    promptly, although it is blocked on a full queue, and halts the
    underlying producer."""
    import itertools
    import threading
    import time

    produced = []

    def endless():
        for i in itertools.count():
            produced.append(i)
            yield (np.zeros((1, 2, 2, 3), np.float32),
                   np.asarray([i], np.int64))

    gen = tdata.stream_batches(endless(), depth=2)
    for _ in range(3):
        next(gen)
    gen.close()
    alive = [t for t in threading.enumerate()
             if t.name == "dorpatch-data-stream" and t.is_alive()]
    assert not alive
    n = len(produced)
    time.sleep(0.1)
    assert len(produced) == n


def test_prefetch_overlap_and_wait_events(tmp_path):
    """The JAX package's telemetry contract: with depth 2 the
    `data.prefetch` span of batch N+1 is recorded before the consumer
    handles batch N, and every batch taken from the loader thread records
    a `data.stream.wait` event."""
    import json

    import torch

    from dorpatch_tpu_torch import observe

    path = str(tmp_path / "events.jsonl")
    with observe.EventLog(path, run_id="r"):
        for i, (x, y) in enumerate(tdata.prefetch_to_device(
                tdata.stream_batches(_numbered_batches(6), depth=2),
                depth=2, device="cpu")):
            assert isinstance(x, torch.Tensor) and float(x[0, 0, 0, 0]) == i
            assert isinstance(y, np.ndarray)
            observe.record_event("consume", batch=i)
    rows = [json.loads(line) for line in open(path)]
    order = [(r["name"], r.get("batch")) for r in rows
             if (r["kind"] == "span" and r["name"] == "data.prefetch")
             or (r["kind"] == "event" and r["name"] == "consume")]
    for n in range(5):
        assert order.index(("data.prefetch", n + 1)) \
            < order.index(("consume", n)), f"no lookahead at batch {n}"
    assert max(r["ahead"] for r in rows if r.get("name") == "data.prefetch"
               and r["kind"] == "span") >= 1
    waits = [r for r in rows if r.get("name") == "data.stream.wait"]
    assert [w["batch"] for w in waits] == list(range(6))
    assert all(w["wait_s"] >= 0.0 for w in waits)


@pytest.mark.parametrize("source", ["synthetic", "procedural"])
def test_streaming_batches_equal_dataset_batches(source):
    """The composed path yields tensors on the device (the CPU here) equal
    to `dataset_batches`' arrays, and to the JAX package's stream."""
    import itertools

    import torch

    it = tdata.streaming_batches("cifar10", batch_size=4, img_size=32,
                                 source=source, data_dir="", device="cpu")
    got = list(itertools.islice(it, 3))
    it.close()
    want = list(itertools.islice(tdata.dataset_batches(
        "cifar10", 4, 32, source=source), 3))
    jwant = list(itertools.islice(jdata.dataset_batches(
        "cifar10", "", 4, 32, source=source), 3))
    for (x, y), (wx, wy), (jx, jy) in zip(got, want, jwant):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
        assert tuple(x.shape) == (4, 32, 32, 3)
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y, wy)
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(y, jy)


def test_streaming_disk_source_without_pillow_fails_at_the_call(
        tmp_path, monkeypatch):
    """The disk source's Pillow check runs when the stream is made, not
    later on the loader thread."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tdata.streaming_batches("cifar10", 2, 32, source="disk",
                                data_dir=str(tmp_path), device="cpu")
