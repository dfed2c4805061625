"""Two CPU training runs of each trainable family from one seed are bit
for bit equal (`dorpatch_tpu_torch.train.train_victim`, the tiny run of
`tests/test_torch_train.py`).

The two runs of each family take minutes on a loaded machine, so they
have a file of their own: `pytest --dist loadfile` then runs them on
another worker than the rest of the training tests."""

import pytest
import torch

from dorpatch_tpu_torch import train as ttrain

#: a tiny run of either family: 10 steps of 24 images, 20 held-out images
#: (the TINY run of tests/test_torch_train.py)
TINY = dict(n_per_class_train=24, n_per_class_test=2, epochs=1,
            batch_size=24, warmup_steps=2, seed=1)


@pytest.mark.parametrize("arch", ["cifar_resnet18", "cifar_vit"])
def test_two_cpu_runs_repeat_bit_for_bit(arch):
    cfg = ttrain.TrainConfig(arch=arch, **TINY)
    runs = [ttrain.train_victim(cfg, device="cpu", log=lambda *a: None)
            for _ in range(2)]
    (m1, r1), (m2, r2) = runs
    assert r1["steps"] == 10 and r1["n_train"] == 240 and r1["n_test"] == 20
    assert r1["backend"] == "cpu"
    for k in ("test_acc", "train_acc", "steps"):
        assert r1[k] == r2[k], k
    for (k1, v1), (k2, v2) in zip(m1.state_dict().items(),
                                  m2.state_dict().items()):
        assert k1 == k2 and torch.equal(v1, v2), k1
