"""The port's checkpoint verifier (`python -m
dorpatch_tpu_torch.models.verify`) and its copy of the timm key contract:
the contract equals `dorpatch_tpu.models.timm_keys`'s, every port victim's
state_dict meets it, and the CLI passes on a `.pth` of the port's export
and fails on the wrong arch, as in `tests/test_verify.py`."""

import pytest
import torch

from dorpatch_tpu.models import timm_keys as jtimm_keys
from dorpatch_tpu_torch.models import registry, timm_keys, verify
from dorpatch_tpu_torch.train import save_victim_checkpoint

CONTRACTS = ("resnetv2_50x1_bit_distilled", "vit_base_patch16_224",
             "resmlp_24_distilled_224", "cifar_resnet18", "cifar_vit")


@pytest.mark.parametrize("num_classes", [10, 100, 1000])
@pytest.mark.parametrize("name", CONTRACTS)
def test_contract_equals_jax(name, num_classes):
    got = timm_keys.state_dict_contract(name, num_classes)
    want = jtimm_keys.state_dict_contract(name, num_classes)
    assert list(got.items()) == list(want.items())


def test_contract_refuses_unknown_arch_and_reports_drift():
    with pytest.raises(KeyError, match="no vendored key contract"):
        timm_keys.state_dict_contract("cifar_resmlp", 10)
    sd = dict(timm_keys.cifar_resnet18_keys(10))
    sd.pop("head.bias")
    sd["head.weight"] = (10, 7)
    sd["extra"] = (1,)
    report = timm_keys.diff_against_contract(sd, "cifar_resnet18", 10,
                                             sd_shapes=sd)
    assert report == jtimm_keys.diff_against_contract(
        sd, "cifar_resnet18", 10, sd_shapes=sd)
    assert report["missing"] == ["head.bias"]
    assert report["unexpected"] == ["extra"]
    assert len(report["shape_drift"]) == 1


@pytest.mark.parametrize("name,dataset,img_size", [
    ("resnetv2_50x1_bit_distilled", "imagenet", 224),
    ("vit_base_patch16_224", "imagenet", 224),
    ("resmlp_24_distilled_224", "imagenet", 224),
    ("cifar_resnet18", "cifar10", 32),
    ("cifar_vit", "cifar10", 32)])
def test_port_victims_meet_the_contract(name, dataset, img_size):
    """Keys and shapes of each victim's state_dict, built on the meta
    device (no memory, no init)."""
    build, _ = registry._FAMILIES[name]
    k = registry.NUM_CLASSES[dataset]
    with torch.device("meta"):
        model = (build(k, img_size) if name in registry.SIZED_FAMILIES
                 else build(k))
    sd = model.state_dict()
    report = timm_keys.diff_against_contract(
        sd.keys(), name, k, sd_shapes={n: v.shape for n, v in sd.items()})
    assert report == {"missing": [], "unexpected": [], "shape_drift": []}


@pytest.fixture(scope="module")
def cifar_ckpt(tmp_path_factory):
    model = registry.build_bare_model("cifar_resnet18", 10, 32, seed=4)
    return save_victim_checkpoint(model, str(tmp_path_factory.mktemp("v")))


def test_verify_cli_passes_on_the_port_export(cifar_ckpt, capsys):
    """Arch and dataset inferred from the export's file name; on the CPU
    the check stops at keys and shapes."""
    assert verify.main([cifar_ckpt, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[OK]" in out and "cifar_resnet18" in out and "cifar10" in out
    assert verify.main([cifar_ckpt, "--keys-only"]) == 0
    report = verify.verify_checkpoint(cifar_ckpt, "resnet18", "cifar10",
                                      img_size=32, device="cpu")
    assert report["n_params"] == len(timm_keys.cifar_resnet18_keys(10))


def test_verify_fails_on_wrong_arch(cifar_ckpt, capsys):
    """A checkpoint whose keys do not meet the arch's contract fails
    loudly, never a partial load."""
    assert verify.main([cifar_ckpt, "--arch", "cifar_vit", "--device",
                        "cpu"]) == 1
    assert verify.main([cifar_ckpt, "--arch", "cifar_vit",
                        "--keys-only"]) == 1
    with pytest.raises(KeyError):
        verify.verify_checkpoint(cifar_ckpt, "cifar_vit", "cifar10",
                                 img_size=32, device="cpu")
    assert "[FAIL]" in capsys.readouterr().out


def test_verify_rejects_bogus_keys(tmp_path):
    path = tmp_path / "resnetv2_50x1_bit_distilled_cutout2_128_imagenet.pth"
    torch.save({"state_dict": {"bogus.weight": torch.zeros(3)}}, path)
    with pytest.raises(KeyError):
        verify.verify_checkpoint(str(path), "resnetv2", "imagenet", batch=1,
                                 img_size=32, device="cpu")


def test_verify_cli_missing_file():
    assert verify.main(["/nonexistent/ckpt.pth"]) == 2


def test_verify_card_check_needs_a_card(cifar_ckpt):
    """The logit comparison runs on the card: without one the default
    device raises, as every entry point does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests run this")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify.verify_checkpoint(cifar_ckpt, "resnet18", "cifar10",
                                 img_size=32)


def test_infer_helpers():
    assert verify._infer_arch(
        "x/vit_base_patch16_224_cutout2_128_cifar10.pth") == "vit"
    assert verify._infer_arch(
        "x/cifar_vit_cutout2_128_cifar10.pth") == "cifar_vit"
    assert verify._infer_dataset(
        "vit_base_patch16_224_cutout2_128_cifar100.pth") == "cifar100"
    assert verify._infer_dataset(
        "resmlp_24_distilled_224_imagenet.pth") == "imagenet"
