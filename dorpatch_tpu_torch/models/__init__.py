"""Victim models: the CIFAR ResNet-18, ResNetV2-50x1 BiT and the victim
factory."""

from dorpatch_tpu_torch.models.registry import Victim, get_model

__all__ = ["Victim", "get_model"]
