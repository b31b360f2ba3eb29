"""Module facade, initialisation, precision and device rules of the port."""

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Container, Criterion, Module

__all__ = ["Container", "Criterion", "Module", "resolve_device"]
