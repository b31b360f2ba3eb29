"""Module facade, initialisation, precision and device rules of the port."""

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.core.module import Container, Module

__all__ = ["Container", "Module", "resolve_device"]
