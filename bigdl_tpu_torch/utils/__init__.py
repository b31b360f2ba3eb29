"""Host-side utilities of the port."""

from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["T", "Table"]
