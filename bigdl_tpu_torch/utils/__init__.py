"""Host-side utilities of the port."""

from bigdl_tpu_torch.utils.file import File, load_model_snapshot
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["File", "T", "Table", "load_model_snapshot"]
