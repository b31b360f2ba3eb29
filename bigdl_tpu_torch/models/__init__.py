"""Model builders of the port's first slice."""

from bigdl_tpu_torch.models.inception import Inception_v1, inception_module
from bigdl_tpu_torch.models.lenet import LeNet5

__all__ = ["Inception_v1", "LeNet5", "inception_module"]
