"""Model builders of the port."""

from bigdl_tpu_torch.models.inception import Inception_v1, inception_module
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.transformer import TransformerBlock, TransformerLM

__all__ = ["Inception_v1", "LeNet5", "TransformerBlock", "TransformerLM",
           "inception_module"]
