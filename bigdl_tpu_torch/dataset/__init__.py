"""Host-side data feed of the port: in-memory datasets and batching."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalArrayDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.transformer import (MiniBatch, Sample,
                                                 SampleToBatch, Transformer)

__all__ = ["AbstractDataSet", "DataSet", "LocalArrayDataSet",
           "MiniBatch", "Sample", "SampleToBatch", "TransformedDataSet",
           "Transformer"]
