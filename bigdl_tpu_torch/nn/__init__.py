"""The layers and criterions of the port, under the reference names."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU, Tanh
from bigdl_tpu_torch.nn.containers import Concat, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import SpatialCrossMapLRN
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.shape_ops import Reshape, View

__all__ = ["ClassNLLCriterion", "Concat", "Dropout", "Linear", "LogSoftMax",
           "ReLU", "Reshape", "Sequential", "SpatialAveragePooling",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling",
           "Tanh", "View"]
