"""The layers and criterions of the port, under the reference names."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU, Tanh, gelu
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, apply_rope
from bigdl_tpu_torch.nn.containers import Concat, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNorm, SpatialCrossMapLRN
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.shape_ops import Reshape, View

__all__ = ["ClassNLLCriterion", "Concat", "Dropout", "LayerNorm", "Linear",
           "LogSoftMax", "MultiHeadAttention", "ReLU", "Reshape",
           "Sequential", "SpatialAveragePooling", "SpatialConvolution",
           "SpatialCrossMapLRN", "SpatialMaxPooling", "Tanh",
           "TimeDistributedCriterion", "View", "apply_rope", "gelu"]
