"""The layers and criterions of the port, under the reference names."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU, Tanh, gelu
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, apply_rope
from bigdl_tpu_torch.nn.containers import (CAddTable, Concat, ConcatTable,
                                           Identity, Sequential)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import (BatchNormalization, LayerNorm,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.shape_ops import Padding, Reshape, View

__all__ = ["BatchNormalization", "CAddTable", "ClassNLLCriterion", "Concat",
           "ConcatTable", "CrossEntropyCriterion", "Dropout", "Identity",
           "LayerNorm", "Linear", "LogSoftMax", "MultiHeadAttention",
           "Padding", "ReLU", "Reshape", "Sequential",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling",
           "Tanh", "TimeDistributedCriterion", "View", "apply_rope", "gelu"]
