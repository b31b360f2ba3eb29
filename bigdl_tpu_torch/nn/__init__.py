"""The layers and criterions of the port, under the reference names."""

from bigdl_tpu_torch.nn.activation import (ELU, Abs, Clamp, Exp,
                                           GradientReversal, HardShrink,
                                           HardTanh, LeakyReLU, Log,
                                           LogSigmoid, LogSoftMax, Power,
                                           PReLU, ReLU, ReLU6, RReLU,
                                           Sigmoid, SoftMax, SoftMin,
                                           SoftPlus, SoftShrink, SoftSign,
                                           Sqrt, Square, Tanh, TanhShrink,
                                           Threshold, gelu)
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, apply_rope
from bigdl_tpu_torch.nn.containers import (CAddTable, Concat, ConcatTable,
                                           Identity, Sequential)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import (Add, AddConstant, Bilinear, CAdd, CMul,
                                       Linear, Mul, MulConstant, Scale)
from bigdl_tpu_torch.nn.normalization import (BatchNormalization, LayerNorm,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.shape_ops import Padding, Reshape, View

__all__ = ["Abs", "Add", "AddConstant", "BatchNormalization", "Bilinear",
           "CAdd", "CAddTable", "CMul", "ClassNLLCriterion", "Clamp",
           "Concat", "ConcatTable", "CrossEntropyCriterion", "Dropout",
           "ELU", "Exp", "GradientReversal", "HardShrink", "HardTanh",
           "Identity", "LayerNorm", "LeakyReLU", "Linear", "Log",
           "LogSigmoid", "LogSoftMax", "Mul", "MulConstant",
           "MultiHeadAttention", "PReLU", "Padding", "Power", "RReLU",
           "ReLU", "ReLU6", "Reshape", "Scale", "Sequential", "Sigmoid",
           "SoftMax", "SoftMin", "SoftPlus", "SoftShrink", "SoftSign",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling",
           "Sqrt", "Square", "Tanh", "TanhShrink", "Threshold",
           "TimeDistributedCriterion", "View", "apply_rope", "gelu"]
