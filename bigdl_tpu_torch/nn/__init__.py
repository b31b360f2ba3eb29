"""The layers and criterions of the port, under the reference names."""

from bigdl_tpu_torch.core.module import Container, Criterion, Module
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
from bigdl_tpu_torch.nn.containers import (Bottle, CAddTable, CDivTable,
                                           CMaxTable, CMinTable, CMulTable,
                                           Concat, ConcatTable, Contiguous,
                                           Copy, CSubTable, Echo,
                                           FlattenTable, Identity, JoinTable,
                                           MapTable, MixtureTable,
                                           NarrowTable, ParallelTable,
                                           SelectTable, Sequential)
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialConvolutionMap,
                                     SpatialDilatedConvolution,
                                     SpatialFullConvolution,
                                     SpatialShareConvolution)
from bigdl_tpu_torch.nn.criterion import (AbsCriterion, BCECriterion,
                                          ClassNLLCriterion,
                                          ClassSimplexCriterion,
                                          CosineEmbeddingCriterion,
                                          CriterionTable,
                                          CrossEntropyCriterion,
                                          DistKLDivCriterion,
                                          HingeEmbeddingCriterion, L1Cost,
                                          L1HingeEmbeddingCriterion,
                                          MarginCriterion,
                                          MarginRankingCriterion,
                                          MSECriterion, MultiCriterion,
                                          MultiLabelMarginCriterion,
                                          MultiLabelSoftMarginCriterion,
                                          MultiMarginCriterion,
                                          ParallelCriterion,
                                          SmoothL1Criterion,
                                          SmoothL1CriterionWithWeights,
                                          SoftMarginCriterion,
                                          SoftmaxWithCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.distance import (MM, MV, Cosine, CosineDistance,
                                         DotProduct, Euclidean, L1Penalty,
                                         PairwiseDistance)
from bigdl_tpu_torch.nn.dropout import Dropout, LookupTable
from bigdl_tpu_torch.nn.linear import (Add, AddConstant, Bilinear, CAdd, CMul,
                                       Linear, Mul, MulConstant, Scale)
from bigdl_tpu_torch.nn.nms import Nms
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, LayerNorm, Normalize, SpatialBatchNormalization,
    SpatialContrastiveNormalization, SpatialCrossMapLRN,
    SpatialDivisiveNormalization, SpatialSubtractiveNormalization)
from bigdl_tpu_torch.nn.pooling import (RoiPooling, SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.recurrent import (Cell, GRUCell, LSTMCell, Recurrent,
                                          RnnCell, TimeDistributed)
from bigdl_tpu_torch.nn.shape_ops import (Index, InferReshape, MaskedSelect,
                                          Max, Mean, Min, Narrow, Padding,
                                          Replicate, Reshape, Select,
                                          SpatialZeroPadding, Squeeze, Sum,
                                          Transpose, Unsqueeze, View)

__all__ = ["Abs", "AbsCriterion", "Add", "AddConstant", "BCECriterion",
           "BatchNormalization", "Bilinear", "Bottle", "CAdd", "CAddTable",
           "CDivTable", "CMaxTable", "CMinTable", "CMul", "CMulTable",
           "CSubTable", "Cell", "Clamp", "ClassNLLCriterion",
           "ClassSimplexCriterion", "Concat", "ConcatTable", "Container",
           "Contiguous", "Copy", "Cosine", "CosineDistance",
           "CosineEmbeddingCriterion", "Criterion", "CriterionTable",
           "CrossEntropyCriterion", "DistKLDivCriterion", "DotProduct",
           "Dropout", "ELU", "Echo", "Euclidean", "Exp", "FlattenTable",
           "GRUCell", "GradientReversal", "HardShrink", "HardTanh",
           "HingeEmbeddingCriterion", "Identity", "Index", "InferReshape",
           "JoinTable", "L1Cost", "L1HingeEmbeddingCriterion", "L1Penalty",
           "LSTMCell", "LayerNorm", "LeakyReLU", "Linear", "Log", "LogSigmoid",
           "LogSoftMax", "LookupTable", "MM", "MSECriterion", "MV", "MapTable",
           "MarginCriterion", "MarginRankingCriterion", "MaskedSelect", "Max",
           "Mean", "Min", "MixtureTable", "Module", "Mul", "MulConstant",
           "MultiCriterion", "MultiHeadAttention", "MultiLabelMarginCriterion",
           "MultiLabelSoftMarginCriterion", "MultiMarginCriterion", "Narrow",
           "NarrowTable", "Nms", "Normalize", "PReLU", "Padding",
           "PairwiseDistance", "ParallelCriterion", "ParallelTable", "Power",
           "RReLU", "ReLU", "ReLU6", "Recurrent", "Replicate", "Reshape",
           "RnnCell", "RoiPooling", "Scale", "Select", "SelectTable",
           "Sequential", "Sigmoid", "SmoothL1Criterion",
           "SmoothL1CriterionWithWeights", "SoftMarginCriterion", "SoftMax",
           "SoftMin", "SoftPlus", "SoftShrink", "SoftSign",
           "SoftmaxWithCriterion", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialContrastiveNormalization",
           "SpatialConvolution", "SpatialConvolutionMap", "SpatialCrossMapLRN",
           "SpatialDilatedConvolution", "SpatialDivisiveNormalization",
           "SpatialFullConvolution", "SpatialMaxPooling",
           "SpatialShareConvolution", "SpatialSubtractiveNormalization",
           "SpatialZeroPadding", "Sqrt", "Square", "Squeeze", "Sum", "Tanh",
           "TanhShrink", "Threshold", "TimeDistributed",
           "TimeDistributedCriterion", "Transpose", "Unsqueeze", "View",
           "apply_rope", "gelu", "load", "load_caffe", "load_torch"]


# -- module-level load helpers (``nn/Module.scala:30-42`` parity) -----------

def load(path, device="cuda"):
    """A module saved with ``Module.save`` (``Module.load``), its
    parameters and buffers on ``device`` (CUDA by default; without CUDA it
    raises unless asked for the CPU).  A file the JAX package's
    ``Module.save`` wrote is refused with ``ValueError`` (it pickles JAX
    objects): ``.t7`` and ``.caffemodel`` carry models between the two."""
    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.utils.file import File
    dev = resolve_device(device)
    module = File.load(path)
    if not isinstance(module, Module):
        raise ValueError(f"{path} holds a {type(module).__name__}, not a "
                         "module saved with Module.save")
    return module.to(dev)


def load_torch(path, device="cuda"):
    """A Torch7 ``.t7`` module file (``Module.loadTorch``) on ``device``."""
    from bigdl_tpu_torch.utils import torch_file
    return torch_file.load_torch(path, device)


def load_caffe(model, prototxt_path, model_path, match_all=True):
    """Copy weights from a caffemodel into ``model`` where its parameters
    lie (``Module.loadCaffe``)."""
    from bigdl_tpu_torch.utils.caffe_loader import CaffeLoader
    return CaffeLoader.load(model, prototxt_path, model_path,
                            match_all=match_all)
