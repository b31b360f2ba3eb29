"""Inception v1 / GoogLeNet and Inception v2 / BN-Inception
(``bigdl_tpu/models/inception.py``).

Input is NCHW 3x224x224; output LogSoftMax over ``class_num``.  Layer names
follow the caffe GoogLeNet convention, as in the reference.  The builder
makes the model on the CPU; move it with ``.to()`` (CUDA by default) or hand
it to ``DLClassifier(device=...)``.
"""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.core import init as init_methods


def inception_module(input_size: int, c1: int, c3r: int, c3: int,
                     c5r: int, c5: int, pool_proj: int,
                     name_prefix: str = "") -> nn.Concat:
    """The 4-branch Concat block: 1x1 / 1x1->3x3 / 1x1->5x5 / pool->1x1."""
    p = name_prefix
    concat = nn.Concat(2).set_name(p + "output")
    concat.add(nn.Sequential()
               .add(nn.SpatialConvolution(input_size, c1, 1, 1,
                                          init_method=init_methods.XAVIER)
                    .set_name(p + "1x1"))
               .add(nn.ReLU(True).set_name(p + "relu_1x1")))
    concat.add(nn.Sequential()
               .add(nn.SpatialConvolution(input_size, c3r, 1, 1,
                                          init_method=init_methods.XAVIER)
                    .set_name(p + "3x3_reduce"))
               .add(nn.ReLU(True).set_name(p + "relu_3x3_reduce"))
               .add(nn.SpatialConvolution(c3r, c3, 3, 3, 1, 1, 1, 1,
                                          init_method=init_methods.XAVIER)
                    .set_name(p + "3x3"))
               .add(nn.ReLU(True).set_name(p + "relu_3x3")))
    concat.add(nn.Sequential()
               .add(nn.SpatialConvolution(input_size, c5r, 1, 1,
                                          init_method=init_methods.XAVIER)
                    .set_name(p + "5x5_reduce"))
               .add(nn.ReLU(True).set_name(p + "relu_5x5_reduce"))
               .add(nn.SpatialConvolution(c5r, c5, 5, 5, 1, 1, 2, 2,
                                          init_method=init_methods.XAVIER)
                    .set_name(p + "5x5"))
               .add(nn.ReLU(True).set_name(p + "relu_5x5")))
    concat.add(nn.Sequential()
               .add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1)
                    .set_name(p + "pool"))
               .add(nn.SpatialConvolution(input_size, pool_proj, 1, 1,
                                          init_method=init_methods.XAVIER)
                    .set_name(p + "pool_proj"))
               .add(nn.ReLU(True).set_name(p + "relu_pool_proj")))
    return concat


def Inception_v1(class_num: int = 1000,
                 dropout: float = 0.4) -> nn.Sequential:
    m = (nn.Sequential()
         .add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3,
                                    init_method=init_methods.XAVIER)
              .set_name("conv1/7x7_s2"))
         .add(nn.ReLU(True).set_name("conv1/relu_7x7"))
         .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()
              .set_name("pool1/3x3_s2"))
         .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75)
              .set_name("pool1/norm1"))
         .add(nn.SpatialConvolution(64, 64, 1, 1,
                                    init_method=init_methods.XAVIER)
              .set_name("conv2/3x3_reduce"))
         .add(nn.ReLU(True).set_name("conv2/relu_3x3_reduce"))
         .add(nn.SpatialConvolution(64, 192, 3, 3, 1, 1, 1, 1,
                                    init_method=init_methods.XAVIER)
              .set_name("conv2/3x3"))
         .add(nn.ReLU(True).set_name("conv2/relu_3x3"))
         .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("conv2/norm2"))
         .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()
              .set_name("pool2/3x3_s2"))
         .add(inception_module(192, 64, 96, 128, 16, 32, 32,
                               "inception_3a/"))                  # -> 256
         .add(inception_module(256, 128, 128, 192, 32, 96, 64,
                               "inception_3b/"))                  # -> 480
         .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()
              .set_name("pool3/3x3_s2"))
         .add(inception_module(480, 192, 96, 208, 16, 48, 64,
                               "inception_4a/"))                  # -> 512
         .add(inception_module(512, 160, 112, 224, 24, 64, 64,
                               "inception_4b/"))
         .add(inception_module(512, 128, 128, 256, 24, 64, 64,
                               "inception_4c/"))
         .add(inception_module(512, 112, 144, 288, 32, 64, 64,
                               "inception_4d/"))                  # -> 528
         .add(inception_module(528, 256, 160, 320, 32, 128, 128,
                               "inception_4e/"))                  # -> 832
         .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil()
              .set_name("pool4/3x3_s2"))
         .add(inception_module(832, 256, 160, 320, 32, 128, 128,
                               "inception_5a/"))
         .add(inception_module(832, 384, 192, 384, 48, 128, 128,
                               "inception_5b/"))                  # -> 1024
         .add(nn.SpatialAveragePooling(7, 7, 1, 1).set_name("pool5/7x7_s1"))
         .add(nn.Dropout(dropout).set_name("pool5/drop_7x7_s1"))
         .add(nn.View(1024).set_num_input_dims(3))
         .add(nn.Linear(1024, class_num,
                        init_method=init_methods.XAVIER)
              .set_name("loss3/classifier"))
         .add(nn.LogSoftMax().set_name("loss3/loss3")))
    return m


def _conv_bn(ni, no, kw, kh, sw=1, sh=1, pw=0, ph=0):
    """Conv (no bias: the BN cancels it), BN (eps 1e-3), ReLU."""
    return (nn.Sequential()
            .add(nn.SpatialConvolution(ni, no, kw, kh, sw, sh, pw, ph,
                                       init_method=init_methods.XAVIER,
                                       with_bias=False))
            .add(nn.SpatialBatchNormalization(no, 1e-3))
            .add(nn.ReLU(True)))


def _conv_bn_into(seq, ni, no, stride):
    """A 3x3 pad-1 conv, BN and ReLU appended to ``seq``."""
    return (seq.add(nn.SpatialConvolution(ni, no, 3, 3, stride, stride, 1, 1,
                                          init_method=init_methods.XAVIER,
                                          with_bias=False))
            .add(nn.SpatialBatchNormalization(no, 1e-3))
            .add(nn.ReLU(True)))


def inception_module_v2(input_size: int, c1: int, c3r: int, c3: int,
                        c5r: int, c5: int, pool_proj: int,
                        pool: str = "avg", stride: int = 1) -> nn.Concat:
    """The BN-Inception block (``Inception_v2.scala``): the 5x5 branch is
    two stacked 3x3s; a stride-2 reduction block has no 1x1 branch and
    pools without padding (padding would give 15x15 beside the conv
    branches' 14x14)."""
    concat = nn.Concat(2)
    if c1 > 0:
        concat.add(_conv_bn(input_size, c1, 1, 1))
    concat.add(_conv_bn_into(_conv_bn(input_size, c3r, 1, 1), c3r, c3,
                             stride))
    b3 = _conv_bn_into(_conv_bn(input_size, c5r, 1, 1), c5r, c5, 1)
    concat.add(_conv_bn_into(b3, c5, c5, stride))
    pool_branch = nn.Sequential()
    if pool == "avg":
        pool_branch.add(nn.SpatialAveragePooling(3, 3, stride, stride, 1, 1,
                                                 ceil_mode=True))
    elif stride == 1:
        pool_branch.add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
    else:
        pool_branch.add(nn.SpatialMaxPooling(3, 3, stride, stride).ceil())
    if pool_proj > 0:
        pool_branch.add(nn.SpatialConvolution(
            input_size, pool_proj, 1, 1, init_method=init_methods.XAVIER,
            with_bias=False))
        pool_branch.add(nn.SpatialBatchNormalization(pool_proj, 1e-3))
        pool_branch.add(nn.ReLU(True))
    concat.add(pool_branch)
    return concat


def Inception_v2(class_num: int = 1000) -> nn.Sequential:
    """BN-Inception: five max pools (K1 on the card), seven 3x3 ceil-mode
    average pools, 69 BatchNorms."""
    return (nn.Sequential()
            .add(_conv_bn(3, 64, 7, 7, 2, 2, 3, 3))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(_conv_bn(64, 64, 1, 1))
            .add(_conv_bn(64, 192, 3, 3, 1, 1, 1, 1))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(inception_module_v2(192, 64, 64, 64, 64, 96, 32))   # ->256
            .add(inception_module_v2(256, 64, 64, 96, 64, 96, 64))   # ->320
            .add(inception_module_v2(320, 0, 128, 160, 64, 96, 0,
                                     pool="max", stride=2))          # ->576
            .add(inception_module_v2(576, 224, 64, 96, 96, 128, 128))
            .add(inception_module_v2(576, 192, 96, 128, 96, 128, 128))
            .add(inception_module_v2(576, 160, 128, 160, 128, 160, 96))
            .add(inception_module_v2(576, 96, 128, 192, 160, 192, 96))
            .add(inception_module_v2(576, 0, 128, 192, 192, 256, 0,
                                     pool="max", stride=2))          # ->1024
            .add(inception_module_v2(1024, 352, 192, 320, 160, 224, 128))
            .add(inception_module_v2(1024, 352, 192, 320, 192, 224, 128,
                                     pool="max"))
            .add(nn.SpatialAveragePooling(7, 7, 1, 1))
            .add(nn.View(1024).set_num_input_dims(3))
            .add(nn.Linear(1024, class_num,
                           init_method=init_methods.XAVIER))
            .add(nn.LogSoftMax()))
