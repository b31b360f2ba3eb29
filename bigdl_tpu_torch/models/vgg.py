"""VGG models (``bigdl_tpu/models/vgg.py``, the builders).

``VggForCifar10``: 3x3 conv + BatchNorm (eps 1e-3) + ReLU stacks with
dropout for 3x32x32 inputs and five ceil-mode 2x2/2 max pools.
``Vgg_16`` and ``Vgg_19``: the ImageNet layouts (3x224x224) with five 2x2/2
max pools (K1 on the card, K3 in a step) on 224, 112, 56, 28 and 14-pixel
planes and a ``Threshold(0, 1e-6)`` classifier.  Output is LogSoftMax over
``class_num``.  The builder makes the model on the CPU; move it with
``.to()`` (CUDA by default).
"""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn


def VggForCifar10(class_num: int = 10) -> nn.Sequential:
    model = nn.Sequential()

    def conv_bn_relu(ni, no):
        model.add(nn.SpatialConvolution(ni, no, 3, 3, 1, 1, 1, 1))
        model.add(nn.SpatialBatchNormalization(no, 1e-3))
        model.add(nn.ReLU(True))

    conv_bn_relu(3, 64)
    model.add(nn.Dropout(0.3))
    conv_bn_relu(64, 64)
    model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    conv_bn_relu(64, 128)
    model.add(nn.Dropout(0.4))
    conv_bn_relu(128, 128)
    model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    conv_bn_relu(128, 256)
    model.add(nn.Dropout(0.4))
    conv_bn_relu(256, 256)
    model.add(nn.Dropout(0.4))
    conv_bn_relu(256, 256)
    model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    conv_bn_relu(256, 512)
    model.add(nn.Dropout(0.4))
    conv_bn_relu(512, 512)
    model.add(nn.Dropout(0.4))
    conv_bn_relu(512, 512)
    model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    conv_bn_relu(512, 512)
    model.add(nn.Dropout(0.4))
    conv_bn_relu(512, 512)
    model.add(nn.Dropout(0.4))
    conv_bn_relu(512, 512)
    model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    model.add(nn.View(512))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(512, 512))
    model.add(nn.BatchNormalization(512))
    model.add(nn.ReLU(True))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(512, class_num))
    model.add(nn.LogSoftMax())
    return model


def _vgg_imagenet(cfg, class_num: int) -> nn.Sequential:
    model = nn.Sequential()
    in_c = 3
    for v in cfg:
        if v == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            model.add(nn.SpatialConvolution(in_c, v, 3, 3, 1, 1, 1, 1))
            model.add(nn.ReLU(True))
            in_c = v
    model.add(nn.View(512 * 7 * 7))
    model.add(nn.Linear(512 * 7 * 7, 4096))
    model.add(nn.Threshold(0, 1e-6))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, 4096))
    model.add(nn.Threshold(0, 1e-6))
    model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, class_num))
    model.add(nn.LogSoftMax())
    return model


def Vgg_16(class_num: int = 1000) -> nn.Sequential:
    return _vgg_imagenet(
        [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"], class_num)


def Vgg_19(class_num: int = 1000) -> nn.Sequential:
    return _vgg_imagenet(
        [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"], class_num)
