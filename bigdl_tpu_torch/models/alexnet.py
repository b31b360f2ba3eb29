"""AlexNet variants (``bigdl_tpu/models/alexnet.py``).

``AlexNet`` is the Caffe bvlc layout (input 3x227x227): grouped conv2, 4
and 5, two cross-map LRNs (K2 on the card, K4 in a step) and three 3x3/2
max pools (K1, K3 in a step), with the layer names of the released
``.caffemodel``.  ``AlexNet_OWT`` is the one-weird-trick layout (input
3x224x224) without LRN or groups.  Output is LogSoftMax over
``class_num``.  The builder makes the model on the CPU; move it with
``.to()`` (CUDA by default).
"""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn


def AlexNet_OWT(class_num: int = 1000, has_dropout: bool = True,
                first_layer_propagate_back: bool = False) -> nn.Sequential:
    model = nn.Sequential()
    model.add(nn.SpatialConvolution(
        3, 64, 11, 11, 4, 4, 2, 2, 1,
        propagate_back=first_layer_propagate_back).set_name("conv1"))
    model.add(nn.ReLU(True).set_name("relu1"))
    model.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
    model.add(nn.SpatialConvolution(64, 192, 5, 5, 1, 1, 2, 2)
              .set_name("conv2"))
    model.add(nn.ReLU(True).set_name("relu2"))
    model.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
    model.add(nn.SpatialConvolution(192, 384, 3, 3, 1, 1, 1, 1)
              .set_name("conv3"))
    model.add(nn.ReLU(True).set_name("relu3"))
    model.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1)
              .set_name("conv4"))
    model.add(nn.ReLU(True).set_name("relu4"))
    model.add(nn.SpatialConvolution(256, 256, 3, 3, 1, 1, 1, 1)
              .set_name("conv5"))
    model.add(nn.ReLU(True).set_name("relu5"))
    model.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"))
    model.add(nn.View(256 * 6 * 6))
    model.add(nn.Linear(256 * 6 * 6, 4096).set_name("fc6"))
    model.add(nn.ReLU(True).set_name("relu6"))
    if has_dropout:
        model.add(nn.Dropout(0.5).set_name("drop6"))
    model.add(nn.Linear(4096, 4096).set_name("fc7"))
    model.add(nn.ReLU(True).set_name("relu7"))
    if has_dropout:
        model.add(nn.Dropout(0.5).set_name("drop7"))
    model.add(nn.Linear(4096, class_num).set_name("fc8"))
    model.add(nn.LogSoftMax())
    return model


def AlexNet(class_num: int = 1000) -> nn.Sequential:
    model = nn.Sequential()
    model.add(nn.SpatialConvolution(3, 96, 11, 11, 4, 4, 0, 0, 1,
                                    propagate_back=False).set_name("conv1"))
    model.add(nn.ReLU(True).set_name("relu1"))
    model.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1"))
    model.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
    model.add(nn.SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, 2)
              .set_name("conv2"))
    model.add(nn.ReLU(True).set_name("relu2"))
    model.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm2"))
    model.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
    model.add(nn.SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1)
              .set_name("conv3"))
    model.add(nn.ReLU(True).set_name("relu3"))
    model.add(nn.SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, 2)
              .set_name("conv4"))
    model.add(nn.ReLU(True).set_name("relu4"))
    model.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, 2)
              .set_name("conv5"))
    model.add(nn.ReLU(True).set_name("relu5"))
    model.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"))
    model.add(nn.View(256 * 6 * 6))
    model.add(nn.Linear(256 * 6 * 6, 4096).set_name("fc6"))
    model.add(nn.ReLU(True).set_name("relu6"))
    model.add(nn.Dropout(0.5).set_name("drop6"))
    model.add(nn.Linear(4096, 4096).set_name("fc7"))
    model.add(nn.ReLU(True).set_name("relu7"))
    model.add(nn.Dropout(0.5).set_name("drop7"))
    model.add(nn.Linear(4096, class_num).set_name("fc8"))
    model.add(nn.LogSoftMax().set_name("loss"))
    return model
