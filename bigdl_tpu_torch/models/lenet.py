"""LeNet-5 (``bigdl_tpu/models/lenet.py``): conv(1->6,5x5) -> tanh ->
maxpool -> tanh -> conv(6->12,5x5) -> maxpool -> reshape -> linear(100) ->
tanh -> linear(classNum) -> logsoftmax."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn


def LeNet5(class_num: int = 10) -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.Reshape([1, 28, 28]))
            .add(nn.SpatialConvolution(1, 6, 5, 5))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Tanh())
            .add(nn.SpatialConvolution(6, 12, 5, 5))
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Reshape([12 * 4 * 4]))
            .add(nn.Linear(12 * 4 * 4, 100))
            .add(nn.Tanh())
            .add(nn.Linear(100, class_num))
            .add(nn.LogSoftMax()))
