"""MNIST autoencoder (``bigdl_tpu/models/autoencoder.py``, the builder):
784 -> ``class_num`` hidden -> 784 sigmoid."""

import bigdl_tpu_torch.nn as nn


def Autoencoder(class_num: int = 32) -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.Reshape([28 * 28]))
            .add(nn.Linear(28 * 28, class_num))
            .add(nn.ReLU(True))
            .add(nn.Linear(class_num, 28 * 28))
            .add(nn.Sigmoid()))
