"""ResNet (``bigdl_tpu/models/resnet.py``).

Basic blocks and bottlenecks with shortcut A (stride, then zero-padded
channels), B (a 1x1 projection where the width changes) or C (a projection
always); the ImageNet layout at depths 18/34/50/101/152 (input NCHW
3x224x224) and the CIFAR-10 layout at depth 6n+2 (3x32x32).  Output is
LogSoftMax over ``class_num``.  No convolution has a bias: every one feeds
a BatchNorm, which cancels it.  The builder makes the model on the CPU;
move it with ``.to()`` (CUDA by default) or hand it to a trainer or
``DLClassifier`` with its device.
"""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn


def _conv(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0):
    return nn.SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph,
                                 with_bias=False)


def _shortcut(n_in: int, n_out: int, stride: int,
              shortcut_type: str) -> nn.Sequential:
    use_conv = shortcut_type == "C" or \
        (shortcut_type == "B" and n_in != n_out)
    if use_conv:
        return (nn.Sequential()
                .add(_conv(n_in, n_out, 1, 1, stride, stride))
                .add(nn.SpatialBatchNormalization(n_out)))
    if n_in != n_out:  # type A: stride then zero-pad channels
        return (nn.Sequential()
                .add(nn.SpatialAveragePooling(1, 1, stride, stride))
                .add(nn.Padding(1, n_out - n_in, 3)))
    if stride != 1:
        return nn.SpatialAveragePooling(1, 1, stride, stride)
    return nn.Identity()


def _residual(s, n_in, n_out, stride, shortcut_type):
    return (nn.Sequential()
            .add(nn.ConcatTable()
                 .add(s)
                 .add(_shortcut(n_in, n_out, stride, shortcut_type)))
            .add(nn.CAddTable(True))
            .add(nn.ReLU(True)))


def basic_block(n_in: int, n: int, stride: int,
                shortcut_type: str = "B") -> nn.Sequential:
    s = (nn.Sequential()
         .add(_conv(n_in, n, 3, 3, stride, stride, 1, 1))
         .add(nn.SpatialBatchNormalization(n))
         .add(nn.ReLU(True))
         .add(_conv(n, n, 3, 3, 1, 1, 1, 1))
         .add(nn.SpatialBatchNormalization(n)))
    return _residual(s, n_in, n, stride, shortcut_type)


def bottleneck(n_in: int, n: int, stride: int,
               shortcut_type: str = "B") -> nn.Sequential:
    out = n * 4
    s = (nn.Sequential()
         .add(_conv(n_in, n, 1, 1, 1, 1))
         .add(nn.SpatialBatchNormalization(n))
         .add(nn.ReLU(True))
         .add(_conv(n, n, 3, 3, stride, stride, 1, 1))
         .add(nn.SpatialBatchNormalization(n))
         .add(nn.ReLU(True))
         .add(_conv(n, out, 1, 1, 1, 1))
         .add(nn.SpatialBatchNormalization(out)))
    return _residual(s, n_in, out, stride, shortcut_type)


_IMAGENET_CFG = {
    18: ([2, 2, 2, 2], 512, basic_block),
    34: ([3, 4, 6, 3], 512, basic_block),
    50: ([3, 4, 6, 3], 2048, bottleneck),
    101: ([3, 4, 23, 3], 2048, bottleneck),
    152: ([3, 8, 36, 3], 2048, bottleneck),
}


def ResNet(class_num: int = 1000, depth: int = 50,
           shortcut_type: str = "B",
           dataset: str = "imagenet") -> nn.Sequential:
    model = nn.Sequential()
    if dataset == "imagenet":
        cfg, n_features, block = _IMAGENET_CFG[depth]
        expansion = 4 if block is bottleneck else 1
        model.add(_conv(3, 64, 7, 7, 2, 2, 3, 3))
        model.add(nn.SpatialBatchNormalization(64))
        model.add(nn.ReLU(True))
        model.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
        n_in = 64
        for i, (w, count) in enumerate(zip([64, 128, 256, 512], cfg)):
            seq = nn.Sequential()
            for j in range(count):
                seq.add(block(n_in if j == 0 else w * expansion, w,
                              (1 if i == 0 else 2) if j == 0 else 1,
                              shortcut_type))
            model.add(seq)
            n_in = w * expansion
        model.add(nn.SpatialAveragePooling(7, 7, 1, 1))
        model.add(nn.View(n_features).set_num_input_dims(3))
        model.add(nn.Linear(n_features, class_num))
        model.add(nn.LogSoftMax())
    elif dataset == "cifar10":
        if (depth - 2) % 6:
            raise ValueError(f"cifar depth must be 6n+2, got {depth}")
        n = (depth - 2) // 6
        model.add(_conv(3, 16, 3, 3, 1, 1, 1, 1))
        model.add(nn.SpatialBatchNormalization(16))
        model.add(nn.ReLU(True))
        for n_in, width, stride in ((16, 16, 1), (16, 32, 2), (32, 64, 2)):
            seq = nn.Sequential()
            for j in range(n):
                seq.add(basic_block(n_in if j == 0 else width, width,
                                    stride if j == 0 else 1, shortcut_type))
            model.add(seq)
        model.add(nn.SpatialAveragePooling(8, 8, 1, 1))
        model.add(nn.View(64).set_num_input_dims(3))
        model.add(nn.Linear(64, class_num))
        model.add(nn.LogSoftMax())
    else:
        raise ValueError(f"unknown dataset {dataset}")
    return model


def cifar10_decay(epoch: int) -> float:
    """The exponent of ``EpochDecay`` in the CIFAR-10 recipe
    (``models/resnet/Train.scala:38-39``)."""
    return 2.0 if epoch >= 122 else (1.0 if epoch >= 81 else 0.0)
