"""ResNet (``bigdl_tpu/models/resnet.py``).

Basic blocks and bottlenecks with shortcut A (stride, then zero-padded
channels), B (a 1x1 projection where the width changes) or C (a projection
always); the ImageNet layout at depths 18/34/50/101/152 (input NCHW
3x224x224) and the CIFAR-10 layout at depth 6n+2 (3x32x32).  Output is
LogSoftMax over ``class_num``.  No convolution has a bias: every one feeds
a BatchNorm, which cancels it.  The builder makes the model on the CPU;
move it with ``.to()`` (CUDA by default) or hand it to a trainer or
``DLClassifier`` with its device.

``train_main`` and ``test_main`` are the reference's CIFAR-10 mains
(``models/resnet/Train.scala:41-118``, ``Test.scala``) on CIFAR-10 binary
batches, with their flags and defaults, on ``device`` (CUDA by default;
they raise without CUDA unless asked for the CPU).
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


def _cifar_val_set(folder: str, batch_size: int):
    from bigdl_tpu_torch.dataset import (BGRImgNormalizer, BGRImgToBatch,
                                         BytesToBGRImg, DataSet,
                                         load_cifar10)
    from bigdl_tpu_torch.dataset.loaders import (CIFAR10_TEST_MEAN,
                                                 CIFAR10_TEST_STD)
    return DataSet.array(load_cifar10(folder, train=False)) >> \
        BytesToBGRImg() >> BGRImgNormalizer(CIFAR10_TEST_MEAN,
                                            CIFAR10_TEST_STD) >> \
        BGRImgToBatch(batch_size)


def train_main(argv=None, device="cuda"):
    """CLI training of the CIFAR-10 ResNet (depth ``--depth``, shortcut
    ``--shortcutType``): normalize, HFlip(0.5) and a pad-4 random crop,
    ``CrossEntropyCriterion``, SGD with weight decay, momentum and nesterov
    under ``EpochDecay(cifar10_decay)``, Top-1 on the test batch every
    epoch, ``--checkpoint`` snapshots every epoch, ``--model``/``--state``
    to resume.  Returns the trained model."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgNormalizer,
                                         BGRImgToBatch, BytesToBGRImg,
                                         DataSet, HFlip, load_cifar10)
    from bigdl_tpu_torch.dataset.loaders import (CIFAR10_TRAIN_MEAN,
                                                 CIFAR10_TRAIN_STD)
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import (SGD, EpochDecay, Optimizer,
                                       Top1Accuracy, Trigger)
    from bigdl_tpu_torch.utils.file import File, load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("resnet-train")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--nepochs", type=int, default=165)
    p.add_argument("--depth", type=int, default=20)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--shortcutType", default="A")
    p.add_argument("-r", "--learningRate", type=float, default=0.1)
    p.add_argument("--weightDecay", type=float, default=1e-4)
    p.add_argument("-m", "--momentum", type=float, default=0.9)
    p.add_argument("--dampening", type=float, default=0.0)
    p.add_argument("--nesterov", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--state", default=None, help="state snapshot to resume")
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    train_set = DataSet.array(load_cifar10(args.folder, train=True)) >> \
        BytesToBGRImg() >> BGRImgNormalizer(CIFAR10_TRAIN_MEAN,
                                            CIFAR10_TRAIN_STD) >> \
        HFlip(0.5) >> BGRImgCropper(32, 32, padding=4) >> \
        BGRImgToBatch(args.batchSize)
    val_set = _cifar_val_set(args.folder, args.batchSize)
    model = ResNet(class_num=args.classes, depth=args.depth,
                   shortcut_type=args.shortcutType, dataset="cifar10")
    if args.model:
        load_model_snapshot(model, args.model)
    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=CrossEntropyCriterion(), device=device)
    optimizer.set_optim_method(SGD(
        learning_rate=args.learningRate, weight_decay=args.weightDecay,
        momentum=args.momentum, dampening=args.dampening,
        nesterov=args.nesterov,
        learning_rate_schedule=EpochDecay(cifar10_decay)))
    if args.state:
        optimizer.set_state(File.load(args.state))
    optimizer.set_end_when(Trigger.max_epoch(args.nepochs))
    optimizer.set_validation(Trigger.every_epoch(), val_set,
                             [Top1Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return optimizer.optimize()


def test_main(argv=None, device="cuda"):
    """CLI evaluation (``models/resnet/Test.scala``): Top-1 of a
    ``model.<n>`` snapshot on the CIFAR-10 test batch.  Prints and returns
    the results."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.optim import LocalValidator, Top1Accuracy
    from bigdl_tpu_torch.utils.file import load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("resnet-test")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True)
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--depth", type=int, default=20)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--shortcutType", default="A")
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    val_set = _cifar_val_set(args.folder, args.batchSize)
    model = ResNet(class_num=args.classes, depth=args.depth,
                   shortcut_type=args.shortcutType, dataset="cifar10")
    load_model_snapshot(model, args.model)
    results = LocalValidator(model, val_set, device=device).test(
        [Top1Accuracy()])
    for r in results:
        print(r)
    return results


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["test"]:
        test_main(sys.argv[2:])
    else:
        train_main()
