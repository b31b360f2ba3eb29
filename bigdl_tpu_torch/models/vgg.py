"""VGG models (``bigdl_tpu/models/vgg.py``, the builders).

``VggForCifar10``: 3x3 conv + BatchNorm (eps 1e-3) + ReLU stacks with
dropout for 3x32x32 inputs and five ceil-mode 2x2/2 max pools.
``Vgg_16`` and ``Vgg_19``: the ImageNet layouts (3x224x224) with five 2x2/2
max pools (K1 on the card, K3 in a step) on 224, 112, 56, 28 and 14-pixel
planes and a ``Threshold(0, 1e-6)`` classifier.  Output is LogSoftMax over
``class_num``.  The builder makes the model on the CPU; move it with
``.to()`` (CUDA by default).

``train_main`` and ``test_main`` are the reference's ``VggForCifar10``
mains (``models/vgg/Train.scala:38-97``, ``Test.scala``) on CIFAR-10
binary batches, with their flags and defaults, on ``device`` (CUDA by
default; they raise without CUDA unless asked for the CPU).
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


def _cifar_set(folder: str, batch_size: int, train: bool):
    from bigdl_tpu_torch.dataset import (BGRImgNormalizer, BGRImgToBatch,
                                         BytesToBGRImg, DataSet,
                                         load_cifar10)
    from bigdl_tpu_torch.dataset.loaders import (CIFAR10_TEST_MEAN,
                                                 CIFAR10_TEST_STD,
                                                 CIFAR10_TRAIN_MEAN,
                                                 CIFAR10_TRAIN_STD)
    mean = CIFAR10_TRAIN_MEAN if train else CIFAR10_TEST_MEAN
    std = CIFAR10_TRAIN_STD if train else CIFAR10_TEST_STD
    return DataSet.array(load_cifar10(folder, train=train)) >> \
        BytesToBGRImg() >> BGRImgNormalizer(mean, std) >> \
        BGRImgToBatch(batch_size)


def train_main(argv=None, device="cuda"):
    """CLI training of ``VggForCifar10``: ``ClassNLLCriterion``, SGD 0.01
    with weight decay 5e-4 and momentum 0.9 under ``EpochStep(25, 0.5)``,
    Top-1 on the test batch every epoch, ``--checkpoint`` snapshots every
    epoch (``--overWrite``: one pair), ``--model``/``--state`` to resume.
    Returns the trained model."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, EpochStep, Optimizer,
                                       Top1Accuracy, Trigger)
    from bigdl_tpu_torch.utils.file import File, load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("vgg-train")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("-b", "--batchSize", type=int, default=112)
    p.add_argument("-e", "--maxEpoch", type=int, default=90)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--overWrite", action="store_true")
    p.add_argument("--model", default=None)
    p.add_argument("--state", default=None, help="state snapshot to resume")
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    train_set = _cifar_set(args.folder, args.batchSize, train=True)
    val_set = _cifar_set(args.folder, args.batchSize, train=False)
    model = VggForCifar10(10)
    if args.model:
        load_model_snapshot(model, args.model)
    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=ClassNLLCriterion(), device=device)
    optimizer.set_optim_method(SGD(
        learning_rate=0.01, weight_decay=0.0005, momentum=0.9,
        dampening=0.0, learning_rate_schedule=EpochStep(25, 0.5)))
    if args.state:
        optimizer.set_state(File.load(args.state))
    optimizer.set_end_when(Trigger.max_epoch(args.maxEpoch))
    optimizer.set_validation(Trigger.every_epoch(), val_set,
                             [Top1Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    if args.overWrite:
        optimizer.overwrite_checkpoint_()
    return optimizer.optimize()


def test_main(argv=None, device="cuda"):
    """CLI evaluation (``models/vgg/Test.scala``): Top-1 of a ``model.<n>``
    snapshot on the CIFAR-10 test batch.  Prints and returns the
    results."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.optim import LocalValidator, Top1Accuracy
    from bigdl_tpu_torch.utils.file import load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("vgg-test")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True)
    p.add_argument("-b", "--batchSize", type=int, default=112)
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    val_set = _cifar_set(args.folder, args.batchSize, train=False)
    model = VggForCifar10(10)
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
