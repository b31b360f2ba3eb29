"""Inception v1 / GoogLeNet and Inception v2 / BN-Inception
(``bigdl_tpu/models/inception.py``).

Input is NCHW 3x224x224; output LogSoftMax over ``class_num``.  Layer names
follow the caffe GoogLeNet convention, as in the reference.  The builder
makes the model on the CPU; move it with ``.to()`` (CUDA by default) or hand
it to ``DLClassifier(device=...)``.

``train_main`` and ``test_main`` are the reference's mains
(``models/inception/Train.scala:37-116``, ``Test.scala``) on record-file
ImageNet (``train/`` and ``val/`` folders of ``.seq`` files, as
``dataset/seqfile.py``'s generator writes them), with their flags and
defaults, on ``device`` (CUDA by default; they raise without CUDA unless
asked for the CPU).
"""

from __future__ import annotations

import math
import os

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.core import init as init_methods

IMAGENET_TRAIN_SIZE = 1281167          # Train.scala's Poly horizon constant


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


def _imagenet_set(folder: str, batch_size: int, train: bool,
                  image_size: int = 224, workers: int = 4,
                  total_size=None):
    """Record-file ImageNet (``models/inception/ImageNet2012.scala:36-96``):
    decode -> crop (random for train, centre for val) -> HFlip(0.5) ->
    per-channel normalize -> the multi-threaded batcher.  The val side's
    HFlip is the reference pipeline's, as written."""
    from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgNormalizer,
                                         DataSet, HFlip, LocalSeqFileToBytes,
                                         SeqBytesToBGRImg)
    from bigdl_tpu_torch.dataset.prefetch import MTLabeledBGRImgToBatch

    sub = os.path.join(folder, "train" if train else "val")
    return (DataSet.seq_file_folder(sub, total_size=total_size)
            >> LocalSeqFileToBytes()
            >> SeqBytesToBGRImg()
            >> BGRImgCropper(image_size, image_size, center=not train)
            >> HFlip(0.5)
            >> BGRImgNormalizer((0.485, 0.456, 0.406),
                                (0.229, 0.224, 0.225))
            >> MTLabeledBGRImgToBatch(image_size, image_size, batch_size,
                                      workers=workers))


def _build_net(net: str, class_num: int):
    return (Inception_v1 if net == "inception_v1" else Inception_v2)(
        class_num)


def train_main(argv=None, device="cuda"):
    """CLI training (``models/inception/Train.scala:37-116``,
    ``Options.scala:22-76``): Inception v1 or v2 on record-file ImageNet,
    ``ClassNLLCriterion``, SGD (``-l``, momentum 0.9, ``--weightDecay``)
    under ``Poly(0.5)`` over the run's horizon (``-e`` epochs of the
    training set's record count, ``--trainSize`` where given, or ``-i``
    iterations), bf16 mixed precision, Top-1/Top-5 validation and
    ``--checkpoint`` snapshots every epoch (``-e``) or every 620
    iterations.  ``--model``/``--state`` resume from a snapshot pair.
    Returns the trained model."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, Optimizer, Poly, Top1Accuracy,
                                       Top5Accuracy, Trigger)
    from bigdl_tpu_torch.utils.file import File, load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("inception-train")
    p.add_argument("-f", "--folder", default="./",
                   help="record-file folder with train/ and val/")
    p.add_argument("--model", default=None, help="model snapshot location")
    p.add_argument("--state", default=None, help="state snapshot location")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--overWrite", action="store_true")
    p.add_argument("-e", "--maxEpoch", type=int, default=None)
    p.add_argument("-i", "--maxIteration", type=int, default=62000)
    p.add_argument("-l", "--learningRate", type=float, default=0.01)
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--weightDecay", type=float, default=0.0002)
    p.add_argument("--classNum", type=int, default=1000)
    p.add_argument("--trainSize", type=int, default=None,
                   help="training-set record count; skips the record-count "
                        f"scan (ImageNet: {IMAGENET_TRAIN_SIZE})")
    p.add_argument("--net", choices=["inception_v1", "inception_v2"],
                   default="inception_v1")
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    train_set = _imagenet_set(args.folder, args.batchSize, train=True,
                              total_size=args.trainSize)
    val_set = _imagenet_set(args.folder, args.batchSize, train=False)
    model = _build_net(args.net, args.classNum)
    if args.model:
        load_model_snapshot(model, args.model)

    if args.maxEpoch is not None:
        train_size = args.trainSize or train_set.size()
        horizon = int(math.ceil(train_size / args.batchSize)) * args.maxEpoch
        end = Trigger.max_epoch(args.maxEpoch)
        cadence = Trigger.every_epoch()
    else:
        horizon = args.maxIteration
        end = Trigger.max_iteration(args.maxIteration)
        cadence = Trigger.several_iteration(620)

    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=ClassNLLCriterion(), device=device)
    optimizer.set_optim_method(SGD(
        learning_rate=args.learningRate, weight_decay=args.weightDecay,
        momentum=0.9, dampening=0.0,
        learning_rate_schedule=Poly(0.5, horizon)))
    if args.state:
        optimizer.set_state(File.load(args.state))
    optimizer.set_end_when(end)
    optimizer.set_validation(cadence, val_set,
                             [Top1Accuracy(), Top5Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, cadence)
    if args.overWrite:
        optimizer.overwrite_checkpoint_()
    optimizer.set_mixed_precision(True)
    return optimizer.optimize()


def test_main(argv=None, device="cuda"):
    """CLI evaluation (``models/inception/Test.scala``): Top-1 and Top-5
    over the val record files, from a ``model.<n>`` snapshot (``--model``)
    or a Caffe checkpoint (``--caffeDefPath``/``--caffeModelPath``, copied
    by layer name, unmatched layers kept).  Prints and returns the
    results."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.optim import (LocalValidator, Top1Accuracy,
                                       Top5Accuracy)
    from bigdl_tpu_torch.utils.file import load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("inception-test")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", default=None, help="model snapshot")
    p.add_argument("--caffeDefPath", default=None)
    p.add_argument("--caffeModelPath", default=None)
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--classNum", type=int, default=1000)
    p.add_argument("--net", choices=["inception_v1", "inception_v2"],
                   default="inception_v1")
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    model = _build_net(args.net, args.classNum)
    if args.model:
        load_model_snapshot(model, args.model)
    elif args.caffeDefPath and args.caffeModelPath:
        from bigdl_tpu_torch.utils.caffe_loader import CaffeLoader
        CaffeLoader.load(model, args.caffeDefPath, args.caffeModelPath,
                         match_all=False)
    else:
        p.error("provide --model or --caffeDefPath/--caffeModelPath")

    val_set = _imagenet_set(args.folder, args.batchSize, train=False)
    results = LocalValidator(model, val_set, device=device).test(
        [Top1Accuracy(), Top5Accuracy()])
    for r in results:
        print(r)
    return results


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["test"]:
        test_main(sys.argv[2:])
    elif sys.argv[1:2] == ["train"]:
        train_main(sys.argv[2:])
    else:
        train_main()
