"""LeNet-5 (``bigdl_tpu/models/lenet.py``): conv(1->6,5x5) -> tanh ->
maxpool -> tanh -> conv(6->12,5x5) -> maxpool -> reshape -> linear(100) ->
tanh -> linear(classNum) -> logsoftmax; its two 2x2/2 max pools run K1 on
the card (and K3 in a step).

``train_main`` and ``test_main`` are the reference's mains
(``models/lenet/Train.scala:41-104``, ``Test.scala``) on MNIST idx files,
with their flags and defaults, on ``device`` (CUDA by default; they raise
without CUDA unless asked for the CPU)."""

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


def _mnist_set(folder: str, prefix: str, batch_size: int, mean: float,
               std: float):
    from bigdl_tpu_torch.dataset import (BytesToGreyImg, DataSet,
                                         GreyImgNormalizer, GreyImgToBatch,
                                         load_mnist)
    records = load_mnist(f"{folder}/{prefix}-images-idx3-ubyte",
                         f"{folder}/{prefix}-labels-idx1-ubyte")
    return DataSet.array(records) >> BytesToGreyImg(28, 28) >> \
        GreyImgNormalizer(mean, std) >> GreyImgToBatch(batch_size)


TRAIN_MEAN, TRAIN_STD = 0.13066047740239506, 0.3081078
TEST_MEAN, TEST_STD = 0.13251460584233699, 0.31048024


def train_main(argv=None, device="cuda"):
    """CLI training on ``<folder>/train-*-ubyte``: ``ClassNLLCriterion``,
    SGD ``-r``, ``-e`` epochs, Top-1 on ``t10k-*-ubyte`` every epoch,
    ``--checkpoint`` snapshots every epoch, ``--model``/``--state`` to
    resume.  Returns the trained model."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
    from bigdl_tpu_torch.utils.file import File, load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("lenet-train")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("-e", "--maxEpoch", type=int, default=10)
    p.add_argument("-r", "--learningRate", type=float, default=0.05)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None, help="model snapshot to resume")
    p.add_argument("--state", default=None, help="state snapshot to resume")
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    # both sets take the training set's statistics (Train.scala)
    train_set = _mnist_set(args.folder, "train", args.batchSize,
                           TRAIN_MEAN, TRAIN_STD)
    val_set = _mnist_set(args.folder, "t10k", args.batchSize, TRAIN_MEAN,
                         TRAIN_STD)
    model = LeNet5(10)
    if args.model:
        load_model_snapshot(model, args.model)
    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=ClassNLLCriterion(), device=device)
    optimizer.set_optim_method(SGD(learning_rate=args.learningRate))
    if args.state:
        optimizer.set_state(File.load(args.state))
    optimizer.set_end_when(Trigger.max_epoch(args.maxEpoch))
    optimizer.set_validation(Trigger.every_epoch(), val_set,
                             [Top1Accuracy()])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return optimizer.optimize()


def test_main(argv=None, device="cuda"):
    """CLI evaluation (``models/lenet/Test.scala``): Top-1 of a
    ``model.<n>`` snapshot on ``<folder>/t10k-*-ubyte``, normalized by the
    test set's statistics.  Prints and returns the results."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.optim import LocalValidator, Top1Accuracy
    from bigdl_tpu_torch.utils.file import load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("lenet-test")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True)
    p.add_argument("-b", "--batchSize", type=int, default=128)
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    val_set = _mnist_set(args.folder, "t10k", args.batchSize, TEST_MEAN,
                         TEST_STD)
    model = LeNet5(10)
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
