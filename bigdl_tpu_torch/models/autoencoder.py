"""MNIST autoencoder (``bigdl_tpu/models/autoencoder.py``): 784 ->
``class_num`` hidden -> 784 sigmoid, and its main
(``models/autoencoder/Train.scala``), trained by MSE reconstruction on
MNIST idx files on ``device`` (CUDA by default; it raises without CUDA
unless asked for the CPU)."""

import bigdl_tpu_torch.nn as nn


def Autoencoder(class_num: int = 32) -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.Reshape([28 * 28]))
            .add(nn.Linear(28 * 28, class_num))
            .add(nn.ReLU(True))
            .add(nn.Linear(class_num, 28 * 28))
            .add(nn.Sigmoid()))


def _to_reconstruction(b):
    """The target is the flattened input (``Train.scala``'s
    toAutoencoderBatch)."""
    from bigdl_tpu_torch.dataset import MiniBatch
    flat = b.data.reshape(b.data.shape[0], -1)
    return MiniBatch(flat, flat)


def train_main(argv=None, device="cuda"):
    """CLI training on ``<folder>/train-*-ubyte``: ``MSECriterion``, SGD
    0.01 with momentum 0.9, ``-e`` epochs at batch ``-b``, ``--checkpoint``
    snapshots every epoch, ``--model``/``--state`` to resume.  Returns the
    trained model."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import Lambda
    from bigdl_tpu_torch.models.lenet import TRAIN_MEAN, TRAIN_STD, _mnist_set
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils.file import File, load_model_snapshot
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("autoencoder-train")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("-b", "--batchSize", type=int, default=150)
    p.add_argument("-e", "--maxEpoch", type=int, default=10)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model", default=None, help="model snapshot to resume")
    p.add_argument("--state", default=None, help="state snapshot to resume")
    args = p.parse_args(argv)
    device = resolve_device(device)

    init_logging()
    train_set = _mnist_set(args.folder, "train", args.batchSize,
                           TRAIN_MEAN, TRAIN_STD) >> \
        Lambda(_to_reconstruction)
    model = Autoencoder(32)
    if args.model:
        load_model_snapshot(model, args.model)
    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=MSECriterion(), device=device)
    optimizer.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    if args.state:
        optimizer.set_state(File.load(args.state))
    optimizer.set_end_when(Trigger.max_epoch(args.maxEpoch))
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return optimizer.optimize()


if __name__ == "__main__":
    train_main()
