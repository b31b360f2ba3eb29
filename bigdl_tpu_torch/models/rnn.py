"""The recurrent language model and text classifier
(``bigdl_tpu/models/rnn.py``).

``SimpleRNN`` (``models/rnn/SimpleRNN.scala``): one-hot tokens ->
``Recurrent`` (an ``RnnCell``, or an ``LSTMCell`` or ``GRUCell``) with
truncated BPTT -> ``TimeDistributed(Linear)`` -> ``TimeDistributed(
LogSoftMax)``.  ``TextClassifierRNN``: ``LookupTable`` -> ``Recurrent`` ->
the last step's hidden state -> ``Linear`` -> ``LogSoftMax``.

``train_main`` and ``test_main`` are the reference's mains
(``models/rnn/Train.scala:35-105``, ``Test.scala:39-92``) with their flags
and defaults, on ``device`` (CUDA by default; they raise without CUDA
unless asked for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.file import File, load_model_snapshot


def _cell(kind: str, input_size: int, hidden_size: int):
    return {"rnn": lambda: nn.RnnCell(input_size, hidden_size, "tanh"),
            "lstm": lambda: nn.LSTMCell(input_size, hidden_size),
            "gru": lambda: nn.GRUCell(input_size, hidden_size)}[kind]()


def SimpleRNN(input_size: int = 100, hidden_size: int = 40,
              output_size: int = 100, bptt: int = 4,
              cell: str = "rnn") -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.Recurrent(hidden_size, bptt_truncate=bptt)
                 .add(_cell(cell, input_size, hidden_size)))
            .add(nn.TimeDistributed(nn.Linear(hidden_size, output_size)))
            .add(nn.TimeDistributed(nn.LogSoftMax())))


def TextClassifierRNN(vocab_size: int, embed_dim: int = 128,
                      hidden_size: int = 128, class_num: int = 20,
                      cell: str = "lstm") -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.LookupTable(vocab_size, embed_dim))
            .add(nn.Recurrent(hidden_size)
                 .add(_cell(cell, embed_dim, hidden_size)))
            .add(nn.Select(2, -1))          # (B, T, H) -> (B, H)
            .add(nn.Linear(hidden_size, class_num))
            .add(nn.LogSoftMax()))


def train_main(argv=None, device="cuda"):
    """CLI training of ``SimpleRNN`` on next-token prediction: the
    ``WordTokenizer`` over ``<folder>/input.txt`` (``--vocab`` words and
    the unknown one), ``load_in_data``'s 80/20 split by the host RNG,
    one-hot sentences padded to the longest of their split in batches of
    ``-b`` (the last short one dropped), per-token ``ClassNLLCriterion``
    averaged over time, SGD, validation by ``Loss`` every epoch.
    ``--model`` starts from a ``model.<n>`` snapshot, ``--state`` resumes a
    ``state.<n>`` snapshot's progress and optimizer state, and
    ``--checkpoint <dir>`` writes a snapshot pair every epoch.  Returns
    the trained model."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import (DataSet, LabeledSentenceToSample,
                                         SampleToBatch, WordTokenizer,
                                         load_in_data)
    from bigdl_tpu_torch.optim import SGD, Loss, Optimizer, Trigger

    p = argparse.ArgumentParser("rnn-train")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", default=None, help="model snapshot location")
    p.add_argument("--state", default=None, help="state snapshot location")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("-r", "--learningRate", type=float, default=0.1)
    p.add_argument("-m", "--momentum", type=float, default=0.0)
    p.add_argument("--weightDecay", type=float, default=0.0)
    p.add_argument("--dampening", type=float, default=0.0)
    p.add_argument("-h2", "--hidden", type=int, default=40)
    p.add_argument("--vocab", type=int, default=4000)
    p.add_argument("--bptt", type=int, default=4)
    p.add_argument("-e", "--nEpochs", type=int, default=30)
    p.add_argument("-b", "--batchSize", type=int, default=8)
    args = p.parse_args(argv)
    device = resolve_device(device)

    dictionary_length = args.vocab + 1
    WordTokenizer(f"{args.folder}/input.txt", args.folder,
                  dictionary_length=dictionary_length).process()
    train, val, train_max, val_max = load_in_data(args.folder,
                                                  dictionary_length)
    train_set = DataSet.array(train) >> \
        LabeledSentenceToSample(dictionary_length, fix_data_length=train_max,
                                fix_label_length=train_max) >> \
        SampleToBatch(args.batchSize, drop_last=True)
    val_set = DataSet.array(val) >> \
        LabeledSentenceToSample(dictionary_length, fix_data_length=val_max,
                                fix_label_length=val_max) >> \
        SampleToBatch(args.batchSize, drop_last=True)

    model = SimpleRNN(input_size=dictionary_length, hidden_size=args.hidden,
                      output_size=dictionary_length, bptt=args.bptt)
    if args.model:
        load_model_snapshot(model, args.model)
    criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                            size_average=True)
    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=criterion, device=device)
    optimizer.set_optim_method(SGD(
        learning_rate=args.learningRate, momentum=args.momentum,
        weight_decay=args.weightDecay, dampening=args.dampening))
    optimizer.set_end_when(Trigger.max_epoch(args.nEpochs))
    optimizer.set_validation(Trigger.every_epoch(), val_set,
                             [Loss(criterion)])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    if args.state:
        optimizer.set_state(File.load(args.state))
    return optimizer.optimize()


def test_main(argv=None, device="cuda"):
    """CLI generation: the ``SimpleRNN`` of a ``model.<n>`` snapshot extends
    each ``test.txt`` sentence by ``--words`` tokens, each drawn from the
    last step's softmax by a uniform of the host RNG
    (``utils/random_generator.py``, the reference's stream) against the
    cumulative probabilities.  Prints the grown sentences and returns
    them."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import Dictionary, read_sentence
    from bigdl_tpu_torch.utils.random_generator import RNG

    p = argparse.ArgumentParser("rnn-test")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True)
    p.add_argument("--words", type=int, required=True)
    p.add_argument("-h2", "--hidden", type=int, default=40)
    p.add_argument("--vocab", type=int, default=4000)
    args = p.parse_args(argv)
    device = resolve_device(device)

    vocab = Dictionary(args.folder)
    dictionary_length = args.vocab + 1
    model = SimpleRNN(input_size=dictionary_length, hidden_size=args.hidden,
                      output_size=dictionary_length)
    load_model_snapshot(model, args.model)
    model.to(device).evaluate()

    sentences = [[float(vocab.get_index(t)) for t in line]
                 for line in read_sentence(args.folder)]
    rng = RNG()
    for _ in range(args.words):
        grown = []
        for seq in sentences:
            onehot = np.zeros((1, len(seq), dictionary_length), np.float32)
            onehot[0, np.arange(len(seq)), np.asarray(seq, np.int64)] = 1.0
            with torch.inference_mode():
                out = model(torch.from_numpy(onehot).to(device))[0, -1]
            out = out.cpu().numpy()
            probs = np.exp(out - out.max())
            probs /= probs.sum()
            nxt = int(np.searchsorted(np.cumsum(probs),
                                      rng.uniform(0.0, 1.0)))
            grown.append(seq + [float(min(nxt, dictionary_length - 1))])
        sentences = grown
    results = [" ".join(vocab.get_word(t) for t in seq) for seq in sentences]
    for line in results:
        print(line)
    return results


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["test"]:
        test_main(sys.argv[2:])
    else:
        train_main()
