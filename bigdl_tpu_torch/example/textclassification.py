"""Text classifier: GloVe embeddings and a temporal conv net over 20
Newsgroups (``bigdl_tpu/example/textclassification.py``).

Parity: ``example/textclassification/TextClassifier.scala:46-203``.
``<baseDir>/20_newsgroup/`` holds a folder per category of numerically
named documents and ``<baseDir>/glove.6B/glove.6B.<dim>d.txt`` the word
vectors.  The documents are tokenized, the ``maxWordsNum`` most frequent
words are kept less the 10 most frequent, and each document becomes an
(embeddingDim, seqLen) matrix of its first words' vectors (zero for a word
without one, and for the padding).  The model is the reference's: three
convolutions of width 5 over the one-row plane, each with a ReLU and a max
pool (1x5/5, 1x5/5, then the rest of the row: 1x35/35 at seqLen 1000),
then two ``Linear``s and ``LogSoftMax``; it trains with Adagrad
(learningRate 0.01, learningRateDecay 0.0002) and reports Top-1 on the
held-out 20 % every epoch.  The pools run the port's max-pool kernels
(K1 forward, K3 backward) on the card.

``main`` builds the model for ``--maxSequenceLength`` (the reference's
``main`` builds it for 1000 whatever the flag says, and a shorter length
fails its ``Reshape``); at the default the two are the same.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Tuple

import numpy as np

import bigdl_tpu_torch.nn as nn

logger = logging.getLogger("bigdl_tpu_torch.example.textclassification")


def build_model(class_num: int, embedding_dim: int = 100,
                sequence_len: int = 1000) -> nn.Sequential:
    """``TextClassifier.buildModel``: temporal convolutions as
    ``SpatialConvolution`` over an (embeddingDim, 1, seqLen) input; the last
    pool spans what is left of the row (35 at seqLen 1000)."""
    last = ((sequence_len - 4) // 5 - 4) // 5 - 4
    if last < 1:
        raise ValueError(
            f"sequence_len {sequence_len} too short for the conv stack")
    return (nn.Sequential()
            .add(nn.Reshape([embedding_dim, 1, sequence_len]))
            .add(nn.SpatialConvolution(embedding_dim, 128, 5, 1))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(5, 1, 5, 1))
            .add(nn.SpatialConvolution(128, 128, 5, 1))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(5, 1, 5, 1))
            .add(nn.SpatialConvolution(128, 128, 5, 1))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(last, 1, last, 1))
            .add(nn.Reshape([128]))
            .add(nn.Linear(128, 100))
            .add(nn.Linear(100, class_num))
            .add(nn.LogSoftMax()))


def load_raw_data(text_data_dir: str) -> Tuple[List[str], List[float]]:
    """``TextClassifier.loadRawData``: (text, 1-based label) of every
    numerically named document, categories in folder-name order."""
    texts, labels = [], []
    categories = sorted(d for d in os.listdir(text_data_dir)
                        if os.path.isdir(os.path.join(text_data_dir, d)))
    for label_id, cat in enumerate(categories, start=1):
        cdir = os.path.join(text_data_dir, cat)
        for fname in sorted(os.listdir(cdir)):
            fpath = os.path.join(cdir, fname)
            if os.path.isfile(fpath) and fname.isdigit():
                with open(fpath, encoding="ISO-8859-1") as f:
                    texts.append(f.read())
                labels.append(float(label_id))
    logger.info("Found %d texts, %d classes", len(texts), len(set(labels)))
    return texts, labels


def analyze_texts(texts: List[str], max_words_num: int) -> Dict[str, int]:
    """``TextClassifier.analyzeTexts``: word -> 1-based rank by frequency
    (ties in first-seen order, Python's sort being stable), less the 10
    most frequent words, up to rank ``max_words_num`` - 10."""
    from bigdl_tpu_torch.dataset.text import to_tokens
    freq: Dict[str, int] = {}
    for t in texts:
        for w in to_tokens(t):
            freq[w] = freq.get(w, 0) + 1
    ranked = sorted(freq.items(), key=lambda kv: -kv[1])[10:max_words_num]
    return {w: i + 1 for i, (w, _) in enumerate(ranked)}


def build_word2vec(glove_dir: str, word2index: Dict[str, int],
                   embedding_dim: int = 100) -> Dict[int, np.ndarray]:
    """``TextClassifier.buildWord2Vec``: the GloVe vector of every known
    word, keyed by its index."""
    path = os.path.join(glove_dir, f"glove.6B.{embedding_dim}d.txt")
    out: Dict[int, np.ndarray] = {}
    with open(path, encoding="ISO-8859-1") as f:
        for line in f:
            values = line.rstrip().split(" ")
            if values[0] in word2index:
                out[word2index[values[0]]] = np.asarray(values[1:],
                                                        np.float32)
    logger.info("Found %d word vectors", len(out))
    return out


def load_samples(base_dir: str, sequence_len: int = 1000,
                 max_words_num: int = 20000, embedding_dim: int = 100):
    """Every document of ``<base_dir>/20_newsgroup`` as a Sample of its
    (embedding_dim, sequence_len) matrix and 1-based label; returns
    (samples, class count)."""
    from bigdl_tpu_torch.dataset import (Sample, shaping, to_tokens,
                                         vectorization)
    texts, labels = load_raw_data(os.path.join(base_dir, "20_newsgroup"))
    word2index = analyze_texts(texts, max_words_num)
    word2vec = build_word2vec(os.path.join(base_dir, "glove.6B"), word2index,
                              embedding_dim)
    samples = []
    for text, label in zip(texts, labels):
        tokens = shaping(to_tokens(text, word2index), sequence_len)
        vec = vectorization(tokens, embedding_dim, word2vec)
        samples.append(Sample(vec.T.copy(), np.asarray(label)))
    return samples, len(set(labels))


def split_samples(samples, training_split: float = 0.8):
    """The reference's split: a permutation by ``RandomState(42)``, the
    first ``training_split`` of it to train, the rest to validate."""
    order = np.random.RandomState(42).permutation(len(samples))
    n_train = int(len(samples) * training_split)
    return ([samples[i] for i in order[:n_train]],
            [samples[i] for i in order[n_train:]])


def main(argv=None, device="cuda"):
    """CLI training of the classifier on ``device`` (CUDA by default; it
    raises without CUDA unless asked for the CPU); batches of ``-b``, the
    last short one dropped.  Returns the trained model."""
    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.optim import Adagrad, Optimizer, Top1Accuracy, Trigger
    from bigdl_tpu_torch.utils.table import T

    p = argparse.ArgumentParser("text-classifier")
    p.add_argument("--baseDir", default="./")
    p.add_argument("--maxSequenceLength", type=int, default=1000)
    p.add_argument("--maxWordsNum", type=int, default=20000)
    p.add_argument("--trainingSplit", type=float, default=0.8)
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("--embeddingDim", type=int, default=100)
    p.add_argument("-e", "--maxEpoch", type=int, default=20)
    args = p.parse_args(argv)
    device = resolve_device(device)

    samples, class_num = load_samples(args.baseDir, args.maxSequenceLength,
                                      args.maxWordsNum, args.embeddingDim)
    train, val = split_samples(samples, args.trainingSplit)
    train_set = DataSet.array(train) >> SampleToBatch(args.batchSize,
                                                      drop_last=True)
    val_set = DataSet.array(val) >> SampleToBatch(args.batchSize,
                                                  drop_last=True)
    model = build_model(class_num, args.embeddingDim, args.maxSequenceLength)
    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=nn.ClassNLLCriterion(), device=device)
    optimizer.set_optim_method(Adagrad())
    optimizer.set_config(T(learningRate=0.01, learningRateDecay=0.0002))
    optimizer.set_end_when(Trigger.max_epoch(args.maxEpoch))
    optimizer.set_validation(Trigger.every_epoch(), val_set,
                             [Top1Accuracy()])
    return optimizer.optimize()


if __name__ == "__main__":
    main()
