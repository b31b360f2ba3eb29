"""Text data pipeline of the language models (``bigdl_tpu/dataset/
text.py``, the part ``TransformerLM``'s ``train_main`` reads).

Parity: ``dataset/text/LabeledSentence.scala`` (index sequences with
per-token labels) and ``models/rnn/Utils.scala:144-258``: ``WordTokenizer``
builds a frequency-ranked dictionary and writes ``dictionary.txt``,
``discard.txt`` and ``mapped_data.txt``; ``Dictionary`` maps words to
indices with an out-of-vocabulary fallback; ``read_sentence`` and
``load_in_data`` (next-token pairs split 80/20 by the host RNG).  Written
files and token ids equal the reference's.  ``LabeledSentenceToTokens``
encodes a sentence as fixed-length 1-based token ids for the transformer
LM, ``LabeledSentenceToSample`` as a one-hot (T, vocab) matrix for the
recurrent LM (``models/rnn.py``).  ``to_tokens``, ``shaping`` and
``vectorization`` are the GloVe text classifier's tokenizer helpers
(``example/textclassification.py``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Sample, Transformer
from bigdl_tpu_torch.utils.random_generator import RNG, shuffle

_SENTENCE_START = "SENTENCE_START"
_SENTENCE_END = "SENTENCE_END"
_SPLIT = re.compile(r"\W+")


class LabeledSentence:
    """An indexed sentence with per-token labels."""

    __slots__ = ("data", "label")

    def __init__(self, data, label):
        self.data = np.asarray(data, np.float32)
        self.label = np.asarray(label, np.float32)

    def data_length(self) -> int:
        return int(self.data.shape[0])

    def label_length(self) -> int:
        return int(self.label.shape[0])

    def __repr__(self):
        return f"LabeledSentence({self.data_length()} tokens)"


class LabeledSentenceToSample(Transformer):
    """LabeledSentence -> Sample with a one-hot ``(data_length,
    vocab_length)`` feature (``dataset/text/LabeledSentenceToSample.scala``).
    Rows past the sentence, up to ``fix_data_length``, are one-hot at its
    end token (the last label; 0 for a one-label sentence); labels shift
    to 1-based, and label padding up to ``fix_label_length`` repeats the
    start token (the first datum) plus one."""

    def __init__(self, vocab_length: int,
                 fix_data_length: Optional[int] = None,
                 fix_label_length: Optional[int] = None):
        self.vocab_length = vocab_length
        self.fix_data_length = fix_data_length
        self.fix_label_length = fix_label_length

    def apply(self, prev):
        for sentence in prev:
            data = sentence.data.astype(np.int64)
            label = sentence.label.astype(np.int64)
            data_length = self.fix_data_length or sentence.data_length()
            label_length = self.fix_label_length or sentence.label_length()
            end_token = 0 if sentence.label_length() == 1 else int(label[-1])
            rows = np.concatenate(
                [data, np.full((data_length - data.shape[0],), end_token,
                               np.int64)])
            feature = np.zeros((data_length, self.vocab_length), np.float32)
            feature[np.arange(data_length), rows] = 1.0
            start_token = float(sentence.data[0])
            lab = np.concatenate(
                [label.astype(np.float32) + 1.0,
                 np.full((label_length - label.shape[0],), start_token + 1.0,
                         np.float32)])
            yield Sample(feature, lab)


class LabeledSentenceToTokens(Transformer):
    """LabeledSentence -> Sample of 1-based token ids of ``fix_length``:
    longer sentences are truncated, shorter ones padded, the features with
    the sentence's end token, the labels with its start token."""

    def __init__(self, fix_length: int):
        self.fix_length = fix_length

    def apply(self, prev):
        for s in prev:
            data = s.data.astype(np.int64)[:self.fix_length]
            label = s.label.astype(np.int64)[:self.fix_length]
            end = 0 if label.shape[0] == 0 else int(label[-1])
            start = 0 if data.shape[0] == 0 else int(data[0])
            pad_d = np.full((self.fix_length - data.shape[0],), end,
                            np.int64)
            pad_l = np.full((self.fix_length - label.shape[0],), start,
                            np.int64)
            yield Sample(
                np.concatenate([data, pad_d]).astype(np.float32) + 1.0,
                np.concatenate([label, pad_l]).astype(np.float32) + 1.0)


class Dictionary:
    """word <-> index.  An unknown word maps to ``length()`` (one past the
    last index); an unknown index maps back to a discarded word drawn from
    the host RNG, or ``UNKNOWN_TOKEN`` when nothing was discarded."""

    def __init__(self, directory: Optional[str] = None,
                 vocab2index: Optional[Dict[str, int]] = None,
                 discard: Optional[Sequence[str]] = None):
        if directory is not None:
            dict_path = os.path.join(directory, "dictionary.txt")
            discard_path = os.path.join(directory, "discard.txt")
            if not os.path.exists(dict_path):
                raise FileNotFoundError("dictionary file not exists!")
            if not os.path.exists(discard_path):
                raise FileNotFoundError("discard file not exists!")
            vocab2index = {}
            with open(dict_path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    word, _, idx = line.partition("->")
                    vocab2index[word.strip()] = int(idx.strip())
            with open(discard_path) as f:
                discard = [l.rstrip("\n") for l in f if l.rstrip("\n")]
        self._vocab2index = dict(vocab2index or {})
        self._index2vocab = {v: k for k, v in self._vocab2index.items()}
        self._discard = list(discard or [])

    def get_index(self, word: str) -> int:
        return self._vocab2index.get(word, len(self._vocab2index))

    def get_word(self, index) -> str:
        index = int(index)
        if index in self._index2vocab:
            return self._index2vocab[index]
        if not self._discard:
            return "UNKNOWN_TOKEN"
        return self._discard[int(RNG().uniform(0, len(self._discard)))]

    def length(self) -> int:
        return len(self._vocab2index)

    def __len__(self) -> int:
        return self.length()


class WordTokenizer:
    """Corpus preprocessor: keeps the ``dictionary_length - 1`` most common
    words and writes ``dictionary.txt`` (``word -> index``), ``discard.txt``
    and ``mapped_data.txt`` (comma-separated indices, one sentence per line,
    each wrapped in SENTENCE_START / SENTENCE_END).  A mapped corpus whose
    dictionary has the asked length is reused as it is."""

    def __init__(self, input_file: str, save_directory: str,
                 dictionary_length: int):
        self.input_file = input_file
        self.save_directory = save_directory
        self.dictionary_length = dictionary_length

    def _cache_matches(self) -> bool:
        dict_path = os.path.join(self.save_directory, "dictionary.txt")
        if not os.path.exists(dict_path):
            return False
        with open(dict_path) as f:
            n = sum(1 for line in f if line.strip())
        return n == self.dictionary_length - 1

    def process(self) -> None:
        mapped = os.path.join(self.save_directory, "mapped_data.txt")
        if os.path.exists(mapped) and self._cache_matches():
            return
        with open(self.input_file) as f:
            lines = [l.rstrip("\n") for l in f if l.rstrip("\n")]
        freq: Dict[str, int] = {}
        tokenized = []
        for line in lines:
            toks = [t for t in _SPLIT.split(
                f"{_SENTENCE_START} {line} {_SENTENCE_END}") if t]
            tokenized.append(toks)
            for t in toks:
                freq[t] = freq.get(t, 0) + 1
        # ascending frequency (stable): keep the most common
        by_freq = sorted(freq.items(), key=lambda kv: kv[1])
        keep = min(self.dictionary_length - 1, len(by_freq))
        vocab = [w for w, _ in by_freq[len(by_freq) - keep:]]
        discard = [w for w, _ in by_freq[:len(by_freq) - keep]]
        word2index = {w: i for i, w in enumerate(vocab)}
        os.makedirs(self.save_directory, exist_ok=True)
        with open(os.path.join(self.save_directory, "dictionary.txt"),
                  "w") as f:
            f.write("\n".join(f"{w} -> {i}" for w, i in word2index.items()))
        with open(os.path.join(self.save_directory, "discard.txt"),
                  "w") as f:
            f.write("\n".join(discard))
        with open(mapped, "w") as f:
            f.write("\n".join(
                ",".join(str(word2index.get(t, len(vocab))) for t in toks)
                for toks in tokenized))


def read_sentence(directory: str) -> List[List[str]]:
    """The tokenized lines of ``test.txt``."""
    path = os.path.join(directory, "test.txt")
    if not os.path.exists(path):
        raise FileNotFoundError("test file not exists!")
    with open(path) as f:
        return [[t for t in _SPLIT.split(l.rstrip("\n")) if t] for l in f]


def load_in_data(folder: str, dictionary_size: int, split: float = 0.8,
                 seed: Optional[int] = None
                 ) -> Tuple[List[LabeledSentence], List[LabeledSentence],
                            int, int]:
    """Next-token (input, target) pairs of ``mapped_data.txt``, shuffled
    (by ``np.random.RandomState(seed)``, or the thread's host RNG when
    ``seed`` is None) and split ``split`` / rest into (train, val,
    train_max_len, val_max_len).  ``dictionary_size`` is unused, as in the
    reference."""
    del dictionary_size
    with open(os.path.join(folder, "mapped_data.txt")) as f:
        seqs = [[int(x) for x in l.strip().split(",")]
                for l in f if l.strip()]
    pairs = [(s[:-1], s[1:]) for s in seqs if len(s) >= 2]
    order = list(range(len(pairs)))
    if seed is not None:
        np.random.RandomState(seed).shuffle(order)
    else:
        shuffle(order)
    n_train = int(np.floor(len(order) * split))
    train = [LabeledSentence(*pairs[i]) for i in order[:n_train]]
    val = [LabeledSentence(*pairs[i]) for i in order[n_train:]]
    train_max = max((s.data_length() for s in train), default=0)
    val_max = max((s.data_length() for s in val), default=0)
    return train, val, train_max, val_max


# -- the GloVe text classifier's tokenizer helpers ----------------------------

def to_tokens(text: str, word2meta: Optional[Dict[str, int]] = None
              ) -> List:
    """Lower-cased words split on non-word characters; with
    ``word2meta``, only the known words, as their indices."""
    words = [w for w in _SPLIT.split(text.lower()) if w]
    if word2meta is None:
        return words
    return [word2meta[w] for w in words if w in word2meta]


def shaping(tokens: List, sequence_len: int, pad=0) -> List:
    """``tokens`` cut or right-padded with ``pad`` to ``sequence_len``."""
    out = list(tokens[:sequence_len])
    out.extend([pad] * (sequence_len - len(out)))
    return out


def vectorization(tokens: Sequence, embedding_dim: int,
                  word2vec: Dict) -> np.ndarray:
    """A (len, embedding_dim) float32 matrix of the tokens' vectors, zero
    for a token without one."""
    out = np.zeros((len(tokens), embedding_dim), np.float32)
    for i, t in enumerate(tokens):
        vec = word2vec.get(t)
        if vec is not None:
            out[i] = vec
    return out
