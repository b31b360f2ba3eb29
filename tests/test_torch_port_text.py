"""The port's one-hot sentence encoding, the GloVe text classifier's
helpers and ``example/textclassification.py`` against the JAX package's.

``LabeledSentenceToSample``, ``to_tokens``, ``shaping``,
``vectorization``, ``load_raw_data``, ``analyze_texts`` (its ties broken
by first appearance) and ``build_word2vec`` give the reference's values
exactly.  ``main`` on a staged folder (4 classes of 5 documents, seeded
word vectors, seqLen 160, one epoch at batch 4) gives the reference's
losses within rtol 1e-5 from the same weights (the reference's ``main``
patched to build for that seqLen, which it leaves at 1000, and both
``build_model``s to load one seeded draw; the JAX max pool in Pallas
interpret mode).  The cases mirror ``tests/test_text_pipeline.py:16-83,
170``.
"""

import os

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.example import textclassification as jtc
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import text as ttext
from bigdl_tpu_torch.example import textclassification as ttc
from tests.test_torch_port_models import _build, _np_params
from tests.test_torch_port_training_lm import losses  # noqa: F401

torch.set_num_threads(1)

SENTENCES = [([3, 1, 4, 1, 5], [1, 4, 1, 5, 9]), ([2, 7], [7, 1]),
             ([6], [8]), ([0, 0, 2, 9], [0, 2, 9, 3])]


@pytest.mark.parametrize("fix", [None, 6])
def test_labeled_sentence_to_sample_matches_jax(fix):
    sents = SENTENCES if fix else SENTENCES[2:3]
    want = list(jtext.LabeledSentenceToSample(10, fix, fix)(
        [jtext.LabeledSentence(d, l) for d, l in sents]))
    got = list(ttext.LabeledSentenceToSample(10, fix, fix)(
        [ttext.LabeledSentence(d, l) for d, l in sents]))
    assert len(got) == len(want) == len(sents)
    for g, w in zip(got, want):
        assert g.feature.dtype == np.float32 and g.label.dtype == np.float32
        np.testing.assert_array_equal(g.feature, w.feature)
        np.testing.assert_array_equal(g.label, w.label)
    if fix:
        # padding rows one-hot at the end token, labels at start + 1
        np.testing.assert_array_equal(got[1].feature[2:].argmax(1), [1] * 4)
        np.testing.assert_array_equal(got[1].label, [8, 2, 3, 3, 3, 3])


TEXT = "The cat, the DOG; and the\ncat's toy -- twice: cat cat!"


def test_tokenizer_helpers_match_jax():
    assert ttext.to_tokens(TEXT) == jtext.to_tokens(TEXT)
    w2i = {"cat": 1, "dog": 2, "toy": 5}
    assert ttext.to_tokens(TEXT, w2i) == jtext.to_tokens(TEXT, w2i)
    for n in (3, 12):
        toks = ttext.to_tokens(TEXT, w2i)
        assert ttext.shaping(toks, n) == jtext.shaping(toks, n)
        assert len(ttext.shaping(toks, n)) == n
    w2v = {1: np.arange(4, dtype=np.float32), 5: -np.ones(4, np.float32)}
    toks = [1, 0, 5, 7, 1]
    np.testing.assert_array_equal(ttext.vectorization(toks, 4, w2v),
                                  jtext.vectorization(toks, 4, w2v))


CLASSES, DOCS, EMBED, SEQ = 4, 5, 8, 160


def stage(base, seed=0):
    """``<base>/20_newsgroup/<class>/<n>`` documents of Zipf-drawn common
    words and a few class words, a non-numeric file that is skipped, and
    ``glove.6B/glove.6B.<EMBED>d.txt`` with seeded vectors for most
    words."""
    rng = np.random.RandomState(seed)
    common = [f"w{i}" for i in range(60)]
    words = list(common)
    for c in range(CLASSES):
        cdir = os.path.join(base, "20_newsgroup", f"group.{c}")
        os.makedirs(cdir)
        own = [f"c{c}x{i}" for i in range(5)]
        words += own
        for d in range(DOCS):
            n = rng.randint(90, 220)
            draw = [common[min(k, 60) - 1] for k in rng.zipf(1.3, n)]
            for i in rng.randint(0, n, 12):
                draw[i] = own[rng.randint(5)]
            with open(os.path.join(cdir, str(1000 + d)), "w") as f:
                f.write("Subject: " + " ".join(draw).upper() + ".\n")
        with open(os.path.join(cdir, "README"), "w") as f:
            f.write("not a document\n")
    os.makedirs(os.path.join(base, "glove.6B"))
    with open(os.path.join(base, "glove.6B", f"glove.6B.{EMBED}d.txt"),
              "w") as f:
        for w in words[3:]:
            vec = rng.standard_normal(EMBED)
            f.write(w + " " + " ".join(f"{v:.5f}" for v in vec) + "\n")


def test_corpus_helpers_match_jax(tmp_path):
    stage(str(tmp_path))
    news = str(tmp_path / "20_newsgroup")
    texts, labels = ttc.load_raw_data(news)
    assert (texts, labels) == jtc.load_raw_data(news)
    assert len(texts) == CLASSES * DOCS and sorted(set(labels)) == [1, 2, 3,
                                                                     4]
    for top in (20000, 30):
        w2i = ttc.analyze_texts(texts, top)
        assert list(w2i.items()) == list(jtc.analyze_texts(texts,
                                                           top).items())
    assert len(w2i) == 20 and min(w2i.values()) == 1
    glove = str(tmp_path / "glove.6B")
    got = ttc.build_word2vec(glove, w2i, EMBED)
    want = jtc.build_word2vec(glove, w2i, EMBED)
    assert got.keys() == want.keys() and 0 < len(got) < len(w2i) + 1
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_build_model_gives_one_row_of_classes():
    m = ttc.build_model(20)
    assert isinstance(m.layers[3], tnn.SpatialMaxPooling)
    assert (m.layers[9].kernel_w, m.layers[9].stride_w) == (35, 35)
    y = m(torch.zeros(2, 100, 1000))
    assert tuple(y.shape) == (2, 20)
    with pytest.raises(ValueError, match="too short"):
        ttc.build_model(20, 100, 148)


def test_main_matches_jax_on_a_staged_folder(tmp_path, monkeypatch,
                                             losses):  # noqa: F811
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")
    stage(str(tmp_path))
    jbuild = jtc.build_model

    def jax_built(class_num, embedding_dim=100, sequence_len=1000):
        return _build(jbuild(class_num, embedding_dim, SEQ), 3)

    def port_built(class_num, embedding_dim=100, sequence_len=1000):
        tm = ttc_build(class_num, embedding_dim, sequence_len)
        load_jax_params(tm, _np_params(_build(
            jbuild(class_num, embedding_dim, sequence_len), 3)))
        return tm

    ttc_build = ttc.build_model
    monkeypatch.setattr(jtc, "build_model", jax_built)
    monkeypatch.setattr(ttc, "build_model", port_built)
    argv = ["--baseDir", str(tmp_path), "--maxSequenceLength", str(SEQ),
            "--embeddingDim", str(EMBED), "-b", "4", "-e", "1"]
    jtc.main(argv)
    model = ttc.main(argv, device="cpu")
    want, got = losses["bigdl_tpu.optim"], losses["bigdl_tpu_torch.optim"]
    assert len(want) == len(got) == CLASSES * DOCS * 4 // 5 // 4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    x = torch.zeros(3, EMBED, SEQ)
    assert tuple(model(x).shape) == (3, CLASSES)


def test_main_raises_without_cuda_unless_asked_for_the_cpu(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttc.main(["--baseDir", str(tmp_path)])
