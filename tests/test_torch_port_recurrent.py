"""The port's recurrent layers and models (``bigdl_tpu_torch.nn.recurrent``,
``bigdl_tpu_torch.models.rnn``) against the JAX package's.

Both sides get the same seeded numpy parameters (U(-1, 1) for the layers,
``_build``'s draws for the models) and inputs.  Layers: the output and the
gradients of the sum of the output times a seeded random tensor, with
respect to the input, the hidden state and every parameter, within rtol
1e-5 / atol 1e-6 of ``jax.grad``'s (float32; sums in another order), over
10 steps at ``bptt_truncate`` 0 and 4 for each cell.  Models: three SGD
steps of ``SimpleRNN`` (three cells) and ``TextClassifierRNN`` through both
packages' ``Optimizer``: losses within rtol 1e-5, weights within atol
1e-5.  ``train_main``'s losses within atol 1e-4 of the reference's from
the same weights and split (as ``test_torch_port_training_lm.py``), and
``test_main``'s sampled sentences equal to the reference's on one snapshot
with one RNG seed.  The cases mirror ``tests/test_layers_misc.py:316-355,
381-401``, ``tests/test_torch_oracle.py:462-519`` and
``tests/test_model_zoo.py:111-124``.
"""

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.text import LabeledSentence as JLabeledSentence
from bigdl_tpu.dataset.text import \
    LabeledSentenceToSample as JLabeledSentenceToSample
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models import rnn as jrnn
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils import random_generator as jrandom
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import (DataSet, LabeledSentence,
                                     LabeledSentenceToSample, Sample,
                                     SampleToBatch)
from bigdl_tpu_torch.models import rnn as trnn
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils import random_generator as trandom
from tests.test_torch_port_models import _build, _np_params
from tests.test_torch_port_tables import _hold, _n
from tests.test_torch_port_training import jax_losses  # noqa: F401
from tests.test_torch_port_training_lm import _corpus, losses  # noqa: F401

torch.set_num_threads(1)

CELLS = {"rnn": lambda nn, d, h: nn.RnnCell(d, h),
         "rnn-relu": lambda nn, d, h: nn.RnnCell(d, h, "relu"),
         "lstm": lambda nn, d, h: nn.LSTMCell(d, h),
         "gru": lambda nn, d, h: nn.GRUCell(d, h)}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_step_matches_jax(kind):
    """One step through ``Cell.apply``'s table form ``[x_t, hidden]``."""
    hidden = (_n(3, 4, 5), _n(4, 4, 5)) if kind == "lstm" else _n(3, 4, 5)
    tm, out = _hold(lambda nn: CELLS[kind](nn, 6, 5),
                    [_n(2, 4, 6), list(hidden) if kind == "lstm"
                     else hidden])
    assert len(out) == 2 and tuple(out[0].shape) == (4, 5)


@pytest.mark.parametrize("bptt", [0, 4])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_recurrent_matches_jax_over_ten_steps(kind, bptt):
    tm, y = _hold(lambda nn: nn.Recurrent(5, bptt_truncate=bptt)
                  .add(CELLS[kind](nn, 6, 5)), _n(7, 3, 10, 6), seed=1)
    assert tuple(y.shape) == (3, 10, 5)


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru"])
def test_truncation_cuts_the_gradient_at_the_reference_steps(kind):
    """Chunked truncation: at bptt 4 the input gradient of a step before 4
    differs from the full one (the rule acts), and a loss on steps 0-3
    alone gives the same gradients either way (nothing is cut inside the
    first chunk)."""
    x = torch.from_numpy(_n(8, 2, 10, 6))
    grads = []
    for bptt in (0, 4):
        rec = tnn.Recurrent(5, bptt_truncate=bptt).add(
            CELLS[kind](tnn, 6, 5)).reset(3)
        xs = x.clone().requires_grad_(True)
        y = rec(xs)
        (g_all,) = torch.autograd.grad(y.sum(), xs, retain_graph=True)
        (g_head,) = torch.autograd.grad(y[:, :4].sum(), xs)
        grads.append((g_all, g_head))
    assert not torch.allclose(grads[0][0][:, :4], grads[1][0][:, :4])
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=0)


def test_recurrent_matches_an_unrolled_loop():
    """``tests/test_layers_misc.py:318-332``: the RNN's hidden sequence is
    the hand-unrolled tanh recurrence."""
    rec = tnn.Recurrent().add(tnn.RnnCell(3, 5)).reset(0)
    x = _n(9, 2, 4, 3)
    y = rec(torch.from_numpy(x)).detach().numpy()
    cell = rec.layers[0]
    w = {k: getattr(cell, k).detach().numpy()
         for k in ("i2h_w", "i2h_b", "h2h_w", "h2h_b")}
    h = np.zeros((2, 5), np.float32)
    for t in range(4):
        h = np.tanh(x[:, t] @ w["i2h_w"].T + w["i2h_b"] +
                    h @ w["h2h_w"].T + w["h2h_b"])
        np.testing.assert_allclose(y[:, t], h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inner", ["Linear", "LogSoftMax"])
def test_time_distributed_matches_jax(inner):
    make = {"Linear": lambda nn: nn.TimeDistributed(nn.Linear(4, 2)),
            "LogSoftMax": lambda nn: nn.TimeDistributed(nn.LogSoftMax())}
    tm, y = _hold(make[inner], _n(5, 3, 6, 4))
    assert tuple(y.shape)[:2] == (3, 6)


def test_cells_draw_the_reference_ranges():
    rnn, gru = tnn.RnnCell(9, 4).reset(5), tnn.GRUCell(9, 16).reset(5)
    assert rnn.i2h_w.abs().max() <= 1 / 3 and rnn.h2h_w.abs().max() <= 0.5
    assert gru.wi.abs().max() <= 0.25 and tuple(gru.wh.shape) == (48, 16)
    assert tnn.LSTMCell(3, 4).param_tree().keys() == {"wi", "wh", "b"}
    assert isinstance(tnn.LSTMCell(3, 4).zero_hidden(2), tuple)


# -- the models -----------------------------------------------------------------

def _sentences(pkg_sentence, n, vocab, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        s = rng.randint(0, vocab - 1, rng.randint(3, 8))
        out.append(pkg_sentence(s[:-1], s[1:]))
    return out


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_simple_rnn_sgd_steps_match_the_jax_optimizer(cell, jax_losses):  # noqa: F811
    vocab, n = 12, 12
    jm = jrnn.SimpleRNN(vocab, 6, vocab, bptt=2, cell=cell)
    tm = trnn.SimpleRNN(vocab, 6, vocab, bptt=2, cell=cell)
    _build(jm, 4)
    load_jax_params(tm, _np_params(jm))

    def data(sentence, to_sample, ds, batch):
        return ds.array(_sentences(sentence, n, vocab, 5)) >> \
            to_sample(vocab, fix_data_length=7, fix_label_length=7) >> \
            batch(4)

    crit = "TimeDistributedCriterion"
    jopt = JOptimizer(jm, data(JLabeledSentence, JLabeledSentenceToSample,
                               JDataSet, JSampleToBatch),
                      getattr(jnn, crit)(jnn.ClassNLLCriterion(),
                                         size_average=True),
                      JTrigger.max_iteration(3))
    topt = Optimizer(tm, data(LabeledSentence, LabeledSentenceToSample,
                              DataSet, SampleToBatch),
                     getattr(tnn, crit)(tnn.ClassNLLCriterion(),
                                        size_average=True),
                     Trigger.max_iteration(3), device="cpu")
    jopt.set_optim_method(JSGD(learning_rate=0.1))
    topt.set_optim_method(SGD(learning_rate=0.1))
    jopt.optimize()
    topt.optimize()
    got = [r["loss"] for r in topt.step_records]
    assert len(got) == len(jax_losses) == 3
    np.testing.assert_allclose(got, jax_losses, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(_np_params(jm)),
                    jax.tree_util.tree_leaves(export_params(tm))):
        np.testing.assert_allclose(b, a, atol=1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_text_classifier_rnn_sgd_steps_match_the_jax_optimizer(
        cell, jax_losses):  # noqa: F811
    vocab, classes = 30, 4
    jm = jrnn.TextClassifierRNN(vocab, 8, 6, classes, cell)
    tm = trnn.TextClassifierRNN(vocab, 8, 6, classes, cell)
    _build(jm, 6)
    load_jax_params(tm, _np_params(jm))
    rng = np.random.RandomState(7)
    ids = rng.randint(1, vocab + 1, (12, 9)).astype(np.float32)
    labels = rng.randint(1, classes + 1, 12).astype(np.float32)
    jopt = JOptimizer(jm, JDataSet.array([JSample(ids[i], labels[i])
                                          for i in range(12)]) >>
                      JSampleToBatch(4), jnn.ClassNLLCriterion(),
                      JTrigger.max_iteration(3))
    topt = Optimizer(tm, DataSet.array([Sample(ids[i], labels[i])
                                        for i in range(12)]) >>
                     SampleToBatch(4), tnn.ClassNLLCriterion(),
                     Trigger.max_iteration(3), device="cpu")
    jopt.set_optim_method(JSGD(learning_rate=0.5, momentum=0.9))
    topt.set_optim_method(SGD(learning_rate=0.5, momentum=0.9))
    jopt.optimize()
    topt.optimize()
    got = [r["loss"] for r in topt.step_records]
    np.testing.assert_allclose(got, jax_losses, rtol=1e-5)
    assert len(got) == 3 and got[-1] != got[0]
    for a, b in zip(jax.tree_util.tree_leaves(_np_params(jm)),
                    jax.tree_util.tree_leaves(export_params(tm))):
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_text_classifier_rnn_reads_the_last_step():
    m = trnn.TextClassifierRNN(20, 4, 3, 5, "rnn").reset(2)
    ids = torch.randint(1, 21, (2, 6)).float()
    full = m.layers[1](m.layers[0](ids))
    want = m.layers[4](m.layers[3](full[:, -1]))
    torch.testing.assert_close(m(ids), want)


ARGV = ["--vocab", "20", "-h2", "6", "-b", "2", "-e", "1", "--bptt", "3"]


def _from(jax_make, port_make, seed=9):
    """A port model constructor that loads the weights ``jax_make``'s model
    draws from ``_build``'s seeded numpy, so both mains start alike."""
    def build(*args, **kw):
        tm = port_make(*args, **kw)
        load_jax_params(tm, _np_params(_build(jax_make(*args, **kw), seed)))
        return tm
    return build


def test_train_main_matches_jax_on_a_written_corpus(tmp_path, monkeypatch,
                                                    losses):  # noqa: F811
    """Both ``train_main``s on one corpus (10 sentences: 8 train, 2 val;
    four iterations of batch 2), the split seeded alike, from the same
    weights; the port's writes a snapshot pair per epoch."""
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        _corpus(tmp_path / pkg / "input.txt", lines=10, words=6)

    jax_simple = jrnn.SimpleRNN
    monkeypatch.setattr(jrnn, "SimpleRNN",
                        lambda *a, **kw: _build(jax_simple(*a, **kw), 9))
    monkeypatch.setattr(trnn, "SimpleRNN", _from(jax_simple,
                                                 trnn.SimpleRNN))
    jrandom.RNG().set_seed(8)
    trandom.RNG().set_seed(8)
    jrnn.train_main(["-f", str(tmp_path / "jax")] + ARGV)
    model = trnn.train_main(["-f", str(tmp_path / "port"), "--checkpoint",
                             str(tmp_path / "ck")] + ARGV, device="cpu")
    want, got = losses["bigdl_tpu.optim"], losses["bigdl_tpu_torch.optim"]
    assert len(want) == len(got) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert isinstance(model, tnn.Sequential)
    assert (tmp_path / "ck" / "model.4").exists()


def test_test_main_grows_the_reference_sentences(tmp_path, capsys):
    """``train_main --checkpoint`` on the CPU, then both ``test_main``s on
    its snapshot with one RNG seed: the same sampled words, unknown words
    drawn back from the discard list by the same stream."""
    _corpus(tmp_path / "input.txt", lines=12, words=8)
    trandom.RNG().set_seed(4)
    trnn.train_main(["-f", str(tmp_path), "--checkpoint",
                     str(tmp_path / "ck"), "-e", "2", "--vocab", "15",
                     "-b", "2"], device="cpu")
    snap = sorted(p.name for p in (tmp_path / "ck").iterdir()
                  if p.name.startswith("model."))[-1]
    (tmp_path / "test.txt").write_text("w1 w2 w3\nw0 nope w5 w1\n")
    argv = ["-f", str(tmp_path), "--model", str(tmp_path / "ck" / snap),
            "--words", "6", "--vocab", "15"]
    jrandom.RNG().set_seed(11)
    want = jrnn.test_main(argv)
    trandom.RNG().set_seed(11)
    capsys.readouterr()
    got = trnn.test_main(argv, device="cpu")
    assert got == want and len(got) == 2
    assert capsys.readouterr().out.splitlines() == got
    assert [len(s.split()) for s in got] == [9, 10]


def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "input.txt").write_text("a b c\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trnn.train_main(["-f", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trnn.test_main(["-f", str(tmp_path), "--model", "x", "--words",
                        "2"])
    assert not (tmp_path / "dictionary.txt").exists()
