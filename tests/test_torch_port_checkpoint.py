"""The port's File snapshots and resume (``bigdl_tpu_torch.utils.file``,
``LocalOptimizer.set_checkpoint``/``resume_from``, ``train_main
--checkpoint/--model/--state``, ``generate_main``) against the JAX
package's.

Resume in the port is exact: k steps, a snapshot and a fresh trainer give
the losses and the weights of an uninterrupted run bit for bit (the same
CPU math in the same order, the dropout generator's state restored).
Against the JAX trainer, from the same weights and batches without
dropout, the resumed losses agree to rtol 1e-5 in float32 (sums taken in
another order).  ``model.<n>`` files have one format in both packages: a
snapshot written by either loads into the other and gives logits within
1e-5.  ``train_main``'s losses agree with the reference's to 1e-4 (as in
``test_torch_port_training_lm.py``), and greedy ``generate_main`` gives the
reference's sentences.
"""

import logging
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models import transformer as jtransformer
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim.validation import LossResult as JLossResult
from bigdl_tpu.utils import file as jfile
from bigdl_tpu.utils import random_generator as jrandom
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import LeNet5, TransformerLM
from bigdl_tpu_torch.models import transformer as ttransformer
from bigdl_tpu_torch.optim import SGD, Adam, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim.validation import LossResult
from bigdl_tpu_torch.utils import file as tfile
from bigdl_tpu_torch.utils import random_generator as trandom
from bigdl_tpu_torch.utils.durable_io import atomic_write_json
from tests.test_torch_port_models import _build, _np_params
from tests.test_torch_port_training_lm import _corpus

torch.set_num_threads(1)

VOCAB, T_LEN = 30, 12
LM = dict(max_len=T_LEN, embed_dim=16, num_heads=2, num_layers=1)


@pytest.fixture
def losses():
    """Per-step losses of both trainers, from the arguments of their log
    lines, keyed by logger."""
    got = {"bigdl_tpu.optim": [], "bigdl_tpu_torch.optim": []}
    saved = []

    class Grab(logging.Handler):
        def __init__(self, into):
            super().__init__(logging.INFO)
            self.into = into

        def emit(self, record):
            if str(record.msg).startswith("Epoch "):
                self.into.append(record.args[3])

    for name, into in got.items():
        log = logging.getLogger(name)
        handler = Grab(into)
        saved.append((log, handler, log.level))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
    yield got
    for log, handler, level in saved:
        log.removeHandler(handler)
        log.setLevel(level)


def _lm_samples(pkg_sample, n=12, seed=4):
    ids = np.random.RandomState(seed).randint(
        1, VOCAB + 1, (n, T_LEN)).astype(np.float32)
    return [pkg_sample(x, np.roll(x, -1)) for x in ids]


def _lm_trainer(weights, iters, method, dropout=0.3):
    """A 1-layer LM with ``dropout`` over 12 seeded sequences in batches of
    4 (3 steps an epoch, reshuffled at each epoch), from ``weights``."""
    tm = TransformerLM(VOCAB, dropout=dropout, **LM)
    load_jax_params(tm, weights)
    opt = LocalOptimizer(
        tm, tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=True),
        DataSet.array(_lm_samples(Sample)) >> SampleToBatch(4),
        Trigger.max_iteration(iters), device="cpu")
    opt.set_optim_method(method()).set_seed(3)
    return opt


METHODS = {"sgd-momentum": lambda: SGD(learning_rate=0.2, momentum=0.9,
                                       dampening=0.0),
           "adam": lambda: Adam(learning_rate=0.01)}


@pytest.mark.parametrize("overwrite", [False, True],
                         ids=["numbered", "overwrite"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_resume_is_exact(tmp_path, method, overwrite):
    """7 steps straight, against 4 steps with a snapshot (mid-epoch 2) and
    3 more by a fresh trainer that crosses into epoch 3 (a shuffle): equal
    losses and weights, dropout 0.3 drawing the same masks."""
    weights = export_params(TransformerLM(VOCAB, **LM).reset(5))
    straight = _lm_trainer(weights, 7, METHODS[method])
    straight.optimize()
    first = _lm_trainer(weights, 4, METHODS[method])
    first.set_checkpoint(str(tmp_path), Trigger.several_iteration(4))
    if overwrite:
        first.overwrite_checkpoint_()
    first.optimize()
    assert sorted(os.listdir(tmp_path)) == \
        (["model", "state"] if overwrite else ["model.4", "state.4"])
    resumed = _lm_trainer(export_params(TransformerLM(VOCAB, **LM)
                                        .reset(9)), 7, METHODS[method])
    resumed.resume_from(str(tmp_path))
    resumed.optimize()
    want = [r["loss"] for r in straight.step_records]
    got = [r["loss"] for r in first.step_records + resumed.step_records]
    assert got == want and len(got) == 7
    assert [r["epoch"] for r in resumed.step_records] == [2, 2, 3]
    assert resumed.state["neval"] == 7 and resumed.state["epoch"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(export_params(straight.model)),
                    jax.tree_util.tree_leaves(export_params(resumed.model))):
        assert np.array_equal(a, b)
    for k in straight.opt_state:
        for a, b in zip(straight.opt_state[k], resumed.opt_state[k]):
            assert torch.equal(a, b)


def _lenet_pair(iters, seed=11):
    jm, tm = JLeNet5(10), LeNet5(10)
    _build(jm, seed)
    load_jax_params(tm, _np_params(jm))
    rs = np.random.RandomState(2)
    x = rs.standard_normal((24, 28, 28)).astype(np.float32)
    y = rs.randint(1, 11, 24).astype(np.float32)
    jopt = JLocalOptimizer(
        jm, jnn.ClassNLLCriterion(),
        JDataSet.array([JSample(a, b) for a, b in zip(x, y)]) >>
        JSampleToBatch(8), JTrigger.max_iteration(iters))
    topt = LocalOptimizer(
        tm, tnn.ClassNLLCriterion(),
        DataSet.array([Sample(a, b) for a, b in zip(x, y)]) >>
        SampleToBatch(8), Trigger.max_iteration(iters), device="cpu")
    jopt.set_optim_method(JSGD(learning_rate=0.01, momentum=0.9))
    topt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    return jopt, topt


def test_resumed_losses_match_the_jax_trainer(tmp_path, losses):
    """Both trainers snapshot at step 4 (mid-epoch 2 of 3 batches), and
    fresh ones resume to step 7; the port also resumes from the JAX
    trainer's snapshot pair (its momentum tree flattened in leaf order)."""
    jopt, topt = _lenet_pair(4)
    jopt.set_checkpoint(str(tmp_path / "jax"), JTrigger.several_iteration(4))
    topt.set_checkpoint(str(tmp_path / "port"), Trigger.several_iteration(4))
    jopt.optimize()
    topt.optimize()
    np.testing.assert_allclose(losses["bigdl_tpu_torch.optim"],
                               losses["bigdl_tpu.optim"], rtol=1e-5)
    for what in losses.values():
        what.clear()
    jopt, topt = _lenet_pair(7, seed=12)
    jopt.resume_from(str(tmp_path / "jax"))
    topt.resume_from(str(tmp_path / "port"))
    jopt.optimize()
    topt.optimize()
    want, got = losses["bigdl_tpu.optim"], losses["bigdl_tpu_torch.optim"]
    assert len(want) == len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _, cross = _lenet_pair(7, seed=13)
    cross.resume_from(str(tmp_path / "jax"))
    cross.optimize()
    np.testing.assert_allclose([r["loss"] for r in cross.step_records],
                               want, rtol=1e-5)


def _logits_pair(jm, tm, seed=6):
    ids = np.random.RandomState(seed).randint(1, VOCAB + 1, (2, T_LEN))
    want, _ = jm.apply(jm.params, jm.state, ids.astype(np.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    return got.numpy(), np.asarray(want)


def test_model_snapshots_cross_between_the_packages(tmp_path):
    """A JAX-written ``model.<n>`` loads into the port, and one that the
    port's trainer writes loads into JAX's ``load_model_snapshot``."""
    jm = JTransformerLM(VOCAB, **LM)
    jm.build(seed=4)
    jfile.File.save({"params": jm.params, "model_state": jm.state},
                    str(tmp_path / "model.3"))
    tm = tfile.load_model_snapshot(TransformerLM(VOCAB, **LM),
                                   str(tmp_path / "model.3"))
    got, want = _logits_pair(jm, tm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    opt = _lm_trainer(export_params(tm), 1, METHODS["adam"], dropout=0.0)
    opt.set_checkpoint(str(tmp_path / "port"), Trigger.several_iteration(1))
    opt.optimize()
    jback = jfile.load_model_snapshot(JTransformerLM(VOCAB, **LM),
                                      str(tmp_path / "port" / "model.1"))
    assert jback.state == opt.model.state_tree()
    got, want = _logits_pair(jback, opt.model)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # another architecture is refused whole
    other = TransformerLM(VOCAB, **dict(LM, num_layers=2))
    before = [p.clone() for p in other.parameters()]
    with pytest.raises(ValueError, match="does not match the model"):
        tfile.load_model_snapshot(other, str(tmp_path / "model.3"))
    assert all(torch.equal(a, b) for a, b in zip(before, other.parameters()))


def test_latest_snapshot_skips_torn_pairs(tmp_path):
    latest = LocalOptimizer._latest_file_snapshot
    assert latest(str(tmp_path / "missing")) is None
    assert latest(str(tmp_path)) is None
    for name in ("model", "state", "model.4", "state.4", "model.8",
                 "state.12", "state.x", "model.20.tmp"):
        (tmp_path / name).write_bytes(b"")
    # model.8 lacks its state (a crash between the writes), state.12 its
    # model: the newest complete pair is the 4th, before the overwrite pair
    assert latest(str(tmp_path)) == ".4"
    for name in ("model.4", "state.4"):
        (tmp_path / name).unlink()
    assert latest(str(tmp_path)) == ""
    (tmp_path / "model").unlink()
    assert latest(str(tmp_path)) is None


def test_resume_without_a_snapshot(tmp_path, caplog):
    _, opt = _lenet_pair(1)
    opt.resume_from(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no complete model/state"):
        opt.optimize()
    # auto_resume starts fresh when there is none, and resumes when there is
    _, opt = _lenet_pair(2)
    opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(2),
                       auto_resume=True)
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch.optim")
    opt.optimize()
    assert "fresh start" in caplog.text and len(opt.step_records) == 2
    assert sorted(os.listdir(tmp_path)) == ["model.2", "state.2"]
    _, again = _lenet_pair(3)
    again.set_checkpoint(str(tmp_path), Trigger.several_iteration(2),
                         auto_resume=True)
    again.optimize()
    assert [r["step"] for r in again.step_records] == [2]


def test_file_save_load_and_the_refused_classes(tmp_path):
    path = str(tmp_path / "sub" / "snap")
    tfile.File.save({"w": torch.arange(3.0).to(torch.bfloat16),
                     "v": [torch.ones(2)], "t": (1, "a")}, path)
    got = tfile.File.load(path)
    assert got["w"].dtype == np.float32 and got["w"].tolist() == [0, 1, 2]
    assert isinstance(got["v"][0], np.ndarray) and got["t"] == (1, "a")
    assert os.listdir(tmp_path / "sub") == ["snap"]     # no .tmp left
    with pytest.raises(FileExistsError):
        tfile.File.save({}, path)
    tfile.File.save({"x": 1}, path, is_overwrite=True)
    assert tfile.File.load(path) == {"x": 1}
    # the port's validation results load; the JAX package's are refused
    tfile.File.save({"lastValidation": [LossResult(2.0, 4)]}, path, True)
    assert tfile.File.load(path)["lastValidation"][0].result() == (0.5, 4)
    jfile.File.save({"state": {"lastValidation": [JLossResult(2.0, 4)]}},
                    path, True)
    with pytest.raises(ValueError,
                       match="bigdl_tpu.optim.validation.LossResult"):
        tfile.File.load(path)
    with open(path, "wb") as f:
        pickle.dump({"a": jax.numpy.float32}, f)
    with pytest.raises(ValueError, match="jax"):
        tfile.File.load(path)
    # a scheme with a registered opener
    store = {}

    class Mem:
        def __init__(self, p, mode):
            self.p, self.mode = p, mode

        def __enter__(self):
            import io
            if self.mode == "rb":
                if self.p not in store:
                    raise FileNotFoundError(self.p)
                self.f = io.BytesIO(store[self.p])
            else:
                self.f = io.BytesIO()
            return self.f

        def __exit__(self, *exc):
            if self.mode == "wb":
                store[self.p] = self.f.getvalue()

    tfile.register_filesystem("mem", Mem)
    assert tfile.path_scheme("mem://a/b") == "mem"
    tfile.File.save({"k": torch.zeros(2)}, "mem://a/b")
    assert tfile.File.load("mem://a/b")["k"].tolist() == [0.0, 0.0]
    with pytest.raises(FileExistsError):
        tfile.File.save({}, "mem://a/b")
    atomic_write_json(str(tmp_path / "j.json"), {"a": 1})
    assert (tmp_path / "j.json").read_text() == '{"a": 1}'


def _from_jax(vocab, **kw):
    """The port's ``TransformerLM`` with the reference's initial weights
    (``build()``'s PRNGKey(0)), which its trainer draws itself."""
    tm = TransformerLM(vocab, **kw)
    jm = JTransformerLM(vocab, **kw)
    jm.build()
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    return tm


ARGV = ["--vocab", "20", "--embed", "32", "--heads", "4", "--layers", "1",
        "--maxLen", "16", "-b", "2", "-r", "0.5", "-m", "0.9"]


def test_train_main_checkpoint_then_model_and_state(tmp_path, monkeypatch,
                                                    losses):
    """``train_main -e 1 --checkpoint`` and then ``--model/--state -e 2``
    in both packages, on one corpus (2 steps an epoch): equal losses to
    1e-4, and the port's resumed steps equal to its own uninterrupted
    run's 3rd and 4th."""
    monkeypatch.setattr(ttransformer, "TransformerLM", _from_jax)
    runs = {}
    for pkg, main in (("jax", jtransformer.train_main),
                      ("port", lambda a: ttransformer.train_main(
                          a, device="cpu"))):
        d = tmp_path / pkg
        d.mkdir()
        _corpus(d / "input.txt")
        for seed, argv in ((8, ["-e", "1", "--checkpoint", str(d / "ck")]),
                           (8, ["-e", "2", "--model", str(d / "ck/model.2"),
                                "--state", str(d / "ck/state.2")])):
            jrandom.RNG().set_seed(seed)
            trandom.RNG().set_seed(seed)
            main(["-f", str(d)] + ARGV + argv)
        assert sorted(os.listdir(d / "ck")) == ["model.2", "state.2"]
    want, got = losses["bigdl_tpu.optim"], losses["bigdl_tpu_torch.optim"]
    assert len(want) == len(got) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    resumed = list(got[2:])
    got.clear()
    trandom.RNG().set_seed(8)
    ttransformer.train_main(["-f", str(tmp_path / "port")] + ARGV +
                            ["-e", "2"], device="cpu")
    assert got[2:] == resumed


def test_generate_main_greedy_matches_jax(tmp_path, capsys):
    """Both ``generate_main``s, ``--temperature 0``, on one JAX-written
    snapshot and one folder (the reference's tokenizer files, a test.txt
    with an unknown word)."""
    _corpus(tmp_path / "input.txt")
    jrandom.RNG().set_seed(8)
    jtransformer.train_main(["-f", str(tmp_path), "-e", "1", "--checkpoint",
                             str(tmp_path / "ck")] + ARGV)
    (tmp_path / "test.txt").write_text("w1 w2 w3\nw0 nope w5 w1\n")
    argv = ["-f", str(tmp_path), "--model", str(tmp_path / "ck/model.2"),
            "--words", "5", "--vocab", "20", "--embed", "32", "--heads",
            "4", "--layers", "1", "--maxLen", "16", "--temperature", "0"]
    jrandom.RNG().set_seed(3)
    want = jtransformer.generate_main(argv)
    trandom.RNG().set_seed(3)
    capsys.readouterr()
    got = ttransformer.generate_main(argv, device="cpu")
    assert got == want and len(got) == 2
    assert capsys.readouterr().out.splitlines() == got
    assert all(len(s.split()) == n + 5 for s, n in zip(got, (3, 4)))
    # sampled generation draws from the seeded generator, reproducibly
    sampled = []
    for _ in range(2):
        trandom.RNG().set_seed(3)
        sampled.append(ttransformer.generate_main(
            argv + ["--temperature", "0.8", "--topK", "5"], device="cpu"))
    assert sampled[0] == sampled[1]
