"""The port's TransformerLM training (``remat``, ``Adam``, ``Warmup``, the
text pipeline, ``train_main`` and ``longcontext_perf_main``) against the
JAX package.

Both trainers start from the same weights (the JAX model's, carried by
``load_jax_params``) and read the same seeded batches.  At T 2112 and head
dim 64 the keys pass the reference's 512 KB budget, so its training
attention runs the streaming kernel K9 and the flash backward K10/K11
(in Pallas interpret mode) and the port's runs the same autograd function
that the card runs, on the plain versions.  Per-step losses agree to rtol
1e-4 and the weights to atol 1e-4 in float32 (sums taken in another
order); under bf16 mixed precision, where the two frameworks round at
other places, the losses agree to rtol 2e-2 (as for Inception-v1).  Adam
and Warmup agree with the reference's updates to rtol 1e-5 / atol 1e-6
over 5 steps (the bias corrections are rounded to f32 at other places).
The text pipeline writes the same files and the same token ids;
``train_main`` on a corpus the test writes gives the same losses to 1e-4.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models import transformer as jtransformer
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import optim_method as joptim
from bigdl_tpu.utils import random_generator as jrandom
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.dataset import text as ttext
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models import perf as tperf
from bigdl_tpu_torch.models import transformer as ttransformer
from bigdl_tpu_torch.ops import attention as tattn
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim import optim_method as toptim
from bigdl_tpu_torch.utils import random_generator as trandom
from bigdl_tpu_torch.utils.table import T

torch.set_num_threads(1)

# keys past the reference's 512 KB K/V budget at head dim 64: K9 + K10/K11
LONG_T, VOCAB, EMBED, HEADS = 2112, 50, 64, 1


@pytest.fixture
def losses():
    """Per-step losses of both trainers, from the arguments of their log
    lines ("Epoch %d %d/%d loss %.6f ...", unrounded), keyed by logger."""
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


def _lm_pair(layers, remat, dropout=0.0, seed=0, vocab=VOCAB, t=LONG_T):
    kw = dict(max_len=t, embed_dim=EMBED, num_heads=HEADS, num_layers=layers,
              dropout=dropout, remat=remat)
    jm = JTransformerLM(vocab, **kw)
    jm.build(seed=seed)
    tm = TransformerLM(vocab, **kw)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _lm_samples(pkg_sample, n, t, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, VOCAB + 1, (n, t)).astype(np.float32)
    return [pkg_sample(x, np.roll(x, -1)) for x in ids]


@pytest.mark.parametrize("remat,mixed", [(False, False), (True, False),
                                         (True, True)],
                         ids=["f32", "f32-remat", "bf16-mixed-remat"])
def test_lm_training_steps_match_jax_through_the_flash_backward(
        monkeypatch, losses, remat, mixed):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")
    jm, tm = _lm_pair(1, remat)
    steps = 2
    jopt = JLocalOptimizer(
        jm, jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                         size_average=True),
        JDataSet.array(_lm_samples(JSample, 2, LONG_T, 1)) >>
        JSampleToBatch(1), JTrigger.max_iteration(steps))
    topt = LocalOptimizer(
        tm, tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=True),
        DataSet.array(_lm_samples(Sample, 2, LONG_T, 1)) >>
        SampleToBatch(1), Trigger.max_iteration(steps), device="cpu")
    jopt.set_optim_method(JSGD(learning_rate=0.5))
    topt.set_optim_method(SGD(learning_rate=0.5))
    if mixed:
        jopt.set_mixed_precision(True)
        topt.set_mixed_precision(True)
    seen = []
    real = tattn._K9.apply
    monkeypatch.setattr(tattn._K9, "apply",
                        lambda *a: seen.append(1) or real(*a))
    jopt.optimize()
    topt.optimize()
    # one K9 forward per step, and one more per step recomputed under remat
    assert len(seen) == steps * (2 if remat else 1)
    want, got = losses["bigdl_tpu.optim"], losses["bigdl_tpu_torch.optim"]
    assert len(want) == len(got) == steps
    np.testing.assert_allclose(got, want, rtol=2e-2 if mixed else 1e-4)
    if not mixed:
        jleaves = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jm.params))
        tleaves = jax.tree_util.tree_leaves(export_params(tm))
        assert len(jleaves) == len(tleaves) > 0
        for a, b in zip(jleaves, tleaves):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


# head dim 256, the wgmma kernels' largest (embed 512 over 2 heads), and
# 320 (embed 640 over 2 heads), which the D-chunked kernels take; the key-
# padding mask routes both frameworks' attention to the streaming kernels
D256 = dict(max_len=64, embed_dim=512, num_heads=2, num_layers=2)
D320 = dict(D256, embed_dim=640)


@pytest.mark.parametrize("what", ["eval", "step"])
def test_head_dim_256_lm_matches_jax(monkeypatch, what):
    """Eval log-probs (rtol/atol 1e-4) and one SGD step (the loss to rtol
    1e-5, each gradient to 1e-4 of its largest magnitude plus 1e-7, the
    stepped model's log-probs to 1e-4) of a head-dim-256 LM through the port's K9
    autograd function (the plain versions here) against JAX's K9 and flash
    backward in interpret mode."""
    _wide_head_lm_matches_jax(monkeypatch, what, D256)


@pytest.mark.parametrize("what", ["eval", "step"])
def test_head_dim_320_lm_matches_jax(monkeypatch, what):
    """As the head-dim-256 test, at head dim 320 (padded to no other size:
    a multiple of the D-chunked kernels' 64-column panel)."""
    _wide_head_lm_matches_jax(monkeypatch, what, D320)


def _wide_head_lm_matches_jax(monkeypatch, what, config):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")
    jm = JTransformerLM(VOCAB, **config)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(VOCAB, **config)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    rs = np.random.RandomState(7)
    ids = rs.randint(1, VOCAB + 1, (2, 65))
    x, y = ids[:, :-1], ids[:, 1:]
    kpm = np.ones((2, 64), bool)
    kpm[1, 40:] = False
    jx, jkpm = jnp.asarray(x), jnp.asarray(kpm)
    tx, tkpm = torch.from_numpy(x), torch.from_numpy(kpm)
    seen = []
    real = tattn._K9.apply
    monkeypatch.setattr(tattn._K9, "apply",
                        lambda *a: seen.append(1) or real(*a))
    if what == "eval":
        want, _ = jm.apply(params, state, jx, key_padding_mask=jkpm)
        with torch.inference_mode():
            got = tm.evaluate()(tx, key_padding_mask=tkpm)
        assert len(seen) == config["num_layers"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        return

    def jloss(p):
        logp, _ = jm.apply(p, state, jx, training=True,
                           key_padding_mask=jkpm)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[..., None],
                                             -1))

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    tm.training_()
    logp = tm(tx, key_padding_mask=tkpm)
    loss = -logp.gather(-1, torch.from_numpy(y)[..., None]).mean()
    loss.backward()
    assert len(seen) == config["num_layers"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, want_grads))
    tleaves = list(tm.param_leaves())
    assert len(jleaves) == len(tleaves) > 0
    for w, p in zip(jleaves, tleaves):   # plus 1e-7: the key bias's
        np.testing.assert_allclose(      # gradient is zero but for rounding
            p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-7)
    lr = 0.1
    stepped = jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                     want_grads)
    with torch.no_grad():
        for p in tleaves:
            p.sub_(lr * p.grad)
        got = tm.evaluate()(tx, key_padding_mask=tkpm)
    want, _ = jm.apply(stepped, state, jx, key_padding_mask=jkpm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16-mixed"])
def test_remat_gives_the_gradients_of_the_plain_forward_with_dropout(mixed):
    """A recomputed block draws the same dropout mask as its forward did
    (the generator is rewound for the recompute and put back after), and
    runs on the parameters the forward saw (``mixed_forward``'s casts)."""
    from bigdl_tpu_torch.core.precision import mixed_forward
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        1, VOCAB + 1, (2, 136)))
    out = []
    for remat in (False, True):
        _, tm = _lm_pair(2, remat, dropout=0.3, t=136)
        gen = torch.Generator().manual_seed(7)
        tm.set_generator(gen).training_()
        y = mixed_forward(tm, ids) if mixed else tm(ids)
        (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
        out.append(([p.grad.clone() for p in tm.param_leaves()],
                    gen.get_state()))
    (plain, g0), (remat, g1) = out
    assert torch.equal(g0, g1)      # the generator ends where it would
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def _update_both(jmethod, tmethod, schedule_pair=None, steps=5):
    rs = np.random.RandomState(11)
    shapes = [(4, 3), (5,)]
    params = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    jp, tp = list(map(jax.numpy.asarray, params)), \
        [torch.from_numpy(p.copy()) for p in params]
    js, ts = jmethod.init_state(jp), tmethod.init_state(tp)
    for step in range(steps):
        grads = [rs.standard_normal(s).astype(np.float32) for s in shapes]
        cfg_j, cfg_t = T(), T()
        if schedule_pair is not None:
            st = T(evalCounter=step, epoch=1)
            cfg_j["clr"] = schedule_pair[0].current_rate(
                jmethod.defaults.clone(), st)
            cfg_t["clr"] = schedule_pair[1].current_rate(
                tmethod.defaults.clone(), st)
            assert cfg_j["clr"] == cfg_t["clr"]
        jp, js = jmethod.update(list(map(jax.numpy.asarray, grads)), jp, js,
                                cfg_j, jax.numpy.asarray(step, np.int32))
        tp, ts = tmethod.update([torch.from_numpy(g) for g in grads], tp, ts,
                                cfg_t, step)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["plain", "weight-decay"])
def test_adam_matches_jax_over_five_updates(wd):
    _update_both(joptim.Adam(learning_rate=0.01, weight_decay=wd),
                 toptim.Adam(learning_rate=0.01, weight_decay=wd))


def test_adam_with_warmup_matches_jax_over_five_updates():
    jw, tw = joptim.Warmup(3), toptim.Warmup(3)
    rates = [tw.current_rate(T(learningRate=0.1), T(evalCounter=i))
             for i in range(5)]
    assert rates == [jw.current_rate(T(learningRate=0.1), T(evalCounter=i))
                     for i in range(5)]
    assert rates == pytest.approx([-0.1 / 3, -0.2 / 3, -0.1, -0.1, -0.1])
    _update_both(joptim.Adam(learning_rate=0.05, learning_rate_schedule=jw),
                 toptim.Adam(learning_rate=0.05, learning_rate_schedule=tw),
                 (jw, tw))
    # with a schedule after the ramp, its counter re-zeroed at the boundary
    jw = joptim.Warmup(3, after=joptim.Poly(0.5, 10))
    tw = toptim.Warmup(3, after=toptim.Poly(0.5, 10))
    rates = [tw.current_rate(T(learningRate=0.1), T(evalCounter=i))
             for i in range(15)]
    assert rates == [jw.current_rate(T(learningRate=0.1), T(evalCounter=i))
                     for i in range(15)]
    assert rates[3] == -0.1 and rates[13] == 0.0 and rates[14] == 0.0
    _update_both(joptim.Adam(learning_rate=0.05, learning_rate_schedule=jw),
                 toptim.Adam(learning_rate=0.05, learning_rate_schedule=tw),
                 (jw, tw), steps=8)


def _corpus(path, lines=6, words=12, types=40, seed=3):
    """A corpus of seeded Zipf-drawn words, so the dictionary fills and
    discards."""
    rs = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(types)]
    with open(path, "w") as f:
        for _ in range(lines):
            draw = np.minimum(rs.zipf(1.3, words), types) - 1
            f.write(" ".join(vocab[i] for i in draw) + ".\n")


def test_text_pipeline_writes_the_reference_files_and_ids(tmp_path):
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        _corpus(d / "input.txt", lines=20)
        tok = jtext.WordTokenizer if pkg == "jax" else ttext.WordTokenizer
        tok(str(d / "input.txt"), str(d), dictionary_length=15).process()
    for name in ("dictionary.txt", "discard.txt", "mapped_data.txt"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / "discard.txt").read_text()  # it discards
    # seeded splits, by RandomState and by the host RNG, give the same ids
    jrandom.RNG().set_seed(21)
    trandom.RNG().set_seed(21)
    for seed in (4, None):
        want = jtext.load_in_data(str(tmp_path / "jax"), 15, seed=seed)
        got = ttext.load_in_data(str(tmp_path / "port"), 15, seed=seed)
        assert got[2:] == want[2:]
        for ws, gs in zip(want[:2], got[:2]):
            assert len(ws) == len(gs) > 0
            for w, g in zip(ws, gs):
                assert np.array_equal(w.data, g.data)
                assert np.array_equal(w.label, g.label)
    fix = 9
    want = [(s.feature, s.label) for s in jtext.LabeledSentenceToTokens(fix)(
        iter(jtext.load_in_data(str(tmp_path / "jax"), 15, seed=4)[0]))]
    got = [(s.feature, s.label) for s in ttext.LabeledSentenceToTokens(fix)(
        iter(ttext.load_in_data(str(tmp_path / "port"), 15, seed=4)[0]))]
    assert len(got) == len(want)
    for (wf, wl), (gf, gl) in zip(want, got):
        assert np.array_equal(wf, gf) and np.array_equal(wl, gl)
    jd, td = jtext.Dictionary(str(tmp_path / "jax")), \
        ttext.Dictionary(str(tmp_path / "port"))
    assert td.length() == jd.length() == 14
    assert [td.get_index(w) for w in ("w0", "w1", "nope")] == \
        [jd.get_index(w) for w in ("w0", "w1", "nope")]
    jrandom.RNG().set_seed(2)
    trandom.RNG().set_seed(2)
    assert [td.get_word(i) for i in (0, 3, 99, 99)] == \
        [jd.get_word(i) for i in (0, 3, 99, 99)]
    (tmp_path / "port" / "test.txt").write_text("a b, c\nd\n")
    assert ttext.read_sentence(str(tmp_path / "port")) == \
        [["a", "b", "c"], ["d"]]


def test_sample_to_batch_drops_the_last_short_batch():
    samples = [Sample(np.full(3, i, np.float32), np.zeros(3, np.float32))
               for i in range(5)]
    sizes = [b.size() for b in SampleToBatch(2, drop_last=True)(samples)]
    assert sizes == [2, 2]
    assert [b.size() for b in SampleToBatch(2)(samples)] == [2, 2, 1]
    with pytest.raises(NotImplementedError, match="DistriOptimizer slice"):
        SampleToBatch(2, feature_padding=0.0)


def test_train_main_matches_jax_on_a_written_corpus(tmp_path, monkeypatch,
                                                    losses):
    """Both ``train_main``s on one corpus (6 sentences: 4 train, 2 val; two
    iterations of batch 2), the split seeded alike, from the reference's
    initial weights (``build()``'s PRNGKey(0))."""
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        _corpus(tmp_path / pkg / "input.txt")
    argv = ["--vocab", "20", "--embed", "32", "--heads", "4", "--layers",
            "1", "--maxLen", "16", "-b", "2", "-e", "1", "-r", "0.5",
            "--optim", "adam", "--warmup", "2"]

    def from_jax(vocab, **kw):
        tm = TransformerLM(vocab, **kw)
        jm = JTransformerLM(vocab, **kw)
        jm.build()
        load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
        return tm

    monkeypatch.setattr(ttransformer, "TransformerLM", from_jax)
    jrandom.RNG().set_seed(8)
    trandom.RNG().set_seed(8)
    jtransformer.train_main(["-f", str(tmp_path / "jax")] + argv)
    model = ttransformer.train_main(["-f", str(tmp_path / "port")] + argv,
                                    device="cpu")
    want, got = losses["bigdl_tpu.optim"], losses["bigdl_tpu_torch.optim"]
    assert len(want) == len(got) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert isinstance(model, TransformerLM) and model.max_len == 16


def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "input.txt").write_text("a b c\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttransformer.train_main(["-f", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tperf.longcontext_perf_main(["-t", "16"])
    # a remat model trains through the trainer, which takes the device rule
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalOptimizer(TransformerLM(10, max_len=8, remat=True),
                       tnn.ClassNLLCriterion(), DataSet.array([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttransformer.generate_main(["-f", str(tmp_path), "--model", "x",
                                    "--words", "2"])
    with pytest.raises(NotImplementedError, match="DistriOptimizer slice"):
        tperf.main(["distri"])
    assert not os.path.exists(tmp_path / "dictionary.txt")


def test_longcontext_perf_main_trains_on_the_cpu(caplog):
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch.models.perf")
    toks = tperf.longcontext_perf_main(
        ["-t", "72", "-l", "1", "-e", "32", "--heads", "2", "--vocab", "40",
         "-i", "2"], device="cpu")
    assert toks > 0
    rec = [r for r in caplog.records if "tokens/sec" in r.getMessage()]
    assert len(rec) == 1
    first, last = rec[0].args[-2:]
    assert np.isfinite(first) and np.isfinite(last) and last < first
