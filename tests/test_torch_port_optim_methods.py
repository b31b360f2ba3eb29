"""The learning-rate schedules and optim methods of the port
(``bigdl_tpu_torch.optim``: ``EpochDecay``, ``EpochSchedule``/``Regime``,
``Cosine``, ``Warmup(after=)``, ``Adagrad``, ``AdamW``) against the JAX
package's.

The schedules give the reference's rate exactly at every (iteration,
epoch) of the grid; the updates see the same seeded numpy gradients and
parameters agree to rtol 1e-5 / atol 1e-6 after every step (float32 on
both sides, the same operations in another framework).  Through the
trainers, a small classifier trained by both ``LocalOptimizer``s from the
same weights on the same batches gives the same losses to rtol 1e-5 and
the same weights to atol 1e-5.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.resnet import cifar10_decay as j_cifar10_decay
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import optim_method as joptim
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import cifar10_decay
from bigdl_tpu_torch.utils.table import T

torch.set_num_threads(1)


def _schedules(pkg, table, decay):
    """The schedules of the slice, built in one package."""
    return {
        "epoch-decay": pkg.EpochDecay(decay),
        "epoch-schedule": pkg.EpochSchedule([
            pkg.Regime(1, 2, table(learningRate=0.1, weightDecay=1e-4)),
            pkg.Regime(3, 4, table(learningRate=0.02)),
            pkg.Regime(5, 9, table(learningRate=0.004))]),
        "cosine": pkg.Cosine(8, min_ratio=0.1),
        "cosine-to-zero": pkg.Cosine(5),
        "warmup-poly": pkg.Warmup(3, after=pkg.Poly(0.5, 10)),
        "warmup-cosine": pkg.Warmup(2, after=pkg.Cosine(6, 0.2)),
    }


GRID = [(it, ep) for it, ep in zip(range(16), [1, 1, 2, 2, 3, 3, 4, 4, 5, 5,
                                               80, 81, 121, 122, 165, 166])]


@pytest.mark.parametrize("name", sorted(_schedules(toptim, T,
                                                   cifar10_decay)))
def test_schedule_rates_match_jax(name):
    js = _schedules(joptim, JT, j_cifar10_decay)[name]
    ts = _schedules(toptim, T, cifar10_decay)[name]
    got, want = [], []
    for it, ep in GRID:
        got.append(ts.current_rate(T(learningRate=0.1),
                                   T(evalCounter=it, epoch=ep)))
        want.append(js.current_rate(JT(learningRate=0.1),
                                    JT(evalCounter=it, epoch=ep)))
    assert got == want
    assert len(set(got)) > 2          # the grid moves every schedule


def test_epoch_schedule_updates_the_config_as_the_reference():
    cfg_t, cfg_j = T(learningRate=0.5), JT(learningRate=0.5)
    _schedules(toptim, T, cifar10_decay)["epoch-schedule"].current_rate(
        cfg_t, T(epoch=2))
    _schedules(joptim, JT, j_cifar10_decay)["epoch-schedule"].current_rate(
        cfg_j, JT(epoch=2))
    assert dict(cfg_t) == dict(cfg_j) == {"learningRate": 0.1,
                                          "weightDecay": 1e-4}


def _methods(pkg, schedule):
    return {
        "adagrad": lambda: pkg.Adagrad(learning_rate=0.1,
                                       learning_rate_decay=0.05),
        "adagrad-wd": lambda: pkg.Adagrad(learning_rate=0.05,
                                          weight_decay=0.01),
        "adamw": lambda: pkg.AdamW(learning_rate=0.01),
        "adamw-cosine": lambda: pkg.AdamW(
            learning_rate=0.02, weight_decay=0.05,
            learning_rate_schedule=schedule(pkg, "cosine")),
        "adam-l2": lambda: pkg.Adam(learning_rate=0.01, weight_decay=0.05),
        "sgd-nesterov-epoch-decay": lambda: pkg.SGD(
            learning_rate=0.1, weight_decay=1e-4, momentum=0.9,
            dampening=0.0, nesterov=True,
            learning_rate_schedule=schedule(pkg, "epoch-decay")),
        "sgd-epoch-schedule": lambda: pkg.SGD(
            momentum=0.9, learning_rate_schedule=schedule(
                pkg, "epoch-schedule")),
        "sgd-warmup-poly": lambda: pkg.SGD(
            learning_rate=0.2, momentum=0.5,
            learning_rate_schedule=schedule(pkg, "warmup-poly")),
    }


def _schedule(pkg, name):
    if pkg is toptim:
        return _schedules(toptim, T, cifar10_decay)[name]
    return _schedules(joptim, JT, j_cifar10_decay)[name]


@pytest.mark.parametrize("name", sorted(_methods(toptim, _schedule)))
def test_updates_match_jax_over_several_steps(name):
    """Each method for 7 steps on the same gradients, the rate from its
    schedule on the host (as both trainers pass it, in ``config["clr"]``)
    over the grid's iterations and epochs."""
    jm = _methods(joptim, _schedule)[name]()
    tm = _methods(toptim, _schedule)[name]()
    rs = np.random.RandomState(21)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for step, (_, epoch) in enumerate(GRID[:7]):
        grads = [rs.standard_normal(s).astype(np.float32) for s in shapes]
        cfg_j, cfg_t = JT(), T()
        sched_j = getattr(jm, "schedule", None) or joptim.Default()
        sched_t = getattr(tm, "schedule", None) or toptim.Default()
        cfg_j["clr"] = sched_j.current_rate(
            jm.defaults.clone(), JT(evalCounter=step, epoch=epoch))
        cfg_t["clr"] = sched_t.current_rate(
            tm.defaults.clone(), T(evalCounter=step, epoch=epoch))
        assert cfg_j["clr"] == cfg_t["clr"]
        jp, js = jm.update([jnp.asarray(g) for g in grads], jp, js, cfg_j,
                           jnp.asarray(step, jnp.int32))
        tp, ts = tm.update([torch.from_numpy(g) for g in grads], tp, ts,
                           cfg_t, step)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
    assert sorted(ts) == sorted(js)


def test_adamw_is_adam_with_the_decoupled_flag():
    w = toptim.AdamW(learning_rate=0.01)
    assert isinstance(w, toptim.Adam) and w.decoupled
    assert w.defaults["weightDecay"] == 0.01
    assert not toptim.Adam().decoupled


@pytest.fixture
def losses():
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


def _classifier(nn):
    return (nn.Sequential().add(nn.Linear(6, 8)).add(nn.Tanh())
            .add(nn.Linear(8, 4)).add(nn.LogSoftMax()))


@pytest.mark.parametrize("name", ["adagrad", "adamw-cosine",
                                  "sgd-epoch-schedule"])
def test_trainers_agree_under_the_new_methods(losses, name):
    """8 steps of 3 batches an epoch (so the epoch schedules move) by both
    trainers from the same weights on the same batches."""
    rs = np.random.RandomState(5)
    x = rs.standard_normal((12, 6)).astype(np.float32)
    y = rs.randint(1, 5, size=12).astype(np.float32)
    jm = _classifier(jnn)
    jm.build(seed=3)
    tm = _classifier(tnn)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    jopt = JLocalOptimizer(
        jm, jnn.ClassNLLCriterion(),
        JDataSet.array([JSample(a, b) for a, b in zip(x, y)]) >>
        JSampleToBatch(4), JTrigger.max_iteration(8))
    topt = toptim.LocalOptimizer(
        tm, tnn.ClassNLLCriterion(),
        DataSet.array([Sample(a, b) for a, b in zip(x, y)]) >>
        SampleToBatch(4), toptim.Trigger.max_iteration(8), device="cpu")
    jopt.set_optim_method(_methods(joptim, _schedule)[name]())
    topt.set_optim_method(_methods(toptim, _schedule)[name]())
    jopt.optimize()
    topt.optimize()
    got, want = losses["bigdl_tpu_torch.optim"], losses["bigdl_tpu.optim"]
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(export_params(tm)),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
