"""The port's trainer (``bigdl_tpu_torch.optim``) against the JAX package's.

Both trainers start from the same weights (built in ``bigdl_tpu`` from a
seed and copied with ``load_jax_params``), read the same seeded numpy
samples through ``DataSet.array(...) >> SampleToBatch(...)`` (the same
shuffle stream, so the same batches in the same order) and run the same
SGD.  Per-step losses agree to rtol 1e-4 and the final weights, exported
with ``export_params``, to atol 1e-4 in float32 (sums taken in another
order); under mixed precision, where the two frameworks round to bf16 at
other places, the losses agree to rtol 2e-2.  The narrow Inception stack
runs the JAX side in Pallas interpret mode, so its kernels K1-K4 are on
that path.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.core import init as jinit
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.inception import inception_module as j_inception_module
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Poly as JPoly
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Top1Accuracy as JTop1
from bigdl_tpu.optim import Top5Accuracy as JTop5
from bigdl_tpu.optim import Trigger as JTrigger
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.core import init as tinit
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import LeNet5, inception_module
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Poly, Top1Accuracy,
                                   Top5Accuracy, Trigger)
from tests.test_torch_port_models import _build, _np_params

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)


def _samples(pkg_sample, n, shape, classes, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = rng.randint(1, classes + 1, size=n).astype(np.float32)
    return [pkg_sample(x[i], y[i]) for i in range(n)]


@pytest.fixture
def jax_losses():
    """Per-step losses of the JAX trainer, from the arguments of its log
    line ("Epoch %d %d/%d loss %.6f ...", unrounded).  The handler sits on
    the trainer's own logger, so it sees the records however other tests
    left propagation and levels."""
    losses = []

    class Grab(logging.Handler):
        def emit(self, record):
            if str(record.msg).startswith("Epoch "):
                losses.append(record.args[3])

    log = logging.getLogger("bigdl_tpu.optim")
    handler, level = Grab(logging.INFO), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    yield losses
    log.removeHandler(handler)
    log.setLevel(level)


def _train_both(jmodel, tmodel, make_sgd, pair_seed, n, batch, iters, shape,
                classes, mixed=False, validate=False):
    _build(jmodel, pair_seed)
    load_jax_params(tmodel, _np_params(jmodel))
    jopt = JLocalOptimizer(
        jmodel, jnn.ClassNLLCriterion(),
        JDataSet.array(_samples(JSample, n, shape, classes, 1)) >>
        JSampleToBatch(batch), JTrigger.max_iteration(iters))
    topt = LocalOptimizer(
        tmodel, tnn.ClassNLLCriterion(),
        DataSet.array(_samples(Sample, n, shape, classes, 1)) >>
        SampleToBatch(batch), Trigger.max_iteration(iters), device="cpu")
    jopt.set_optim_method(make_sgd(JSGD, JPoly))
    topt.set_optim_method(make_sgd(SGD, Poly))
    if mixed:
        jopt.set_mixed_precision(True)
        topt.set_mixed_precision(True)
    if validate:
        val = _samples(JSample, batch, shape, classes, 2)
        jopt.set_validation(JTrigger.several_iteration(iters),
                            JDataSet.array(val) >> JSampleToBatch(batch),
                            [JTop1(), JTop5()])
        tval = _samples(Sample, batch, shape, classes, 2)
        topt.set_validation(Trigger.several_iteration(iters),
                            DataSet.array(tval) >> SampleToBatch(batch),
                            [Top1Accuracy(), Top5Accuracy()])
    jopt.optimize()
    topt.optimize()
    return jopt, topt


def _assert_weights_close(jmodel, tmodel, atol):
    jleaves = jax.tree_util.tree_leaves(_np_params(jmodel))
    tleaves = jax.tree_util.tree_leaves(export_params(tmodel))
    assert len(jleaves) == len(tleaves) > 0
    for a, b in zip(jleaves, tleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def _lenet_sgd(sgd, poly):
    return sgd(learning_rate=0.05, momentum=0.9, weight_decay=2e-4,
               learning_rate_schedule=poly(0.5, 6))


def test_lenet5_trajectory_matches_jax_local_optimizer(jax_losses):
    jm, tm = JLeNet5(10), LeNet5(10)
    jopt, topt = _train_both(jm, tm, _lenet_sgd, pair_seed=3, n=48,
                             batch=16, iters=6, shape=(28, 28), classes=10,
                             validate=True)
    tl = [r["loss"] for r in topt.step_records]
    jl = list(jax_losses)
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert [r["epoch"] for r in topt.step_records] == [1, 1, 1, 2, 2, 2]
    assert (topt.state["epoch"], topt.state["neval"]) == \
        (jopt.state["epoch"], jopt.state["neval"]) == (3, 6)
    _assert_weights_close(jm, tm, atol=1e-4)
    assert topt.state["lastValidation"] == jopt.state["lastValidation"]


def _narrow_stack(pkg, init):
    """Inception stem (ceil pool, LRN) + one narrow inception module + pool
    + linear, no dropout."""
    nn, mod = pkg
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 16, 7, 7, 2, 2, 3, 3,
                                       init_method=init))
            .add(nn.ReLU(True))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(nn.SpatialCrossMapLRN(5, 0.5, 0.75))
            .add(mod(16, 8, 8, 12, 4, 6, 6, "inception_x/"))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(nn.SpatialAveragePooling(4, 4, 1, 1))
            .add(nn.View(32).set_num_input_dims(3))
            .add(nn.Linear(32, 10, init_method=init))
            .add(nn.LogSoftMax()))


def _stack_sgd(sgd, poly):
    return sgd(learning_rate=0.05, weight_decay=2e-4, momentum=0.9,
               dampening=0.0, learning_rate_schedule=poly(0.5, 3))


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16-mixed"])
def test_narrow_inception_trajectory_matches_jax_kernels(monkeypatch,
                                                         jax_losses, mixed):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")
    jm = _narrow_stack((jnn, j_inception_module), jinit.XAVIER)
    tm = _narrow_stack((tnn, inception_module), tinit.XAVIER)
    ops.reset_launches()
    _, topt = _train_both(jm, tm, _stack_sgd, pair_seed=5, n=8, batch=4,
                          iters=3, shape=(3, 32, 32), classes=10,
                          mixed=mixed)
    tl = [r["loss"] for r in topt.step_records]
    jl = list(jax_losses)
    assert len(tl) == len(jl) == 3 and np.isfinite(tl).all()
    if mixed:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        _assert_weights_close(jm, tm, atol=1e-4)
    # on the CPU every wrapper took its plain version
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


def test_mid_epoch_state_resumes_at_the_reference_batch(jax_losses):
    """A bare ``set_state`` in mid-epoch (epoch 2, 16 of 48 records
    trained) skips the records the state says were trained, as the
    reference's resume fast-forward does: both trainers take batches 3-6 of
    epoch 2's shuffle, then the first of epoch 3's.  A remainder smaller
    than a batch raises in both."""
    from bigdl_tpu.utils.table import T as JT
    from bigdl_tpu_torch.utils.table import T

    jm, tm = JLeNet5(10), LeNet5(10)
    _build(jm, 7)
    load_jax_params(tm, _np_params(jm))

    def pair(records, iters):
        jopt = JLocalOptimizer(
            jm, jnn.ClassNLLCriterion(),
            JDataSet.array(_samples(JSample, 48, (28, 28), 10, 1)) >>
            JSampleToBatch(8), JTrigger.max_iteration(iters))
        topt = LocalOptimizer(
            tm, tnn.ClassNLLCriterion(),
            DataSet.array(_samples(Sample, 48, (28, 28), 10, 1)) >>
            SampleToBatch(8), Trigger.max_iteration(iters), device="cpu")
        for opt, sgd, t in ((jopt, JSGD, JT), (topt, SGD, T)):
            opt.set_optim_method(sgd(learning_rate=0.05))
            opt.set_state(t(epoch=2, neval=8,
                            recordsProcessedThisEpoch=records))
        return jopt, topt

    jopt, topt = pair(16, 13)
    jopt.optimize()
    topt.optimize()
    tl = [r["loss"] for r in topt.step_records]
    assert len(tl) == len(jax_losses) == 5
    np.testing.assert_allclose(tl, jax_losses, rtol=1e-5)
    assert [r["epoch"] for r in topt.step_records] == [2, 2, 2, 2, 3]
    assert (topt.state["epoch"], topt.state["neval"]) == \
        (jopt.state["epoch"], jopt.state["neval"]) == (3, 13)
    for opt in pair(12, 10):
        with pytest.raises(ValueError, match="resume skip remainder 4"):
            opt.optimize()
