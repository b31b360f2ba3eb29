"""BatchNorm with running statistics, the table containers, ``Padding``,
ResNet and Inception-v2 of the port (``bigdl_tpu_torch``) against the JAX
package.

Both sides get the same seeded numpy parameters and module state (running
means small, running variances positive, BN weights near 1, as a trained
model has them), copied with ``load_jax_params`` and ``load_jax_state``,
and see the same numpy inputs.  float32 outputs, gradients, running
statistics and weights agree to rtol/atol 1e-4 (sums taken in another
order); the full-width ResNet-50 and Inception-v2 log-probabilities to
atol 1e-3, as the full Inception-v1 in ``test_torch_port_models.py``.  The
bf16 mixed forward is held in bf16 steps of the largest magnitude: the
reference rounds the batch mean, the inverse deviation and the affine to
bf16 one by one, ``F.batch_norm`` normalises in f32 and rounds once.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.core.precision import mixed_forward as j_mixed_forward
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.inception import Inception_v2 as JInception_v2
from bigdl_tpu.models.inception import \
    inception_module_v2 as j_inception_module_v2
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.optim import EpochDecay as JEpochDecay
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Top1Accuracy as JTop1
from bigdl_tpu.optim import Trigger as JTrigger
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.convert import (export_params, export_state,
                                     load_jax_params, load_jax_state)
from bigdl_tpu_torch.core.precision import mixed_forward
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import (Inception_v2, ResNet, cifar10_decay,
                                    inception_module_v2)
from bigdl_tpu_torch.optim import (SGD, EpochDecay, LocalOptimizer,
                                   SKIPPED_STEPS, Top1Accuracy, Trigger)
from bigdl_tpu_torch.utils import file as tfile

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)


def bf16_steps(ref, steps):
    """``steps`` bfloat16 rounding steps at the largest magnitude of
    ``ref``."""
    return steps * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _draw_bn_tree(shapes, rng):
    """Seeded numpy leaves for a params or state tree of ``shapes``: a BN
    weight U(0.5, 1.5), a running mean U(-0.1, 0.1), a running variance
    U(0.5, 1.5), a weight of rank >= 2 Xavier-uniform, any other leaf
    U(-0.05, 0.05)."""
    def draw(path, leaf):
        name = getattr(path[-1], "key", None) if path else None
        shape = leaf.shape
        if name == "running_mean":
            return rng.uniform(-0.1, 0.1, shape).astype(np.float32)
        if name == "running_var" or (name == "weight" and len(shape) == 1):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if len(shape) >= 2:
            field = int(np.prod(shape[2:]))
            bound = np.sqrt(6.0 / ((shape[0] + shape[1]) * field))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        return rng.uniform(-0.05, 0.05, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _build(jmodel, seed):
    """Seeded numpy params and state in the tree ``jmodel.init`` makes
    (shapes from ``jax.eval_shape``, nothing compiled)."""
    rng = np.random.RandomState(seed)
    params, state = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed))
    jmodel.params = _draw_bn_tree(params, rng)
    jmodel.state = _draw_bn_tree(state, rng)
    return jmodel


def _pair(jmodel, tmodel, seed):
    _build(jmodel, seed)
    load_jax_params(tmodel, jmodel.params)
    load_jax_state(tmodel, jmodel.state)
    return jmodel, tmodel


def _apply_both(jmodel, tmodel, x, training, jit=True):
    """Both forwards on ``x``; returns (jax out, jax new state, port out),
    the port's state moved in place."""
    fn = lambda p, s, v: jmodel.apply(p, s, v, training=training)
    if jit:
        fn = jax.jit(fn)
    a, new_state = fn(jmodel.params, jmodel.state, jnp.asarray(x))
    tmodel.train(training)
    with torch.no_grad():
        b = tmodel(torch.from_numpy(x))
    return a, new_state, b


def _assert_tree_close(got, want, rtol=1e-4, atol=1e-4):
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


# -- BatchNormalization ------------------------------------------------------

BN_CASES = [(jnn.BatchNormalization, tnn.BatchNormalization, (8, 5)),
            (jnn.SpatialBatchNormalization, tnn.SpatialBatchNormalization,
             (4, 5, 6, 7))]


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", BN_CASES, ids=["2d", "4d"])
def test_batch_norm_matches_jax(case, training, eps, affine):
    """Forward, the running statistics after 3 forwards, and the gradients
    of x, weight and bias against ``jax.grad``."""
    jcls, tcls, shape = case
    n = shape[1]
    jm, tm = _pair(jcls(n, eps, affine=affine), tcls(n, eps, affine=affine),
                   seed=n)
    rng = np.random.RandomState(3)
    xs = [(rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
          for _ in range(3)]
    initial = export_state(tm)
    for x in xs:
        a, new_state, b = _apply_both(jm, tm, x, training, jit=False)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)
        jm.state = new_state
    _assert_tree_close(export_state(tm), jm.state, rtol=1e-5, atol=1e-6)
    if not training:
        assert all(np.array_equal(export_state(tm)[k], initial[k])
                   for k in initial)

    r = rng.standard_normal(shape).astype(np.float32)

    def jloss(p, v):
        y, _ = jm.apply(p, jm.state, v, training=training)
        return jnp.sum(y * r)
    gp, gx = jax.grad(jloss, argnums=(0, 1))(jm.params, jnp.asarray(xs[0]))
    x = torch.from_numpy(xs[0]).requires_grad_(True)
    tm.train(training)
    (tm(x) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    if affine:
        for k in ("weight", "bias"):
            np.testing.assert_allclose(getattr(tm, k).grad.numpy(),
                                       np.asarray(gp[k]), rtol=1e-4,
                                       atol=1e-4)
    else:
        assert tm.param_tree() == {} and not list(tm.parameters())


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_bf16_mixed_forward_moves_the_f32_buffers(training):
    """Under ``mixed_forward`` the running statistics stay f32, move in
    the module's own buffers (no temporary bf16 copy), and follow the
    reference's f32 state; the output is within 2 bf16 steps."""
    shape = (6, 5, 4, 4)
    jm = (jnn.Sequential().add(jnn.SpatialBatchNormalization(5, 1e-3))
          .add(jnn.ReLU()))
    tm = (tnn.Sequential().add(tnn.SpatialBatchNormalization(5, 1e-3))
          .add(tnn.ReLU()))
    _pair(jm, tm, seed=9)
    tm.train(training)
    x = (np.random.RandomState(4).standard_normal(shape) * 3 + 1) \
        .astype(np.float32)
    a, new_state = j_mixed_forward(jm, jm.params, jm.state, jnp.asarray(x),
                                   training=training)
    buffers = [b.data_ptr() for b in tm.state_leaves()]
    with torch.no_grad():
        b = mixed_forward(tm, torch.from_numpy(x))
    assert b.dtype == torch.float32
    assert [t.data_ptr() for t in tm.state_leaves()] == buffers
    assert all(t.dtype == torch.float32 for t in tm.state_leaves())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    a = np.asarray(a)
    np.testing.assert_allclose(b.numpy(), a, rtol=0,
                               atol=bf16_steps(a, 2))
    _assert_tree_close(export_state(tm), new_state, rtol=1e-5, atol=1e-6)
    moved = not np.array_equal(export_state(tm)[0]["running_mean"],
                               np.asarray(jm.state[0]["running_mean"]))
    assert moved == training


# -- tables and Padding ---------------------------------------------------

def test_concat_table_cadd_table_and_identity_match_jax():
    def block(nn):
        return (nn.Sequential()
                .add(nn.ConcatTable()
                     .add(nn.Sequential().add(nn.Linear(6, 6))
                          .add(nn.ReLU(True)))
                     .add(nn.Identity())
                     .add(nn.Linear(6, 6)))
                .add(nn.CAddTable(True)))
    jm, tm = _pair(block(jnn), block(tnn), seed=2)
    x = np.random.RandomState(2).standard_normal((3, 6)).astype(np.float32)
    a, _, b = _apply_both(jm, tm, x, training=False, jit=False)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                               atol=1e-6)
    table = tnn.ConcatTable().add(tnn.Identity()).add(tnn.Identity())
    t = torch.from_numpy(x)
    out = table(t)
    assert isinstance(out, list) and len(out) == 2
    assert torch.equal(tnn.CAddTable()(out), 2 * t)
    # the add is out of place: autograd through both branches works
    t.requires_grad_(True)
    tnn.CAddTable(True)(table(t)).sum().backward()
    assert torch.equal(t.grad, torch.full_like(t, 2.0))


@pytest.mark.parametrize("dim, pad, n_input_dim, shape", [
    (1, 3, 3, (2, 4, 5)), (1, -2, 3, (2, 4, 5)), (1, 3, 3, (6, 2, 4, 5)),
    (1, -2, 3, (6, 2, 4, 5)), (3, 2, 3, (6, 2, 4, 5)), (2, -1, 2, (3, 4))],
    ids=["after", "before", "batched-after", "batched-before",
         "last-axis", "2d-before"])
def test_padding_matches_jax(dim, pad, n_input_dim, shape):
    x = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    jm = jnn.Padding(dim, pad, n_input_dim, value=0.5)
    tm = tnn.Padding(dim, pad, n_input_dim, value=0.5)
    a, _ = jm.apply((), (), jnp.asarray(x))
    b = tm(torch.from_numpy(x))
    assert b.shape == a.shape
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_cross_entropy_criterion_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((6, 7)).astype(np.float32)
    t = rng.randint(1, 8, size=6).astype(np.float32)
    w = rng.uniform(0.5, 2, 7).astype(np.float32)
    for kw in ({}, {"weights": w}, {"size_average": False}):
        a = jnn.CrossEntropyCriterion(**kw).apply(jnp.asarray(x),
                                                  jnp.asarray(t))
        b = tnn.CrossEntropyCriterion(**kw)(torch.from_numpy(x),
                                            torch.from_numpy(t))
        np.testing.assert_allclose(b.item(), float(a), rtol=1e-6)


# -- ResNet and Inception-v2 ----------------------------------------------

@pytest.mark.parametrize("shortcut", ["A", "B", "C"])
def test_cifar_resnet_depth_8_matches_jax(shortcut):
    """A training forward (output and running statistics) then an eval
    forward on the moved statistics."""
    jm, tm = _pair(JResNet(10, 8, shortcut, "cifar10"),
                   ResNet(10, 8, shortcut, "cifar10"), seed=8)
    x = np.random.RandomState(8).standard_normal((3, 3, 32, 32)) \
        .astype(np.float32)
    a, new_state, b = _apply_both(jm, tm, x, training=True)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                               atol=1e-4)
    _assert_tree_close(export_state(tm), new_state)
    jm.state = new_state
    a, _, b = _apply_both(jm, tm, x, training=False)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("pool, stride", [("max", 2), ("max", 1),
                                          ("avg", 1)])
def test_narrow_inception_module_v2_matches_jax(pool, stride):
    args = (16, 0 if stride == 2 else 8, 8, 12, 4, 6, 0 if stride == 2
            else 6)
    jm, tm = _pair(j_inception_module_v2(*args, pool=pool, stride=stride),
                   inception_module_v2(*args, pool=pool, stride=stride),
                   seed=4)
    x = np.random.RandomState(4).standard_normal((2, 16, 14, 14)) \
        .astype(np.float32)
    for training in (True, False):
        a, new_state, b = _apply_both(jm, tm, x, training)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4)
        _assert_tree_close(export_state(tm), new_state)
        jm.state = new_state


@pytest.mark.parametrize("size", [28, 14, 7])
def test_inception_v2_average_pool_divisors_match_jax(size):
    """``SpatialAveragePooling(3, 3, 1, 1, 1, 1, ceil_mode=True)`` as
    Inception-v2 runs it seven times, at the widths it sees."""
    x = np.random.RandomState(size).standard_normal((2, 3, size, size)) \
        .astype(np.float32)
    jm = jnn.SpatialAveragePooling(3, 3, 1, 1, 1, 1, ceil_mode=True)
    tm = tnn.SpatialAveragePooling(3, 3, 1, 1, 1, 1, ceil_mode=True)
    a, _ = jm.apply((), (), jnp.asarray(x))
    b = tm(torch.from_numpy(x))
    assert b.shape == a.shape == (2, 3, size, size)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("which", ["resnet50", "inception_v2"])
def test_full_width_eval_forward_matches_jax(which):
    if which == "resnet50":
        jm, tm = JResNet(1000, 50, "B", "imagenet"), ResNet(1000, 50)
    else:
        jm, tm = JInception_v2(1000), Inception_v2(1000)
    _pair(jm, tm, seed=11)
    x = np.random.RandomState(11).standard_normal((1, 3, 224, 224)) \
        .astype(np.float32)
    ops.reset_launches()
    a, _, b = _apply_both(jm, tm, x, training=False)
    a, b = np.asarray(a), b.numpy()
    assert b.shape == (1, 1000) and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=1e-3)
    assert b.argmax() == a.argmax()
    # on the CPU every wrapper took its plain version
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


# -- training --------------------------------------------------------------

@pytest.fixture
def jax_losses():
    """Per-step losses of the JAX trainer, from its log lines."""
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


def _samples(pkg_sample, n, seed, classes=10, nan_at=None):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, 3, 32, 32)).astype(np.float32)
    if nan_at is not None:
        x[nan_at] = np.nan
    y = rng.randint(1, classes + 1, size=n).astype(np.float32)
    return [pkg_sample(x[i], y[i]) for i in range(n)]


def _decay(epoch):
    """An ``EpochDecay`` exponent that moves within a short run."""
    return 0.0 if epoch < 2 else 1.0


def _recipe(sgd, decay):
    """The reference's ResNet recipe (``models/resnet.py`` ``train_main``)
    with a decay that moves at epoch 2."""
    return sgd(learning_rate=0.1, weight_decay=1e-4, momentum=0.9,
               dampening=0.0, nesterov=True,
               learning_rate_schedule=decay(_decay))


def _port_trainer(weights, state, iters, samples, **kw):
    tm = ResNet(10, 8, "B", "cifar10")
    load_jax_params(tm, weights)
    load_jax_state(tm, state)
    opt = LocalOptimizer(tm, tnn.CrossEntropyCriterion(),
                         DataSet.array(samples) >> SampleToBatch(4),
                         Trigger.max_iteration(iters), device="cpu", **kw)
    return opt.set_optim_method(_recipe(SGD, EpochDecay))


def test_narrow_resnet_trajectory_matches_jax_local_optimizer(jax_losses):
    """Nesterov SGD with ``EpochDecay`` and ``CrossEntropyCriterion``, 6
    steps over 3 epochs, validated at step 3: losses, weights and running
    statistics; validation runs in eval mode, moves no statistic, and
    training resumes in training mode."""
    jm = _build(JResNet(10, 8, "B", "cifar10"), 12)
    topt = _port_trainer(jm.params, jm.state, 6, _samples(Sample, 8, 1))
    jopt = JLocalOptimizer(
        jm, jnn.CrossEntropyCriterion(),
        JDataSet.array(_samples(JSample, 8, 1)) >> JSampleToBatch(4),
        JTrigger.max_iteration(6))
    jopt.set_optim_method(_recipe(JSGD, JEpochDecay))
    val = 4
    jopt.set_validation(JTrigger.several_iteration(3),
                        JDataSet.array(_samples(JSample, val, 2)) >>
                        JSampleToBatch(4), [JTop1()])
    topt.set_validation(Trigger.several_iteration(3),
                        DataSet.array(_samples(Sample, val, 2)) >>
                        SampleToBatch(4), [Top1Accuracy()])
    seen = []
    validate = topt.validate

    def watched():
        before = export_state(topt.model)
        out = validate()
        seen.append((before, export_state(topt.model), topt.model.training))
        return out
    topt.validate = watched
    jopt.optimize()
    topt.optimize()
    tl = [r["loss"] for r in topt.step_records]
    assert len(tl) == len(jax_losses) == 6 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jax_losses, rtol=1e-4)
    _assert_tree_close(export_params(topt.model), jm.params)
    _assert_tree_close(export_state(topt.model), jm.state)
    assert len(seen) == 2
    for before, after, training in seen:
        assert training
        for g, w in zip(jax.tree_util.tree_leaves(after),
                        jax.tree_util.tree_leaves(before)):
            assert np.array_equal(g, w)
    assert topt.state["lastValidation"] == jopt.state["lastValidation"]
    assert cifar10_decay(80) == 0.0 and cifar10_decay(81) == 1.0 and \
        cifar10_decay(122) == 2.0


def test_non_finite_step_leaves_the_running_stats_as_they_were():
    """Step 2's batch holds a NaN image: the step is skipped, and the
    weights, the velocity and every running statistic stay as step 1 left
    them (without the guard the batch statistics would poison them)."""
    jm = _build(JResNet(10, 8, "B", "cifar10"), 13)
    samples = _samples(Sample, 8, 3, nan_at=5)
    one = _port_trainer(jm.params, jm.state, 1, samples)
    one.optimize()
    two = _port_trainer(jm.params, jm.state, 2, samples)
    two.optimize()
    assert two.metrics[SKIPPED_STEPS] == 1 and \
        two.state["skippedSteps"] == 1
    assert np.isnan(two.step_records[1]["loss"])
    for got, want in ((export_state(two.model), export_state(one.model)),
                      (export_params(two.model), export_params(one.model))):
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert np.array_equal(g, w) and np.isfinite(g).all()
    for g, w in zip(two.opt_state["velocity"], one.opt_state["velocity"]):
        assert torch.equal(g, w)


def test_snapshot_resume_of_a_bn_model_is_exact(tmp_path):
    """4 steps straight against 2 steps, a snapshot, and a fresh trainer
    resumed from it for 2 more: the same losses, weights and running
    statistics, bit for bit (bf16 mixed precision, as the card trains).
    The snapshot holds the running statistics as numpy; a snapshot of
    another architecture is refused with nothing copied."""
    jm = _build(JResNet(10, 8, "B", "cifar10"), 14)
    samples = _samples(Sample, 12, 4)
    straight = _port_trainer(jm.params, jm.state, 4, samples)
    straight.set_mixed_precision(True).optimize()
    first = _port_trainer(jm.params, jm.state, 2, samples)
    first.set_mixed_precision(True)
    first.set_checkpoint(str(tmp_path), Trigger.several_iteration(2))
    first.optimize()
    snap = tfile.File.load(str(tmp_path / "model.2"))
    leaves = jax.tree_util.tree_leaves(snap["model_state"])
    assert len(leaves) == 2 * 9 and all(
        isinstance(v, np.ndarray) and v.dtype == np.float32 for v in leaves)
    resumed = _port_trainer(_build(JResNet(10, 8, "B", "cifar10"), 15)
                            .params, jm.state, 4, samples)
    resumed.set_mixed_precision(True).resume_from(str(tmp_path)).optimize()
    got = [r["loss"] for r in resumed.step_records]
    assert got == [r["loss"] for r in straight.step_records[2:]]
    for a, b in ((export_state(resumed.model), export_state(straight.model)),
                 (export_params(resumed.model),
                  export_params(straight.model))):
        for g, w in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert np.array_equal(g, w)
    other = ResNet(10, 8, "A", "cifar10")
    before = export_state(other)
    with pytest.raises(ValueError, match="does not match the model"):
        tfile.load_model_snapshot(other, str(tmp_path / "model.2"))
    assert all(np.array_equal(g, w) for g, w in zip(
        jax.tree_util.tree_leaves(export_state(other)),
        jax.tree_util.tree_leaves(before)))


def test_state_round_trip_and_mismatches_raise():
    jm, tm = _pair(JResNet(10, 8, "A", "cifar10"),
                   ResNet(10, 8, "A", "cifar10"), seed=16)
    back = export_state(tm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jm.state)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jm.state)):
        assert np.array_equal(g, np.asarray(w))
    fresh = ResNet(10, 8, "A", "cifar10").load_state_tree(back)
    assert all(np.array_equal(g, w) for g, w in zip(
        jax.tree_util.tree_leaves(export_state(fresh)),
        jax.tree_util.tree_leaves(back)))
    untouched = export_state(tm)
    bad_shape = jax.tree_util.tree_map(lambda v: v, back)
    bad_shape[1]["running_mean"] = np.zeros(17, np.float32)
    bad_name = jax.tree_util.tree_map(lambda v: v, back)
    bad_name[1] = {"running_avg": back[1]["running_mean"],
                   "running_var": back[1]["running_var"]}
    for bad, match in ((bad_shape, "shape"), (bad_name, "state"),
                       (back[:-1], "children")):
        with pytest.raises(ValueError, match=match):
            load_jax_state(tm, bad)
    assert all(np.array_equal(g, w) for g, w in zip(
        jax.tree_util.tree_leaves(export_state(tm)),
        jax.tree_util.tree_leaves(untouched)))
    # a model without state has none, in the reference's layout
    assert ResNet(10, 8, "A", "cifar10").state_tree()[2] == ()


@pytest.mark.parametrize("state", ["listed", "empty"])
def test_stateless_snapshots_still_load(tmp_path, state):
    """A ``model.<n>`` of a model without BatchNorm, as written before the
    port had run-time state (its ``model_state`` a list of ``()`` per
    layer, or ``()``), loads into such a model; into a BN model it is
    refused, with nothing copied."""
    from bigdl_tpu_torch.models import LeNet5
    src = LeNet5(10).reset(3)
    model_state = src.state_tree() if state == "listed" else ()
    assert jax.tree_util.tree_leaves(model_state) == []
    tfile.File.save({"params": export_params(src),
                     "model_state": model_state}, str(tmp_path / "model.1"))
    dst = tfile.load_model_snapshot(LeNet5(10).reset(4),
                                    str(tmp_path / "model.1"))
    for a, b in zip(dst.param_leaves(), src.param_leaves()):
        assert torch.equal(a, b)
    bn = ResNet(10, 8, "B", "cifar10")
    tfile.File.save({"params": export_params(bn),
                     "model_state": model_state}, str(tmp_path / "model.2"))
    fresh = ResNet(10, 8, "B", "cifar10").reset(5)
    before = export_params(fresh)
    with pytest.raises(ValueError, match="model_state"):
        tfile.load_model_snapshot(fresh, str(tmp_path / "model.2"))
    assert all(np.array_equal(g, w) for g, w in zip(
        jax.tree_util.tree_leaves(export_params(fresh)),
        jax.tree_util.tree_leaves(before)))
