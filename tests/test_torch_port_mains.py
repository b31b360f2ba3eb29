"""The port's training mains (``models/lenet.py``, ``resnet.py``,
``vgg.py``, ``autoencoder.py``, ``inception.py``) and the Torch-style
``optimize`` of ``LBFGS``, ``SGD``, ``Adam`` and ``Adagrad`` against the
JAX package's, on the CPU.

Each main runs on staged files (MNIST idx, CIFAR-10 binaries, record-file
ImageNet) from the same seeded weights on both sides (``_build``'s draws,
dropout off where a model has it: the two packages draw other masks); the
losses of every iteration agree within rtol 1e-4 (float32 sums in another
order over one to two epochs; the reference's native image normalization
moves inputs by about 1e-7) and ``test_main``'s Top-1 counts are equal.
The Inception mains run a small stand-in net (Inception-v1 at 224² takes
the reference minutes to compile on a CPU): the record-file pipeline, the
optimizer they build (schedule horizon from the record count, triggers,
SGD's configuration, bf16 mixed precision) and ``test_main`` against the
reference's, losses within 2 bfloat16 rounding steps of their magnitude
(the bf16 logits round in steps; products sum in another order).
``optimize``'s iterates agree within rtol 1e-5 (LBFGS: 1e-4 over its line
search).
Mirrors ``tests/test_models.py::test_lenet_train_main_cli`` and
``tests/test_training.py::test_lbfgs_quadratic``/
``test_adam_legacy_optimize_protocol``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import autoencoder as jautoencoder
from bigdl_tpu.models import inception as jinception
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.optim import LBFGS as JLBFGS
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Adagrad as JAdagrad
from bigdl_tpu.optim import Adam as JAdam
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.dataset import (BGRImgToLocalSeqFile, LabeledImage,
                                     write_cifar10_batch, write_mnist)
from bigdl_tpu_torch.models import autoencoder as tautoencoder
from bigdl_tpu_torch.models import inception as tinception
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.models import resnet as tresnet
from bigdl_tpu_torch.models import vgg as tvgg
from bigdl_tpu_torch.optim import LBFGS, SGD, Adagrad, Adam
from bigdl_tpu_torch.utils.table import T
from tests.test_torch_port_models import _build
from tests.test_torch_port_recurrent import _from
from tests.test_torch_port_training_lm import losses  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_logging():
    """Both packages' mains call ``init_logging``, which adds a stdout
    handler and stops propagation; other tests' ``caplog`` needs it back."""
    saved = []
    for name in ("bigdl_tpu", "bigdl_tpu_torch"):
        log = logging.getLogger(name)
        saved.append((log, list(log.handlers), log.propagate, log.level))
    yield
    for log, handlers, propagate, level in saved:
        log.handlers[:] = handlers
        log.propagate = propagate
        log.setLevel(level)


def _no_dropout(model):
    """Dropout off in a model of either package (a reference container
    lists its children in ``.modules``)."""
    if isinstance(model, torch.nn.Module):
        layers = list(model.modules())
    else:
        layers, todo = [], [model]
        while todo:
            m = todo.pop()
            layers.append(m)
            todo.extend(getattr(m, "modules", []))
    for m in layers:
        if isinstance(m, (jnn.Dropout, tnn.Dropout)):
            m.p = 0.0
    return model


def _same_start(monkeypatch, jmod, tmod, name, seed=5, dropout_off=False):
    """Patch both modules' builder ``name`` so they start from the weights
    ``_build`` draws for the reference's model."""
    jmake, tmake = getattr(jmod, name), getattr(tmod, name)

    def jbuild(*a, **kw):
        return _build(_no_dropout(jmake(*a, **kw)), seed)

    def tbuild(*a, **kw):
        return _no_dropout(_from(jmake, tmake, seed)(*a, **kw))
    monkeypatch.setattr(jmod, name, jbuild if dropout_off else
                        lambda *a, **kw: _build(jmake(*a, **kw), seed))
    monkeypatch.setattr(tmod, name, tbuild if dropout_off else
                        _from(jmake, tmake, seed))


def _mnist(folder, n_train, n_test, seed=0):
    rs = np.random.RandomState(seed)
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        labels = rs.randint(0, 10, n)
        # a faint class pattern, so training moves the loss
        imgs = rs.randint(0, 120, (n, 28, 28)) + \
            (labels[:, None, None] * 12 * (np.arange(28) % 2)[None, None, :])
        write_mnist(os.path.join(folder, f"{prefix}-images-idx3-ubyte"),
                    os.path.join(folder, f"{prefix}-labels-idx1-ubyte"),
                    np.clip(imgs, 0, 255).astype(np.uint8), labels)


def _cifar(folder, per_batch, n_test, seed=0):
    rs = np.random.RandomState(seed)
    for name, n in [(f"data_batch_{i}.bin", per_batch) for i in range(1, 6)] \
            + [("test_batch.bin", n_test)]:
        write_cifar10_batch(os.path.join(folder, name),
                            rs.randint(0, 256, (n, 3, 32, 32)),
                            rs.randint(0, 10, n))


def _snapshot(folder):
    return os.path.join(folder, sorted(
        f for f in os.listdir(folder) if f.startswith("model."))[-1])


def _check_losses(losses, n, bf16_steps=None):  # noqa: F811
    """Every iteration's loss within rtol 1e-4 of the reference's, or
    within ``bf16_steps`` bfloat16 rounding steps of its magnitude."""
    want, got = losses["bigdl_tpu.optim"], losses["bigdl_tpu_torch.optim"]
    assert len(got) == len(want) == n
    if bf16_steps is None:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:
        step = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert (np.abs(np.subtract(got, want)) <= bf16_steps * step).all(), \
            (got, want)
    assert got[-1] != got[0]


def test_lenet_mains_match_the_reference(tmp_path, monkeypatch,
                                         losses):  # noqa: F811
    _mnist(str(tmp_path), 96, 40)
    _same_start(monkeypatch, jlenet, tlenet, "LeNet5")
    argv = ["-f", str(tmp_path), "-b", "32", "-e", "2", "-r", "0.1"]
    jlenet.train_main(argv + ["--checkpoint", str(tmp_path / "jck")])
    tlenet.train_main(argv + ["--checkpoint", str(tmp_path / "tck")],
                      device="cpu")
    _check_losses(losses, 6)
    assert sorted(os.listdir(tmp_path / "tck")) == \
        ["model.3", "model.6", "state.3", "state.6"]
    test = ["-f", str(tmp_path), "-b", "16", "--model",
            str(tmp_path / "tck" / "model.6")]
    got = tlenet.test_main(test, device="cpu")
    want = jlenet.test_main(test)
    assert [r.correct for r in got] == [r.correct for r in want]
    assert got[0].count == 40


def test_autoencoder_main_matches_the_reference(tmp_path, monkeypatch,
                                                losses):  # noqa: F811
    _mnist(str(tmp_path), 90, 10)
    _same_start(monkeypatch, jautoencoder, tautoencoder, "Autoencoder")
    argv = ["-f", str(tmp_path), "-b", "30", "-e", "2"]
    jautoencoder.train_main(argv)
    model = tautoencoder.train_main(argv, device="cpu")
    _check_losses(losses, 6)
    assert isinstance(model, tnn.Sequential)


def test_resnet_mains_match_the_reference(tmp_path, monkeypatch,
                                          losses):  # noqa: F811
    _cifar(str(tmp_path), 8, 20)
    _same_start(monkeypatch, jresnet, tresnet, "ResNet")
    argv = ["-f", str(tmp_path), "-b", "16", "--nepochs", "1", "--depth",
            "8"]
    jresnet.train_main(argv)
    tresnet.train_main(argv + ["--checkpoint", str(tmp_path / "ck")],
                       device="cpu")
    _check_losses(losses, 3)
    test = ["-f", str(tmp_path), "-b", "16", "--depth", "8", "--model",
            _snapshot(str(tmp_path / "ck"))]
    got = tresnet.test_main(test, device="cpu")
    want = jresnet.test_main(test)
    assert [r.correct for r in got] == [r.correct for r in want]
    assert got[0].count == 20


def test_vgg_mains_match_the_reference(tmp_path, monkeypatch,
                                       losses):  # noqa: F811
    _cifar(str(tmp_path), 6, 12)
    _same_start(monkeypatch, jvgg, tvgg, "VggForCifar10", dropout_off=True)
    argv = ["-f", str(tmp_path), "-b", "15", "-e", "1"]
    jvgg.train_main(argv)
    tvgg.train_main(argv + ["--checkpoint", str(tmp_path / "ck"),
                            "--overWrite"], device="cpu")
    _check_losses(losses, 2)
    assert sorted(os.listdir(tmp_path / "ck")) == ["model", "state"]
    test = ["-f", str(tmp_path), "-b", "8", "--model",
            str(tmp_path / "ck" / "model")]
    got = tvgg.test_main(test, device="cpu")
    want = jvgg.test_main(test)
    assert [r.correct for r in got] == [r.correct for r in want]


# -- Inception's mains --------------------------------------------------------

def _small_net(nn):
    def build(class_num=1000, *args, **kw):
        return (nn.Sequential()
                .add(nn.SpatialConvolution(3, 4, 7, 7, 4, 4))
                .add(nn.ReLU())
                .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
                .add(nn.View(4 * 3 * 3))
                .add(nn.Linear(4 * 3 * 3, class_num))
                .add(nn.LogSoftMax()))
    return build


def _records(folder, n_train=10, n_val=6, size=40, classes=20):
    rs = np.random.RandomState(2)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(folder, split))
        imgs = [LabeledImage(rs.randint(0, 256, (size + i % 3, size, 3))
                             .astype(np.float32),
                             float(rs.randint(1, classes + 1)))
                for i in range(n)]
        list(BGRImgToLocalSeqFile(3, os.path.join(folder, split, "part"))
             .apply(iter(imgs)))


@pytest.fixture
def small_inception(monkeypatch):
    """Both mains on the stand-in net at 32² crops, classes 20."""
    jsmall, tsmall = _small_net(jnn), _small_net(tnn)
    monkeypatch.setattr(jinception, "Inception_v1",
                        lambda n: _build(jsmall(n), 6))
    monkeypatch.setattr(tinception, "_build_net", lambda net, n: _from(
        jsmall, tsmall, 6)(n))
    for mod in (jinception, tinception):
        make = mod._imagenet_set
        monkeypatch.setattr(mod, "_imagenet_set", lambda *a, make=make,
                            **kw: make(*a, image_size=32, **kw))


def test_inception_train_main_builds_the_reference_optimizer(
        tmp_path, small_inception, monkeypatch):
    _records(str(tmp_path))
    built = {}
    for mod, key in ((jinception, "jax"), (tinception, "port")):
        import bigdl_tpu.optim as jo
        import bigdl_tpu_torch.optim as to
        pkg = jo if key == "jax" else to
        real = pkg.Optimizer

        def capture(*a, real=real, key=key, **kw):
            built[key] = real(*a, **kw)
            built[key].optimize = lambda: built[key].model
            return built[key]
        monkeypatch.setattr(pkg, "Optimizer", capture)
    argv = ["-f", str(tmp_path), "-b", "4", "-e", "3", "--classNum", "20",
            "--checkpoint", str(tmp_path / "ck")]
    jinception.train_main(argv)
    tinception.train_main(argv, device="cpu")
    j, t = built["jax"], built["port"]
    # the Poly horizon counts records: ceil(10 / 4) * 3 steps
    assert t.optim_method.schedule.max_iteration == \
        j.optim_method.schedule.max_iteration == 9
    assert dict(t.optim_method.defaults) == dict(j.optim_method.defaults)
    assert t.mixed_precision and j.mixed_precision
    for state in ({"epoch": 2, "neval": 3, "isLastBatchOfEpoch": True},
                  {"epoch": 4, "neval": 9, "isLastBatchOfEpoch": False}):
        for trig in ("end_when", "validation_trigger", "checkpoint_trigger"):
            assert getattr(t, trig)(dict(state)) == \
                getattr(j, trig)(dict(state)), trig
    assert t.dataset.size() == 10 and t.validation_dataset.size() == 6
    assert [repr(m) for m in t.validation_methods] == \
        ["Top1Accuracy", "Top5Accuracy"]
    # -i: 620-iteration cadence, horizon -i
    tinception.train_main(["-f", str(tmp_path), "-i", "700"], device="cpu")
    t = built["port"]
    assert t.optim_method.schedule.max_iteration == 700
    assert not t.validation_trigger({"neval": 619, "epoch": 1})
    assert t.validation_trigger({"neval": 620, "epoch": 1})


def test_inception_mains_match_the_reference(tmp_path, small_inception,
                                             losses):  # noqa: F811
    _records(str(tmp_path))
    argv = ["-f", str(tmp_path), "-b", "2", "-e", "2", "--classNum", "20"]
    jinception.train_main(argv + ["--checkpoint", str(tmp_path / "jck")])
    tinception.train_main(argv + ["--checkpoint", str(tmp_path / "tck")],
                          device="cpu")
    _check_losses(losses, 10, bf16_steps=2)
    test = ["-f", str(tmp_path), "-b", "4", "--classNum", "20", "--model",
            str(tmp_path / "tck" / "model.10")]
    got = tinception.test_main(test, device="cpu")
    want = jinception.test_main(test)
    assert [r.correct for r in got] == [r.correct for r in want]
    assert [r.count for r in got] == [6, 6]


def test_inception_test_main_reads_a_caffe_model(tmp_path, small_inception,
                                                 capsys):
    from bigdl_tpu_torch.utils.caffe_loader import encode_caffemodel
    _records(str(tmp_path))
    (tmp_path / "net.prototxt").write_text('name: "x"\n')
    encode_path = tmp_path / "net.caffemodel"
    encode_path.write_bytes(encode_caffemodel([]))
    got = tinception.test_main(
        ["-f", str(tmp_path), "--classNum", "20", "--caffeDefPath",
         str(tmp_path / "net.prototxt"), "--caffeModelPath",
         str(encode_path)], device="cpu")
    assert [r.count for r in got] == [6, 6]
    assert "Accuracy" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tinception.test_main(["-f", str(tmp_path)], device="cpu")


@pytest.mark.parametrize("main", ["inception.train", "inception.test",
                                  "lenet.train", "lenet.test",
                                  "resnet.train", "resnet.test",
                                  "vgg.train", "vgg.test",
                                  "autoencoder.train"])
def test_mains_raise_without_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                           tmp_path, main):
    mod, which = main.split(".")
    mod = {"inception": tinception, "lenet": tlenet, "resnet": tresnet,
           "vgg": tvgg, "autoencoder": tautoencoder}[mod]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(mod, f"{which}_main")(["-f", str(tmp_path), "--model", "m"]
                                      if which == "test" else
                                      ["-f", str(tmp_path)])


# -- optimize(feval, x) -------------------------------------------------------

def _quadratic(pkg):
    target = np.asarray([1.0, -2.0, 3.0, 0.5], np.float32)
    mat = np.diag([1.0, 4.0, 0.5, 2.0]).astype(np.float32)
    if pkg == "jax":
        def feval(p):
            r = p["w"] - jnp.asarray(target)
            return float(r @ jnp.asarray(mat) @ r), \
                {"w": 2.0 * jnp.asarray(mat) @ r}
        return feval, {"w": jnp.zeros(4)}

    def feval(p):
        r = p["w"] - torch.from_numpy(target)
        return float(r @ torch.from_numpy(mat) @ r), \
            {"w": 2.0 * torch.from_numpy(mat) @ r}
    return feval, {"w": torch.zeros(4)}


@pytest.mark.parametrize("line_search", [False, True])
def test_lbfgs_matches_the_reference(line_search):
    jfe, jx = _quadratic("jax")
    tfe, tx = _quadratic("port")
    jx, jl = JLBFGS(max_iter=30, line_search=line_search).optimize(jfe, jx)
    tx, tl = LBFGS(max_iter=30, line_search=line_search).optimize(tfe, tx)
    assert len(tl) == len(jl)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-10)
    np.testing.assert_allclose(tx["w"].numpy(), np.asarray(jx["w"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tx["w"].numpy(), [1.0, -2.0, 3.0, 0.5],
                               atol=1e-3)


def _logistic(pkg, n=64, d=5, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, d)).astype(np.float32)
    y = (rs.rand(n) < 0.5).astype(np.float32)
    if pkg == "jax":
        xa, ya = jnp.asarray(x), jnp.asarray(y)

        def loss(w):
            z = xa @ w["w"] + w["b"]
            return jnp.mean(jnp.logaddexp(0.0, z) - ya * z)

        def feval(w):
            return float(loss(w)), jax.grad(loss)(w)
        return feval, {"w": jnp.zeros(d), "b": jnp.zeros(())}
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def feval(w):
        p = {k: v.detach().requires_grad_() for k, v in w.items()}
        z = xt @ p["w"] + p["b"]
        out = (torch.logaddexp(torch.zeros(()), z) - yt * z).mean()
        gw, gb = torch.autograd.grad(out, [p["w"], p["b"]])
        return float(out.detach()), {"w": gw, "b": gb}
    return feval, {"w": torch.zeros(d), "b": torch.zeros(())}


METHODS = {
    "sgd": (lambda m: m(learning_rate=0.5, momentum=0.9, weight_decay=1e-3),
            SGD, JSGD),
    "sgd-nesterov": (lambda m: m(learning_rate=0.5, momentum=0.9,
                                 dampening=0.0, nesterov=True), SGD, JSGD),
    "adam": (lambda m: m(learning_rate=0.05), Adam, JAdam),
    "adagrad": (lambda m: m(learning_rate=0.5, learning_rate_decay=0.01,
                            weight_decay=1e-3), Adagrad, JAdagrad)}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_optimize_iterates_match_the_reference(name):
    make, tcls, jcls = METHODS[name]
    tm, jm = make(tcls), make(jcls)
    tfe, tx = _logistic("port")
    jfe, jx = _logistic("jax")
    ts, js = T(), T()
    for _ in range(20):
        tx, tl = tm.optimize(tfe, tx, state=ts)
        jx, jl = jm.optimize(jfe, jx, state=js)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                   rtol=1e-5, atol=1e-6)
    assert ts["evalCounter"] == js["evalCounter"] == 20
    assert tl[0] < _logistic("port")[0](_logistic("port")[1])[0]


def test_adam_optimize_keeps_history_in_the_config():
    """Without a state Table, Adam accumulates in the caller's config
    (torch's ``state = state or config``), as the reference does."""
    target = torch.tensor([1.0, -2.0, 0.5])
    x = torch.zeros(3)
    opt = Adam(learning_rate=0.1)
    config = opt.defaults.clone()
    for _ in range(200):
        x, _ = opt.optimize(lambda w: (float(((w - target) ** 2).sum()),
                                       2.0 * (w - target)), x, config)
    np.testing.assert_allclose(x.numpy(), target.numpy(), atol=1e-2)
    assert config["evalCounter"] == 200
    with pytest.raises(ValueError, match="nesterov"):
        SGD(momentum=0.9, dampening=0.1, nesterov=True).optimize(
            lambda w: (0.0, w), torch.zeros(2))
