"""The perf harness of the port (``bigdl_tpu_torch/models/perf.py``
``local`` and ``infer``) against the reference's (``bigdl_tpu/models/
perf.py``), on the CPU.

Both packages' ``_build`` are patched to give the same dropout-free model
with the weights the reference's harness draws itself (``PRNGKey(0)``):
dropout masks come from different generators, so losses are compared
only where there is none.  Tolerances: each logged loss of ``local`` within
rtol 1e-5 of the reference's (float32; one SGD step apart, sums in
another order); ``infer --fp32``'s log-probs within atol 1e-4 and its
classes equal wherever the reference's top-2 margin exceeds that; the
synthetic batch bit-equal.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import perf as jperf
from bigdl_tpu.models.alexnet import AlexNet as JAlexNet
from bigdl_tpu.models.alexnet import AlexNet_OWT as JAlexNet_OWT
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import AlexNet, AlexNet_OWT
from bigdl_tpu_torch.models import perf as tperf

torch.set_num_threads(1)


@pytest.fixture
def logged():
    """The arguments of both harnesses' "Iteration ..." log lines, keyed
    by logger; both packages' logger set-up is put back after (their
    ``init_logging`` stops propagation, which other tests' ``caplog``
    needs)."""
    got = {"bigdl_tpu.models.perf": [], "bigdl_tpu_torch.models.perf": []}

    class Grab(logging.Handler):
        def __init__(self, into):
            super().__init__(logging.INFO)
            self.into = into

        def emit(self, record):
            if str(record.msg).startswith("Iteration "):
                self.into.append(record.args)

    saved = []
    for name in ("bigdl_tpu", "bigdl_tpu_torch"):
        log = logging.getLogger(name)
        saved.append((log, list(log.handlers), log.propagate, log.level))
    handlers = []
    for name, into in got.items():
        log = logging.getLogger(name)
        handlers.append((log, Grab(into)))
        log.addHandler(handlers[-1][1])
    yield got
    for log, handler in handlers:
        log.removeHandler(handler)
    for log, hs, propagate, level in saved:
        log.handlers[:] = hs
        log.propagate = propagate
        log.setLevel(level)


def _patch_builds(monkeypatch, jbuild, tbuild):
    """Both ``_build``s give ``jbuild()`` and ``tbuild()`` (any model
    name), the port's carrying the weights the reference's harness draws
    from ``PRNGKey(0)``; returns the port's models as built."""
    jm = jbuild()
    params, _ = jm.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    built = []

    def port_build(name, class_num=1000):
        built.append(load_jax_params(tbuild(), params))
        return built[-1]
    monkeypatch.setattr(jperf, "_build", lambda name, class_num=1000:
                        jbuild())
    monkeypatch.setattr(tperf, "_build", port_build)
    return params, built


def test_local_losses_match_the_reference(monkeypatch, logged):
    _patch_builds(monkeypatch,
                  lambda: JAlexNet_OWT(1000, has_dropout=False),
                  lambda: AlexNet_OWT(1000, has_dropout=False))
    argv = ["-m", "alexnetowt", "-b", "2", "-i", "2", "-d", "constant"]
    assert jperf.local_perf_main(argv) > 0
    ops.reset_launches()
    assert tperf.local_perf_main(argv, device="cpu") > 0
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)
    want = logged["bigdl_tpu.models.perf"]
    got = logged["bigdl_tpu_torch.models.perf"]
    assert [a[0] for a in got] == [a[0] for a in want] == [1, 2]
    losses = [a[1] for a in got]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    np.testing.assert_allclose(losses, [a[1] for a in want], rtol=1e-5)


def test_infer_fp32_forward_and_classes_match_the_reference(monkeypatch,
                                                           logged):
    params, built = _patch_builds(monkeypatch, lambda: JAlexNet(1000),
                                  lambda: AlexNet(1000))
    seen = []
    real = tperf.infer_forward

    def watched(model, data, fp32, device):
        fwd = real(model, data, fp32, device)

        def run():
            seen.append(fwd())
            return seen[-1]
        seen.append((model, data, fp32))
        return run
    monkeypatch.setattr(tperf, "infer_forward", watched)
    argv = ["-m", "alexnet", "-b", "4", "-i", "2", "--fp32"]
    assert jperf.infer_perf_main(argv) > 0
    assert tperf.infer_perf_main(argv, device="cpu") > 0
    (model, data, fp32), classes = seen[0], seen[1:]
    assert fp32 and len(classes) == 3 and model is built[0]
    assert not model.training and all(p.dtype == torch.float32
                                      for p in model.parameters())
    want_data, _ = jperf._synthetic_batch("alexnet", 4, "random")
    np.testing.assert_array_equal(data, want_data)
    jm = JAlexNet(1000)
    _, state = jm.init(jax.random.PRNGKey(0))
    ref = np.asarray(jax.jit(lambda p, s, v: jm.apply(
        p, s, v, training=False)[0])(params, state, jnp.asarray(data)))
    with torch.inference_mode():
        got = model(torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    firm = top2[:, 1] - top2[:, 0] > 1e-4
    assert firm.sum() >= 2
    for c in classes:
        assert c.shape == (4,) and c.dtype == torch.int64
        assert (c.numpy() == ref.argmax(-1))[firm].all()
        assert torch.equal(c, classes[0])


def test_infer_casts_parameters_and_input_to_bf16(monkeypatch, logged):
    """Without ``--fp32`` the forward sees bf16 parameters and input (its
    output dtype) while the model keeps its f32 parameters; the classes
    come back to the host."""
    seen = []
    real = tperf.infer_forward

    def watched(model, data, fp32, device):
        hook = model.layers[-1].register_forward_hook(
            lambda m, args, out: seen.append((args[0].dtype, out.dtype)))
        fwd = real(model, data, fp32, device)

        def run():
            classes = fwd()
            assert classes.shape == (2,) and classes.device.type == "cpu"
            assert all(p.dtype == torch.float32 for p in model.parameters())
            return classes, hook
        return run
    monkeypatch.setattr(tperf, "infer_forward", watched)
    monkeypatch.setattr(tperf, "_build", lambda name, class_num=1000:
                        AlexNet_OWT(10))
    assert tperf.infer_perf_main(["-m", "alexnetowt", "-b", "2", "-i", "1"],
                                 device="cpu") > 0
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2


def test_synthetic_batch_and_flags_follow_the_reference():
    assert tperf._INPUT_SIZES == jperf._INPUT_SIZES
    for name in tperf._INPUT_SIZES:
        for kind in ("constant", "random"):
            a = jperf._synthetic_batch(name, 3, kind)
            b = tperf._synthetic_batch(name, 3, kind)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x, y)
    argv = ["-b", "8", "-i", "2", "-m", "vgg16", "-d", "constant", "-c",
            "28"]
    assert vars(tperf._parser("t").parse_args(argv)) == \
        vars(jperf._parser("t").parse_args(argv))
    with pytest.raises(SystemExit, match="model can only be"):
        tperf._build("resnet50")


@pytest.mark.parametrize("argv, item", [
    (["distri"], "DistriOptimizer slice of the port .ROADMAP.md Queue 1 "
     "item 12"),
    (["ingest"], "data-feed slice of the port .ROADMAP.md Queue 1 item 11"),
    (["local", "--dataType", "double"], "Queue 1 item 14, perf --dataType "
     "double"),
    (["infer", "--dataType", "double"], "Queue 1 item 14, perf --dataType "
     "double"),
    (["--dataType", "double", "-m", "vgg16"], "Queue 1 item 14")],
    ids=["distri", "ingest", "local-double", "infer-double",
         "default-double"])
def test_dispatch_raises_for_what_is_not_ported(argv, item, logged):
    with pytest.raises(NotImplementedError, match=item):
        tperf.main(argv, device="cpu")


def test_corePerNode_is_accepted_logged_and_ignored(monkeypatch, logged,
                                                     caplog):
    monkeypatch.setattr(tperf, "_build", lambda name, class_num=1000:
                        AlexNet_OWT(10, has_dropout=False))
    logging.getLogger("bigdl_tpu_torch.models.perf").addHandler(
        caplog.handler)
    try:
        ips = tperf.main(["-m", "alexnetowt", "-b", "2", "-i", "1", "-c",
                          "28"], device="cpu")
    finally:
        logging.getLogger("bigdl_tpu_torch.models.perf").removeHandler(
            caplog.handler)
    assert ips > 0
    assert "corePerNode=28 accepted for flag parity and ignored" in \
        caplog.text
    assert len(logged["bigdl_tpu_torch.models.perf"]) == 1


def test_harnesses_raise_without_cuda_unless_asked_for_the_cpu(
        monkeypatch, logged):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(tperf, "_build", lambda name, class_num=1000:
                        built.append(name))
    for fn in (tperf.local_perf_main, tperf.infer_perf_main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(["-m", "alexnet", "-b", "2", "-i", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tperf.main(["infer", "-m", "vgg16"])
    assert built == []          # nothing built before the device check
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlexNet(10).to()
