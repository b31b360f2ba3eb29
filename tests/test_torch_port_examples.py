"""The port's ModelValidator and ImagePredictor mains
(``bigdl_tpu_torch.example.loadmodel``, ``imageclassification``) against
the JAX package's, from the same weights, on image trees the tests write.

The images are PNG files with a short edge of 256, so ``LocalImgReader``
resizes nothing and both packages see the same pixels exactly.
``loadmodel.main`` with ``-t bigdl`` (each package's own ``Module.save``
of the same weights), ``-t torch`` (one ``.t7`` the reference wrote) and
``-t caffe`` (one caffemodel into ``Inception_v1(1000)``) gives the
reference's Top-1 and Top-5 counts exactly; the alexnet pipeline (a
256 x 256 x 3 mean file the port's ``File.save`` wrote) gives the
reference's (2, 3, 227, 227) batches exactly, labels {1, 2}.
``imageclassification.main`` gives the reference's top-N classes.  Without
CUDA each main, ``nn.load`` and ``nn.load_torch`` raise ``RuntimeError``
unless asked for the CPU.  Mirrors ``tests/test_examples.py``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.example import imageclassification as jic
from bigdl_tpu.example import loadmodel as jlm
from bigdl_tpu.utils import caffe_loader as jcl
from bigdl_tpu.utils import torch_file as jtf
from bigdl_tpu.utils.file import File as JFile
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import png
from bigdl_tpu_torch.example import imageclassification as tic
from bigdl_tpu_torch.example import loadmodel as tlm
from bigdl_tpu_torch.utils.file import File
from tests.test_torch_port_caffe import _blobs_for
from tests.test_torch_port_models import _build, _np_params

torch.set_num_threads(2)


def _tiny(nn, image_size, class_num=5):
    out = (image_size - 3) // 2 + 1
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 4, 3, 3, 2, 2))
            .add(nn.ReLU())
            .add(nn.Reshape([4 * out * out]))
            .add(nn.Linear(4 * out * out, class_num))
            .add(nn.LogSoftMax()))


def _pair(image_size, seed=0):
    jm = _build(_tiny(jnn, image_size), seed)
    tm = _tiny(tnn, image_size)
    load_jax_params(tm, _np_params(jm))
    return jm, tm


def _write_pngs(folder, n, seed, shape=(256, 256)):
    """Smooth seeded images (so a weak classifier still tells them apart),
    their rows through all five PNG filters."""
    rs = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        f = rs.uniform(0.01, 0.1, 3)
        img = np.stack([127 + 120 * np.sin(f[c] * (xx + 2 * c * yy) + i)
                        for c in range(3)], axis=2)
        img += rs.uniform(-6, 6, img.shape)
        with open(os.path.join(folder, f"img_{i}.png"), "wb") as fh:
            fh.write(png.encode_png(np.clip(img, 0, 255).astype(np.uint8),
                                    [0, 1, 2, 3, 4]))


def _val_tree(root, per_class=3):
    for c, cls in enumerate(("cat", "dog")):
        _write_pngs(os.path.join(root, "val", cls), per_class, 10 + c)


def _counts(results):
    return [(r.correct, r.count) for r in results]


@pytest.mark.parametrize("mtype", ["bigdl", "torch"])
def test_model_validator_matches_the_reference(tmp_path, mtype):
    _val_tree(str(tmp_path))
    jm, tm = _pair(224)
    if mtype == "bigdl":
        tm.save(str(tmp_path / "port_model"))
        jm.save(str(tmp_path / "jax_model"))
        paths = (str(tmp_path / "port_model"), str(tmp_path / "jax_model"))
    else:
        jtf.save_torch(jm, str(tmp_path / "m.t7"))
        paths = (str(tmp_path / "m.t7"),) * 2
    args = ["-f", str(tmp_path), "-m", "inception", "-t", mtype, "-b", "2"]
    got = tlm.main(args + ["--modelPath", paths[0]], device="cpu")
    want = jlm.main(args + ["--modelPath", paths[1]])
    assert _counts(got) == _counts(want)
    assert got[0].count == 6 and got[1].result()[0] == 1.0


def test_model_validator_caffe_inception_matches_the_reference(tmp_path):
    from bigdl_tpu_torch.models import Inception_v1
    _val_tree(str(tmp_path), per_class=1)
    layers = _blobs_for(Inception_v1(1000), 5)
    model_path = str(tmp_path / "googlenet.caffemodel")
    with open(model_path, "wb") as f:
        f.write(jcl.encode_caffemodel(layers))
    args = ["-f", str(tmp_path), "-m", "inception", "-t", "caffe",
            "--caffeDefPath", str(tmp_path / "deploy.prototxt"),
            "--modelPath", model_path, "-b", "2"]
    got = tlm.main(args, device="cpu")
    want = jlm.main(args)
    assert _counts(got) == _counts(want)
    assert [r.count for r in got] == [2, 2]


def test_alexnet_mean_file_pipeline_matches_the_reference(tmp_path):
    for cls in ("a", "b"):
        _write_pngs(str(tmp_path / "val" / cls), 1, ord(cls))
    means = np.random.RandomState(3).uniform(90, 130, (256, 256, 3)) \
        .astype(np.float32)
    File.save(means, str(tmp_path / "means"))
    np.testing.assert_array_equal(JFile.load(str(tmp_path / "means")), means)
    got = next(iter(tlm._preprocessor(
        "alexnet", str(tmp_path), 2, str(tmp_path / "means")).data(
            train=False)))
    want = next(iter(jlm._preprocessor(
        "alexnet", str(tmp_path), 2, str(tmp_path / "means")).data(
            train=False)))
    assert got.data.shape == (2, 3, 227, 227)
    assert set(np.asarray(got.labels).tolist()) == {1.0, 2.0}
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("model_name", ["inception", "resnet"])
def test_preprocessors_match_the_reference(tmp_path, model_name):
    _val_tree(str(tmp_path), per_class=1)
    got = list(tlm._preprocessor(model_name, str(tmp_path), 2).data(
        train=False))
    want = list(jlm._preprocessor(model_name, str(tmp_path), 2).data(
        train=False))
    assert len(got) == len(want) == 1
    assert got[0].data.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(got[0].data, want[0].data, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mtype", ["torch", "bigdl"])
def test_image_predictor_matches_the_reference(tmp_path, mtype):
    _write_pngs(str(tmp_path / "imgs"), 5, 21)
    jm, tm = _pair(227, seed=4)
    if mtype == "torch":
        jtf.save_torch(jm, str(tmp_path / "m.t7"))
        paths = (str(tmp_path / "m.t7"),) * 2
    else:
        tm.save(str(tmp_path / "port_model"))
        jm.save(str(tmp_path / "jax_model"))
        paths = (str(tmp_path / "port_model"), str(tmp_path / "jax_model"))
    args = ["-f", str(tmp_path / "imgs"), "--modelType", mtype, "-b", "2",
            "--topN", "3"]
    got = tic.main(args + ["--modelPath", paths[0]], device="cpu")
    want = jic.main(args + ["--modelPath", paths[1]])
    assert got == want
    assert len(got) == 5 and all(len(c) == 3 for _, c in got)
    assert all(1 <= k <= 5 for _, c in got for k in c)


def test_entry_points_need_cuda_unless_asked_for_the_cpu(tmp_path,
                                                          monkeypatch):
    _write_pngs(str(tmp_path / "imgs"), 1, 1)
    _val_tree(str(tmp_path), per_class=1)
    _, tm = _pair(224)
    tm.save(str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.main(["-f", str(tmp_path), "-m", "inception", "-t", "bigdl",
                  "--modelPath", str(tmp_path / "m")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tic.main(["-f", str(tmp_path / "imgs"), "--modelPath",
                  str(tmp_path / "m")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnn.load(str(tmp_path / "m"))
    r = tlm.main(["-f", str(tmp_path), "-m", "inception", "-t", "bigdl",
                  "--modelPath", str(tmp_path / "m")], device="cpu")
    assert [x.count for x in r] == [2, 2]
