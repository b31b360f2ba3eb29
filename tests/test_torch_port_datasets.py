"""The port's dataset parsers and python-binding helpers
(``bigdl_tpu_torch.dataset.loaders``, ``mnist``, ``news20``, ``base`` and
``transformer``'s ``Lambda``/``Identity``/``normalizer``) against the JAX
package's, on files the tests write: MNIST idx files (gzipped and raw, a
bad magic), CIFAR-10 batches, a 20 Newsgroups tar.gz with a stray file and
a GloVe zip.  Every parsed record, array, label and text equals the
reference's exactly.  ``maybe_download`` returns a staged file without a
download and, with ``urllib.request.urlretrieve`` patched to raise (no test
touches the network), raises the reference's actionable ``IOError``.
Mirrors ``tests/test_dataset.py:24-52`` and
``tests/test_python_binding_datasets.py``.
"""

import gzip
import os
import struct
import tarfile
import urllib.request
import zipfile

import numpy as np
import pytest

from bigdl_tpu.dataset import base as jbase
from bigdl_tpu.dataset import loaders as jloaders
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.dataset import news20 as jnews20
from bigdl_tpu.dataset import transformer as jtransformer
from bigdl_tpu_torch.dataset import (DataSet, Identity, Lambda, Sample,
                                     base, loaders, mnist, news20,
                                     normalizer)

RNG = np.random.RandomState(0)


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data == w.data and g.label == w.label
        assert type(g.label) is type(w.label)


def test_mnist_idx_round_trip(tmp_path):
    imgs = RNG.randint(0, 256, (20, 28, 28)).astype(np.uint8)
    labels = RNG.randint(0, 10, 20).astype(np.uint8)
    fi, fl = str(tmp_path / "img"), str(tmp_path / "lab")
    loaders.write_mnist(fi, fl, imgs, labels)
    ji, jl = str(tmp_path / "jimg"), str(tmp_path / "jlab")
    jloaders.write_mnist(ji, jl, imgs, labels)
    assert open(fi, "rb").read() == open(ji, "rb").read()
    assert open(fl, "rb").read() == open(jl, "rb").read()
    recs = loaders.load_mnist(fi, fl)
    _same_records(recs, jloaders.load_mnist(fi, fl))
    assert recs[3].label == labels[3] + 1.0          # 1-based
    np.testing.assert_array_equal(
        np.frombuffer(recs[3].data, np.uint8).reshape(28, 28), imgs[3])


@pytest.mark.parametrize("train", [True, False])
def test_cifar_batches(tmp_path, train):
    imgs = RNG.randint(0, 256, (10, 3, 32, 32)).astype(np.uint8)
    labels = RNG.randint(0, 10, 10).astype(np.uint8)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
        else ["test_batch.bin"]
    per = len(imgs) // len(names)
    for i, name in enumerate(names):
        loaders.write_cifar10_batch(str(tmp_path / name),
                                    imgs[i * per:(i + 1) * per],
                                    labels[i * per:(i + 1) * per])
    recs = loaders.load_cifar10(str(tmp_path), train=train)
    _same_records(recs, jloaders.load_cifar10(str(tmp_path), train=train))
    np.testing.assert_array_equal(
        np.frombuffer(recs[0].data, np.uint8).reshape(3, 32, 32),
        imgs[0][::-1])                                # RGB -> BGR planes
    assert loaders.CIFAR10_TRAIN_MEAN == jloaders.CIFAR10_TRAIN_MEAN
    assert loaders.CIFAR10_TEST_STD == jloaders.CIFAR10_TEST_STD


def _write_idx(folder, gz):
    rs = np.random.RandomState(0)
    imgs = (rs.rand(10, 28, 28) * 255).astype(np.uint8)
    labels = (np.arange(10) % 10).astype(np.uint8)
    img_bytes = struct.pack(">IIII", 2051, 10, 28, 28) + imgs.tobytes()
    lbl_bytes = struct.pack(">II", 2049, 10) + labels.tobytes()
    for name, payload in zip(("train-images-idx3-ubyte",
                              "train-labels-idx1-ubyte"),
                             (img_bytes, lbl_bytes)):
        if gz:
            with gzip.open(os.path.join(folder, name + ".gz"), "wb") as f:
                f.write(payload)
        else:
            with open(os.path.join(folder, name), "wb") as f:
                f.write(payload)
    return imgs, labels


@pytest.mark.parametrize("gz", [True, False], ids=["gz", "raw"])
def test_mnist_read_data_sets(tmp_path, gz):
    imgs, labels = _write_idx(str(tmp_path), gz)
    got = mnist.read_data_sets(str(tmp_path), "train")
    want = jmnist.read_data_sets(str(tmp_path), "train")
    assert got[0].shape == (10, 28, 28, 1)          # reference layout
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][..., 0], imgs)
    np.testing.assert_array_equal(got[1], labels)
    assert (mnist.TRAIN_MEAN, mnist.TRAIN_STD, mnist.TEST_MEAN,
            mnist.TEST_STD) == (jmnist.TRAIN_MEAN, jmnist.TRAIN_STD,
                                jmnist.TEST_MEAN, jmnist.TEST_STD)


@pytest.mark.parametrize("kind", ["images", "labels"])
def test_mnist_bad_magic(tmp_path, kind):
    p = tmp_path / "bad"
    p.write_bytes(struct.pack(">IIII", 1234, 1, 28, 28) + b"\0" * 784)
    fn = mnist.extract_images if kind == "images" else mnist.extract_labels
    with pytest.raises(ValueError, match="invalid magic 1234"):
        with open(p, "rb") as f:
            fn(f)


def test_maybe_download_is_local_first(tmp_path, monkeypatch):
    p = tmp_path / "present.bin"
    p.write_bytes(b"data")

    def no_network(*args, **kwargs):
        raise AssertionError("maybe_download reached for the network")
    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    got = base.maybe_download("present.bin", str(tmp_path),
                              "http://example.invalid/present.bin")
    assert got == str(p) == jbase.maybe_download(
        "present.bin", str(tmp_path), "http://example.invalid/present.bin")


def test_maybe_download_offline_error(tmp_path, monkeypatch):
    calls = []

    def offline(url, dest):
        calls.append(url)
        raise OSError("network is unreachable")
    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    url = "http://example.invalid/absent.bin"
    with pytest.raises(IOError, match="stage the file") as got:
        base.maybe_download("absent.bin", str(tmp_path / "w"), url)
    with pytest.raises(IOError) as want:
        jbase.maybe_download("absent.bin", str(tmp_path / "w"), url)
    assert calls == [url, url]
    assert str(got.value).replace("Training hosts", "TPU hosts") == \
        str(want.value)
    assert not os.path.exists(str(tmp_path / "w" / "absent.bin"))


def _news20_archive(folder):
    tree = os.path.join(folder, "src", "20_newsgroup")
    os.makedirs(tree)
    # a stray top-level file sorting before the class folders takes no
    # label id; a non-numeric document name is skipped
    with open(os.path.join(tree, "README"), "w") as f:
        f.write("stray")
    for cls, items in [("alt.atheism", {"101": "first text",
                                        "49": "second \xe9 text"}),
                       ("comp.graphics", {"201": "third text",
                                          "notdigit": "skipped"}),
                       ("sci.space", {"7": "fourth"})]:
        os.makedirs(os.path.join(tree, cls))
        for fname, text in items.items():
            with open(os.path.join(tree, cls, fname), "w",
                      encoding="latin-1") as f:
                f.write(text)
    with tarfile.open(os.path.join(folder, "20news-19997.tar.gz"),
                      "w:gz") as tar:
        tar.add(tree, arcname="20_newsgroup")


def test_get_news20(tmp_path):
    _news20_archive(str(tmp_path / "a"))
    _news20_archive(str(tmp_path / "b"))
    got = news20.get_news20(str(tmp_path / "a"))
    assert got == jnews20.get_news20(str(tmp_path / "b"))
    assert [lbl for _, lbl in got] == [1, 1, 2, 3]
    assert got[0] == ("first text", 1) and got[1][0] == "second \xe9 text"


def test_get_glove_w2v(tmp_path):
    lines = ("hello " + " ".join(["0.5"] * 50) + "\n"
             "world " + " ".join(["-1.25"] * 50) + "\n")
    for d in ("a", "b"):
        os.makedirs(str(tmp_path / d))
        with zipfile.ZipFile(str(tmp_path / d / "glove.6B.zip"), "w") as zf:
            zf.writestr("glove.6B.50d.txt", lines)
    got = news20.get_glove_w2v(str(tmp_path / "a"), dim=50)
    want = jnews20.get_glove_w2v(str(tmp_path / "b"), dim=50)
    assert set(got) == set(want) == {"hello", "world"}
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["world"], np.full(50, -1.25))


def test_news20_defaults_to_the_temporary_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(news20.tempfile, "tempdir", str(tmp_path))
    _news20_archive(str(tmp_path / "news20"))
    assert news20.get_news20()[0] == ("first text", 1)


def test_lambda_normalizer_and_identity():
    s = Sample(np.full((2, 2), 4.0, np.float32), 1.0)
    out = list(Lambda(normalizer(1.0, 2.0))([s]))
    want = list(jtransformer.Lambda(jtransformer.normalizer(1.0, 2.0))(
        [jtransformer.Sample(np.full((2, 2), 4.0, np.float32), 1.0)]))
    np.testing.assert_array_equal(out[0].feature, want[0].feature)
    np.testing.assert_array_equal(out[0].feature, np.full((2, 2), 1.5))
    assert out[0].feature.dtype == np.float32 and float(out[0].label) == 1.0
    ds = DataSet.array([s, s]) >> Identity() >> Lambda(normalizer(0.0, 4.0))
    assert [float(x.feature[0, 0]) for x in ds.data(train=False)] == \
        [1.0, 1.0]
