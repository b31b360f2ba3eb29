"""The port's record files (``bigdl_tpu_torch.dataset.seqfile``,
``hadoop_seqfile``, ``ingest_config`` and ``DataSet.seq_file_folder``)
against the JAX package's.

Files the port writes are byte for byte the reference's (BTSF, and Hadoop
SequenceFiles written to one path, whose sync marker is the md5 of the
path), and each package reads the other's records.  The decoded images are
equal.  The generator's records from a PNG tree hold the same keys, sizes
and labels as the reference's (which reads through PIL), their pixels
within 1 of 255 on at most 2 % of the values where a resize runs, as
``tests/test_torch_port_images.py`` holds ``LocalImgReader``.  The ingest
knobs parse strictly, as the reference's do, and resolve dtypes to
torch's.  Mirrors ``tests/test_seqfile.py`` and
``tests/test_hadoop_seqfile.py``.
"""

import io
import os
import struct

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import hadoop_seqfile as jhadoop
from bigdl_tpu.dataset import ingest_config as jingest
from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.image import LabeledImage as JLabeledImage
from bigdl_tpu_torch.dataset import DataSet, LabeledImage
from bigdl_tpu_torch.dataset import hadoop_seqfile as thadoop
from bigdl_tpu_torch.dataset import ingest_config as tingest
from bigdl_tpu_torch.dataset import seqfile as tseq

RESIZE_SHARE = 0.02     # values that differ by 1 after a resize, at most


def _images(mod, n, seed=0, h=9, w=7):
    rs = np.random.RandomState(seed)
    return [mod(rs.randint(0, 256, (h + i % 3, w, 3)).astype(np.float32),
                float(rs.randint(1, 1001))) for i in range(n)]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- the containers -----------------------------------------------------------

@pytest.mark.parametrize("has_name", [False, True])
def test_btsf_files_are_the_reference_bytes(tmp_path, has_name):
    for pkg, mod, img in (("jax", jseq, JLabeledImage),
                          ("port", tseq, LabeledImage)):
        (tmp_path / pkg).mkdir()
        items = _images(img, 11)
        if has_name:
            items = [(x, f"n{i}.png") for i, x in enumerate(items)]
        files = list(mod.BGRImgToLocalSeqFile(
            4, str(tmp_path / pkg / "part"), has_name=has_name).apply(
                iter(items)))
        assert [os.path.basename(f) for f in files] == \
            ["part_0.seq", "part_1.seq", "part_2.seq"]
    for i in range(3):
        assert _bytes(tmp_path / "port" / f"part_{i}.seq") == \
            _bytes(tmp_path / "jax" / f"part_{i}.seq")
    # and each package reads the other's
    for i in range(3):
        got = list(tseq.read_seq_file(str(tmp_path / "jax" / f"part_{i}.seq")))
        want = list(jseq.read_seq_file(str(tmp_path / "port" /
                                           f"part_{i}.seq")))
        assert got == want and len(got) == (4 if i < 2 else 3)
        assert tseq.count_records(str(tmp_path / "jax" / f"part_{i}.seq")) \
            == len(got)


def test_codec_and_labels_match_the_reference():
    rs = np.random.RandomState(3)
    img = rs.uniform(-5, 300, (5, 6, 3)).astype(np.float32)
    for norm in (1.0, 255.0):
        raw = tseq.encode_bgr_image(img / norm, norm)
        assert raw == jseq.encode_bgr_image(img / norm, norm)
        np.testing.assert_array_equal(tseq.decode_bgr_bytes(raw),
                                      jseq.decode_bgr_bytes(raw))
    assert struct.unpack(">II", raw[:8]) == (6, 5)
    for key in ("7", "name.png\n12", "a\nb\n3"):
        assert tseq.read_label(key) == jseq.read_label(key)


def test_pipeline_decodes_the_reference_images(tmp_path):
    images = _images(JLabeledImage, 7, seed=5)
    files = list(jseq.BGRImgToLocalSeqFile(3, str(tmp_path / "p")).apply(
        iter(images)))
    got = list(tseq.SeqBytesToBGRImg()(tseq.LocalSeqFileToBytes()(
        [tseq.LocalSeqFilePath(files[0])] + files[1:])))
    want = list(jseq.SeqBytesToBGRImg()(jseq.LocalSeqFileToBytes()(files)))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
        assert g.data.dtype == np.float32
        assert g.label == w.label and isinstance(g.label, float)


@pytest.mark.parametrize("case", ["magic", "truncated"])
def test_bad_files_raise(tmp_path, case):
    path = str(tmp_path / "bad.seq")
    if case == "magic":
        with open(path, "wb") as f:
            f.write(b"NOPE" + b"\0" * 20)
        match = "not a BTSF record file"
    else:
        with tseq.SeqFileWriter(path) as w:
            w.append("1", b"x" * 50)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 10)
        match = "truncated record"
    for mod in (tseq, jseq):
        with pytest.raises(ValueError, match=match):
            mod.count_records(path)
    with pytest.raises(ValueError, match=match):
        list(tseq.read_seq_file(path))


def test_vint_matches_the_reference():
    for v in [0, 1, -1, 112, 127, -112, 128, -113, 255, 256, 65535, -65536,
              2 ** 31 - 1, -2 ** 31, 2 ** 40, -2 ** 40]:
        raw = thadoop.write_vint(v)
        assert raw == jhadoop.write_vint(v)
        assert thadoop.read_vint(io.BytesIO(raw)) == v


@pytest.mark.parametrize("value_class", ["text", "bytes"])
def test_hadoop_files_are_the_reference_bytes(tmp_path, value_class):
    """Both writers on one path (the sync marker is the md5 of the path),
    more payload than a sync interval, so sync escapes are written."""
    vc = thadoop.TEXT if value_class == "text" else thadoop.BYTES_WRITABLE
    rs = np.random.RandomState(1)
    records = [(f"k{i}\n{i % 10 + 1}", rs.bytes(300)) for i in range(40)]
    path = str(tmp_path / "h.seq")
    jhadoop.write_hadoop_seq_file(path, records, value_class=vc)
    want = _bytes(path)
    os.remove(path)
    thadoop.write_hadoop_seq_file(path, records, value_class=vc)
    assert _bytes(path) == want
    assert struct.pack(">i", -1) in want
    assert list(thadoop.read_hadoop_seq_file(path)) == \
        list(jhadoop.read_hadoop_seq_file(path))
    assert thadoop.count_hadoop_records(path) == 40
    assert thadoop.is_hadoop_seq_file(path)


def test_hadoop_records_read_back_through_the_pipeline(tmp_path):
    """The same records as a BTSF file and as a Hadoop SequenceFile give
    the same images through ``LocalSeqFileToBytes``; ``DataSet.
    seq_file_folder`` counts both containers' records."""
    images = _images(LabeledImage, 9, seed=8)
    (tmp_path / "btsf").mkdir()
    (tmp_path / "hadoop").mkdir()
    btsf = list(tseq.BGRImgToLocalSeqFile(5, str(tmp_path / "btsf" / "p"))
                .apply(iter(images)))
    for i, f in enumerate(btsf):
        thadoop.write_hadoop_seq_file(str(tmp_path / "hadoop" / f"h{i}.seq"),
                                      tseq.read_seq_file(f))
    pipe = tseq.LocalSeqFileToBytes() >> tseq.SeqBytesToBGRImg()
    got = list(pipe(tseq.seq_file_paths(str(tmp_path / "hadoop"))))
    want = list(pipe(btsf))
    assert len(got) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
        assert g.label == w.label
    for sub in ("btsf", "hadoop"):
        ds = DataSet.seq_file_folder(str(tmp_path / sub))
        assert ds.size() == 9 == \
            JDataSet.seq_file_folder(str(tmp_path / sub)).size()
        assert len(ds.buffer) == 2
        assert DataSet.seq_file_folder(str(tmp_path / sub),
                                       total_size=5).size() == 5


def test_check_file_and_main_match_the_reference(tmp_path, capsys):
    images = _images(LabeledImage, 5, seed=2)
    (path,) = tseq.BGRImgToLocalSeqFile(8, str(tmp_path / "c")).apply(
        iter(images))
    hpath = thadoop.write_hadoop_seq_file(str(tmp_path / "h.seq"),
                                          tseq.read_seq_file(path))
    for p in (path, hpath):
        got = tseq.main(["--check", p])
        assert got == jseq.check_file(p)
        assert got["records"] == 5 and got["decoded_through_pipeline"] == 4
    assert tseq.check_file(hpath)["container"] == "hadoop SequenceFile v6"
    (tmp_path / "short.seq").write_bytes(b"BT")
    with pytest.raises(ValueError, match="truncated/not a record file"):
        tseq.check_file(str(tmp_path / "short.seq"))


# -- the generator ------------------------------------------------------------

def _png_tree(root, seed=0):
    from bigdl_tpu_torch.dataset import png
    rs = np.random.RandomState(seed)
    sizes = [(300, 260), (256, 256), (270, 400), (240, 300), (256, 300)]
    for split, per in (("train", 3), ("val", 2)):
        for c in ("cat", "dog"):
            d = os.path.join(root, split, c)
            os.makedirs(d)
            for i in range(per):
                h, w = sizes[(i + len(c)) % len(sizes)]
                arr = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
                with open(os.path.join(d, f"{c}{i}.png"), "wb") as f:
                    f.write(png.encode_png(arr, [0, 1, 2, 3, 4]))


@pytest.mark.parametrize("has_name", [False, True])
def test_generator_records_match_the_reference(tmp_path, has_name):
    pytest.importorskip("PIL")      # the reference reads through PIL
    _png_tree(str(tmp_path / "img"))
    got_files = tseq.main(["-f", str(tmp_path / "img"), "-o",
                           str(tmp_path / "port"), "-p", "2", "-b", "2",
                           "-s", "256"] + (["-r"] if has_name else []))
    want_files = jseq.imagenet_seqfile_generator(
        str(tmp_path / "img"), str(tmp_path / "jax"), parallel=2,
        block_size=2, scale_to=256, has_name=has_name)
    rel = [os.path.relpath(f, str(tmp_path / "port")) for f in got_files]
    assert sorted(rel) == sorted(os.path.relpath(f, str(tmp_path / "jax"))
                                 for f in want_files)
    assert len(rel) == 6        # 2 writers a split, train 3 + 3, val 2 + 2
    diffs = []
    for r in rel:
        got = list(tseq.read_seq_file(str(tmp_path / "port" / r)))
        want = list(jseq.read_seq_file(str(tmp_path / "jax" / r)))
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g[:8] == w[:8]          # the same width and height
            diffs.append(np.abs(np.frombuffer(g[8:], np.uint8).astype(int) -
                                np.frombuffer(w[8:], np.uint8)))
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 1 and (diffs > 0).mean() <= RESIZE_SHARE
    # a rerun replaces the old records
    again = tseq.imagenet_seqfile_generator(
        str(tmp_path / "img"), str(tmp_path / "port"), parallel=1,
        block_size=10, validate=False)
    assert [os.path.basename(f) for f in again] == ["imagenet-p0_0.seq"]
    assert tseq.seq_file_paths(str(tmp_path / "port" / "train")) == again


# -- the dataset and the knobs ------------------------------------------------

def test_seq_file_folder_shuffles_files_as_the_reference(tmp_path):
    images = _images(LabeledImage, 10)
    list(tseq.BGRImgToLocalSeqFile(2, str(tmp_path / "p")).apply(
        iter(images)))
    got = DataSet.seq_file_folder(str(tmp_path), seed=3)
    want = JDataSet.seq_file_folder(str(tmp_path), seed=3)
    for _ in range(2):
        got.shuffle()
        want.shuffle()
        a, b = got.data(train=True), want.data(train=True)
        assert [next(a) for _ in range(7)] == [next(b) for _ in range(7)]
    assert list(got.data(train=False)) == tseq.seq_file_paths(str(tmp_path))


def test_later_items_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 12"):
        DataSet.seq_file_folder(str(tmp_path), num_shards=2)
    with pytest.raises(NotImplementedError, match="item 12"):
        DataSet.seq_file_folder(str(tmp_path), host_shard=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        tseq.host_shard_paths(str(tmp_path))


KNOBS = {"BIGDL_TPU_INGEST_DEPTH": ("depth", "4", 4),
         "BIGDL_TPU_INGEST_WORKERS": ("workers", "0", 0),
         "BIGDL_TPU_INGEST_CHUNK": ("chunk", "16", 16),
         "BIGDL_TPU_INGEST_START": ("start_method", "fork", "fork")}


@pytest.mark.parametrize("var", sorted(KNOBS))
def test_ingest_knobs_parse_as_the_reference(monkeypatch, var):
    name, raw, want = KNOBS[var]
    for mod in (tingest, jingest):
        monkeypatch.delenv(var, raising=False)
        default = getattr(mod, name)()
        monkeypatch.setenv(var, raw)
        assert getattr(mod, name)() == want
        monkeypatch.setenv(var, "x1")
        with pytest.raises(ValueError):
            getattr(mod, name)()
        monkeypatch.delenv(var)
        assert getattr(tingest, name)() == default == getattr(jingest,
                                                              name)()
    for mod in (tingest, jingest):
        if name == "start_method":
            assert mod.start_method("forkserver") == "forkserver"
        else:
            minimum = {"depth": 2, "workers": 0, "chunk": 1}[name]
            assert getattr(mod, name)(minimum) == minimum
            with pytest.raises(ValueError):
                getattr(mod, name)(minimum - 1)


def test_pack_dtype_resolves_to_torch(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_INGEST_DTYPE", raising=False)
    assert tingest.pack_dtype() is None is jingest.pack_dtype()
    for spelling, dt in (("bf16", torch.bfloat16), ("F32", torch.float32),
                         ("float16", torch.float16)):
        assert tingest.pack_dtype(spelling) is dt
        monkeypatch.setenv("BIGDL_TPU_INGEST_DTYPE", spelling)
        assert tingest.pack_dtype() is dt
        assert str(jingest.pack_dtype()) == str(dt).split(".")[1]
    assert tingest.pack_dtype(torch.float16) is torch.float16
    monkeypatch.setenv("BIGDL_TPU_INGEST_DTYPE", "int8")
    for mod in (tingest, jingest):
        with pytest.raises(ValueError, match="BIGDL_TPU_INGEST_DTYPE"):
            mod.pack_dtype()
