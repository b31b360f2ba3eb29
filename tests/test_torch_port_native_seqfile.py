"""The native record scan of the port's ``dataset/seqfile.py`` and the
sharded feed's host split of a record folder, against the Python reader and
the JAX package's.

Mirrors ``tests/test_native_seqfile.py`` case for case.  Exact: the native
scan's records equal the Python reader's and the reference's, key and value
byte for byte, and its count equals theirs; a bad magic and a truncated
last record raise ``ValueError`` in both.  The reference's
``host_shard_paths`` reads the process index and count, which the port
reads with the DistriOptimizer slice (``ROADMAP.md`` Queue 1 item 12): the
port's raises naming it, and ``ShardedDataSet.from_seq_folder``'s
``host_index``/``host_count`` split the files as the reference's
``worker_shard`` does.
"""

import numpy as np
import pytest

from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset import seqfile as tseq
from bigdl_tpu_torch.dataset.image import LabeledImage


def _write(tmp_path, n=7):
    rng = np.random.RandomState(0)
    imgs = [LabeledImage(rng.randint(0, 256, (6, 5, 3))
                         .astype(np.float32), float(i % 3 + 1))
            for i in range(n)]
    return list(tseq.BGRImgToLocalSeqFile(100, str(tmp_path / "part"))
                .apply(iter(imgs)))


def test_native_scan_matches_python_reader(tmp_path):
    files = _write(tmp_path)
    fast = list(tseq.read_seq_file(files[0]))
    slow = list(tseq.read_seq_file(files[0], native=False))
    ref = list(jseq.read_seq_file(files[0]))
    assert len(fast) == len(slow) == len(ref) == 7
    for (ka, va), (kb, vb), (kc, vc) in zip(fast, slow, ref):
        assert ka == kb == kc and va == vb == vc
    assert tseq.count_records(files[0]) == \
        tseq.count_records(files[0], native=False) == \
        jseq.count_records(files[0]) == 7
    empty = tmp_path / "empty.seq"
    with tseq.SeqFileWriter(str(empty)):
        pass
    assert list(tseq.read_seq_file(str(empty))) == []
    assert tseq.count_records(str(empty)) == 0


def test_native_scan_rejects_garbage_and_truncation(tmp_path):
    bad = tmp_path / "bad.seq"
    bad.write_bytes(b"JUNKJUNKJUNK")
    with pytest.raises(ValueError, match="not a BTSF"):
        native.seqfile_scan(str(bad))
    with pytest.raises(ValueError, match="not a BTSF"):
        list(tseq.read_seq_file(str(bad)))

    files = _write(tmp_path, n=3)
    blob = open(files[0], "rb").read()
    trunc = tmp_path / "trunc.seq"
    trunc.write_bytes(blob[:-5])
    for read in (native.seqfile_scan, native.seqfile_count,
                 lambda p: list(tseq.read_seq_file(p, native=False)),
                 jseq.count_records):
        with pytest.raises(ValueError, match="truncated"):
            read(str(trunc))
    with pytest.raises(OSError):
        native.seqfile_count(str(tmp_path / "missing.seq"))


def test_host_shard_paths_round_robin(tmp_path):
    from bigdl_tpu.dataset.sharded import worker_shard as jworker_shard
    from bigdl_tpu_torch.dataset import ShardedDataSet
    for i in range(5):
        with tseq.SeqFileWriter(str(tmp_path / f"f{i}.seq")) as w:
            w.append("1", b"x")
    all_paths = tseq.seq_file_paths(str(tmp_path))
    assert all_paths == jseq.seq_file_paths(str(tmp_path))
    assert len(all_paths) == 5
    with pytest.raises(NotImplementedError, match="item 12"):
        tseq.host_shard_paths(str(tmp_path), 0, 2)
    shards = [ShardedDataSet.from_seq_folder(str(tmp_path), workers=0,
                                             host_index=h, host_count=2)
              for h in range(2)]
    assert [len(s.items) for s in shards] == [3, 2]
    assert shards[0].items + shards[1].items == all_paths
    for h, s in enumerate(shards):
        assert s.items == jworker_shard(all_paths, h, 2, 0, 1)
        assert s.size() == len(s.items)       # one record a file
    # the default is process 0 of 1: everything
    assert ShardedDataSet.from_seq_folder(str(tmp_path), workers=0).items \
        == all_paths
