"""Packed image record files, the ImageNet-scale ingest path
(``bigdl_tpu/dataset/seqfile.py``).

Parity: the reference stores ImageNet as Hadoop SequenceFiles of raw scaled
BGR bytes and streams them back at train time:

* ``dataset/image/BGRImgToLocalSeqFile.scala:30-83``: the writer, blocks of
  ``blockSize`` records per file, key ``"label"`` (or ``"name\\nlabel"``),
  value a 4-byte width and a 4-byte height, then interleaved BGR bytes.
* ``dataset/image/LocalSeqFileToBytes.scala:35-90``: the reader, record
  files -> ``ByteRecord`` stream (dim-prefixed bytes, float label).
* ``models/utils/ImageNetSeqFileGenerator.scala``: folder of images ->
  record-file shards.
* ``dataset/DataSet.scala:410-449``: ``SeqFileFolder`` and ``readLabel``.

The port's own container is the JAX package's "BTSF" record file, byte for
byte: the same logical record (key text, dim-prefixed BGR bytes), no JVM.
Real Hadoop SequenceFiles ingest too: ``read_seq_file`` sniffs the magic
per file and routes ``SEQ\\x06`` containers through
``dataset/hadoop_seqfile.py``.  Files are the unit a dataset shuffles.
A BTSF file's record offsets come from the native host library's scan
(``bn_seqfile_scan``, one buffered pass in C) and its records are sliced
out of an mmap; ``native=False`` reads them by the plain Python loop over
the record headers.  A file opens through ``_open_retry`` (transient
errors retried; the ``io.read`` fault site).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch import native as _native
from bigdl_tpu_torch.dataset import hadoop_seqfile
from bigdl_tpu_torch.dataset.image import ByteRecord, LabeledImage
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector
from bigdl_tpu_torch.resilience.retry import retry

MAGIC = b"BTSF\x01"


def _open_retry(path: str):
    """Open a record file, retrying transient errors (NFS or object-store
    hiccups must not kill an epoch; the reference inherited this from
    Spark's task re-execution).  ``io.read`` is the fault site."""
    def do_open():
        FaultInjector.fire("io.read")
        return open(path, "rb")
    return retry(do_open, label=f"seqfile open {os.path.basename(path)}")


class LocalSeqFilePath:
    """A path to one record file (``dataset/Types.scala`` LocalSeqFilePath)."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path


# -- the container ------------------------------------------------------------

class SeqFileWriter:
    """Append (key: str, value: bytes) records to one file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)

    def append(self, key: str, value: bytes) -> None:
        kb = key.encode("utf-8")
        self._f.write(struct.pack(">II", len(kb), len(value)))
        self._f.write(kb)
        self._f.write(value)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_seq_file(path: str, native: bool = True
                  ) -> Iterator[Tuple[str, bytes]]:
    """Stream (key, value) records out of one file: a BTSF record file, or a
    Hadoop SequenceFile (``SEQ\\x06``, an existing BigDL ImageNet shard)
    through ``dataset/hadoop_seqfile.py``.  A BTSF file's offsets come
    from the native scan and its records from an mmap (``native=False``:
    the Python loop over its headers)."""
    if hadoop_seqfile.is_hadoop_seq_file(path):
        yield from hadoop_seqfile.read_hadoop_seq_file(path)
        return
    if native:
        import mmap
        key_off, key_len, val_off, val_len = _native.seqfile_scan(path)
        with _open_retry(path) as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                for ko, kl, vo, vl in zip(key_off.tolist(), key_len.tolist(),
                                          val_off.tolist(), val_len.tolist()):
                    yield mm[ko:ko + kl].decode("utf-8"), mm[vo:vo + vl]
            finally:
                mm.close()
        return
    with _open_retry(path) as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a BTSF record file")
        while True:
            head = f.read(8)
            if not head:
                return
            if len(head) < 8:
                raise ValueError(f"{path}: truncated record")
            klen, vlen = struct.unpack(">II", head)
            key = f.read(klen).decode("utf-8")
            value = f.read(vlen)
            if len(value) != vlen:
                raise ValueError(f"{path}: truncated record")
            yield key, value


def count_records(path: str, native: bool = True) -> int:
    """Number of records in one file, by a header-skip pass that decodes no
    payload (the native scan's counting pass; ``native=False``: a Python
    loop).  ``DataSet.seq_file_folder``'s ``size()`` sums it, so epoch
    triggers count images, not files (the reference's RDD elements are
    records)."""
    if hadoop_seqfile.is_hadoop_seq_file(path):
        return hadoop_seqfile.count_hadoop_records(path)
    if native:
        return _native.seqfile_count(path)
    n = 0
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a BTSF record file")
        while True:
            head = f.read(8)
            if not head:
                return n
            if len(head) < 8:
                raise ValueError(f"{path}: truncated record")
            klen, vlen = struct.unpack(">II", head)
            # fail fast on a cut-short last record: seek() past the end
            # succeeds silently, and the read would fail mid-epoch
            if f.tell() + klen + vlen > fsize:
                raise ValueError(f"{path}: truncated record")
            f.seek(klen + vlen, 1)
            n += 1


def read_label(key: str) -> str:
    """The label text of a record key (``DataSet.scala:410-415``): the key
    is ``"label"`` or ``"name\\nlabel"``."""
    return key.rsplit("\n", 1)[-1]


# -- the image record codec ---------------------------------------------------

def encode_bgr_image(img: np.ndarray, normalize: float = 1.0) -> bytes:
    """float HxWx3 BGR -> dim-prefixed uint8 bytes (the writer's value,
    ``BGRImgToLocalSeqFile.scala:62-67`` and ``Types.scala``
    convertToByte)."""
    h, w = img.shape[:2]
    data = np.clip(np.round(img * normalize), 0, 255).astype(np.uint8)
    return struct.pack(">II", w, h) + data.tobytes()


def decode_bgr_bytes(data: bytes, normalize: float = 255.0) -> np.ndarray:
    """Dim-prefixed bytes -> float HxWx3 BGR / normalize
    (``Types.scala`` BGRImage.copy(rawData))."""
    w, h = struct.unpack(">II", data[:8])
    img = np.frombuffer(data, np.uint8, count=h * w * 3, offset=8)
    return img.reshape(h, w, 3).astype(np.float32) / normalize


# -- transformers -------------------------------------------------------------

class BGRImgToLocalSeqFile(Transformer):
    """LabeledImage (or (LabeledImage, name)) stream -> record files of
    ``block_size`` images each; yields each finished file's path
    (``BGRImgToLocalSeqFile.scala:30-83``)."""

    def __init__(self, block_size: int, base_file_name: str,
                 has_name: bool = False, normalize: float = 1.0):
        self.block_size = block_size
        self.base_file_name = base_file_name
        self.has_name = has_name
        self.normalize = normalize

    def _record(self, item):
        if self.has_name:
            image, name = item
            key = f"{name}\n{int(image.label)}"
        else:
            image = item
            key = f"{int(image.label)}"
        return key, encode_bgr_image(image.data, self.normalize)

    def apply(self, prev):
        index = 0
        prev = iter(prev)
        for first in prev:
            file_name = f"{self.base_file_name}_{index}.seq"
            with SeqFileWriter(file_name) as w:
                w.append(*self._record(first))
                for _, item in zip(range(self.block_size - 1), prev):
                    w.append(*self._record(item))
            index += 1
            yield file_name


class LocalSeqFileToBytes(Transformer):
    """Record-file paths (or ``LocalSeqFilePath``s) -> ByteRecord stream
    with float labels (``LocalSeqFileToBytes.scala:35-90``).

    Each file's read is one ``seqfile.read`` ``io`` record in the run
    ledger, its time added up around the generator pulls and written once
    the file is done (or the consumer stops), so only the read is
    attributed.  An ``io`` record, not a span: the same seconds already
    sit inside the span pulling the pipeline (``data.next``), and the run
    report lists them apart instead of counting them twice."""

    def apply(self, prev):
        for item in prev:
            path = item.path if isinstance(item, LocalSeqFilePath) else item
            if run_ledger.get_ledger() is None:
                for key, value in read_seq_file(path):
                    yield ByteRecord(value, float(read_label(key)))
                continue
            spent = 0.0
            count = 0
            it = read_seq_file(path)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        key, value = next(it)
                    except StopIteration:
                        spent += time.perf_counter() - t0
                        break
                    spent += time.perf_counter() - t0
                    count += 1
                    yield ByteRecord(value, float(read_label(key)))
            finally:
                # a consumer that stops mid-file still gets its partial
                # time ledgered
                run_ledger.emit("io", name="seqfile.read", dur_s=spent,
                                file=os.path.basename(path), records=count)


class SeqBytesToBGRImg(Transformer):
    """Dim-prefixed ByteRecord -> float BGR LabeledImage (the record-file
    form of ``BytesToBGRImg``; the reference parses the same 8-byte prefix
    in ``BGRImage.copy``)."""

    def __init__(self, normalize: float = 255.0):
        self.normalize = normalize

    def apply(self, prev):
        for rec in prev:
            yield LabeledImage(decode_bgr_bytes(rec.data, self.normalize),
                               rec.label)


def seq_file_paths(folder: str) -> List[str]:
    """Every record file of a folder, sorted (``SeqFileFolder.files``)."""
    return sorted(os.path.join(folder, f) for f in os.listdir(folder)
                  if f.endswith(".seq"))


def host_shard_paths(folder: str, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> List[str]:
    """This host's share of a record-file folder in multi-host training."""
    raise NotImplementedError(
        "host_shard_paths (one host's share of a record-file folder) comes "
        "with the DistriOptimizer slice of the port (ROADMAP.md Queue 1 "
        "item 12)")


# -- the ImageNet generator ---------------------------------------------------

def _generate_shard(args):
    """One worker: its share of the (path, label) pairs -> record files."""
    from bigdl_tpu_torch.dataset.image import LocalImgReader
    pairs, base_name, block_size, scale_to, has_name = args
    imgs = LocalImgReader(scale_to=scale_to, normalize=1.0).apply(
        iter(pairs))
    if has_name:
        named = ((img, os.path.basename(p))
                 for img, (p, _) in zip(imgs, pairs))
        sink = BGRImgToLocalSeqFile(block_size, base_name, has_name=True)
        return list(sink.apply(named))
    return list(BGRImgToLocalSeqFile(block_size, base_name).apply(imgs))


def imagenet_seqfile_generator(folder: str, output: str, parallel: int = 1,
                               block_size: int = 12800,
                               scale_to: int = 256,
                               train: bool = True, validate: bool = True,
                               has_name: bool = False) -> List[str]:
    """Folder-per-class image tree (``train/`` and ``val/``) -> record-file
    shards (``models/utils/ImageNetSeqFileGenerator.scala``: -f folder,
    -o output, -p parallel, -b blockSize, -r hasName).  Each of the
    ``parallel`` writer threads writes its own file series (``-p<i>``), as
    the reference's writer threads do.  Images read through the port's
    ``LocalImgReader``, so PNG trees need no PIL."""
    from bigdl_tpu_torch.dataset.image import image_folder_paths

    written: List[str] = []
    splits = (["train"] if train else []) + (["val"] if validate else [])
    for split in splits:
        dst = os.path.join(output, split)
        os.makedirs(dst, exist_ok=True)
        for stale in seq_file_paths(dst):   # a rerun must not mix in old
            os.remove(stale)                # records
        pairs = image_folder_paths(os.path.join(folder, split))
        tasks = [(pairs[i::parallel], os.path.join(dst, f"imagenet-p{i}"),
                  block_size, scale_to, has_name)
                 for i in range(parallel) if pairs[i::parallel]]
        if len(tasks) > 1:
            # threads: decode, resize and file IO release the GIL, and
            # threads are the reference's model (one writer a slot)
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(len(tasks)) as pool:
                for files in pool.map(_generate_shard, tasks):
                    written.extend(files)
        else:
            for t in tasks:
                written.extend(_generate_shard(t))
    return written


def check_file(path: str) -> dict:
    """The ingest check of one record file from any producer
    (``python -m bigdl_tpu_torch.dataset.seqfile --check FILE``): sniffs
    the container magic, scans every record and decodes the first four
    through the training pipeline's transformers."""
    import itertools

    info = {"path": path}
    with open(path, "rb") as f:
        magic = f.read(4)
    if len(magic) < 4:
        raise ValueError(
            f"{path}: truncated/not a record file ({len(magic)} bytes — "
            "need at least a 4-byte container magic)")
    if magic[:3] == b"SEQ":
        info["container"] = "hadoop SequenceFile v%d" % magic[3]
    else:
        info["container"] = "BTSF record file"
    info["records"] = sum(1 for _ in read_seq_file(path))
    decoded = 0
    pipeline = SeqBytesToBGRImg().apply(
        LocalSeqFileToBytes().apply(iter([path])))
    for img in itertools.islice(pipeline, 4):
        # raise, not assert: the check must hold under python -O
        if img.data.ndim != 3 or img.data.shape[2] != 3:
            raise ValueError(f"bad decoded shape {img.data.shape}")
        if not np.isfinite(img.data).all():
            raise ValueError("non-finite pixels in decoded record")
        decoded += 1
    info["decoded_through_pipeline"] = decoded
    return info


def main(argv=None):
    """``--check FILE``, or the ImageNet generator's flags."""
    import argparse
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if "--check" in argv:
        cp = argparse.ArgumentParser("seqfile-check")
        cp.add_argument("--check", metavar="FILE", required=True)
        info = check_file(cp.parse_args(argv).check)
        print(info)
        return info
    p = argparse.ArgumentParser("imagenet-seqfile-generator")
    p.add_argument("-f", "--folder", required=True,
                   help="ImageNet root with train/ and val/ class folders")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-p", "--parallel", type=int, default=1)
    p.add_argument("-b", "--blockSize", type=int, default=12800)
    p.add_argument("-s", "--scaleTo", type=int, default=256)
    p.add_argument("-r", "--hasName", action="store_true")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--trainOnly", action="store_true")
    which.add_argument("--validationOnly", action="store_true")
    args = p.parse_args(argv)
    files = imagenet_seqfile_generator(
        args.folder, args.output, parallel=args.parallel,
        block_size=args.blockSize, scale_to=args.scaleTo,
        train=not args.validationOnly, validate=not args.trainOnly,
        has_name=args.hasName)
    print(f"wrote {len(files)} record files")
    return files


if __name__ == "__main__":
    main()
