"""Uncompressed Hadoop SequenceFile reader and writer
(``bigdl_tpu/dataset/hadoop_seqfile.py``), pure Python, no JVM.

The reference's ImageNet datasets are Hadoop SequenceFiles of Text->Text
records (``dataset/image/BGRImgToLocalSeqFile.scala:30-83`` writes
``new Text(imageKey), new Text(dimPrefixedBgrBytes)``;
``dataset/image/LocalSeqFileToBytes.scala:35-90`` reads them back).
``read_seq_file`` and ``LocalSeqFileToBytes`` sniff the container magic and
route such files here; the port's own "BTSF" container is the other one.
Files written here are byte for byte the JAX package's (the sync marker is
the md5 of the path and ``sync_seed``, so one path gives one file).

Wire format (SequenceFile version 6, record-oriented, no compression):

    header:  b"SEQ" + version byte
             keyClassName, valueClassName      (Text.writeString: VInt+utf8)
             compressed? (1 byte), blockCompressed? (1 byte)  - both 0 here
             metadata count (4B BE) + count * (Text key, Text value)
             sync marker (16 bytes)
    record:  recordLength (4B BE)  - total serialized key+value bytes
             keyLength    (4B BE)
             key bytes, value bytes
    sync:    recordLength == -1 -> next 16 bytes must equal the header
             sync marker (the writer emits one every ~2000 bytes)

Serialization per class: ``org.apache.hadoop.io.Text`` is VInt length +
raw bytes; ``org.apache.hadoop.io.BytesWritable`` is 4-byte BE length +
raw bytes.  Values come back with the length prefix stripped (the payload
the reference's ``value.copyBytes()`` saw).
"""

from __future__ import annotations

import os
import struct
from typing import IO, Iterable, Iterator, Tuple, Union

HADOOP_MAGIC = b"SEQ"
TEXT = "org.apache.hadoop.io.Text"
BYTES_WRITABLE = "org.apache.hadoop.io.BytesWritable"
SYNC_SIZE = 16
SYNC_INTERVAL = 100 * (SYNC_SIZE + 4)      # hadoop's default cadence


# -- Hadoop VInt (WritableUtils.writeVInt/readVInt) ---------------------------

def write_vint(value: int) -> bytes:
    if -112 <= value <= 127:
        return struct.pack("b", value)
    length = 0
    tmp = value if value >= 0 else (~value)
    while tmp:
        tmp >>= 8
        length += 1
    first = -(length + 112) if value >= 0 else -(length + 120)
    mag = value if value >= 0 else ~value
    return struct.pack("b", first) + mag.to_bytes(length, "big")


def read_vint(f: IO[bytes]) -> int:
    first = struct.unpack("b", f.read(1))[0]
    if first >= -112:
        return first
    negative = first < -120
    length = -(first + 120) if negative else -(first + 112)
    mag = int.from_bytes(f.read(length), "big")
    return ~mag if negative else mag


def _read_text_string(f: IO[bytes]) -> str:
    return f.read(read_vint(f)).decode("utf-8")


def _write_text_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return write_vint(len(b)) + b


# -- reader -------------------------------------------------------------------

def _decode_writable(raw: bytes, class_name: str) -> bytes:
    """Strip the per-class length prefix from one serialized writable."""
    import io
    if class_name == TEXT:
        f = io.BytesIO(raw)
        n = read_vint(f)
        return f.read(n)
    if class_name == BYTES_WRITABLE:
        (n,) = struct.unpack(">i", raw[:4])
        return raw[4:4 + n]
    # unknown writable: hand back the serialized bytes untouched
    return raw


def is_hadoop_seq_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(3) == HADOOP_MAGIC


def read_hadoop_seq_file(path: str) -> Iterator[Tuple[str, bytes]]:
    """Stream (key_text, value_bytes) records — the interface
    ``LocalSeqFileToBytes`` consumes (key decoded as utf-8 text to match
    the reference's Text keys; value prefix-stripped raw bytes)."""
    for k, v in read_hadoop_seq_file_raw(path):
        yield k.decode("utf-8"), v


def read_hadoop_seq_file_raw(path: str) -> Iterator[Tuple[bytes, bytes]]:
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != HADOOP_MAGIC:
            raise ValueError(f"{path}: not a Hadoop SequenceFile")
        version = f.read(1)[0]
        if version < 5:
            raise ValueError(
                f"{path}: SequenceFile version {version} predates "
                "per-record sync markers; only version >= 5 is supported")
        key_class = _read_text_string(f)
        value_class = _read_text_string(f)
        compressed = f.read(1)[0] != 0
        block_compressed = f.read(1)[0] != 0
        if compressed or block_compressed:
            raise ValueError(
                f"{path}: compressed SequenceFiles are not supported "
                "(the reference's ImageNet generator writes uncompressed; "
                "re-export with compression off)")
        (meta_count,) = struct.unpack(">i", f.read(4))
        for _ in range(meta_count):
            _read_text_string(f)
            _read_text_string(f)
        sync = f.read(SYNC_SIZE)

        while True:
            head = f.read(4)
            if not head:
                return
            if len(head) < 4:
                raise ValueError(f"{path}: truncated record header")
            (rec_len,) = struct.unpack(">i", head)
            if rec_len == -1:                      # sync escape
                marker = f.read(SYNC_SIZE)
                if marker != sync:
                    raise ValueError(f"{path}: corrupt sync marker")
                continue
            (key_len,) = struct.unpack(">i", f.read(4))
            if key_len < 0 or key_len > rec_len or \
                    f.tell() + rec_len > fsize:
                raise ValueError(f"{path}: corrupt record lengths")
            key_raw = f.read(key_len)
            val_raw = f.read(rec_len - key_len)
            yield (_decode_writable(key_raw, key_class),
                   _decode_writable(val_raw, value_class))


def count_hadoop_records(path: str) -> int:
    """Record count by header-skip (no payload decode)."""
    n = 0
    for _ in read_hadoop_seq_file_raw(path):
        n += 1
    return n


# -- writer -------------------------------------------------------------------

class HadoopSeqFileWriter:
    """Write Text->Text records bit-compatible with the reference's
    ``BGRImgToLocalSeqFile`` output (so files produced here are readable
    by actual Hadoop/BigDL, and vice versa)."""

    def __init__(self, path: str, key_class: str = TEXT,
                 value_class: str = TEXT, sync_seed: int = 0):
        import hashlib
        self.path = path
        self.key_class = key_class
        self.value_class = value_class
        self._f = open(path, "wb")
        self._sync = hashlib.md5(
            f"{path}:{sync_seed}".encode()).digest()[:SYNC_SIZE]
        self._last_sync_pos = 0
        self._f.write(HADOOP_MAGIC + bytes([6]))
        self._f.write(_write_text_string(key_class))
        self._f.write(_write_text_string(value_class))
        self._f.write(b"\x00\x00")                 # no (block) compression
        self._f.write(struct.pack(">i", 0))        # empty metadata
        self._f.write(self._sync)

    def _encode(self, data: bytes, class_name: str) -> bytes:
        if class_name == TEXT:
            return write_vint(len(data)) + data
        if class_name == BYTES_WRITABLE:
            return struct.pack(">i", len(data)) + data
        raise ValueError(f"unsupported writable {class_name}")

    def append(self, key: Union[str, bytes], value: bytes) -> None:
        kb = key.encode("utf-8") if isinstance(key, str) else key
        k = self._encode(kb, self.key_class)
        v = self._encode(value, self.value_class)
        if self._f.tell() >= self._last_sync_pos + SYNC_INTERVAL:
            self._f.write(struct.pack(">i", -1))
            self._f.write(self._sync)
            self._last_sync_pos = self._f.tell()
        self._f.write(struct.pack(">ii", len(k) + len(v), len(k)))
        self._f.write(k)
        self._f.write(v)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_hadoop_seq_file(path: str,
                          records: Iterable[Tuple[Union[str, bytes], bytes]],
                          key_class: str = TEXT,
                          value_class: str = TEXT) -> str:
    with HadoopSeqFileWriter(path, key_class, value_class) as w:
        for k, v in records:
            w.append(k, v)
    return path
