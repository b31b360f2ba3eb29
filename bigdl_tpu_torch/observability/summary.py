"""``TrainSummary`` / ``ValidationSummary`` — the reference's TensorBoard
facade, teed into the run ledger (``bigdl_tpu/observability/summary.py``;
the same scalars at the same wall times give byte-identical event files).

Parity: the reference's ``visualization/TrainSummary.scala`` +
``ValidationSummary.scala`` (python surface ``TrainSummary(log_dir,
app_name)``, ``read_scalar(tag)``, ``set_summary_trigger(name,
trigger)``; BigDL paper §4).  Scalars land in THREE places:

* in memory, for ``read_scalar(tag)`` (the notebook-plotting surface);
* the run ledger (``type: "scalar"``), so summaries survive the process
  and merge into ``run-report``;
* TensorBoard event files under ``<log_dir>/<app_name>/<train|
  validation>/`` — written by a minimal, dependency-free tfevents
  encoder (the Event/Summary protobuf wire format and the TFRecord
  masked-crc framing are both simple enough to emit by hand), so
  ``tensorboard --logdir`` works without tensorflow/tensorboardX
  installed in the training image.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.observability import ledger

# -- masked crc32c (TFRecord framing) -----------------------------------------

def _build_crc_table():
    poly = 0x82F63B78              # Castagnoli, reflected
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


# built eagerly at import: a lazy first-use init would race when two
# threads write their first scalar simultaneously
_CRC_TABLE = _build_crc_table()


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding (Event / Summary messages) ----------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _pb_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _pb_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _pb_varint(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _pb_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _event_bytes(wall_time: float, step: int,
                 tag: Optional[str] = None,
                 value: Optional[float] = None,
                 file_version: Optional[str] = None) -> bytes:
    # Event: 1=wall_time double, 2=step int64, 3=file_version string,
    # 5=summary; Summary: repeated 1=Value; Value: 1=tag, 2=simple_value
    ev = _pb_double(1, wall_time) + _pb_varint(2, step)
    if file_version is not None:
        ev += _pb_bytes(3, file_version.encode("utf-8"))
    if tag is not None:
        val = _pb_bytes(1, tag.encode("utf-8")) + _pb_float(2, float(value))
        ev += _pb_bytes(5, _pb_bytes(1, val))
    return ev


class TFEventWriter:
    """Append Event records to one ``events.out.tfevents.*`` file in the
    TFRecord framing TensorBoard reads (length + masked-crc(length) +
    payload + masked-crc(payload))."""

    _FLUSH_EVERY_S = 2.0       # throttled: per-scalar fsync-ish flushes
    #                            would tax the training loop for nothing
    #                            (the ledger is the durable copy)

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{os.getpid()}")
        self._f = open(self.path, "ab")
        self._last_flush = time.monotonic()
        self._write(_event_bytes(time.time(), 0,
                                 file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header)) +
                      payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write(_event_bytes(wall_time or time.time(), step,
                                 tag=tag, value=value))
        now = time.monotonic()
        if now - self._last_flush >= self._FLUSH_EVERY_S:
            self._last_flush = now
            self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()     # close() flushes buffered records
        except OSError:
            pass


# -- the facade ---------------------------------------------------------------

class Summary:
    """Base scalar-summary sink (shared by Train/Validation flavours)."""

    kind = "summary"

    def __init__(self, log_dir: str, app_name: str,
                 tensorboard: bool = True):
        self.log_dir = log_dir
        self.app_name = app_name
        self.logdir = os.path.join(log_dir, app_name, self.kind)
        self._scalars: Dict[str, List[Tuple[int, float, float]]] = {}
        self._triggers: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._writer = TFEventWriter(self.logdir) if tensorboard else None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        wall = time.time()
        with self._lock:
            self._scalars.setdefault(tag, []).append((step, value, wall))
            # writer stays under the lock: interleaved frames from two
            # threads would corrupt the TFRecord stream from that offset
            if self._writer is not None:
                self._writer.add_scalar(tag, value, step, wall_time=wall)
        ledger.emit("scalar", src=self.kind, tag=tag, value=value,
                    step=int(step))

    def read_scalar(self, tag: str) -> List[Tuple[int, float, float]]:
        """``[(step, value, wall_time), ...]`` for ``tag`` (reference
        ``TrainSummary.readScalar`` surface)."""
        with self._lock:
            return list(self._scalars.get(tag, []))

    def set_summary_trigger(self, name: str, trigger) -> "Summary":
        """Per-tag emission trigger (reference surface; the trainers
        consult it — tags without one are emitted every step)."""
        self._triggers[name] = trigger
        return self

    def trigger_for(self, name: str):
        return self._triggers.get(name)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class TrainSummary(Summary):
    """Per-step training scalars (``Loss``, ``Throughput``,
    ``LearningRate``)."""

    kind = "train"


class ValidationSummary(Summary):
    """Per-validation scalars, one tag per ``ValidationMethod``."""

    kind = "validation"
