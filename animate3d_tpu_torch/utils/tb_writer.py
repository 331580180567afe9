"""Dependency-free TensorBoard scalar event writer (a copy of
``animate3d_tpu/utils/tb_writer.py``: pure Python).

Parity target: the reference's TensorBoard logger surface
(launch.py:212-227 builds `TensorBoardLogger`; train.py:610-611 logs scalars
rank-0). tensorflow/tensorboardX are not dependencies here, so this writes
the on-disk format directly:

  * TFRecord framing — each record is
      uint64 length | uint32 masked_crc32c(length) | payload
      | uint32 masked_crc32c(payload)
    with the Castagnoli CRC and TF's mask rotation;
  * hand-encoded `tensorflow.Event` protobuf messages (wall_time=1 double,
    step=2 int64, file_version=3 string, summary=9 message) with
    `Summary.Value{tag=1 string, simple_value=2 float}` — the tiny subset
    TensorBoard's scalars dashboard reads.

Files land as ``events.out.tfevents.<ts>.<host>`` under ``log_dir`` and load
in stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# --- crc32c (Castagnoli, table-driven; TFRecord checksums) ------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # reflected Castagnoli
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding ----------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _i64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    msg = _f64(1, wall_time)
    if step is not None:
        msg += _i64(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary is not None:
        msg += _bytes_field(9, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _bytes_field(1, tag.encode()) + _f32(2, float(value))
    return _bytes_field(1, val)


class TBWriter:
    """Scalar summary writer readable by stock TensorBoard."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int,
               wall_time: Optional[float] = None) -> None:
        self._record(_event(wall_time if wall_time is not None else time.time(),
                            step=step, summary=_scalar_summary(tag, value)))

    def scalars(self, metrics, step: int) -> None:
        t = time.time()
        for k, v in metrics.items():
            try:
                self.scalar(k, float(v), step, wall_time=t)
            except (TypeError, ValueError):
                continue  # non-numeric (strings etc.) — JSONL keeps those

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_events(path: str):
    """Parse a TB event file back into [(step, tag, value)] — the framing/
    proto inverse, used by tests and debugging (no TF dependency)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt header crc"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "corrupt payload crc"
            out.extend(_parse_event(payload))
    return out


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:  # pragma: no cover
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _parse_event(payload: bytes):
    step, summary = 0, None
    for field, wire, v in _fields(payload):
        if field == 2 and wire == 0:
            step = v
        elif field == 9 and wire == 2:
            summary = v
    if summary is None:
        return []
    out = []
    for field, wire, val in _fields(summary):
        if field == 1 and wire == 2:  # Summary.Value
            tag, value = None, None
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    tag = v2.decode()
                elif f2 == 2 and w2 == 5:
                    (value,) = struct.unpack("<f", v2)
            if tag is not None:
                out.append((step, tag, value))
    return out
