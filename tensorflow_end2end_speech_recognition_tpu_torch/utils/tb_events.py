"""Minimal TensorBoard event-file writer (no TensorFlow dependency).

A copy of ``tensorflow_end2end_speech_recognition_tpu/utils/tb_events.py``
(framework-free), whose byte format that package's tests check against
TensorFlow's own reader:

- TFRecord framing: ``u64 length | u32 masked_crc32c(length) | payload |
  u32 masked_crc32c(payload)``, CRC32C (Castagnoli, reflected 0x82F63B78)
  with TensorFlow's rotate+offset masking.
- ``Event`` protobuf, hand-encoded: ``wall_time``(1,double) ``step``(2,varint)
  and either ``file_version``(3,string, first record "brain.Event:2") or
  ``summary``(5) holding ``Summary.Value{tag(1,string), simple_value(2,float)}``.
"""

from __future__ import annotations

import struct
import time
from pathlib import Path

# ---- CRC32C (Castagnoli), reflected, table-driven --------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---- minimal protobuf encoding ---------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float32(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _field_bytes(num: int, val: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(val)) + val


def _event(step: int, scalars: dict | None, file_version: str | None,
           wall_time: float) -> bytes:
    body = _field_double(1, wall_time)
    if step:
        body += _field_varint(2, step)
    if file_version is not None:
        body += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, val in scalars.items():
            value = _field_bytes(1, tag.encode()) + _field_float32(2, float(val))
            summary += _field_bytes(1, value)
        body += _field_bytes(5, summary)
    return body


class EventWriter:
    """Append-only scalar event writer, one tfevents file per instance."""

    def __init__(self, logdir: str):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        # the standard name pattern TensorBoard globs for
        self._path = logdir / f"events.out.tfevents.{int(time.time())}.asr.v2"
        self._f = open(self._path, "wb")
        self._record(_event(0, None, "brain.Event:2", time.time()))

    @property
    def path(self) -> Path:
        return self._path

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def write_scalars(self, step: int, scalars: dict):
        """``{tag: float}`` at a global step (clu.metric_writers shape)."""
        self._record(_event(int(step), scalars, None, time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()
