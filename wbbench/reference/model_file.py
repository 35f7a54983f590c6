"""Reader of WaldBoost model files (zlib around a proto3 ``Model``).

The benchmark's own reader, so that the reference reads the model file
itself and takes nothing from the program under test.  Schema (field
number, wire type)::

    Model:       shape=1 packed int32, channel_opts=2 ChannelOpts,
                 classifier=3 repeated DTree, theta=4 packed float
    ChannelOpts: shrink=1, n_per_oct=2, smooth=3 (int32), func=5 string
    DTree:       feature=1 packed int32 ((row, col, channel) triples,
                 (-1, -1, -1) at leaves), threshold=2 packed float,
                 left=3, right=4 packed int32, prediction=5 packed float
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Tuple

import numpy as np

__all__ = ["ModelFile", "read_model"]

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        if pos >= len(buf) or shift >= 70:
            raise ValueError("bad varint")
        byte = buf[pos]
        pos += 1
        out |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return out, pos
        shift += 7


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, pos = _varint(buf, pos)
        elif wt == _I64:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wt == _I32:
            val, pos = buf[pos:pos + 4], pos + 4
        elif wt == _LEN:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"wire type {wt}")
        if pos > len(buf):
            raise ValueError("truncated field")
        yield num, wt, val


def _ints(wt: int, val, out: List[int]) -> None:
    if wt == _VARINT:
        out.append(_int32(val))
        return
    pos = 0
    while pos < len(val):
        v, pos = _varint(val, pos)
        out.append(_int32(v))


def _floats(wt: int, val, out: List[float]) -> None:
    if wt == _I32:
        out.append(struct.unpack("<f", val)[0])
    else:
        out.extend(np.frombuffer(val, "<f4").tolist())


@dataclasses.dataclass
class ModelFile:
    """A model as the reference walks it: window ``shape`` (m, n, C), the
    channel options, and per stage its node arrays (features as (k, 3)
    rows, columns, channels; leaves have ``left < 0``) and ``theta``."""

    shape: Tuple[int, int, int]
    shrink: int
    n_per_oct: int
    smooth: int
    func: str
    stages: List[dict]
    theta: np.ndarray

    @property
    def n_nodes(self) -> int:
        return sum(len(s["threshold"]) for s in self.stages)


def _tree(buf: bytes) -> dict:
    f, thr, left, right, pred = [], [], [], [], []
    for num, wt, val in _fields(buf):
        if num == 1:
            _ints(wt, val, f)
        elif num == 2:
            _floats(wt, val, thr)
        elif num == 3:
            _ints(wt, val, left)
        elif num == 4:
            _ints(wt, val, right)
        elif num == 5:
            _floats(wt, val, pred)
    left = np.asarray(left, np.int32)
    feature = np.asarray(f, np.int32).reshape(-1, 3).copy()
    feature[left < 0] = 0
    return dict(feature=feature, threshold=np.asarray(thr, np.float32),
                left=left, right=np.asarray(right, np.int32),
                prediction=np.asarray(pred, np.float32))


def read_model(path: str) -> ModelFile:
    """Parse a model file; a file that does not parse raises ValueError."""
    with open(path, "rb") as fh:
        buf = zlib.decompress(fh.read())
    shape: List[int] = []
    theta: List[float] = []
    stages = []
    opts = {1: 0, 2: 0, 3: 0, 5: ""}
    for num, wt, val in _fields(buf):
        if num == 1:
            _ints(wt, val, shape)
        elif num == 2:
            for n2, wt2, v2 in _fields(val):
                if n2 in (1, 2, 3):
                    opts[n2] = _int32(v2)
                elif n2 == 5:
                    opts[5] = v2.decode("utf-8")
        elif num == 3:
            stages.append(_tree(val))
        elif num == 4:
            _floats(wt, val, theta)
    if len(shape) != 3 or len(theta) != len(stages):
        raise ValueError(f"{path}: not a model file")
    return ModelFile(tuple(shape), opts[1], opts[2], opts[3], opts[5],
                     stages, np.asarray(theta, np.float32))
