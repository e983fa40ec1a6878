"""Reader and writer for the msgpack subset of flax checkpoints.

``model.msgpack`` as flax's ``serialization.to_bytes`` writes it: a map of
nested maps with string keys whose leaves are numpy arrays, each stored as
msgpack extension type 1 holding ``msgpack((shape, dtype name, C-order
bytes))``.  This module covers exactly that subset (maps, strings, arrays
of integers, binary, extension 1) and raises on anything else, so the port
needs neither the ``msgpack`` package nor flax.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

_NDARRAY_EXT = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self):
        t = self.uint(1)
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.value() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return self.str(t & 0x1f)
        simple = {
            0xcc: lambda: self.uint(1), 0xcd: lambda: self.uint(2),
            0xce: lambda: self.uint(4), 0xcf: lambda: self.uint(8),
            0xd0: lambda: struct.unpack(">b", self.take(1))[0],
            0xd1: lambda: struct.unpack(">h", self.take(2))[0],
            0xd2: lambda: struct.unpack(">i", self.take(4))[0],
            0xd3: lambda: struct.unpack(">q", self.take(8))[0],
            0xd9: lambda: self.str(self.uint(1)),
            0xda: lambda: self.str(self.uint(2)),
            0xdb: lambda: self.str(self.uint(4)),
            0xc4: lambda: bytes(self.take(self.uint(1))),
            0xc5: lambda: bytes(self.take(self.uint(2))),
            0xc6: lambda: bytes(self.take(self.uint(4))),
            0xdc: lambda: [self.value() for _ in range(self.uint(2))],
            0xdd: lambda: [self.value() for _ in range(self.uint(4))],
            0xde: lambda: self.map(self.uint(2)),
            0xdf: lambda: self.map(self.uint(4)),
        }
        if t in simple:
            return simple[t]()
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        if t in (0xc7, 0xc8, 0xc9):
            return self.ext(self.uint({0xc7: 1, 0xc8: 2, 0xc9: 4}[t]))
        raise ValueError(f"msgpack type byte 0x{t:02x} is outside the "
                         "checkpoint subset")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"non-string map key {key!r}")
            out[key] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code != _NDARRAY_EXT:
            raise ValueError(f"msgpack extension type {code} is outside the "
                             "checkpoint subset")
        inner = _Reader(payload)
        shape, dtype_name, buf = inner.value()
        if inner.pos != len(payload):
            raise ValueError("trailing bytes in an array payload")
        dtype = np.dtype(dtype_name)
        return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes) -> Dict:
    """Decode a checkpoint: nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _uint_header(n: int, fix_base: int, fix_max: int,
                 codes: Tuple[int, int, int]) -> bytes:
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"length {n} too large for msgpack")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _uint_header(len(raw), 0xa0, 31, (0xd9, 0xda, 0xdb)) + raw


def _pack_bin(b: bytes) -> bytes:
    if len(b) < 1 << 8:
        head = bytes([0xc4, len(b)])
    elif len(b) < 1 << 16:
        head = b"\xc5" + len(b).to_bytes(2, "big")
    else:
        head = b"\xc6" + len(b).to_bytes(4, "big")
    return head + b


def _pack_uint(n: int) -> bytes:
    if n < 0:
        raise ValueError("negative array dimension")
    if n <= 0x7f:
        return bytes([n])
    for code, width in ((0xcc, 1), (0xcd, 2), (0xce, 4), (0xcf, 8)):
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"integer {n} too large for msgpack")


def _pack_array(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"dtype {a.dtype} is outside the checkpoint subset")
    shape = _uint_header(a.ndim, 0x90, 15, (None, 0xdc, 0xdd)) + b"".join(
        _pack_uint(d) for d in a.shape)
    payload = (b"\x93" + shape + _pack_str(a.dtype.name)
               + _pack_bin(a.tobytes("C")))
    n = len(payload)
    if n < 1 << 8:
        head = bytes([0xc7, n])
    elif n < 1 << 16:
        head = b"\xc8" + n.to_bytes(2, "big")
    else:
        head = b"\xc9" + n.to_bytes(4, "big")
    return head + bytes([_NDARRAY_EXT]) + payload


def packb(tree: Dict) -> bytes:
    """Encode nested dicts (string keys) of numpy arrays."""
    if not isinstance(tree, dict):
        if isinstance(tree, np.ndarray):
            return _pack_array(tree)
        raise TypeError(f"{type(tree).__name__} is outside the checkpoint "
                        "subset")
    parts = [_uint_header(len(tree), 0x80, 15, (None, 0xde, 0xdf))]
    for k, v in tree.items():
        if not isinstance(k, str):
            raise TypeError(f"non-string key {k!r}")
        parts.append(_pack_str(k))
        parts.append(packb(v))
    return b"".join(parts)
