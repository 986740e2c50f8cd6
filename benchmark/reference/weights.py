"""Weights files read without the program: flax's msgpack bytes.

A frozen copy of the decoder in `tak_tpu_torch/utils/checkpoint.py`
(`_Reader`, `_ndarray`, `_ext`, `_unpack`, `_map`, `unpackb`), so that the
reference reads the committed weights files by itself.  A file is
`{params, batch_stats}`: nested string-keyed maps whose leaves are numpy
arrays in msgpack extension type 1 (a msgpack tuple of shape, dtype name
and the raw row-major bytes).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


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

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(payload) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported by this reader")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, payload):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _unpack(r: _Reader):
    b = r.num("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):                      # bin 8/16/32
        return bytes(r.take(r.num("BHI"[b - 0xC4])))
    if b in (0xC7, 0xC8, 0xC9):                      # ext 8/16/32
        n = r.num("BHI"[b - 0xC7])
        return _ext(r.num("b"), r.take(n))
    if b == 0xCA:
        return r.num("f")
    if b == 0xCB:
        return r.num("d")
    if 0xCC <= b <= 0xCF:                            # uint 8/16/32/64
        return r.num("BHIQ"[b - 0xCC])
    if 0xD0 <= b <= 0xD3:                            # int 8/16/32/64
        return r.num("bhiq"[b - 0xD0])
    if 0xD4 <= b <= 0xD8:                            # fixext 1/2/4/8/16
        return _ext(r.num("b"), r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):                      # str 8/16/32
        return bytes(r.take(r.num("BHI"[b - 0xD9]))).decode("utf-8")
    if b in (0xDC, 0xDD):                            # array 16/32
        return [_unpack(r) for _ in range(r.num("HI"[b - 0xDC]))]
    if b in (0xDE, 0xDF):                            # map 16/32
        return _map(r, r.num("HI"[b - 0xDE]))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _map(r: _Reader, n: int):
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    if out.get(_CHUNKED):
        shape = [out["shape"][str(i)] for i in range(len(out["shape"]))]
        chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return out


def unpackb(data):
    """Decode one msgpack object (the subset flax's serialization emits)."""
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def load_flax(path, want_sha256: str | None = None) -> dict:
    """`{params, batch_stats}` of float32 numpy arrays from a weights file,
    after checking its sha256 where one is given."""
    with open(path, "rb") as f:
        data = f.read()
    if want_sha256 is not None:
        got = hashlib.sha256(data).hexdigest()
        if got != want_sha256:
            raise ValueError(f"{path}: sha256 {got}, want {want_sha256}")
    tree = unpackb(data)
    if not isinstance(tree, dict) or not {"params", "batch_stats"} <= set(tree):
        raise ValueError(f"{path}: not a {{params, batch_stats}} weights file")
    return tree
