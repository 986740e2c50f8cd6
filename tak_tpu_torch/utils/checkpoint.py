"""Weights files and run checkpoints in the JAX package's format.

`tak_tpu.model.network.Network.save` writes `flax.serialization.to_bytes`
of `{params, batch_stats}`: a msgpack map of nested string-keyed maps
(keys sorted, as `jax.device_get` leaves them) whose leaves are numpy
arrays in msgpack extension type 1 (itself a msgpack tuple of shape, dtype
name and the raw row-major bytes).  Arrays near msgpack's 2 GiB leaf limit
are split by flax into a map `{"__msgpack_chunked_array__": True, "shape":
{...}, "chunks": {...}}` of flat pieces.

This module reads and writes that subset of msgpack with the standard
library and numpy alone (neither `msgpack` nor `flax` is a dependency of
the port): `unpackb` / `load_variables` read either package's files,
`packb` writes the bytes flax writes for the same tree, and `save_run` /
`load_run` keep the run checkpoint of `tak_tpu/utils/checkpoint.py`
(`variables.msgpack` + `meta.json`).  No caller of the JAX package
checkpoints optimizer state, and the port writes none.
"""

from __future__ import annotations

import json
import os
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
    # a copy: frombuffer's view of the file's bytes is read-only
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


def load_variables(path: str, config) -> dict:
    """The port's `state_dict` of the weights file at `path` (written by the
    JAX package's `Network.save` for the same `NetConfig`)."""
    from ..model.network import variables_from_numpy

    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict) or not {"params", "batch_stats"} <= set(tree):
        raise ValueError(f"{path}: not a {{params, batch_stats}} weights file")
    return variables_from_numpy(tree["params"], tree["batch_stats"], config)


def _pack_len(out: list, n: int, fix: int, fix_max: int, wide: bytes) -> None:
    """A length-prefixed header: the fix form below `fix_max`, else the
    first of the 8/16/32-bit forms (type bytes `wide`) that holds `n`."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in zip(wide, "BHI", (1 << 8, 1 << 16, 1 << 32)):
        if code and n < limit:
            out.append(bytes([code]) + struct.pack(">" + fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(out: list, obj) -> None:
    if isinstance(obj, bool) or obj is None:
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[obj])
    elif isinstance(obj, int):
        if not 0 <= obj < 1 << 64:
            raise ValueError(f"integer {obj} is not supported by this writer")
        if obj < 0x80:
            out.append(bytes([obj]))
        else:
            for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                     (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
                if obj < limit:
                    out.append(bytes([code]) + struct.pack(">" + fmt, obj))
                    break
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, b"\xd9\xda\xdb")
        out.append(raw)
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, 0, b"\xc4\xc5\xc6")
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, b"\x00\xdc\xdd")
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, b"\x00\xde\xdf")
        for k in sorted(obj):
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a string")
            _pack(out, k)
            _pack(out, obj[k])
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.isalignedstruct:
            raise ValueError(f"dtype {obj.dtype} cannot be written")
        payload = packb((obj.shape, obj.dtype.name, obj.tobytes("C")))
        n = len(payload)
        if n in (1, 2, 4, 8, 16):                    # fixext 1/2/4/8/16
            out.append(bytes([0xD4 + n.bit_length() - 1, _EXT_NDARRAY]))
        else:                                        # ext 8/16/32
            _pack_len(out, n, None, 0, b"\xc7\xc8\xc9")
            out.append(bytes([_EXT_NDARRAY]))
        out.append(payload)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as msgpack")


def packb(obj) -> bytes:
    """Encode nested str-keyed dicts of numpy arrays (and the ints, strings,
    bytes and tuples inside an array's extension payload) as flax's
    `msgpack_serialize` does: maps with sorted keys, arrays as extension
    type 1.  Arrays must stay below msgpack's 2 GiB leaf limit (flax would
    chunk them)."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def save_variables(path: str, variables: dict) -> None:
    """Write the port's `state_dict` as a weights file that either
    package's `Network.load` reads (written to a temporary file, then
    renamed into place)."""
    from ..model.network import variables_to_numpy

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(variables_to_numpy(variables)))
    os.replace(tmp, path)


def save_run(path: str, *, variables: dict, meta: dict | None = None) -> None:
    """Write a resumable checkpoint directory: `variables.msgpack` and
    `meta.json`, read by this module's and the JAX package's `load_run`."""
    os.makedirs(path, exist_ok=True)
    save_variables(os.path.join(path, "variables.msgpack"), variables)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta or {}, f, indent=2)


def load_run(path: str, *, config) -> tuple[dict, dict]:
    """(variables, meta) from a `save_run` directory of either package."""
    variables = load_variables(os.path.join(path, "variables.msgpack"), config)
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return variables, meta
