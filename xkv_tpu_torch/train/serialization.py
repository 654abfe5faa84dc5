"""flax's checkpoint bytes without flax: a minimal msgpack writer and
reader for nested string-keyed dicts of arrays.

The counterpart of ``flax.serialization.to_bytes`` / ``from_bytes`` as the
JAX trainer uses them (the card's machine has neither ``flax`` nor
``msgpack``). The format is flax's: a msgpack map per dict, keys sorted
(as flax's tree copy orders them), each array an ext of type 1 whose
payload is the msgpack triple (shape, dtype name, C-order bytes) (type 3
for a numpy scalar, read as a 0-d tensor). Integers,
strings, binaries, arrays and maps take msgpack's shortest form, as the
``msgpack`` package writes them, so the writer's bytes equal flax's for
the same tree.

flax cuts a leaf over ``MAX_CHUNK_SIZE`` bytes into chunks under a map of
its own; such a leaf is refused here, both ways, rather than written in a
form flax would not read.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
EXT_NDARRAY, EXT_NPSCALAR = 1, 3  # flax's ext types: arrays, numpy scalars
_CHUNKED = "__msgpack_chunked_array__"

# dtype names as numpy (and flax) write them, and their torch dtypes.
DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}

Tree = Dict[str, Any]


# ------------------------------------------------------------------ write
def _pack_int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                          (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
        if n >= lo:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _header(n: int, fix: Union[int, None], fix_max: int, codes) -> bytes:
    """A length header: the fix form below ``fix_max``, else the shortest
    of the 8 / 16 / 32-bit forms in ``codes`` (None: no such form)."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _pack_bin(b: bytes) -> bytes:
    return _header(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b


def _pack_ext(code: int, data: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        return bytes([fixext[len(data)], code]) + data
    return _header(len(data), None, 0, (0xC7, 0xC8, 0xC9)) + bytes([code]) + data


def _array_bytes(x) -> Tuple[Tuple[int, ...], str, bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"dtype {t.dtype} not supported")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        return tuple(t.shape), _NAMES[t.dtype], raw
    a = np.asarray(x)
    if a.dtype.name not in DTYPES:
        raise ValueError(f"dtype {a.dtype} not supported")
    return a.shape, a.dtype.name, a.tobytes("C")


def _pack_array(x, path: str) -> bytes:
    shape, name, raw = _array_bytes(x)
    if len(raw) > MAX_CHUNK_SIZE:
        raise ValueError(f"{path}: {len(raw)} bytes, over flax's MAX_CHUNK_SIZE "
                         f"({MAX_CHUNK_SIZE}); flax would write it in chunks, which this "
                         "codec does not")
    payload = (_header(3, 0x90, 16, (None, 0xDC, 0xDD))
               + _header(len(shape), 0x90, 16, (None, 0xDC, 0xDD))
               + b"".join(_pack_int(int(n)) for n in shape) + _pack_str(name) + _pack_bin(raw))
    return _pack_ext(EXT_NPSCALAR if isinstance(x, np.generic) else EXT_NDARRAY, payload)


def _pack(tree, path: str) -> bytes:
    if isinstance(tree, dict):
        out = [_header(len(tree), 0x80, 16, (None, 0xDE, 0xDF))]
        for key in sorted(tree):
            if not isinstance(key, str):
                raise ValueError(f"{path}: key {key!r} is not a string")
            out.append(_pack_str(key))
            out.append(_pack(tree[key], f"{path}/{key}"))
        return b"".join(out)
    return _pack_array(tree, path)


def to_bytes(tree: Tree) -> bytes:
    """flax ``to_bytes`` of a nested string-keyed dict of arrays (numpy
    arrays or tensors)."""
    return _pack(tree, "")


# ------------------------------------------------------------------- read
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

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        if c not in lens:
            raise ValueError(f"msgpack type byte 0x{c:02x} not supported")
        n = self.unpack(lens[c])
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if c in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("a leaf flax wrote in chunks (over MAX_CHUNK_SIZE bytes): "
                             "not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} not supported (arrays only)")
        shape, name, raw = _Reader(payload).value()
        if name not in DTYPES:
            raise ValueError(f"dtype {name!r} not supported")
        dtype = DTYPES[name]
        if dtype == torch.bfloat16:
            flat = torch.frombuffer(bytearray(raw), dtype=torch.int16).view(torch.bfloat16)
        elif not raw:
            flat = torch.empty((0,), dtype=dtype)
        else:
            flat = torch.frombuffer(bytearray(raw), dtype=dtype)
        return flat.reshape(tuple(shape))


def from_bytes(data: bytes) -> Tree:
    """flax ``msgpack_restore``: the nested dict of CPU tensors the bytes
    hold."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack value")
    return tree
