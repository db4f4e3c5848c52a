"""The subset of msgpack that Flax's ``serialization.to_bytes`` writes.

The JAX package exports its models (``{stem}_{noise}.ckpt``) with Flax's
msgpack serialisation. The machine that serves the port has neither
``msgpack`` nor ``flax``, so the port reads and writes that format with
this codec of its own:

- maps, arrays, str, bin, int, float, bool and nil;
- ext type 1, an ndarray, whose payload is itself msgpack of
  ``(shape, dtype name, C-order bytes)``;
- ext type 3, a numpy scalar, packed as a 0-d ndarray;
- arrays above ``MAX_CHUNK_SIZE`` bytes, which Flax splits into a map
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat pieces keyed ``"0", "1", ...``.

``packb`` picks the shortest encoding of each value, as the msgpack
package does, so it writes the bytes that Flax writes for the same tree
of dicts and numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # Flax's limit, below msgpack's 2**31 - 1 per object
_CHUNKED = "__msgpack_chunked_array__"


def _header(out: bytearray, n: int, small: tuple[int, int] | None,
            wide: tuple[int, int, int]) -> None:
    """A length header: the fix form ``small = (base, limit)`` when it
    fits, else the 8/16/32-bit forms ``wide`` (a code of 0 means none)."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
    elif wide[0] and n < 1 << 8:
        out += bytes((wide[0], n))
    elif n < 1 << 16:
        out.append(wide[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(wide[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
    if fixed is not None:
        out += bytes((fixed, code))
    else:
        _header(out, len(data), None, (0xC7, 0xC8, 0xC9))
        out.append(code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError("object and structured dtypes cannot be serialised")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: bytearray) -> None:
    # numpy first: np.float64 is a float and np.bool_ is not a bool, and
    # Flax sends every numpy value to its ext types
    if isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), None, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, dict):
        _header(out, len(obj), (0x80, 16), (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), (0x90, 16), (0, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__} to msgpack")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (no chunking: see :func:`serialize`)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
# the length field of bin, str, array, map and ext forms
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
            0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c <= 0x8F:
            return self._map(c & 0x0F)
        if c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        if c in _SIMPLE:
            return _SIMPLE[c]
        if c in _NUMBERS:
            return self.unpack(_NUMBERS[c])
        if c in _FIXEXT or c in (0xC7, 0xC8, 0xC9):
            n = _FIXEXT[c] if c in _FIXEXT else self.unpack(_LENGTHS[c])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if c not in _LENGTHS:
            raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
        n = self.unpack(_LENGTHS[c])
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if c in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return obj


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _chunk_tree(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk_tree(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk_tree(v) for k, v in tree.items()}


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts with
    numpy leaves: oversized arrays chunked, then packed."""
    return packb(_chunk_tree(tree))


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: decode, then join chunked
    arrays back into one array each."""
    return _unchunk_tree(unpackb(data))
