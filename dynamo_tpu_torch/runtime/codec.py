"""MessagePack encoder and decoder for the planes' frames and store records.

The reference package sends its request-plane frames, netstore protocol
and file-store records with ``msgpack.packb(obj, use_bin_type=True)`` and
reads them with ``msgpack.unpackb(data, raw=False)``; the machine the port
serves on has no msgpack, so the port carries its own codec for the types
those frames hold: nil, bool, int (up to 64 bits), float (always float64,
as msgpack writes a Python float), str, bytes, list/tuple and dict.

``packb`` picks the smallest encoding of each value exactly as msgpack
does, so its output is byte-identical to the reference's: the port's
frames, store files and netstore wire are the reference's, and either
side can read the other's. ``unpackb`` reads every MessagePack format but
ext; it returns lists for arrays, str for str and bytes for bin, and takes
map keys of str or bytes only (msgpack's ``strict_map_key``). Truncated or
trailing input, an int past 64 bits, or an unknown type raises.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

__all__ = ["CodecError", "ExtraData", "packb", "unpackb"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")

# msgpack's own nesting limit (Packer / Unpacker recursion)
MAX_DEPTH = 511


class CodecError(ValueError):
    """Malformed, truncated or unsupported MessagePack data."""


class ExtraData(CodecError):
    """Bytes left over after one complete object."""


# ---------------------------------------------------------------- encoding
def _pack(obj: Any, out: bytearray, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("recursion limit exceeded")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _d.pack(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 0x100:
            out.append(0xD9)
            out.append(n)
        elif n < 0x10000:
            out.append(0xDA)
            out += _H.pack(n)
        elif n < 0x100000000:
            out.append(0xDB)
            out += _I.pack(n)
        else:
            raise ValueError("String is too large")
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 0x100:
            out.append(0xC4)
            out.append(n)
        elif n < 0x10000:
            out.append(0xC5)
            out += _H.pack(n)
        elif n < 0x100000000:
            out.append(0xC6)
            out += _I.pack(n)
        else:
            raise ValueError("Bytes object is too large")
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 0x10000:
            out.append(0xDC)
            out += _H.pack(n)
        elif n < 0x100000000:
            out.append(0xDD)
            out += _I.pack(n)
        else:
            raise ValueError("list is too large")
        for item in obj:
            _pack(item, out, depth + 1)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 0x10000:
            out.append(0xDE)
            out += _H.pack(n)
        elif n < 0x100000000:
            out.append(0xDF)
            out += _I.pack(n)
        else:
            raise ValueError("dict is too large")
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out.append(0xCC)
            out.append(v)
        elif v < 0x10000:
            out.append(0xCD)
            out += _H.pack(v)
        elif v < 0x100000000:
            out.append(0xCE)
            out += _I.pack(v)
        elif v < 0x10000000000000000:
            out.append(0xCF)
            out += _Q.pack(v)
        else:
            raise OverflowError("Integer value out of range")
    else:
        if v >= -32:
            out.append(v & 0xFF)
        elif v >= -0x80:
            out.append(0xD0)
            out += _b.pack(v)
        elif v >= -0x8000:
            out.append(0xD1)
            out += _h.pack(v)
        elif v >= -0x80000000:
            out.append(0xD2)
            out += _i.pack(v)
        elif v >= -0x8000000000000000:
            out.append(0xD3)
            out += _q.pack(v)
        else:
            raise OverflowError("Integer value out of range")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


# ---------------------------------------------------------------- decoding
# fixed-size formats: first byte -> (struct, size)
_FIXED = {
    0xCA: _f, 0xCB: _d,
    0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
    0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q,
}
# str / bin / array / map with a length prefix: first byte -> (kind, length struct)
_SIZED = {
    0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
    0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
    0xDC: ("array", _H), 0xDD: ("array", _I),
    0xDE: ("map", _H), 0xDF: ("map", _I),
}


def _need(data: memoryview, pos: int, n: int) -> None:
    if pos + n > len(data):
        raise CodecError("Unpack failed: incomplete input")


def _unpack(data: memoryview, pos: int, depth: int) -> Tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise CodecError("recursion limit exceeded")
    _need(data, pos, 1)
    b = data[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _str(data, pos, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(data, pos, b & 0x0F, depth)
    if 0x80 <= b <= 0x8F:
        return _map(data, pos, b & 0x0F, depth)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    fixed = _FIXED.get(b)
    if fixed is not None:
        _need(data, pos, fixed.size)
        return fixed.unpack_from(data, pos)[0], pos + fixed.size
    sized = _SIZED.get(b)
    if sized is not None:
        kind, lst = sized
        _need(data, pos, lst.size)
        n = lst.unpack_from(data, pos)[0]
        pos += lst.size
        if kind == "str":
            return _str(data, pos, n)
        if kind == "bin":
            _need(data, pos, n)
            return bytes(data[pos:pos + n]), pos + n
        if kind == "array":
            return _array(data, pos, n, depth)
        return _map(data, pos, n, depth)
    raise CodecError(f"Unpack failed: unsupported format byte 0x{b:02x}")


def _str(data: memoryview, pos: int, n: int) -> Tuple[str, int]:
    _need(data, pos, n)
    try:
        return str(data[pos:pos + n], "utf-8"), pos + n
    except UnicodeDecodeError as e:
        raise CodecError(f"invalid UTF-8 in str: {e}") from None


def _array(data: memoryview, pos: int, n: int, depth: int) -> Tuple[list, int]:
    # every element takes at least one byte: a count past the input is truncated
    _need(data, pos, n)
    out = []
    for _ in range(n):
        item, pos = _unpack(data, pos, depth + 1)
        out.append(item)
    return out, pos


def _map(data: memoryview, pos: int, n: int, depth: int) -> Tuple[dict, int]:
    _need(data, pos, 2 * n)
    out = {}
    for _ in range(n):
        key, pos = _unpack(data, pos, depth + 1)
        if not isinstance(key, (str, bytes)):
            raise CodecError(f"{type(key).__name__} is not allowed for map key")
        out[key], pos = _unpack(data, pos, depth + 1)
    return out, pos


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False)``: one object, nothing after it."""
    view = memoryview(data).cast("B")
    obj, pos = _unpack(view, 0, 0)
    if pos != len(view):
        raise ExtraData(f"unpack(b) received extra data ({len(view) - pos} bytes)")
    return obj
