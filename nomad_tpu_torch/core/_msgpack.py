"""A small MessagePack codec: the subset `core/wire.py` speaks.

The reference's wire codec calls the `msgpack` package
(`msgpack.packb(obj, default=..., use_bin_type=True)` and
`msgpack.unpackb(data, ext_hook=..., raw=False, strict_map_key=False)`).
The port does not depend on that package, so this module packs and
unpacks the same formats itself:

  - `packb(obj, default)` gives the bytes `msgpack.packb(obj,
    default=default, use_bin_type=True)` gives: nil, bool, int (the
    smallest of fixint, uint8-64 and int8-64), float as float64, str
    (fixstr, str8/16/32, UTF-8), bytes/bytearray/memoryview as bin8/16/32,
    list and tuple as arrays, dict (in its own order) as maps, and
    `ExtType` as fixext/ext8/16/32.  The checks run in msgpack's order, so
    subclasses pack as their base (an int enum as its int, a numpy
    float64 as a float); anything else goes through `default` once, and
    what `default` returns must be one of those types.  Nesting deeper
    than 511 raises ValueError, as msgpack's does.
  - `unpackb(data, ext_hook)` decodes every MessagePack format (float32
    included) as `raw=False, strict_map_key=False` does: str to str, bin
    to bytes, arrays to lists, maps to dicts with any hashable key, and
    every ext to `ext_hook(code, data)` (or an `ExtType` without a hook).
    Truncated input raises ValueError, trailing bytes `ExtraData` (a
    ValueError), the never-used byte 0xc1 `FormatError` (a ValueError),
    and nesting deeper than the interpreter's recursion limit ValueError.
    msgpack's own Timestamp (ext -1) is not special-cased: the port's
    wire never writes one.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Callable, Optional

__all__ = ["ExtType", "ExtraData", "FormatError", "packb", "unpackb"]

NEST_LIMIT = 511


class ExtType(namedtuple("ExtType", "code data")):
    """An application ext value: a type code in [0, 127] and its bytes."""

    def __new__(cls, code: int, data: bytes):
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class ExtraData(ValueError):
    """Bytes left over after one complete object."""

    def __init__(self, unpacked: Any, extra: bytes) -> None:
        super().__init__("unpack(b) received extra data.")
        self.unpacked = unpacked
        self.extra = extra


class FormatError(ValueError):
    """A byte that starts no MessagePack format."""


_BB = struct.Struct(">BB").pack
_BH = struct.Struct(">BH").pack
_BI = struct.Struct(">BI").pack
_BQ = struct.Struct(">BQ").pack
_Bb = struct.Struct(">Bb").pack
_Bh = struct.Struct(">Bh").pack
_Bi = struct.Struct(">Bi").pack
_Bq = struct.Struct(">Bq").pack
_Bd = struct.Struct(">Bd").pack
_BBb = struct.Struct(">BBb").pack
_BHb = struct.Struct(">BHb").pack
_BIb = struct.Struct(">BIb").pack

_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


# ------------------------------------------------------------------ pack


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """`obj` -> MessagePack bytes, as `msgpack.packb(obj, default=default,
    use_bin_type=True)`."""
    buf = bytearray()
    _pack(obj, buf, default, NEST_LIMIT, False)
    return bytes(buf)


def _pack_str(b: bytes, buf: bytearray) -> None:
    n = len(b)
    if n < 32:
        buf.append(0xa0 | n)
    elif n < 0x100:
        buf += _BB(0xd9, n)
    elif n < 0x10000:
        buf += _BH(0xda, n)
    elif n < 0x100000000:
        buf += _BI(0xdb, n)
    else:
        raise ValueError("unicode string is too large")
    buf += b


def _pack_bin(b, buf: bytearray) -> None:
    n = len(b)
    if n < 0x100:
        buf += _BB(0xc4, n)
    elif n < 0x10000:
        buf += _BH(0xc5, n)
    elif n < 0x100000000:
        buf += _BI(0xc6, n)
    else:
        raise ValueError("bytes object is too large")
    buf += b


def _pack_int(o: int, buf: bytearray) -> bool:
    """Pack an int; False when it fits no MessagePack integer."""
    if o >= 0:
        if o < 0x80:
            buf.append(o)
        elif o < 0x100:
            buf += _BB(0xcc, o)
        elif o < 0x10000:
            buf += _BH(0xcd, o)
        elif o < 0x100000000:
            buf += _BI(0xce, o)
        elif o < 0x10000000000000000:
            buf += _BQ(0xcf, o)
        else:
            return False
    elif o >= -32:
        buf.append(o & 0xff)
    elif o >= -0x80:
        buf += _Bb(0xd0, o)
    elif o >= -0x8000:
        buf += _Bh(0xd1, o)
    elif o >= -0x80000000:
        buf += _Bi(0xd2, o)
    elif o >= -0x8000000000000000:
        buf += _Bq(0xd3, o)
    else:
        return False
    return True


def _pack_ext(code: int, data: bytes, buf: bytearray) -> None:
    n = len(data)
    head = _FIXEXT.get(n)
    if head is not None:
        buf += _Bb(head, code)
    elif n < 0x100:
        buf += _BBb(0xc7, n, code)
    elif n < 0x10000:
        buf += _BHb(0xc8, n, code)
    elif n < 0x100000000:
        buf += _BIb(0xc9, n, code)
    else:
        raise ValueError("EXT data is too large")
    buf += data


def _pack(o: Any, buf: bytearray, default, limit: int,
          default_used: bool) -> None:
    # one Python frame per nesting level (arrays and maps loop here), so
    # msgpack's 511 levels fit the interpreter's recursion limit
    if limit < 0:
        raise ValueError("recursion limit exceeded.")
    t = type(o)
    # exact types first (each matches one branch of the ordered checks
    # below, so the bytes are the same); subclasses fall through
    if t is str:
        _pack_str(o.encode("utf-8"), buf)
        return
    if t is int:
        if _pack_int(o, buf):
            return
    elif t is dict:
        _map_header(len(o), buf)
        limit -= 1
        for k, v in o.items():
            _pack(k, buf, default, limit, False)
            _pack(v, buf, default, limit, False)
        return
    elif t is list or t is tuple:
        _array_header(len(o), buf)
        limit -= 1
        for v in o:
            _pack(v, buf, default, limit, False)
        return
    elif o is None:
        buf.append(0xc0)
        return
    elif o is True:
        buf.append(0xc3)
        return
    elif o is False:
        buf.append(0xc2)
        return
    elif t is float:
        buf += _Bd(0xcb, o)
        return
    elif t is bytes:
        _pack_bin(o, buf)
        return
    # msgpack's order of checks, subclasses included
    while True:
        if o is None:
            buf.append(0xc0)
        elif o is True:
            buf.append(0xc3)
        elif o is False:
            buf.append(0xc2)
        elif isinstance(o, int):
            if not _pack_int(o, buf):
                if default_used or default is None:
                    raise OverflowError("Integer value out of range")
                o, default_used = default(o), True
                continue
        elif isinstance(o, float):
            buf += _Bd(0xcb, o)
        elif isinstance(o, (bytes, bytearray)):
            _pack_bin(o, buf)
        elif isinstance(o, str):
            _pack_str(str.encode(o, "utf-8"), buf)
        elif isinstance(o, dict):
            _map_header(len(o), buf)
            for k, v in o.items():
                _pack(k, buf, default, limit - 1, False)
                _pack(v, buf, default, limit - 1, False)
        elif isinstance(o, ExtType):
            _pack_ext(o.code, o.data, buf)
        elif isinstance(o, (list, tuple)):
            _array_header(len(o), buf)
            for v in o:
                _pack(v, buf, default, limit - 1, False)
        elif isinstance(o, memoryview):
            _pack_bin(o.tobytes(), buf)
        elif not default_used and default is not None:
            o, default_used = default(o), True
            continue
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} "
                            "object")
        return


def _map_header(n: int, buf: bytearray) -> None:
    if n < 16:
        buf.append(0x80 | n)
    elif n < 0x10000:
        buf += _BH(0xde, n)
    elif n < 0x100000000:
        buf += _BI(0xdf, n)
    else:
        raise ValueError("dict is too large")


def _array_header(n: int, buf: bytearray) -> None:
    if n < 16:
        buf.append(0x90 | n)
    elif n < 0x10000:
        buf += _BH(0xdc, n)
    elif n < 0x100000000:
        buf += _BI(0xdd, n)
    else:
        raise ValueError("list is too large")


# ---------------------------------------------------------------- unpack


_U8 = struct.Struct(">B").unpack_from
_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from
_U64 = struct.Struct(">Q").unpack_from
_I8 = struct.Struct(">b").unpack_from
_I16 = struct.Struct(">h").unpack_from
_I32 = struct.Struct(">i").unpack_from
_I64 = struct.Struct(">q").unpack_from
_F32 = struct.Struct(">f").unpack_from
_F64 = struct.Struct(">d").unpack_from


class _Incomplete(Exception):
    pass


def unpackb(data, ext_hook: Optional[Callable[[int, bytes], Any]] = None
            ) -> Any:
    """MessagePack bytes -> one object, as `msgpack.unpackb(data,
    ext_hook=ext_hook, raw=False, strict_map_key=False)`."""
    if not isinstance(data, bytes):
        data = bytes(memoryview(data))
    try:
        obj, pos = _unpack(data, 0, ext_hook)
    except (_Incomplete, struct.error, IndexError):
        raise ValueError("Unpack failed: incomplete input") from None
    except RecursionError:
        raise ValueError("Unpack failed: nesting too deep") from None
    if pos != len(data):
        raise ExtraData(obj, data[pos:])
    return obj


def _take(data: bytes, pos: int, n: int) -> bytes:
    end = pos + n
    if end > len(data):
        raise _Incomplete
    return data[pos:end]


def _unpack(data: bytes, pos: int, ext_hook):
    b = data[pos]
    pos += 1
    if b <= 0x7f:                                   # positive fixint
        return b, pos
    if b >= 0xe0:                                   # negative fixint
        return b - 0x100, pos
    if b >= 0xa0 and b <= 0xbf:                     # fixstr
        n = b & 0x1f
        return _take(data, pos, n).decode("utf-8"), pos + n
    if b <= 0x8f:                                   # fixmap
        n = b & 0x0f
        out = {}
        for _ in range(n):
            k, pos = _unpack(data, pos, ext_hook)
            out[k], pos = _unpack(data, pos, ext_hook)
        return out, pos
    if b <= 0x9f:                                   # fixarray
        n = b & 0x0f
        out = [None] * n
        for i in range(n):
            out[i], pos = _unpack(data, pos, ext_hook)
        return out, pos
    if b == 0xc0:
        return None, pos
    if b == 0xc2:
        return False, pos
    if b == 0xc3:
        return True, pos
    if b == 0xcb:
        return _F64(data, pos)[0], pos + 8
    if b == 0xcc:
        return data[pos], pos + 1
    if b == 0xcd:
        return _U16(data, pos)[0], pos + 2
    if b == 0xce:
        return _U32(data, pos)[0], pos + 4
    if b == 0xcf:
        return _U64(data, pos)[0], pos + 8
    if b == 0xd0:
        return _I8(data, pos)[0], pos + 1
    if b == 0xd1:
        return _I16(data, pos)[0], pos + 2
    if b == 0xd2:
        return _I32(data, pos)[0], pos + 4
    if b == 0xd3:
        return _I64(data, pos)[0], pos + 8
    if b == 0xca:
        return _F32(data, pos)[0], pos + 4
    if b in (0xd9, 0xda, 0xdb):                     # str8/16/32
        n, pos = _length(data, pos, b - 0xd9)
        return _take(data, pos, n).decode("utf-8"), pos + n
    if b in (0xc4, 0xc5, 0xc6):                     # bin8/16/32
        n, pos = _length(data, pos, b - 0xc4)
        return _take(data, pos, n), pos + n
    if b in (0xdc, 0xdd):                           # array16/32
        n, pos = _length(data, pos, b - 0xdc + 1)
        if n > len(data) - pos:           # each element takes a byte
            raise _Incomplete
        out = [None] * n
        for i in range(n):
            out[i], pos = _unpack(data, pos, ext_hook)
        return out, pos
    if b in (0xde, 0xdf):                           # map16/32
        n, pos = _length(data, pos, b - 0xde + 1)
        if 2 * n > len(data) - pos:
            raise _Incomplete
        out = {}
        for _ in range(n):
            k, pos = _unpack(data, pos, ext_hook)
            out[k], pos = _unpack(data, pos, ext_hook)
        return out, pos
    if 0xd4 <= b <= 0xd8:                           # fixext 1-16
        n = 1 << (b - 0xd4)
        return _ext(data, pos, n, ext_hook)
    if b in (0xc7, 0xc8, 0xc9):                     # ext8/16/32
        n, pos = _length(data, pos, b - 0xc7)
        return _ext(data, pos, n, ext_hook)
    raise FormatError(f"unknown MessagePack byte 0x{b:02x}")


def _length(data: bytes, pos: int, width: int):
    """width 0/1/2 -> an 8/16/32-bit big-endian length at `pos`."""
    if width == 0:
        return _U8(data, pos)[0], pos + 1
    if width == 1:
        return _U16(data, pos)[0], pos + 2
    return _U32(data, pos)[0], pos + 4


def _ext(data: bytes, pos: int, n: int, ext_hook):
    code = _I8(data, pos)[0]
    body = _take(data, pos + 1, n)
    pos += 1 + n
    if ext_hook is None:
        return ExtType(code, body), pos
    return ext_hook(code, body), pos

