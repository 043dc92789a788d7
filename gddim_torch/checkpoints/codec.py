"""msgpack, in pure Python, for the flax-0.3.1 checkpoint format.

The subset flax's ``msgpack_serialize`` writes: nil, bool, the int and
float forms, str, bin, array, map and ext. An ext of code 1 is a numpy
array, the inner msgpack of ``(shape, dtype name, raw bytes)``; it decodes to
``np.frombuffer`` over the buffer it was read from (no copy, and writable
when that buffer is), and arrays encode to it. Any other ext code raises.
Encoding picks the smallest form of each value, as the ``msgpack`` package
does with ``use_bin_type=True``, so the bytes are the same.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1

_U8, _U16, _U32 = struct.Struct(">B"), struct.Struct(">H"), struct.Struct(">I")


def _len_header(n: int, fix_base: int | None, fix_max: int, codes: tuple) -> bytes:
    """The header of a str / bin / array / map / ext of length ``n``; ``codes``
    are its 8-, 16- and 32-bit forms (None where the form does not exist)."""
    if fix_base is not None and n <= fix_max:
        return bytes((fix_base | n,))
    c8, c16, c32 = codes
    if c8 is not None and n < 0x100:
        return bytes((c8, n))
    if n < 0x10000:
        return bytes((c16,)) + _U16.pack(n)
    if n < 0x100000000:
        return bytes((c32,)) + _U32.pack(n)
    raise ValueError(f"msgpack: length {n} over 2^32 - 1")


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                return bytes((code,)) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -0x8000000000000000)):
            if x >= low:
                return bytes((code,)) + struct.pack(fmt, x)
    raise OverflowError(f"msgpack: integer {x} out of range")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _len_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _len_header(n, None, -1, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes((fixed[n], code))
    return _len_header(n, None, -1, (0xC7, 0xC8, 0xC9)) + bytes((code,))


def pack_to(obj, write) -> None:
    """Encode ``obj`` as msgpack chunk by chunk into ``write`` (a file's
    write, or a list's append); arrays' bytes are passed as memoryviews."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False or isinstance(obj, np.bool_):
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (int, np.integer)):
        write(_int(int(obj)))
    elif isinstance(obj, (float, np.floating)):
        write(b"\xcb" + struct.pack(">d", float(obj)))
    elif isinstance(obj, str):
        write(_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        mv = memoryview(obj).cast("B")
        write(_bin_header(mv.nbytes))
        write(mv)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)  # 1-d for a 0-d obj: the shape is obj's
        raw = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size else memoryview(b"")
        prefix = (b"\x93" + packb([int(d) for d in obj.shape]) + _str(arr.dtype.name)
                  + _bin_header(raw.nbytes))
        write(_ext_header(EXT_NDARRAY, len(prefix) + raw.nbytes))
        write(prefix)
        write(raw)
    elif isinstance(obj, (list, tuple)):
        write(_len_header(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for item in obj:
            pack_to(item, write)
    elif isinstance(obj, dict):
        write(_len_header(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            pack_to(k, write)
            pack_to(v, write)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    chunks: list = []
    pack_to(obj, chunks.append)
    return b"".join(chunks)


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > self.mv.nbytes:
            raise ValueError("msgpack: truncated data")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: struct.Struct):
        return fmt.unpack(self.take(fmt.size))[0]


_FIXED = {0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
          0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: struct.Struct(">Q"),
          0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"), 0xD2: struct.Struct(">i"),
          0xD3: struct.Struct(">q")}
_LEN = {8: _U8, 16: _U16, 32: _U32}
_STR = {0xD9: 8, 0xDA: 16, 0xDB: 32}
_BIN = {0xC4: 8, 0xC5: 16, 0xC6: 32}
_ARR = {0xDC: 16, 0xDD: 32}
_MAP = {0xDE: 16, 0xDF: 32}
_EXT = {0xC7: 8, 0xC8: 16, 0xC9: 32}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(r: _Reader, bin_view: bool = False):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, bin_view) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _STR:
        return str(r.take(r.unpack(_LEN[_STR[b]])), "utf-8")
    if b in _BIN:
        data = r.take(r.unpack(_LEN[_BIN[b]]))
        return data if bin_view else bytes(data)
    if b in _ARR:
        return [_decode(r, bin_view) for _ in range(r.unpack(_LEN[_ARR[b]]))]
    if b in _MAP:
        return _map(r, r.unpack(_LEN[_MAP[b]]))
    if b in _EXT or b in _FIXEXT:
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_LEN[_EXT[b]])
        code = struct.unpack(">b", r.take(1))[0]
        return _ext(code, r.take(n))
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _ext(code: int, data: memoryview):
    if code != EXT_NDARRAY:
        raise ValueError(f"msgpack: ext code {code} is not flax's ndarray ({EXT_NDARRAY})")
    inner = _Reader(data)
    shape, dtype, raw = _decode(inner, bin_view=True)
    if inner.pos != data.nbytes:
        raise ValueError("msgpack: trailing bytes in an ndarray ext")
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def unpackb(buf):
    """Decode one msgpack object from ``buf`` (bytes, bytearray, memoryview)."""
    r = _Reader(buf)
    out = _decode(r)
    if r.pos != r.mv.nbytes:
        raise ValueError(f"msgpack: {r.mv.nbytes - r.pos} trailing bytes")
    return out
