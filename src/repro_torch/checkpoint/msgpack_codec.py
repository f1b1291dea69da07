"""A small msgpack codec: what the checkpoints need, with no package.

``packb(obj)`` writes the bytes that ``msgpack.packb(obj,
use_bin_type=True)`` writes for the types a checkpoint holds: nil, bool,
int (every width, the smallest encoding that holds the value), float
(float64), str (fixstr, str8/16/32), bytes (bin8/16/32), list and tuple
(arrays) and dict (maps, in insertion order).  ``unpackb(data)`` reads
what ``msgpack.unpackb(data, raw=False, strict_map_key=False)`` reads of
those, and float32 too.  Anything else raises ``TypeError`` /
``ValueError``.
"""
from __future__ import annotations

import struct

# (limit, header) pairs: the first whose limit exceeds n is used
_STR = ((32, lambda n: bytes([0xA0 | n])),
        (1 << 8, lambda n: struct.pack(">BB", 0xD9, n)),
        (1 << 16, lambda n: struct.pack(">BH", 0xDA, n)),
        (1 << 32, lambda n: struct.pack(">BI", 0xDB, n)))
_BIN = ((1 << 8, lambda n: struct.pack(">BB", 0xC4, n)),
        (1 << 16, lambda n: struct.pack(">BH", 0xC5, n)),
        (1 << 32, lambda n: struct.pack(">BI", 0xC6, n)))
_ARRAY = ((16, lambda n: bytes([0x90 | n])),
          (1 << 16, lambda n: struct.pack(">BH", 0xDC, n)),
          (1 << 32, lambda n: struct.pack(">BI", 0xDD, n)))
_MAP = ((16, lambda n: bytes([0x80 | n])),
        (1 << 16, lambda n: struct.pack(">BH", 0xDE, n)),
        (1 << 32, lambda n: struct.pack(">BI", 0xDF, n)))


def _header(table, n: int, what: str) -> bytes:
    for limit, make in table:
        if n < limit:
            return make(n)
    raise ValueError(f"{what} of length {n} is too large for msgpack")


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return struct.pack("B", x)
    if -0x20 <= x < 0:
        return struct.pack("b", x)
    if 0x80 <= x <= 0xFF:
        return struct.pack("BB", 0xCC, x)
    if -0x80 <= x < 0:
        return struct.pack(">Bb", 0xD0, x)
    if 0xFF < x <= 0xFFFF:
        return struct.pack(">BH", 0xCD, x)
    if -0x8000 <= x < -0x80:
        return struct.pack(">Bh", 0xD1, x)
    if 0xFFFF < x <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, x)
    if -0x80000000 <= x < -0x8000:
        return struct.pack(">Bi", 0xD2, x)
    if 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, x)
    if -0x8000000000000000 <= x < -0x80000000:
        return struct.pack(">Bq", 0xD3, x)
    raise OverflowError("integer out of msgpack's range")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_header(_BIN, len(data), "bin"))
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(_STR, len(data), "str"))
        out.append(data)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_header(_ARRAY, len(obj), "array"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(_MAP, len(obj), "map"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width codes: byte -> struct format of the value that follows
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _read(r: _Reader):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif b in _LENGTHS:
        kind, fmt = _LENGTHS[b]
        n = r.unpack(fmt)
    elif b in _SCALARS:
        return r.unpack(_SCALARS[b])
    elif b == 0xC0:
        return None
    elif b in (0xC2, 0xC3):
        return b == 0xC3
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "array":
        return [_read(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(data: bytes):
    """The object of msgpack ``data`` (str as str, bin as bytes, arrays as
    lists, maps as dicts with any keys); trailing bytes raise."""
    r = _Reader(bytes(data))
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return obj
