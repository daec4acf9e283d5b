"""MessagePack for the decision journal and the checkpoint payload.

The JAX package packs both with the ``msgpack`` module, which the card's
machine does not have. This module writes and reads the types those
records hold: nil, bool, int (every width msgpack has), float64, str, bin,
array (list or tuple) and map (dict). ``packb`` gives the bytes that
``msgpack.packb(obj, use_bin_type=True)`` gives, chosen by the same rule:
the shortest encoding of each value, float64 for every float, str8 for
strings of 32 to 255 bytes. So a journal or checkpoint written by either
package reads in the other.

``unpackb`` reads the same types, in every encoding msgpack has for them.
It raises ``ValueError`` on truncated input, on bytes after the object, on
a type code it does not read (ext, float32, the unused 0xc1) and on a map
key that is not str or bytes, as ``msgpack.unpackb(b, raw=False)`` does
with its defaults for all of these but ext and float32.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Iterator, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        if v <= 0xFF:
            out += b"\xcc" + _B.pack(v)
        elif v <= 0xFFFF:
            out += b"\xcd" + _H.pack(v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + _I.pack(v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q.pack(v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -0x80:
        out += b"\xd0" + _b.pack(v)
    elif v >= -0x8000:
        out += b"\xd1" + _h.pack(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _i.pack(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, then the 8-bit
    (if ``codes`` has three), 16-bit and 32-bit forms."""
    if n < fix_max:
        out.append(fix | n)
        return
    if len(codes) == 3:
        if n <= 0xFF:
            out += bytes((codes[0], n))
            return
        codes = codes[1:]
    if n <= 0xFFFF:
        out += bytes((codes[0],)) + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += bytes((codes[1],)) + _I.pack(n)
    else:
        raise ValueError(f"object too large for msgpack ({n})")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + _d.pack(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out += bin_header(memoryview(obj).nbytes)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out += map_header(len(obj))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def map_header(n: int) -> bytes:
    """The header of a map of ``n`` pairs, as ``packb`` writes it."""
    out = bytearray()
    _pack_len(n, 0x80, 16, (0xDE, 0xDF), out)
    return bytes(out)


def bin_header(n: int) -> bytes:
    """The header of a bin of ``n`` bytes, as ``packb`` writes it."""
    out = bytearray()
    _pack_len(n, 0, 0, (0xC4, 0xC5, 0xC6), out)
    return bytes(out)


def packb(obj: Any, use_bin_type: bool = True) -> bytes:
    """``obj`` as MessagePack bytes (str and bytes kept apart)."""
    if not use_bin_type:
        raise ValueError("only use_bin_type=True is supported")
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.mv = memoryview(data)
        self.off = 0

    def take(self, n: int) -> memoryview:
        end = self.off + n
        if end > len(self.mv):
            raise ValueError("Unpack failed: incomplete input")
        out = self.mv[self.off:end]
        self.off = end
        return out

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


_FIXED = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
          0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q, 0xCB: _d}
_STR = {0xD9: _B, 0xDA: _H, 0xDB: _I}
_BIN = {0xC4: _B, 0xC5: _H, 0xC6: _I}
_ARRAY = {0xDC: _H, 0xDD: _I}
_MAP = {0xDE: _H, 0xDF: _I}


def _str(r: _Reader, n: int) -> str:
    return str(r.take(n), "utf-8")


def _unpack(r: _Reader) -> Any:
    c = r.num(_B)
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if c < 0x90:
        return _map(r, c & 0x0F)
    if c < 0xA0:
        return [_unpack(r) for _ in range(c & 0x0F)]
    if c < 0xC0:
        return _str(r, c & 0x1F)
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if c in _FIXED:
        return r.num(_FIXED[c])
    if c in _STR:
        return _str(r, r.num(_STR[c]))
    if c in _BIN:
        return bytes(r.take(r.num(_BIN[c])))
    if c in _ARRAY:
        return [_unpack(r) for _ in range(r.num(_ARRAY[c]))]
    if c in _MAP:
        return _map(r, r.num(_MAP[c]))
    raise ValueError(f"Unpack failed: unknown type code 0x{c:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             "key when strict_map_key=True")
        out[k] = _unpack(r)
    return out


def unpackb(packed: bytes, raw: bool = False) -> Any:
    """The one object ``packed`` holds (str decoded as UTF-8)."""
    if raw:
        raise ValueError("only raw=False is supported")
    r = _Reader(packed)
    obj = _unpack(r)
    if r.off != len(r.mv):
        raise ValueError("unpack(b) received extra data.")
    return obj


def iter_bin_map(read: Callable[[int], bytes]) -> Iterator[Tuple[str, int]]:
    """The pairs of a map of str (or bytes) keys to bin values, read
    from a stream through ``read(n)`` (exactly n bytes): yields each key
    and its value's length, and the caller reads those bytes before the
    next pair, so no value is held here. Raises ``ValueError`` on any
    other type code."""
    c = read(1)[0]
    if 0x80 <= c < 0x90:
        n = c & 0x0F
    elif c in _MAP:
        n = _MAP[c].unpack(read(_MAP[c].size))[0]
    else:
        raise ValueError(f"Unpack failed: 0x{c:02x} does not start a map")
    for _ in range(n):
        c = read(1)[0]
        if 0xA0 <= c < 0xC0:
            key = str(read(c & 0x1F), "utf-8")
        elif c in _STR or c in _BIN:
            st = _STR.get(c) or _BIN[c]
            key = read(st.unpack(read(st.size))[0])
            key = str(key, "utf-8") if c in _STR else bytes(key)
        else:
            raise ValueError(f"Unpack failed: map key of type 0x{c:02x}")
        c = read(1)[0]
        if c not in _BIN:
            raise ValueError(f"Unpack failed: value of type 0x{c:02x}, "
                             "not bin")
        yield key, _BIN[c].unpack(read(_BIN[c].size))[0]
