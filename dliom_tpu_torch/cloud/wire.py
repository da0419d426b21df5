"""Length-prefixed msgpack framing with numpy array support; port of
dliom_tpu/cloud/wire.py.

A frame is a little-endian u32 length, then one msgpack object. Arrays
travel as {"__nd__": raw bytes, "d": dtype str, "s": shape} (the
protobuf-equivalent of the reference's sensor protos, cloud/proto/).

The port carries its own encoder and decoder for the part of msgpack that
the wire uses, so it needs no msgpack package. `packb` gives the bytes of
`msgpack.packb(obj, default=_default, use_bin_type=True)` and `unpackb`
the value of `msgpack.unpackb(data, object_hook=_object_hook, raw=False)`,
so either package's client talks to the other's server. As msgpack's packer
does, exact types and their subclasses are packed natively before
`_default` is tried: `np.float64` (a `float`) and `np.str_` pack as
themselves, while `np.float32`, the numpy integers and arrays go through
`_default`, and `np.bool_` (neither a `bool` nor an `np.integer`) and a
`torch.Tensor` raise `TypeError`. The decoder refuses map keys other than
str and bytes (msgpack's `strict_map_key`), ext types, truncated input and
bytes after the object with `ValueError`. An array is one `bin`: its bytes
are written once and read back with one slice.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

_MAX_FRAME = 1 << 28  # 256 MB
_NEST_LIMIT = 511  # msgpack's DEFAULT_RECURSE_LIMIT
_DECODE_DEPTH = 1024  # msgpack's unpacker stack

_U8, _U16, _U32, _U64 = struct.Struct(">B"), struct.Struct(">H"), struct.Struct(">I"), struct.Struct(">Q")
_I8, _I16, _I32, _I64 = struct.Struct(">b"), struct.Struct(">h"), struct.Struct(">i"), struct.Struct(">q")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _default(obj):
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {"__nd__": a.tobytes(), "d": str(a.dtype), "s": list(a.shape)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"unserializable: {type(obj)}")


def _object_hook(obj):
    if "__nd__" in obj:
        return np.frombuffer(obj["__nd__"], dtype=obj["d"]).reshape(obj["s"])
    return obj


# ----- encoder -----


def _header(out: bytearray, n: int, fix: int, fix_max: int, code8, code16: int, code32: int,
            what: str) -> None:
    """Length header of a str, bin, array or map: the fixed form below
    `fix_max` (none when `fix` is None), then 8-, 16- and 32-bit lengths."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif code8 is not None and n < 0x100:
        out += bytes((code8, n))
    elif n < 0x10000:
        out.append(code16)
        out += _U16.pack(n)
    elif n < 0x100000000:
        out.append(code32)
        out += _U32.pack(n)
    else:
        raise ValueError(f"{what} is too large")


def _pack_int(out: bytearray, v: int) -> bool:
    """Smallest encoding of `v`; False when it needs more than 64 bits."""
    if 0 <= v < 0x80:
        out.append(v)  # positive fixint
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)  # negative fixint
    elif v >= 0:
        for code, st in ((0xCC, _U8), (0xCD, _U16), (0xCE, _U32), (0xCF, _U64)):
            if v < 1 << (8 * st.size):
                out.append(code)
                out += st.pack(v)
                return True
        return False
    else:
        for code, st in ((0xD0, _I8), (0xD1, _I16), (0xD2, _I32), (0xD3, _I64)):
            if v >= -(1 << (8 * st.size - 1)):
                out.append(code)
                out += st.pack(v)
                return True
        return False
    return True


def _pack(out: bytearray, obj, nest: int) -> None:
    default_used = False
    while True:
        if nest < 0:
            raise ValueError("recursion limit exceeded")
        if obj is None:
            out.append(0xC0)
        elif obj is True or obj is False:
            out.append(0xC3 if obj else 0xC2)
        elif isinstance(obj, int):
            if not _pack_int(out, obj):
                if default_used:
                    raise OverflowError("Integer value out of range")
                obj, default_used = _default(obj), True
                continue
        elif isinstance(obj, (bytes, bytearray)):
            _header(out, len(obj), None, 0, 0xC4, 0xC5, 0xC6, type(obj).__name__)
            out += obj
        elif isinstance(obj, str):
            data = obj.encode("utf-8")
            _header(out, len(data), 0xA0, 32, 0xD9, 0xDA, 0xDB, "String")
            out += data
        elif isinstance(obj, float):
            out.append(0xCB)
            out += _F64.pack(obj)
        elif isinstance(obj, (list, tuple)):
            _header(out, len(obj), 0x90, 16, None, 0xDC, 0xDD, "list")
            for v in obj:
                _pack(out, v, nest - 1)
        elif isinstance(obj, dict):
            _header(out, len(obj), 0x80, 16, None, 0xDE, 0xDF, "dict")
            for k, v in obj.items():
                _pack(out, k, nest - 1)
                _pack(out, v, nest - 1)
        elif not default_used:
            obj, default_used = _default(obj), True
            continue
        else:
            raise TypeError(f"Cannot serialize {obj!r}")
        return


def packb(obj) -> bytes:
    """`msgpack.packb(obj, default=_default, use_bin_type=True)`."""
    out = bytearray()
    _pack(out, obj, _NEST_LIMIT)
    return bytes(out)


# ----- decoder -----


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        end = self.pos + st.size
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        (v,) = st.unpack_from(self.data, self.pos)
        self.pos = end
        return v


# type byte -> (kind, struct of the value or length); fixed forms are decoded inline
_CODES = {
    0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
    0xCA: ("num", _F32), 0xCB: ("num", _F64),
    0xCC: ("num", _U8), 0xCD: ("num", _U16), 0xCE: ("num", _U32), 0xCF: ("num", _U64),
    0xD0: ("num", _I8), 0xD1: ("num", _I16), 0xD2: ("num", _I32), 0xD3: ("num", _I64),
    0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
    0xDC: ("array", _U16), 0xDD: ("array", _U32),
    0xDE: ("map", _U16), 0xDF: ("map", _U32),
}


def _unpack(r: _Reader, depth: int):
    if depth > _DECODE_DEPTH:
        raise ValueError("Unpack failed: nested too deeply")
    b = r.unpack(_U8)
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b < 0xC0:
        return r.take(b & 0x1F).decode("utf-8")
    if 0x90 <= b < 0xA0:
        return [_unpack(r, depth + 1) for _ in range(b & 0x0F)]
    if 0x80 <= b < 0x90:
        return _unpack_map(r, b & 0x0F, depth)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    kind, st = _CODES.get(b, (None, None))
    if kind is None:
        raise ValueError(f"Unpack failed: type byte 0x{b:02x} is not supported")
    n = r.unpack(st)
    if kind == "num":
        return n
    if kind == "bin":
        return r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_unpack(r, depth + 1) for _ in range(n)]
    return _unpack_map(r, n, depth)


def _unpack_map(r: _Reader, n: int, depth: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, depth + 1)
        if type(k) not in (str, bytes):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _unpack(r, depth + 1)
    return _object_hook(out)


def unpackb(data: bytes):
    """`msgpack.unpackb(data, object_hook=_object_hook, raw=False)`."""
    r = _Reader(bytes(data))
    obj = _unpack(r, 0)
    if r.pos != len(r.data):
        raise ValueError("Unpack failed: extra data")
    return obj


# ----- framing -----


def send_msg(sock: socket.socket, msg) -> None:
    blob = packb(msg)
    sock.sendall(struct.pack("<I", len(blob)) + blob)


def recv_msg(sock: socket.socket):
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack("<I", header)
    if n > _MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    blob = _recv_exact(sock, n)
    if blob is None:
        return None
    return unpackb(blob)


def _recv_exact(sock: socket.socket, n: int):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)
