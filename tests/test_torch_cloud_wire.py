"""The port's msgpack codec (dliom_tpu_torch/cloud/wire.py) byte for byte
against the msgpack package as the JAX package's wire uses it
(dliom_tpu/cloud/wire.py): `packb` against `msgpack.packb(obj,
default=_default, use_bin_type=True)`, `unpackb` against
`msgpack.unpackb(data, object_hook=_object_hook, raw=False)`, on a corpus at
every encoding boundary, numpy arrays and scalars, and a hypothesis strategy
over nested values; the framing over a socket pair; and the port's cloud
modules importing with neither msgpack nor the JAX package available.
"""

import enum
import math
import socket
import struct
import subprocess
import sys
import threading

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dliom_tpu.cloud import wire as jwire
from dliom_tpu_torch.cloud import wire as twire
import torch_threads  # noqa: F401  (one torch thread per test process)


def _ref_pack(obj):
    return msgpack.packb(obj, default=jwire._default, use_bin_type=True)


def _ref_unpack(data):
    return msgpack.unpackb(data, object_hook=jwire._object_hook, raw=False)


def _same(x, y) -> bool:
    """Equal values of equal types; floats by their bits (nan, -0.0),
    arrays by dtype, shape, contents and writeability."""
    if type(x) is not type(y):
        return False
    if isinstance(x, np.ndarray):
        return (x.dtype == y.dtype and x.shape == y.shape and x.flags.writeable == y.flags.writeable
                and np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"))
    if isinstance(x, float):
        return struct.pack(">d", x) == struct.pack(">d", y)
    if isinstance(x, dict):
        return list(x) == list(y) and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, list):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return x == y


def _outcome(fn, *args):
    """fn's result, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001  (the exception type is the result)
        return type(e)


def _check(obj):
    want = _outcome(_ref_pack, obj)
    got = _outcome(twire.packb, obj)
    assert got == want, (type(obj), want if isinstance(want, type) else want[:32],
                         got if isinstance(got, type) else got[:32])
    if isinstance(want, bytes):
        decoded_want = _outcome(_ref_unpack, want)
        decoded_got = _outcome(twire.unpackb, want)
        assert _same(decoded_got, decoded_want), (decoded_got, decoded_want)
    return want


class _Color(enum.IntEnum):
    RED = 1


_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1,
         2**64, -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63,
         -2**63 - 1]
_FLOATS = [0.0, -0.0, 1.5, -2.25, 1e-310, 1.7976931348623157e308, float("nan"), float("inf"),
           float("-inf"), struct.unpack(">d", b"\x7f\xf8\x00\x00\x00\x00\x00\x01")[0]]
_LENGTHS = [0, 1, 31, 32, 255, 256, 65535, 65536]


def _corpus():
    rng = np.random.default_rng(7)
    out = [None, True, False, _Color.RED] + _INTS + _FLOATS
    for n in _LENGTHS:
        out.append("".join(chr(c) for c in rng.integers(0x20, 0x7F, n)))
        out.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    out += ["é€😀" * 11, bytearray(b"\x00\xff" * 20)]
    for n in (0, 1, 15, 16, 65535, 65536):
        out.append(list(range(n)))
        out.append({f"k{i}": i for i in range(n)})
    out += [tuple(range(17)), {"nested": [{"a": [1, [2, [3]]]}, None, b"x"]}, {b"bytes-key": 1},
            {1: "int key"}, {None: 0}]
    return out


_ARRAYS = [
    np.zeros((0, 3), np.float32), np.zeros((4, 0), np.int32), np.array(3.5), np.array(7, np.int16),
    np.array(True), np.arange(12, dtype=np.int16).reshape(3, 4), np.arange(5, dtype=np.uint8),
    np.array([True, False, True]), np.linspace(-1, 1, 9).reshape(3, 3),
    np.array([np.nan, -0.0, np.inf], np.float32), np.arange(24, dtype=np.int32).reshape(2, 3, 4)[:, ::2],
    np.asfortranarray(np.arange(6, dtype=np.float64).reshape(2, 3)),
    np.random.default_rng(1).standard_normal((9600, 3)).astype(np.float32),
]

_SCALARS = [np.float64(2.5), np.float32(1.25), np.float16(0.5), np.longdouble(3.0), np.int8(-5),
            np.int16(300), np.int32(-70000), np.int64(2**40), np.uint8(200), np.uint16(60000),
            np.uint32(2**32 - 1), np.uint64(2**64 - 1), np.intc(3), np.str_("numpy str"),
            np.bytes_(b"numpy bytes"), np.bool_(True), np.complex64(1 + 2j), np.float64("nan"),
            np.datetime64("2026-01-01")]


@pytest.mark.parametrize("obj", _corpus(), ids=lambda o: type(o).__name__)
def test_corpus_matches_msgpack(obj):
    _check(obj)


@pytest.mark.parametrize("arr", _ARRAYS, ids=lambda a: f"{a.dtype}{a.shape}")
def test_arrays_match_msgpack(arr):
    blob = _check(arr)
    back = twire.unpackb(blob)
    # `_default`'s np.ascontiguousarray makes a 0-d array 1-d: it travels,
    # in both packages, with shape (1,)
    assert back.dtype == arr.dtype and back.shape == (arr.shape or (1,))
    assert np.array_equal(back.reshape(arr.shape), arr, equal_nan=arr.dtype.kind == "f")
    _check({"points": arr, "times": [arr, arr.shape], "n": np.int64(arr.size)})


@pytest.mark.parametrize("scalar", _SCALARS, ids=lambda s: type(s).__name__)
def test_numpy_scalars_match_msgpack(scalar):
    """msgpack packs a `float` or `str` subclass natively and hands the rest
    to `_default`: np.float64 and np.str_ as themselves, the other floats
    and every integer through int() / float(), np.bool_ (neither a bool nor
    an np.integer) and the complex and datetime scalars as TypeError."""
    want = _check(scalar)
    if isinstance(scalar, (np.bool_, np.complexfloating, np.datetime64)):
        assert want is TypeError
    else:
        assert isinstance(want, bytes)


def test_tensor_raises_in_both():
    for obj in (torch.zeros(3), {"reply": torch.ones(2, dtype=torch.float64)}, [torch.tensor(1)]):
        with pytest.raises(TypeError):
            _ref_pack(obj)
        with pytest.raises(TypeError):
            twire.packb(obj)


def test_decoder_refuses_truncated_and_trailing_input():
    blob = twire.packb({"points": np.ones((4, 3), np.float32), "time": 1.5})
    for cut in (1, 5, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError):
            _ref_unpack(blob[:cut])
        with pytest.raises(ValueError):
            twire.unpackb(blob[:cut])
    with pytest.raises(ValueError):
        _ref_unpack(blob + b"\xc0")
    with pytest.raises(ValueError):
        twire.unpackb(blob + b"\xc0")
    # the other encodings msgpack decodes: float32, and ext types refused here
    assert twire.unpackb(b"\xca" + struct.pack(">f", 0.5)) == _ref_unpack(b"\xca" + struct.pack(">f", 0.5))
    with pytest.raises(ValueError):
        twire.unpackb(b"\xd4\x01\x00")


_leaf = st.one_of(
    st.none(), st.booleans(), st.integers(-2**63, 2**64 - 1), st.floats(allow_nan=True),
    st.text(max_size=40), st.binary(max_size=300),
    st.builds(lambda n, s: np.arange(n, dtype=np.float32).reshape(-1, 1) * s,
              st.integers(0, 8), st.floats(-10, 10)),
    st.builds(lambda n: np.arange(n, dtype=np.int32) - 3, st.integers(0, 6)),
    st.builds(lambda b: np.array(b, bool), st.lists(st.booleans(), max_size=5)),
)
_values = st.recursive(
    _leaf,
    lambda inner: st.one_of(st.lists(inner, max_size=18), st.dictionaries(st.text(max_size=8), inner, max_size=18)),
    max_leaves=40,
)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_nested_values_match_msgpack(obj):
    _check(obj)


def _sender(sock, fn, msg):
    t = threading.Thread(target=fn, args=(sock, msg), daemon=True)
    t.start()
    return t


def test_framing_over_socketpair_both_ways():
    msg = {"method": "add_range_data",
           "params": {"time": 12.5, "points": np.random.default_rng(3).random((9600, 3), np.float32),
                      "trajectory_id": 0}}
    for send, recv in ((twire.send_msg, jwire.recv_msg), (jwire.send_msg, twire.recv_msg),
                       (twire.send_msg, twire.recv_msg)):
        a, b = socket.socketpair()
        with a, b:
            t = _sender(a, send, msg)
            got = recv(b)
            t.join(10)
            assert not t.is_alive()
        assert _same(got, _ref_unpack(_ref_pack(msg)))


def test_framing_truncated_and_oversized():
    for recv in (jwire.recv_msg, twire.recv_msg):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(struct.pack("<I", 100) + b"\x80" * 10)
            a.shutdown(socket.SHUT_WR)
            assert recv(b) is None
        a, b = socket.socketpair()
        with a, b:
            a.sendall(b"\x01\x02")
            a.shutdown(socket.SHUT_WR)
            assert recv(b) is None
        a, b = socket.socketpair()
        with a, b:
            a.sendall(struct.pack("<I", twire._MAX_FRAME + 1))
            with pytest.raises(ValueError, match="frame too large"):
                recv(b)
    assert twire._MAX_FRAME == jwire._MAX_FRAME == 1 << 28


def test_cloud_imports_without_msgpack_or_the_jax_package():
    code = ("import sys\n"
            "sys.modules['msgpack'] = None\n"
            "sys.modules['dliom_tpu'] = None\n"
            "sys.modules['jax'] = None\n"
            "import dliom_tpu_torch.cloud\n"
            "from dliom_tpu_torch.cloud import client, server, uploader, wire\n"
            "assert wire.unpackb(wire.packb({'a': [1, 2.5, b'x']})) == {'a': [1, 2.5, b'x']}\n"
            "assert not [m for m in sys.modules if m.startswith(('msgpack', 'jax', 'dliom_tpu.'))\n"
            "            and sys.modules[m] is not None]\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_encode_is_one_copy_per_array():
    """An array travels as one bin: a 9600-point scan's frame is its bytes
    plus a few dozen of header, and decodes to a read-only view of them."""
    pts = np.random.default_rng(5).random((9600, 3), np.float32)
    blob = twire.packb({"time": 1.0, "points": pts})
    assert len(blob) - pts.nbytes < 64
    back = twire.unpackb(blob)["points"]
    assert not back.flags.writeable and np.array_equal(back, pts)
    assert math.isclose(twire.unpackb(blob)["time"], 1.0)
