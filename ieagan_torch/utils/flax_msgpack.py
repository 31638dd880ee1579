"""Reader and writer of flax msgpack checkpoints, in pure Python and numpy.

The JAX package saves every checkpoint component with
``flax.serialization.to_bytes``: msgpack maps of strings whose array leaves
are msgpack ext records of type 1, each holding the msgpack triple
``(shape, dtype name, C-order bytes)`` (type 3 is a numpy scalar stored the
same way). Arrays of 2**30 bytes or more are split into
``{"__msgpack_chunked_array__", "shape", "chunks"}`` maps. This module reads
that format without flax, jax or the msgpack package, so the port can load
the repo's checkpoints on a machine that has none of them. Arrays are
returned as read-only numpy views of the file's bytes, as flax returns them.
``msgpack_serialize`` writes the format back as ``flax.serialization.to_bytes``
does (dict keys sorted, as a jax tree map leaves them; msgpack's smallest
encodings; float64 for Python floats), so the JAX package restores what the
port saves.

It also holds the port's copies of the checkpoint-resolution helpers of
``ieagan_tpu/deploy/inference.py`` and ``ieagan_tpu/utils/checkpoint.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """A msgpack decoder over one buffer (the subset of the spec that any
    msgpack writer may emit: nil, bool, int, float, str, bin, array, map,
    ext)."""

    def __init__(self, data: bytes, ext_hook=None):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, code: int, n: int):
        data = self._take(n)
        return self.ext_hook(code, data) if self.ext_hook else (code, bytes(data))

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._unpack({0xC4: ">B", 0xC5: ">H",
                                                  0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self._take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack byte 0x{b:02x} is not valid")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def unpackb(data: bytes, ext_hook=None):
    """Decode one msgpack object that fills ``data``."""
    reader = _Reader(data, ext_hook)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _ndarray_from_bytes(data) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _flax_ext_hook(code: int, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not a flax record")


def _unchunk_in_place(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for key, value in tree.items():
            tree[key] = _unchunk_in_place(value)
    return tree


def msgpack_restore(data: bytes):
    """The twin of ``flax.serialization.msgpack_restore``: a nested dict of
    numpy arrays (and Python scalars) from a flax msgpack byte string."""
    return _unchunk_in_place(unpackb(data, _flax_ext_hook))


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_header(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_header(len(data), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_header(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for key in sorted(obj, key=str):
            _pack(str(key), out)
            _pack(obj[key], out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_to_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to a flax msgpack file")


def _pack_header(n: int, out: bytearray, fix: int | None, fix_limit: int, codes):
    """The length header: the fix form below ``fix_limit``, else the 8-, 16-
    or 32-bit form (``None`` where msgpack has none)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    else:
        out += bytes((codes[2],)) + struct.pack(">I", n)


def _pack_int(n: int, out: bytearray):
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 1 << 64)):
            if n <= top:
                out += bytes((code,)) + struct.pack(fmt, n)
                return
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out += bytes((code,)) + struct.pack(fmt, n)
                return


def _pack_ext(code: int, data: bytes, out: bytearray):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_header(len(data), out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.nbytes >= MAX_CHUNK_BYTES:
        raise ValueError(f"an array of {arr.nbytes} bytes needs flax's chunked "
                         "record, which this writer does not write")
    return _packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


# flax splits arrays of this many bytes or more into chunks
MAX_CHUNK_BYTES = 1 << 30


def _packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def msgpack_serialize(tree) -> bytes:
    """The twin of ``flax.serialization.msgpack_serialize``: ``tree`` (nested
    dicts of numpy arrays; None, bool, int, float, str, bytes, lists and
    numpy scalars also encode) as flax msgpack bytes."""
    return _packb(tree)


def read_checkpoint(path) -> dict:
    """Read a flax msgpack checkpoint file into nested dicts of numpy arrays."""
    with open(path, "rb") as fp:
        return msgpack_restore(fp.read())


def latest_checkpoint(weights_dir) -> str | None:
    """The tag of the newest ``state_dict_<tag>.json`` by stored ``itr``, or
    None (copy of ``ieagan_tpu/utils/checkpoint.py::latest_checkpoint``)."""
    weights_dir = pathlib.Path(weights_dir)
    if not weights_dir.exists():
        return None
    tags = []
    for p in weights_dir.glob("state_dict_*.json"):
        tag = p.stem[len("state_dict_"):]
        try:
            with open(p) as fp:
                itr = json.load(fp).get("itr", -1)
            tags.append((itr, tag))
        except (json.JSONDecodeError, OSError):
            continue
    if not tags:
        return None
    return max(tags)[1]


def resolve_generator_checkpoint(weights_path: str, tag: str | None = None,
                                 use_ema: bool = True) -> str:
    """Resolve a weights dir to a generator checkpoint file (copy of
    ``ieagan_tpu/deploy/inference.py::resolve_generator_checkpoint``).

    Runs tag every component (``G_ema_copy<N>.msgpack``,
    ``G_ema_best<N>.msgpack``); untagged ``G_ema.msgpack``/``G.msgpack``
    exist only for hand-exported files. A file path is returned as-is. With
    ``tag=None`` the newest copy tag (by stored itr) is used.
    """
    if not os.path.isdir(weights_path):
        return weights_path
    if tag is None:
        tag = latest_checkpoint(weights_path)
    names = ["G_ema", "G"] if use_ema else ["G"]
    for base in names:
        cand = os.path.join(weights_path,
                            f"{base}_{tag}.msgpack" if tag else f"{base}.msgpack")
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"no generator checkpoint under {weights_path}"
        + (f" for tag '{tag}'" if tag else ""))
