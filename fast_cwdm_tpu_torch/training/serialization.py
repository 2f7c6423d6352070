"""flax's msgpack checkpoint format, read and written with numpy alone.

The JAX package writes ``.ckpt`` files with ``flax.serialization.to_bytes``
(``fast_cwdm_tpu/training/checkpoints.py``): the tree goes through flax's
``to_state_dict`` (every dict, list and tuple becomes a map with string
keys, lists and tuples keyed ``"0"``, ``"1"``, …), arrays above
``MAX_CHUNK_SIZE`` bytes become ``{"__msgpack_chunked_array__": True,
"shape": …, "chunks": …}`` maps, and the result is
``msgpack.packb(..., strict_types=True)`` with three extension types:

* 1, an ndarray: a nested msgpack array ``(shape, dtype name, C-order
  bytes)``;
* 2, a Python complex: a nested msgpack array ``(real, imag)``;
* 3, a numpy scalar: encoded as ext 1 of the 0-d array.

This module decodes every msgpack type such a file holds and encodes the
smallest form of each, as ``msgpack.packb`` does, so that for the same
nested dict its bytes equal flax's. The format describes itself, so
decoding needs no template. A ``bfloat16`` array (no numpy dtype) decodes
to a ``torch.bfloat16`` tensor with the same bits; torch tensors encode as
the arrays they hold. Nothing here imports flax or msgpack.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # bytes; flax's limit, read at call time
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def to_state_dict(tree):
    """flax's ``to_state_dict`` for dicts, lists and tuples: maps with
    string keys all the way down; leaves are returned as they are."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def _itemsize(leaf) -> int:
    return leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize


def _nbytes(leaf) -> int:
    return math.prod(leaf.shape) * _itemsize(leaf)


def _chunk(arr) -> dict:
    """flax's ``_chunk``: the flattened array in slices of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / _itemsize(arr)))
    flat = arr.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(k): flat[i:i + size]
                       for k, i in enumerate(range(0, flat.shape[0], size))}}


def _chunk_leaves(d):
    """flax's ``_chunk_array_leaves_in_place``, on a copy: oversized array
    values of maps (and an oversized top-level array) become chunk maps."""
    is_array = lambda v: isinstance(v, (np.ndarray, torch.Tensor))  # noqa: E731
    if isinstance(d, dict):
        return {k: (_chunk(v) if is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE
                    else _chunk_leaves(v) if isinstance(v, dict) else v)
                for k, v in d.items()}
    if is_array(d) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


class _Decoder:
    """One msgpack object from ``data``. ``raw`` keeps strings as bytes;
    ``views`` returns bin payloads as memoryviews into ``data``."""

    def __init__(self, data, *, raw: bool = False, views: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw
        self.views = views

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def whole(self):
        obj = self.value()
        if self.pos != len(self.buf):
            raise ValueError(f"extra data after the msgpack object: {len(self.buf) - self.pos} bytes")
        return obj

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:
            return self.bin(self.uint(1 << (b - 0xC4)))
        if 0xC7 <= b <= 0xC9:
            n = self.uint(1 << (b - 0xC7))
            return self.ext(n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return int.from_bytes(self.take(1 << (b - 0xD0)), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.uint(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def str(self, n: int):
        data = self.take(n)
        if self.raw:
            return bytes(data)
        try:
            return str(data, "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"invalid UTF-8 in a msgpack string: {e}") from None

    def bin(self, n: int):
        data = self.take(n)
        return data if self.views else bytes(data)

    def ext(self, n: int):
        code = int.from_bytes(self.take(1), "big", signed=True)
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(payload)
        if code == EXT_NPSCALAR:
            return _ndarray_from(payload)[()]
        if code == EXT_COMPLEX:
            re, im = _Decoder(payload).whole()
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")


def _ndarray_from(payload: memoryview):
    """Ext 1's payload → a numpy array (one copy out of the file's bytes),
    or a torch.bfloat16 tensor for flax's ``bfloat16``."""
    inner = _Decoder(payload, raw=True, views=True).whole()
    if not (isinstance(inner, list) and len(inner) == 3 and isinstance(inner[0], list)
            and isinstance(inner[1], bytes) and isinstance(inner[2], memoryview)):
        raise ValueError("malformed ndarray extension: expected (shape, dtype name, bytes)")
    shape, name, data = tuple(inner[0]), inner[1].decode("ascii", "replace"), inner[2]
    if name == "bfloat16":
        bits = np.frombuffer(data, np.int16).copy().reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown array dtype {name!r} in a msgpack ndarray") from None
    if dtype.hasobject:
        raise ValueError(f"object dtype {name!r} in a msgpack ndarray")
    return np.frombuffer(data, dtype).copy().reshape(shape)


def msgpack_restore(data):
    """flax's ``msgpack_restore``: the tree of dicts (string keys), Python
    scalars, numpy arrays (torch.bfloat16 tensors for bfloat16) and numpy
    scalars, chunked arrays joined. Raises ``ValueError`` on truncated or
    corrupt data."""
    try:
        tree = _Decoder(data).whole()
    except RecursionError:
        raise ValueError("msgpack data nested too deeply") from None
    return _unchunk_leaves(tree)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _head(out: list, n: int, fix: int | None, fix_max: int, codes: tuple[int, ...]) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16- or
    32-bit form (``codes``, None where a width has no form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < (1 << (8 * width)):
            out.append(bytes((code,)) + n.to_bytes(width, "big"))
            return
    raise ValueError(f"msgpack object too long: {n}")


def _int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < hi:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int too big for msgpack: {v}")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= lo:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int too small for msgpack: {v}")


def _str(out: list, s: str) -> None:
    data = s.encode("utf-8")
    _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out.append(data)


def _bin_head(out: list, n: int) -> None:
    _head(out, n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext(out: list, code: int, parts: list) -> None:
    n = sum(len(p) for p in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes((fixed[n], code)))
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes((code,)))
    out.extend(parts)


def _array_bytes(arr) -> tuple[tuple, str, np.ndarray]:
    """(shape, dtype name, the C-order bytes as a flat uint8 array, a view
    where the array is contiguous)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            bits = arr.reshape(-1).view(torch.int16).numpy()
            return tuple(arr.shape), "bfloat16", bits.view(np.uint8)
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return arr.shape, arr.dtype.name, np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _array_parts(arr) -> list:
    """Ext 1's payload ``(shape, dtype name, C-order bytes)`` as parts."""
    shape, name, flat = _array_bytes(arr)
    parts: list = []
    _head(parts, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _head(parts, len(shape), 0x90, 16, (None, 0xDC, 0xDD))
    for d in shape:
        _int(parts, int(d))
    _str(parts, name)
    _bin_head(parts, flat.size)
    parts.append(memoryview(flat))
    return parts


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _int(out, obj)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        _str(out, obj)
    elif type(obj) is bytes:
        _bin_head(out, len(obj))
        out.append(obj)
    elif type(obj) is dict:
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _ext(out, EXT_NDARRAY, _array_parts(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_parts(np.asarray(obj)))
    elif type(obj) is complex:
        inner: list = [b"\x92"]
        _pack(obj.real, inner)
        _pack(obj.imag, inner)
        _ext(out, EXT_COMPLEX, inner)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} into a checkpoint")


def serialize_parts(tree) -> list:
    """The bytes of :func:`to_bytes` as a list of bytes-like parts (array
    data as views, so a large checkpoint is written without a second copy
    in memory)."""
    out: list = []
    _pack(_chunk_leaves(to_state_dict(tree)), out)
    return out


def to_bytes(tree) -> bytes:
    """flax's ``to_bytes`` for a tree of dicts, lists, tuples, Python
    scalars, numpy arrays and scalars, and torch tensors."""
    return b"".join(serialize_parts(tree))
