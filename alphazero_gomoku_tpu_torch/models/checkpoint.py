"""AZTPU1 checkpoints: read and write them without msgpack or flax.

Counterpart of ``alphazero_gomoku_tpu/models/checkpoint.py:23-69``.  A
checkpoint is the magic ``b"AZTPU1\\n"``, a little-endian ``<Q`` header
length, a JSON metadata header, then the flax state dict of the tree as
msgpack (``flax.serialization.msgpack_serialize``).  Writes are atomic (a
temporary file, then ``os.replace``).

The card's machine has neither msgpack nor flax, so this module carries its
own writer and reader for the subset flax writes:

  - maps, str, bin, int, float, bool, nil and arrays (the ndarray payload's
    tuple);
  - ext type 1, an ndarray: the msgpack of ``(shape, dtype name, C-order
    bytes)``;
  - ext type 3, a numpy scalar, the same payload of a 0-d array.

The codes are flax's ``_MsgpackExtType`` (``ndarray`` 1, ``native_complex``
2, ``npscalar`` 3).  The writer picks the smallest encoding of each value,
as msgpack's packer does, and writes map keys in sorted order, as flax's
state dicts are; it gives the bytes ``msgpack_serialize`` gives for the same
tree.  Arrays over flax's 1 GiB chunk size (which it splits into chunks)
are refused both ways.

The tree is flax's state dict: nested dicts with string keys, where flax
turned lists and tuples into dicts keyed ``"0"``, ``"1"``, ...; leaves are
numpy arrays.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

MAGIC = b"AZTPU1\n"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_BYTES = 1 << 30   # flax's MAX_CHUNK_SIZE


# ----------------------------------------------------------------------
# msgpack subset
# ----------------------------------------------------------------------
def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes):
    """A length header: ``fix | n`` when ``n <= fix_max``, else the first of
    ``codes`` (8-, 16-, 32-bit lengths; None where the family has none)
    whose width holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, v: int):
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too small")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "supported")
    if arr.nbytes > MAX_CHUNK_BYTES:
        raise ValueError(f"msgpack: an array of {arr.nbytes} bytes is over "
                         f"flax's chunk size")
    return packb((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, v: Any):
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for key in sorted(v):
            _pack(out, key)
            _pack(out, v[key])
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def packb(tree: Any) -> bytes:
    """msgpack bytes of ``tree`` (the subset the module docstring lists)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk.tobytes()

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",    # bin
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",    # str
                   0xDC: ">H", 0xDD: ">I",                # array
                   0xDE: ">H", 0xDF: ">I",                # map
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}    # ext
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return self.take(n)
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.take(n).decode("utf-8")
        if b <= 0xDD:
            return self.array(n)
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("msgpack: chunked arrays (over 1 GiB) are not "
                             "supported")
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, buf = unpackb(data)
        if isinstance(dtype, bytes):
            dtype = dtype.decode("ascii")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data: bytes) -> Any:
    """The value that ``data`` (msgpack bytes of the subset) holds."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return out


# ----------------------------------------------------------------------
# checkpoint files
# ----------------------------------------------------------------------
def to_state_dict(tree: Any) -> Any:
    """flax's state-dict form: lists and tuples become dicts keyed ``"0"``,
    ``"1"``, ...; leaves (numpy arrays and scalars) stay."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_checkpoint(path: str, tree: Any, metadata: Dict[str, Any]) -> None:
    """Atomically write ``tree`` (numpy leaves) and JSON ``metadata``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    blob = packb(to_state_dict(tree))
    meta = json.dumps(metadata).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(meta)))
        f.write(meta)
        f.write(blob)
    os.replace(tmp, path)


def _read_header(f, path: str) -> Dict[str, Any]:
    if f.read(len(MAGIC)) != MAGIC:
        raise ValueError(f"{path}: not an alphazero_gomoku_tpu checkpoint")
    (meta_len,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(meta_len).decode("utf-8"))


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(state dict, metadata)`` of a checkpoint file."""
    with open(path, "rb") as f:
        metadata = _read_header(f, path)
        blob = f.read()
    return unpackb(blob), metadata


def peek_metadata(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _read_header(f, path)
