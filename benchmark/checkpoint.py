"""AZTPU1 checkpoints: a reader, and the sha256 a configuration pins.

A frozen copy of the reader of ``alphazero_gomoku_tpu_torch/models/
checkpoint.py`` (``_Reader``, ``unpackb``, ``_read_header``,
``load_checkpoint``), taken when the benchmark was added, so that the
benchmark reads the weights itself and hands the same arrays to the program
and to the reference.  A checkpoint is the magic ``b"AZTPU1\\n"``, a
little-endian ``<Q`` header length, a JSON metadata header, then flax's
state dict as msgpack (maps, str, bin, int, float, bool, nil, arrays; ext 1
an ndarray, ext 3 a numpy scalar, each the msgpack of ``(shape, dtype name,
C-order bytes)``).
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Any, Dict, Tuple

import numpy as np

MAGIC = b"AZTPU1\n"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3


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


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _lists(tree):
    """flax's state-dict form back to the params layout: a dict keyed
    ``"0"``, ``"1"``, ... becomes a list."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def load(path: str, expect_sha256: str) -> Tuple[Dict, Dict, Dict]:
    """``(params, batch_stats, metadata)`` of a checkpoint whose sha256 is
    ``expect_sha256``; raises on another file."""
    got = sha256(path)
    if got != expect_sha256:
        raise ValueError(f"{path}: sha256 {got}, the configuration pins "
                         f"{expect_sha256}")
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not an AZTPU1 checkpoint")
        (meta_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(meta_len).decode("utf-8"))
        state = unpackb(f.read())
    return _lists(state["params"]), _lists(state["batch_stats"]), meta
