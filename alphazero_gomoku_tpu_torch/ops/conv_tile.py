"""The padded-board tiles of the two tower kernels, in Python.

Mirrors ``csrc/conv_tile.cuh``, the shared core of ``csrc/int8_tower.cu``
and ``csrc/fused_net.cu``: the geometry the wrappers allocate and check by,
the kernels' activation layout (:func:`to_planes`), and
:func:`conv_planes_plain`, a plain version of one conv as the kernels
compute it (tile by tile, nine row slices of one staged buffer), which the
CPU tests hold against the towers' plain convolutions.

Layout: board ``b`` of side ``size`` is padded to ``p = size + 2`` columns
and rows with zeros and stored flat, ``R = p * p`` rows a board, pixel
``(y, x)`` at row ``b * R + (y + 1) * p + (x + 1)``; the channels are cut
into 16-byte chunk planes, ``[C * itemsize / 16, rows_total, 16 /
itemsize]``.  A tile is ``mt`` output rows of a board's band (rows ``p + 1``
to ``p + size * p``, the two garbage columns a row included; ``mt`` is 128
for the int8 tower, 64 for the bf16 one); its input is the ``mt + 2p + 2``
rows from board row ``s * mt`` on, and tap ``(dy, dx)`` reads them from
row offset ``dy * p + dx``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

MAX_PITCH = 23            # boards up to MAX_BOARD = 21
MAX_BOARD = MAX_PITCH - 2


def a_rows_max(mt: int) -> int:
    """Rows of a board buffer's chunk plane for tiles of ``mt`` rows."""
    return mt + 2 * MAX_PITCH + 2


@dataclasses.dataclass(frozen=True)
class Geometry:
    batch: int
    size: int
    pitch: int            # p = size + 2
    board_rows: int       # R = p * p
    mt: int               # output rows of a tile
    segs: int             # tiles a board
    n_tiles: int
    a_rows: int           # a tile's staged rows, mt + 2p + 2
    rows_total: int       # rows of a chunk plane


def geometry(batch: int, size: int, mt: int) -> Geometry:
    """``conv_tile::geometry`` of the CUDA header, field for field."""
    p = size + 2
    r = p * p
    segs = -(-size * p // mt)
    a_rows = mt + 2 * p + 2
    last = (batch - 1) * r + (segs - 1) * mt + a_rows
    rows_total = -(-max(last, batch * r) // 8) * 8
    return Geometry(batch, size, p, r, mt, segs, batch * segs, a_rows,
                    rows_total)


def check_kernel_shape(name: str, shape, channels: int, itemsize: int,
                       mt: int) -> Geometry:
    """Raise ``ValueError`` for what a tower kernel cannot take: a board
    that is not square or larger than ``MAX_BOARD`` (a tile's staged rows
    fill a board buffer's plane), an empty batch, or more rows than 32-bit
    indices reach.  Returns the geometry of tiles of ``mt`` rows."""
    b, h, w = shape[:3]
    if h != w:
        raise ValueError(f"{name}'s kernel takes square boards, got {h}x{w}")
    if h > MAX_BOARD:
        raise ValueError(f"{name}'s kernel takes boards up to {MAX_BOARD}x"
                         f"{MAX_BOARD} (a tile's rows in a board buffer), "
                         f"got {h}x{h}")
    if b < 1:
        raise ValueError(f"{name}'s kernel needs a batch of at least 1")
    geo = geometry(b, h, mt)
    if (geo.rows_total * channels * itemsize >= 2 ** 31
            or b * h * w * channels >= 2 ** 31):
        raise ValueError(f"{name}'s kernel indexes with 32-bit ints: batch "
                         f"{b} is too large")
    return geo


def to_planes(x: torch.Tensor, mt: int) -> torch.Tensor:
    """NHWC ``x [B, S, S, C]`` -> the kernels' chunk planes ``[C / E,
    rows_total, E]`` (``E = 16 / itemsize``) for tiles of ``mt`` rows, zero
    outside the boards."""
    b, s, _, c = x.shape
    e = 16 // x.element_size()
    geo = geometry(b, s, mt)
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))      # [B, p, p, C]
    flat = x.new_zeros((geo.rows_total, c))
    flat[:b * geo.board_rows] = pad.reshape(b * geo.board_rows, c)
    return flat.reshape(geo.rows_total, c // e, e).transpose(0, 1).contiguous()


def conv_planes_plain(planes: torch.Tensor, w: torch.Tensor, batch: int,
                      size: int, mt: int) -> torch.Tensor:
    """One 3x3 SAME conv as the kernels compute it, in float64: ``planes``
    (:func:`to_planes`), ``w [Cout, 9 * C]`` K-contiguous rows (column
    ``(3*dy + dx) * C + ci``) -> NHWC ``[B, S, S, Cout]`` sums.  Tile by
    tile of ``mt`` rows: stage ``a_rows`` rows, add the nine taps' row
    slices times the tap's weights, keep the interior rows."""
    geo = geometry(batch, size, mt)
    p = geo.pitch
    rows = planes.transpose(0, 1).reshape(geo.rows_total, -1).double()
    c = rows.shape[1]
    wt = w.double()
    out = rows.new_zeros((batch, size, size, w.shape[0]))
    for t in range(geo.n_tiles):
        b, s = divmod(t, geo.segs)
        base = b * geo.board_rows + s * mt
        staged = rows[base:base + geo.a_rows]
        acc = sum(staged[(k // 3) * p + k % 3:][:mt]
                  @ wt[:, k * c:(k + 1) * c].t() for k in range(9))
        rr = p + 1 + s * mt + torch.arange(mt)
        y, x = rr // p - 1, rr % p - 1
        keep = (rr < p + 1 + size * p) & (x >= 0) & (x < size)
        out[b, y[keep], x[keep]] = acc[keep]
    return out


def tile_weights(w: torch.Tensor, ns: int) -> torch.Tensor:
    """K-contiguous weight rows ``[..., Cout, K]`` (column ``tap * Cin +
    ci``) -> the kernels' shared-memory layout ``[..., Cout / ns, K / E,
    ns, E]`` (``E = 16 / itemsize``): per slice of ``ns`` output channels,
    per 16-byte chunk of K (tap-major), the slice's rows, so that a tap of a
    slice is one contiguous bulk copy."""
    *lead, cout, k = w.shape
    e = 16 // w.element_size()
    return w.reshape(*lead, cout // ns, ns, k // e, e).transpose(-3, -2) \
        .contiguous()


# derived(): values made from tensors, by name and the tensors' ids
_DERIVED: Dict[tuple, tuple] = {}


def derived(name: str, sources: Sequence[torch.Tensor],
            make: Callable[..., object]):
    """``make(*sources)``, made once and kept while every source tensor is
    alive and unchanged (``_version``): the wrappers' re-packs of a bundle's
    weights, made once per bundle."""
    key = (name, *(id(t) for t in sources))
    versions = tuple(t._version for t in sources)
    hit = _DERIVED.get(key)
    if (hit is not None and all(r() is t for r, t in zip(hit[0], sources))
            and hit[1] == versions):
        return hit[2]
    for k in [k for k, v in _DERIVED.items()
              if any(r() is None for r in v[0])]:
        del _DERIVED[k]
    value = make(*sources)
    _DERIVED[key] = (tuple(weakref.ref(t) for t in sources), versions, value)
    return value


# zeroed_planes(): per device, stream, dtype and shape, the newest last
_PLANES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
PLANE_SHAPES_KEPT = 8


def zeroed_planes(shape, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tower's two conv-input buffers (chunk planes of ``shape``), zeroed
    once, at allocation, and kept for later calls on the same stream: the
    kernels write only the boards' interior, which every call rewrites
    before it reads it, so the zero borders stay zero."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (str(device), stream, dtype, tuple(shape))
    bufs = _PLANES.pop(key, None)
    if bufs is None:
        bufs = (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    _PLANES[key] = bufs
    while len(_PLANES) > PLANE_SHAPES_KEPT:
        del _PLANES[next(iter(_PLANES))]
    return bufs
