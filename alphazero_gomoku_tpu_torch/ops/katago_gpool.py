"""KataGo's global pooling as one CUDA kernel launch (``csrc/katago_gpool.cu``).

:func:`gpool` pools the channels ``g`` (``[B, C, H, W]`` bf16, before their
norm and ReLU) of a KataGo net (``models/nbt.py``):

  - with a linear ``w`` (bf16 ``[3C, R]``) and a target ``r`` (bf16 ``[B, R,
    H, W]``), KataGPool: ``r += w^T [mean, mean * (sqrt(HW) - 14) / 10,
    max]`` of ``relu(g * scale + shift)``, broadcast over the board, in
    place (a gpool block of the trunk, the policy head); the pooled vector
    float32, its products with the bf16 weights summed in float32, each
    element of ``r`` rounded to bf16 once;
  - without them, the value head's pooling: ``[mean, mean * f / 10, mean
    * (f^2 / 100 - 0.1)]`` with ``f = sqrt(HW) - 14``, float32 ``[B, 3C]``.

CUDA tensors take the kernel, one launch a call (counted in
``gpool.launches``); CPU tensors take :func:`gpool_plain`, which runs on any
device and which the card's test holds the kernel against.  On the card
``g`` and ``r`` need contiguous channels and points one stride apart (a
channels_last tensor, or a channel slice of one: the output of a merged
conv, as the bf16 forward makes them), their channels and strides
multiples of 8 and their bases 16-byte aligned (the kernel loads eight
channels at a time).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops.tree_kernels import _launch, _raise_on

VEC = 8               # bf16 channels a 16-byte load
MAX_CHANNELS = 2048   # eight channels a thread, 256 threads a block

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build("katago_gpool").lib
        p, i, s, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.kata_gpool_launch.argtypes = [p, s, s, i, p, p, i, f, f, p, i, p,
                                          s, s, p, i, p]
        lib.kata_gpool_launch.restype = i
        _LIB = lib
    return _LIB


def factors(height: int, width: int):
    """``(f1, f2)``: the second and third groups' factors of the mean,
    ``(sqrt(HW) - 14) / 10`` and ``(sqrt(HW) - 14)^2 / 100 - 0.1``."""
    f = math.sqrt(height * width) - 14.0
    return f / 10.0, f * f / 100.0 - 0.1


def gpool_plain(g: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                w: Optional[torch.Tensor] = None,
                r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`gpool` in plain torch ops, on any device."""
    f1, f2 = factors(g.shape[2], g.shape[3])
    c = g.shape[1]
    a = torch.relu(g.to(torch.float32) * scale.view(1, c, 1, 1)
                   + shift.view(1, c, 1, 1))
    mean = a.mean(dim=(2, 3))
    if w is None:
        return torch.cat([mean, mean * f1, mean * f2], dim=1)
    pooled = torch.cat([mean, mean * f1, a.amax(dim=(2, 3))], dim=1)
    add = pooled @ w.to(torch.float32)
    r.copy_((r.to(torch.float32) + add[:, :, None, None]).to(r.dtype))
    return r


def _points(t: torch.Tensor, name: str):
    """``(board stride, point stride)`` of a bf16 ``[B, C, H, W]`` view
    whose channels are contiguous and whose points are one stride apart."""
    if t.dtype != torch.bfloat16 or t.dim() != 4:
        raise ValueError(f"{name} must be a bf16 [B, C, H, W] tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.stride(1) != 1 or t.stride(2) != t.shape[3] * t.stride(3):
        raise ValueError(f"{name} needs contiguous channels and points one "
                         f"stride apart (channels_last), got strides "
                         f"{t.stride()}")
    if t.stride(3) % VEC or t.stride(0) % VEC or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides must be multiples of {VEC} and "
                         f"the base 16-byte aligned")
    return t.stride(0), t.stride(3)


def gpool(g: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
          w: Optional[torch.Tensor] = None,
          r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KataGPool added into ``r`` (returned), with ``w`` and ``r``; else the
    value head's pooling, float32 ``[B, 3C]`` (module docstring).
    ``scale`` and ``shift`` are float32 ``[C]``, the norm's affine."""
    if (w is None) != (r is None):
        raise ValueError("gpool takes w and r together, or neither")
    dev = g.device
    if dev.type == "cpu":
        return gpool_plain(g, scale, shift, w, r)
    if dev.type != "cuda":
        raise ValueError(f"gpool: unsupported device {dev}")
    b, c, h, wd = g.shape
    if c % VEC or not VEC <= c <= MAX_CHANNELS:
        raise ValueError(f"gpool takes channels in multiples of {VEC} up "
                         f"to {MAX_CHANNELS}, got {c}")
    g_board, g_pix = _points(g, "g")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or v.shape != (c,) \
                or not v.is_contiguous() or v.device != dev:
            raise ValueError(f"{name} must be float32 [{c}] on {dev}")
    f1, f2 = factors(h, wd)
    if w is None:
        out = torch.empty((b, 3 * c), dtype=torch.float32, device=dev)
        args = (None, 0, None, 0, 0, out.data_ptr())
    else:
        cout = r.shape[1]
        if (w.dtype != torch.bfloat16 or w.shape != (3 * c, cout)
                or not w.is_contiguous() or w.device != dev):
            raise ValueError(f"w must be a contiguous bf16 [{3 * c}, {cout}] "
                             f"tensor on {dev}")
        if r.shape != (b, cout, h, wd) or cout % VEC or r.device != dev:
            raise ValueError(f"r must be [{b}, R, {h}, {wd}] on {dev}, R a "
                             f"multiple of {VEC}, got {tuple(r.shape)}")
        r_board, r_pix = _points(r, "r")
        out = r
        args = (w.data_ptr(), cout, r.data_ptr(), r_board, r_pix, None)
    w_ptr, cout, r_ptr, r_board, r_pix, pooled = args
    err = _launch(dev, _library().kata_gpool_launch, g.data_ptr(), g_board,
                  g_pix, c, scale.data_ptr(), shift.data_ptr(), h * wd, f1,
                  f2, w_ptr, cout, r_ptr, r_board, r_pix, pooled, b)
    _raise_on(err, "kata_gpool")
    gpool.launches += 1
    return out


gpool.launches = 0
