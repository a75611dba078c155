"""KataGo's elementwise passes as one CUDA kernel launch each
(``csrc/katago_eltwise.cu``).

:func:`eltwise` takes a bf16 ``[B, C, H, W]`` tensor ``x`` of KataGo's bf16
forward (``models/nbt.py``) and returns ``u``, bf16, in one pass:

  - ``eltwise(x, (scale, shift))``: ``u = relu(x * scale + shift)``, a
    norm and its ReLU;
  - ``eltwise(x, (scale, shift), add=y, store=...)``: ``x' = x + y`` rounded
    to bf16 (a residual add), stored into ``x`` when ``store``, then ``u =
    relu(x' * scale + shift)``;
  - ``eltwise(x, bias=b)``: ``u = relu(x + b)``, a conv's bf16 bias and its
    ReLU (``out=x`` does it in place).

``scale`` and ``shift`` are float32 with ``C`` elements (the bundle's ``[1,
C, 1, 1]``); the affine is computed in float32 on the bf16 value, rounded
once to bf16, then the ReLU.  ``u`` is a new channels_last tensor, or
``out``.

CUDA tensors take the kernel, one launch a call (counted in
``eltwise.launches``); CPU tensors take :func:`eltwise_plain`, the torch
composition the kernel replaces (``torch.add`` / ``add_``, ``addcmul``,
``relu_``), which runs on any device and which the card's test holds the
kernel against bit for bit.  On the card ``x``, ``add`` and ``out`` need
contiguous channels and points one stride apart (a channels_last tensor,
or a channel slice of one: the output of a merged conv), their channels
and point strides multiples of 8 and their bases 16-byte aligned (the
kernel loads eight channels at a time).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops.tree_kernels import _launch, _raise_on

VEC = 8               # bf16 channels a 16-byte load
MAX_CHANNELS = 2048   # eight channels a thread, 256 threads a block

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build("katago_eltwise").lib
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kata_eltwise_launch.argtypes = [p, s, p, s, i, p, p, p, p, s, i,
                                            s, p]
        lib.kata_eltwise_launch.restype = i
        _LIB = lib
    return _LIB


def _check_modes(affine, add, store, bias, x, out):
    if (affine is None) == (bias is None):
        raise ValueError("eltwise takes an affine or a bias, one of them")
    if bias is not None and add is not None:
        raise ValueError("eltwise adds a tensor or a bias, not both")
    if store and add is None:
        raise ValueError("eltwise stores only a sum (store needs add)")
    if store and out is x:
        raise ValueError("eltwise cannot store the sum into its output")


def eltwise_plain(x: torch.Tensor,
                  affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  *, add: Optional[torch.Tensor] = None, store: bool = False,
                  bias: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`eltwise` in plain torch ops, on any device."""
    _check_modes(affine, add, store, bias, x, out)
    if out is None:
        out = torch.empty_like(x, memory_format=torch.channels_last)
    if bias is not None:
        return torch.add(x, bias.view(1, -1, 1, 1), out=out).relu_()
    if add is not None:
        x = x.add_(add) if store else x + add
    scale, shift = affine
    return torch.addcmul(shift.view(1, -1, 1, 1), x, scale.view(1, -1, 1, 1),
                         out=out).relu_()


def _pix(t: torch.Tensor, shape, name: str) -> int:
    """The point stride of a bf16 ``[B, C, H, W]`` view of ``shape`` whose
    channels are contiguous and whose points are one stride apart."""
    if t.dtype != torch.bfloat16 or t.shape != shape:
        raise ValueError(f"{name} must be a bf16 {list(shape)} tensor, got "
                         f"{t.dtype} {list(t.shape)}")
    b, _, h, w = shape
    st = t.stride()
    pix = st[3]
    if (st[1] != 1 or (h > 1 and st[2] != w * pix)
            or (b > 1 and st[0] != h * w * pix)):
        raise ValueError(f"{name} needs contiguous channels and points one "
                         f"stride apart (channels_last), got strides {st}")
    if pix % VEC or t.data_ptr() % 16:
        raise ValueError(f"{name}: point stride must be a multiple of {VEC} "
                         f"and the base 16-byte aligned")
    return pix


def _vector(v: torch.Tensor, dtype, c: int, dev, name: str) -> int:
    if (v.dtype != dtype or v.numel() != c or not v.is_contiguous()
            or v.device != dev):
        raise ValueError(f"{name} must be a contiguous {dtype} vector of {c} "
                         f"on {dev}")
    return v.data_ptr()


def eltwise(x: torch.Tensor,
            affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            *, add: Optional[torch.Tensor] = None, store: bool = False,
            bias: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One elementwise pass of KataGo's bf16 forward (module docstring):
    ``u`` (``out`` when given).  ``affine`` is the norm's ``(scale,
    shift)``, float32."""
    dev = x.device
    if dev.type == "cpu":
        return eltwise_plain(x, affine, add=add, store=store, bias=bias,
                             out=out)
    if dev.type != "cuda":
        raise ValueError(f"eltwise: unsupported device {dev}")
    _check_modes(affine, add, store, bias, x, out)
    shape = x.shape
    c = shape[1] if x.dim() == 4 else 0
    if c % VEC or not VEC <= c <= MAX_CHANNELS:
        raise ValueError(f"eltwise takes [B, C, H, W] with C a multiple of "
                         f"{VEC} up to {MAX_CHANNELS}, got {list(shape)}")
    x_pix = _pix(x, shape, "x")
    add_ptr, add_pix = (None, 0) if add is None else (
        add.data_ptr(), _pix(add, shape, "add"))
    if add is not None and add.device != dev:
        raise ValueError(f"add must be on {dev}")
    if bias is None:
        scale = _vector(affine[0], torch.float32, c, dev, "scale")
        shift = _vector(affine[1], torch.float32, c, dev, "shift")
        bias_ptr = None
    else:
        scale = shift = None
        bias_ptr = _vector(bias, torch.bfloat16, c, dev, "bias")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.channels_last)
        out_pix = c
    else:
        out_pix = _pix(out, shape, "out")
        if out.device != dev:
            raise ValueError(f"out must be on {dev}")
    err = _launch(dev, _library().kata_eltwise_launch, x.data_ptr(), x_pix,
                  add_ptr, add_pix, int(store), scale, shift, bias_ptr,
                  out.data_ptr(), out_pix, c,
                  shape[0] * shape[2] * shape[3])
    _raise_on(err, "kata_eltwise")
    eltwise.launches += 1
    return out


eltwise.launches = 0
