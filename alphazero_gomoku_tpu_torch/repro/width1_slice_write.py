"""The width-1 minor-dimension slice write through a 3-D scratch, on the card.

Counterpart of ``repro/mosaic_width1_slice_hang.py``, the repro of a Mosaic
compiler hang: its kernel copies ``x [B, G, R]`` float32 into a 3-D VMEM
scratch, rewrites the scratch's column ``C`` of the minor dimension (the
width-1 write that never finished compiling) or, with ``--ok``, its columns
``C:`` (the segment-wide write that compiled) as ``v * 0.5 + 1``, and
copies the scratch out.

  - :func:`width1_slice_write` runs that function as the CUDA kernel in
    ``csrc/width1_slice.cu`` on CUDA tensors (each block holds one ``b``'s
    ``[G, R]`` slab in shared memory, rewrites the slice there and copies
    the slab out), and as :func:`width1_slice_write_plain` on CPU tensors.
    It counts its kernel launches in ``width1_slice_write.launches``.
  - :func:`main` is the repro's entry point:

    python -m alphazero_gomoku_tpu_torch.repro.width1_slice_write [--ok]

prints what the JAX repro prints.  ``nvcc`` has no counterpart of the hang:
both variants build and run.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops.tree_kernels import _check, _raise_on

B, G, R, C = 8, 8, 1152, 1024      # the JAX repro's shape and column
SMEM_LIMIT = 232448                # a block's most shared memory (227 KB)


def _check_args(x: torch.Tensor, c: int):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, G, R], got {tuple(x.shape)}")
    _check(x, "x", torch.float32, tuple(x.shape), x.device)
    if not 0 <= c < x.shape[2]:
        raise ValueError(f"column {c} outside [0, {x.shape[2]})")


def width1_slice_write_plain(x: torch.Tensor, c: int = C,
                             ok: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``x`` with ``[:, :, c]`` (``ok``: ``[:, :,
    c:]``) replaced by ``x * 0.5 + 1``."""
    _check_args(x, c)
    out = x.clone()
    cols = slice(c, None) if ok else slice(c, c + 1)
    out[:, :, cols] = x[:, :, cols] * 0.5 + 1.0
    return out


def _library() -> ctypes.CDLL:
    lib = _build.build("width1_slice").lib
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.width1_slice_launch.argtypes = [p, p, i, i, i, i, i, p]
        lib.width1_slice_launch.restype = i
        lib._argtypes_set = True
    return lib


def width1_slice_write(x: torch.Tensor, c: int = C,
                       ok: bool = False) -> torch.Tensor:
    """``x [B, G, R]`` float32 with column ``c`` of the minor dimension
    (``ok``: columns ``c:``) replaced by ``x * 0.5 + 1``, through a scratch.

    CPU tensors take :func:`width1_slice_write_plain`; CUDA tensors the
    kernel (a ``[G, R]`` slab of at most 227 KB), or raise.
    """
    _check_args(x, c)
    dev = x.device
    if dev.type == "cpu":
        return width1_slice_write_plain(x, c, ok)
    if dev.type != "cuda":
        raise ValueError(f"width1_slice_write: unsupported device {dev}")
    b, g, r = x.shape
    if g * r * 4 > SMEM_LIMIT:
        raise ValueError(f"a [G, R] = [{g}, {r}] float32 slab is over a "
                         f"block's {SMEM_LIMIT} bytes of shared memory")
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.width1_slice_launch(
            x.data_ptr(), out.data_ptr(), b, g, r, int(c), int(bool(ok)),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "width1_slice_write")
    width1_slice_write.launches += 1
    return out


width1_slice_write.launches = 0


def reset_launch_counts():
    width1_slice_write.launches = 0


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ok", action="store_true",
                    help="use the segment-wide write (the variant that "
                         "Mosaic compiled)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    x = torch.zeros((B, G, R), dtype=torch.float32, device=dev)
    print("compiling (variant:", "ok" if args.ok else "hang", ")...",
          flush=True)
    y = width1_slice_write(x, C, args.ok)
    print("compiled and ran; out[0,0,%d] = %s" % (C, float(y[0, 0, C])),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
