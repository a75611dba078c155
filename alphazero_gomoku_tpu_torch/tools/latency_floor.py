"""The least time a latency-bound kernel can take on the card: the floor that
``chip_smoke.py`` sets beside the tree kernels' byte bound.

  - :func:`empty_ms`: an empty kernel's time by CUDA-graph replay, the way
    the tree kernels are timed: what a launch costs by itself.
  - :func:`l2_load_ms`: one dependent L2 load.  One thread follows a random
    cycle over the 128-byte lines of a 16 MB buffer (under the card's 50 MB
    L2, so that after a warm-up each step hits L2 and misses L1), timed by
    CUDA events at two step counts: the difference of the times over the
    difference of the steps.
  - :func:`floor_ms`: ``empty + hops * load``, what a kernel that waits one
    L2 round trip for each hop of its longest path could reach.

The probes are the kernels of ``csrc/latency_floor.cu``; they need the card,
and neither replaces a TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch

from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops.tree_kernels import _raise_on

CHAIN_BYTES = 16 << 20
LINE_INTS = 32               # one 128-byte line of int32 indices
STEPS_LO, STEPS_HI = 1000, 11000

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build("latency_floor").lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.empty_launch.argtypes = [p]
        lib.empty_launch.restype = i
        lib.chase_launch.argtypes = [p, i, p, p]
        lib.chase_launch.restype = i
        _LIB = lib
    return _LIB


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def empty_ms(reps: int = 50) -> float:
    """An empty kernel's milliseconds by replay of ``reps`` launches
    captured in one CUDA graph (on the current device)."""
    lib = _library()

    def launch():
        _raise_on(lib.empty_launch(_stream()), "empty_kernel")

    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain(generator: torch.Generator, device) -> torch.Tensor:
    """A random cycle over the lines of a ``CHAIN_BYTES`` buffer of int32:
    the first entry of each line holds the index of the next line's first
    entry."""
    lines = CHAIN_BYTES // (4 * LINE_INTS)
    order = torch.randperm(lines, generator=generator) * LINE_INTS
    nxt = torch.zeros(lines * LINE_INTS, dtype=torch.int32)
    nxt[order] = torch.roll(order, -1).to(torch.int32)
    return nxt.to(device)


def l2_load_ms(seed: int = 0, best_of: int = 3) -> float:
    """Milliseconds of one dependent L2 load on the current device."""
    lib = _library()
    nxt = chain(torch.Generator().manual_seed(seed), "cuda")
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def run(steps: int) -> float:
        best = float("inf")
        for _ in range(best_of):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _raise_on(lib.chase_launch(nxt.data_ptr(), steps, out.data_ptr(),
                                       _stream()), "chase_kernel")
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    run(CHAIN_BYTES // (4 * LINE_INTS))    # warm-up: every line into L2
    return (run(STEPS_HI) - run(STEPS_LO)) / (STEPS_HI - STEPS_LO)


def floor_ms(hops: int, empty: float, load: float) -> float:
    """``empty + hops * load``: an empty launch and one dependent L2 load
    for each hop of the longest path."""
    return empty + hops * load
