"""Timing on the card for the microbenchmark tools.

  - :func:`card` resolves the device a tool times and refuses any but a
    CUDA card: CUDA events and graphs time nothing elsewhere.
  - :func:`graph_ms`: device milliseconds a call, ``reps`` calls captured in
    one CUDA graph and replayed, so the host's launch cost is left out (as
    ``chip_smoke.py`` times the tree kernels).
  - :func:`events_ms`: milliseconds a call by CUDA events around ``reps``
    eager calls after a warm-up; the host's launch cost counts where it
    exceeds the work.
  - :func:`card_label`: the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them, to print beside each number.
"""

from __future__ import annotations

import subprocess

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device


def card(device=None, what: str = "this tool") -> torch.device:
    """The CUDA device ``device`` names (None: the card); raises on any
    other."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"{what} times the card (CUDA events and graphs); "
                           f"it does not run on {dev}")
    return dev


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn()``: one call to warm up, then
    ``reps`` calls captured in one CUDA graph and replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, reps: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()`` by CUDA events around ``reps``
    eager calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]
