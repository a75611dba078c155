#!/usr/bin/env python3
"""Where a self-play move's time goes on the card: one search, profiled.

    python3 profile_search.py

Runs the search of ``chip_smoke.py``'s main path (bench config #3:
``chip_smoke.MAIN_MCTS``, the 6x128 net, 15x15, batch 256, fp32 with TF32
off) for ``SIMS`` simulations in a tree sized for 400, from positions 4
random plies in, once to warm up, once untraced and once under
``torch.profiler``, and prints:

  - host wall time per simulation (``time.perf_counter`` around work that
    ends in ``torch.cuda.synchronize()``);
  - the card's busy share: the union of the device's kernel, copy and set
    intervals in the trace over the traced wall time;
  - device time per simulation in the network (root and leaf evals), in each
    tree kernel, and in everything else (the game step, state gather and
    write, encoding, priors);
  - the network forward alone at this batch, by CUDA events;
  - the kernels that take the most device time.

It needs the card, and exits 1 without one; it prints "not measured" where
the trace has no device time.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import (
    NetConfig,
    bundle_of,
    init_params,
    make_eval_fn,
)
from alphazero_gomoku_tpu_torch.search.tree_packed import run_mcts_packed
from chip_smoke import BATCH, BOARD, MAIN_MCTS, nvidia_smi, random_states

SIMS = 100   # simulations traced: a quarter of a move, in a 400-sim tree
SEED = 0

# the network runs inside this record_function range; the tree kernels are
# found by kernel name (see _range_device_us)
NETWORK = "network"
TREE_KERNELS = ("select_walk", "backup_paths")


def _ranged(name, fn):
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


def _device_spans(prof):
    """The trace's device work (kernels, copies, sets): ``(name, start_us,
    end_us)``, without the ranges ``record_function`` marks on the device
    timeline."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != NETWORK]


def _busy_us(spans) -> float:
    """Length of the union of the device intervals."""
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _range_device_us(prof, name) -> float:
    """Device time of the kernels launched inside the CPU ranges ``name``.

    The profiler links a kernel to the PyTorch op that launched it; the tree
    kernels are launched through ``ctypes``, outside any op, so they are
    counted by their kernel name (``<name>_kernel``) in :func:`main`.
    """
    return float(sum(e.device_time_total for e in prof.events()
                     if e.name == name
                     and e.device_type == torch.autograd.DeviceType.CPU))


def _kernel_device_us(spans, name) -> float:
    return float(sum(e - s for n, s, e in spans if f"{name}_kernel" in n))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_search: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {nvidia_smi()}; torch {torch.__version__}", flush=True)

    env = make_env("gomoku", BOARD)
    cfg = NetConfig.full(BOARD)
    net = bundle_of(cfg, *init_params(cfg, SEED), device=dev)
    eval_fn = make_eval_fn()
    mcts = dataclasses.replace(MAIN_MCTS, n_simulations=SIMS,
                               max_nodes=MAIN_MCTS.node_capacity)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states = random_states(env, BATCH, 4, gen, dev)
    moves = torch.full((BATCH,), 4, dtype=torch.int32, device=dev)
    ev = _ranged(NETWORK, eval_fn)

    def search():
        run_mcts_packed(env, mcts, ev, net, states, moves, gen)
        torch.cuda.synchronize()

    search()                                  # warm-up: build, cuDNN setup
    t0 = time.perf_counter()
    search()
    plain_s = time.perf_counter() - t0
    print(f"search without profiler: {plain_s / SIMS * 1e3:.3f} ms per "
          f"simulation (batch {BATCH}, {SIMS} sims)", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = _device_spans(prof)
    busy = _busy_us(spans)
    print(f"traced: wall {wall_us / SIMS / 1e3:.3f} ms per simulation",
          flush=True)
    if busy == 0.0:
        print("device busy share: not measured (no device time in the trace)")
    else:
        print(f"device busy share: {busy / wall_us:.4f} "
              f"(idle {1 - busy / wall_us:.4f})")
    print(f"device busy time per simulation: {busy / SIMS / 1e3:.4f} ms")
    named = 0.0
    for name in (NETWORK,) + TREE_KERNELS:
        us = (_range_device_us(prof, name) if name == NETWORK
              else _kernel_device_us(spans, name))
        named += us
        print(f"device time per simulation, {name}: {us / SIMS / 1e3:.4f} ms")
    total = sum(e - s for _, s, e in spans)
    print(f"device time per simulation, other: "
          f"{(total - named) / SIMS / 1e3:.4f} ms")

    by_name = {}
    for name, s, e in spans:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + e - s, n + 1)
    print("top device kernels (ms per simulation, calls):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / SIMS / 1e3:9.4f}  {n:6d}  {name[:90]}")

    obs = env.encode(states)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        eval_fn(net, obs)
    start.record()
    for _ in range(20):
        eval_fn(net, obs)
    end.record()
    torch.cuda.synchronize()
    net_ms = start.elapsed_time(end) / 20
    c = cfg.channels
    flops = 2 * BOARD * BOARD * (cfg.in_channels * c * 9
                                 + 2 * cfg.n_res_blocks * c * c * 9)
    print(f"network forward alone: {net_ms:.4f} ms at batch {BATCH} "
          f"({flops * BATCH / net_ms / 1e9:.2f} TFLOP/s in the "
          f"convolutions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
