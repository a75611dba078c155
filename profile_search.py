#!/usr/bin/env python3
"""Where a self-play move's time goes on the card: each search, profiled.

    python3 profile_search.py

Runs the searches of ``chip_smoke.py``'s main paths from positions 4 random
plies in, at batch 256, 15x15, with the 6x128 net of
``chip_smoke.smoke_weights`` from seed 0: PUCT
(``chip_smoke.MAIN_MCTS``) for ``SIMS`` simulations in a tree sized for 400,
on the float32 ``ResNet`` with TF32 off and on the int8 tower kernel (the
net quantized on ``random_calib_obs`` boards); k-leaf PUCT on the int8
tower (``leaves_per_sim=4``, ``chip_smoke.KLEAF``), one whole 400-simulation
search of 100 macro steps; and one whole Gumbel@64 search
(``chip_smoke.GUMBEL_MCTS``, the fused bf16 tower).  It also times
``packed_advance_root`` on the tree of a Gumbel@64 search with reuse budget
``chip_smoke.REUSE_BUDGET`` (host wall per move, synchronized).  Each runs once
to warm up, once untraced and once under ``torch.profiler``, and prints:

  - host wall time per simulation (``time.perf_counter`` around work that
    ends in ``torch.cuda.synchronize()``);
  - the card's busy share: the union of the device's kernel, copy and set
    intervals in the trace over the traced wall time;
  - device time per simulation in the network's torch ops (root and leaf
    evals), in the tree kernels and the towers' kernels (by kernel name),
    and in everything else (the game step, state gather and write, encoding,
    priors);
  - the kernels that take the most device time;

and then each network's forward alone at batch 256, by CUDA events (the
float32 ``ResNet``, the fused bf16 tower, the int8 tower kernel and the
``torch._int_mm`` int8 forward, each with its heads).

It needs the card, and exits 1 without one; it prints "not measured" where
the trace has no device time.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import (
    NetConfig,
    bundle_of,
    make_eval_fn,
)
from alphazero_gomoku_tpu_torch.ops import fused_net as fn
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8
from alphazero_gomoku_tpu_torch.search.gumbel import run_gumbel_mcts
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    init_packed_carry,
    packed_advance_root,
    run_gumbel_packed_with_tree,
    run_mcts_packed,
)
from chip_smoke import (
    BATCH,
    BOARD,
    GUMBEL_MCTS,
    KLEAF,
    MAIN_MCTS,
    REUSE_BUDGET,
    nvidia_smi,
    random_states,
    smoke_weights,
    tower_flops,
)

SIMS = 100   # simulations traced: a quarter of a move, in a 400-sim tree
SEED = 0

# the network runs inside this record_function range; the tree kernels and
# the towers' kernels are found by kernel name (see _range_device_us)
NETWORK = "network"
TREE_KERNELS = ("select_walk", "gumbel_select_walk", "backup_paths")
# both towers' convs are conv_tile.cuh's conv_kernel (one instance per Op
# and mode); a search runs one tower
TOWER_KERNELS = ("conv",)


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


def _kernel_pattern(name):
    """Matches a kernel named ``<name>_kernel``, mangled or not;
    ``select_walk`` does not match ``gumbel_select_walk_kernel``."""
    return re.compile(rf"(?<![A-Za-z_]){name}_kernel")


def _kernel_device_us(spans, name) -> float:
    """Device time of the kernels named ``<name>_kernel``, the union of
    their intervals: a tower's convs are programmatic dependent launches,
    and a conv's blocks may start (and wait) before the previous conv
    ends."""
    pattern = _kernel_pattern(name)
    return _busy_us([sp for sp in spans if pattern.search(sp[0])])


def profile_search(label, search, sims, kernel_groups):
    """Time ``search()`` (``sims`` simulations) untraced and traced, and print
    where the device time goes: the ``NETWORK`` range's device time, the
    device time of each group of kernels found by name, and the rest."""
    search()                                  # warm-up: build, cuDNN setup
    t0 = time.perf_counter()
    search()
    plain_s = time.perf_counter() - t0
    print(f"[{label}] search without profiler: {plain_s / sims * 1e3:.3f} ms "
          f"per simulation (batch {BATCH}, {sims} sims)", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = _device_spans(prof)
    busy = _busy_us(spans)
    print(f"[{label}] traced: wall {wall_us / sims / 1e3:.3f} ms per "
          f"simulation", flush=True)
    if busy == 0.0:
        print(f"[{label}] device busy share: not measured (no device time in "
              f"the trace)")
    else:
        print(f"[{label}] device busy share: {busy / wall_us:.4f} "
              f"(idle {1 - busy / wall_us:.4f})")
    print(f"[{label}] device busy time per simulation: "
          f"{busy / sims / 1e3:.4f} ms")
    print(f"[{label}] device time per simulation, {NETWORK} range (torch ops "
          f"of the eval): {_range_device_us(prof, NETWORK) / sims / 1e3:.4f} "
          f"ms")
    for group, names in kernel_groups.items():
        us = sum(_kernel_device_us(spans, name) for name in names)
        print(f"[{label}] device time per simulation, {group} kernels: "
              f"{us / sims / 1e3:.4f} ms")
    named = [_kernel_pattern(name) for names in kernel_groups.values()
             for name in names]
    other = sum(e - s for n, s, e in spans
                if not any(p.search(n) for p in named))
    print(f"[{label}] device time per simulation, all other kernels: "
          f"{other / sims / 1e3:.4f} ms")

    by_name = {}
    for name, s, e in spans:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + e - s, n + 1)
    print(f"[{label}] top device kernels (ms per simulation, calls):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / sims / 1e3:9.4f}  {n:6d}  {name[:90]}")


def forward_ms(eval_fn, bundle, obs) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        eval_fn(bundle, obs)
    start.record()
    for _ in range(20):
        eval_fn(bundle, obs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


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
    params, stats = smoke_weights(cfg, SEED, dev)
    net = bundle_of(cfg, params, stats, device=dev)
    folded = fn.fold_bn(cfg, params, stats, device=dev)
    eval_fn = make_eval_fn()
    fused_eval = fn.make_fused_eval_fn(cfg)
    mcts = dataclasses.replace(MAIN_MCTS, n_simulations=SIMS,
                               max_nodes=MAIN_MCTS.node_capacity)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    states = random_states(env, BATCH, 4, gen, dev)
    moves = torch.full((BATCH,), 4, dtype=torch.int32, device=dev)

    def puct():
        run_mcts_packed(env, mcts, _ranged(NETWORK, eval_fn), net, states,
                        moves, gen)
        torch.cuda.synchronize()

    def gumbel():
        run_gumbel_mcts(env, GUMBEL_MCTS, _ranged(NETWORK, fused_eval),
                        folded, states, gen)
        torch.cuda.synchronize()

    q = q8.quantize_int8(cfg, params, stats, q8.random_calib_obs(cfg),
                         device=dev)
    packed = t8.pack_tower_bundle(cfg, q)
    int8_eval = q8.make_int8_eval_fn(cfg)
    tower_eval = t8.make_int8_tower_eval_fn(cfg)

    def puct_int8():
        run_mcts_packed(env, mcts, _ranged(NETWORK, tower_eval), packed,
                        states, moves, gen)
        torch.cuda.synchronize()

    kleaf = dataclasses.replace(MAIN_MCTS, leaves_per_sim=KLEAF)

    def puct_int8_kleaf():
        run_mcts_packed(env, kleaf, _ranged(NETWORK, tower_eval), packed,
                        states, moves, gen)
        torch.cuda.synchronize()

    profile_search(f"PUCT@{MAIN_MCTS.n_simulations}", puct, SIMS,
                   {"tree": TREE_KERNELS})
    profile_search(f"PUCT@{MAIN_MCTS.n_simulations} int8 tower", puct_int8,
                   SIMS, {"tree": TREE_KERNELS,
                          "int8 tower": TOWER_KERNELS})
    profile_search(f"PUCT@{kleaf.n_simulations} k={KLEAF} int8 tower",
                   puct_int8_kleaf, kleaf.n_simulations,
                   {"tree": TREE_KERNELS, "int8 tower": TOWER_KERNELS})
    profile_search(f"Gumbel@{GUMBEL_MCTS.n_simulations}", gumbel,
                   GUMBEL_MCTS.n_simulations,
                   {"tree": TREE_KERNELS, "fused tower": TOWER_KERNELS})

    # subtree reuse's move-loop cost: packed_advance_root on the tree of a
    # Gumbel@64 search with the shipped nets' reuse budget
    reuse = dataclasses.replace(GUMBEL_MCTS, reuse_budget=REUSE_BUDGET)
    _, _, action, carry = run_gumbel_packed_with_tree(
        env, reuse, fused_eval, folded, states, gen,
        carry=init_packed_carry(env, reuse, states))
    for _ in range(2):
        packed_advance_root(env, reuse, carry, action)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        packed_advance_root(env, reuse, carry, action)
    torch.cuda.synchronize()
    print(f"packed_advance_root (Gumbel@{reuse.n_simulations}, reuse budget "
          f"{REUSE_BUDGET}, {reuse.node_capacity} nodes, batch {BATCH}): "
          f"{(time.perf_counter() - t0) / 10 * 1e3:.3f} ms per move (host "
          f"wall, synchronized)", flush=True)

    obs = env.encode(states)
    flops = tower_flops(cfg, BATCH)
    for label, ms in (("float32 ResNet (cuDNN)", forward_ms(eval_fn, net, obs)),
                      ("fused bf16 tower + heads",
                       forward_ms(fused_eval, folded, obs)),
                      ("int8 tower kernel + heads",
                       forward_ms(tower_eval, packed, obs)),
                      ("int8 torch._int_mm forward (int8_apply)",
                       forward_ms(int8_eval, q, obs))):
        print(f"network forward alone, {label}: {ms:.4f} ms at batch {BATCH} "
              f"({flops / ms / 1e9:.2f} TFLOP/s or TOP/s in the "
              f"convolutions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
