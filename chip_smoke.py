#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``alphazero_gomoku_tpu_torch/csrc`` with
``nvcc`` (one process per source, at once), holds each kernel against its
plain PyTorch version on the card, holds a search on the kernels against the
same search on the plain versions, and drives the main paths, with random
weights made from ``--seed`` (their BN stats fitted to random boards,
``smoke_weights``), lockstep Gomoku 15x15 self-play at batch 256 with the
6x128 net:

  - PUCT@400 (bench config #3 of ``bench.py``) on the float32 ``ResNet``,
    2 moves (cut from 8 to keep the script's time): kernels ``select_walk``
    and ``backup_paths``;
  - Gumbel@64 with m=16 (bench config #6's search) on the fused bf16 tower,
    8 moves: kernels ``gumbel_select_walk``, ``backup_paths`` and
    ``fused_tower``; then 2 moves of its round-parallel form;
  - PUCT@400 on the int8 tower (``bench.py --infer int8t``: the net
    quantized on ``random_calib_obs`` boards), 8 moves: kernels
    ``select_walk``, ``backup_paths`` and ``int8_tower``;
  - the same with k-leaf virtual-loss search (``leaves_per_sim=4``,
    ``bench.py --kleaf 4``), 8 moves: kernels ``select_walk``,
    ``backup_paths`` in modes ``"vl"`` and ``"finalize"`` and
    ``int8_tower``;
  - Gumbel@64 with subtree reuse (``reuse_budget=48``, the shipped nets'
    self-play recipe, ``TRAINING_GUIDE.md:139``) on the fused bf16 tower,
    8 moves: kernels ``gumbel_select_walk``, ``backup_paths`` and
    ``fused_tower``;
  - the tensor-core rate probe (``tools/matmul_rate.py``'s ``measure``, the
    entry point's work: every mode at M 2040 and 57600, k 128 and 1152):
    kernel ``matmul_rate`` in its int8 and bf16 forms, counted apart;
  - the width-1 slice-write repro (``repro/width1_slice_write.py``'s
    ``main``, both variants): kernel ``width1_slice_write``;
  - the training iteration (``selfplay/loop.train_alphazero``) with the
    shipped recipe's search, Gumbel@64, m=16, reuse 48, on the int8 tower
    (``inference="int8t"``), 6x128: kernels ``gumbel_select_walk``,
    ``backup_paths`` and ``int8_tower`` (its reductions are in
    ``training_phases``'s docstring);
  - Pente 15x15 with capture planes at bench config #4's shape (PUCT@400,
    batch 64, the int8 tower) with a 6x128 net of 5 input planes, 8 moves:
    kernels ``select_walk``, ``backup_paths`` and ``int8_tower``; K4 and K5
    held first on Pente boards with captured pairs k = 0..4 on both planes
    (``pente_phases``);
  - continuous (auto-reset) self-play, ``play_games_continuous``, Gomoku at
    batch 256, Gumbel@64 m=16 on the int8 tower, 32 plies of games capped
    at 12 moves: kernels ``gumbel_select_walk``, ``backup_paths`` and
    ``int8_tower``; then one ``train_alphazero`` iteration on Pente with
    capture planes in continuous mode on the same kernels
    (``continuous_phases``);
  - the players (``player_phases``), one position at a time (batch 1) on
    the float32 net saved as a checkpoint and loaded by its path:
    ``player`` (PUCT@400 with tree reuse) against ``player_alpha``
    (Gumbel@64, round-parallel) through ``request_move``: kernels
    ``select_walk`` and ``backup_paths`` (PUCT), ``gumbel_select_walk`` and
    ``backup_paths`` (Gumbel); ``player_alpha2`` at its 5000 simulations
    with reuse 5000 (the depth argument 10002); and ``cli.play_loop.main``
    against ``player_mcts`` on the native scans;
  - data parallelism over ``torch.distributed`` (``parallel_phases``, phase
    26): the shipped recipe's search (Gumbel@64 m=16, reuse 48) on the int8
    tower at batch 256 in all, 8 moves, sharded over one rank a card over
    NCCL and, on a one-card machine, over 2 ranks sharing the card over
    gloo, each rank a process of this script: kernels
    ``gumbel_select_walk``, ``backup_paths`` and ``int8_tower`` on every
    rank; the gathered games held against the unsharded run bit for bit, a
    sharded train step against the single-process one, a
    ``train_alphazero`` iteration on the mesh, its ``torch.profiler`` trace
    (which must name the three kernels) and the memory preflight;
  - the bench (``bench_phases``, phase 27), ``alphazero_gomoku_tpu_torch/
    bench.py``'s ``run_bench`` at its configs' shapes, 6x128 (config #2:
    2x64), 15x15, each cut to a few moves and 2 repeats: #3 on ``int8t``
    (batch 128) and on ``int8``, #4 Pente (batch 64), #6 Gumbel@64 (batch
    256), #2 (batch 1, PUCT@100, float32) and ``--kleaf 4``, each with its
    JSON line and its path's kernels (``bench_launches``); then config #1
    (``bench_pure_mcts``, host only) and config #5
    (``bench_training_iteration``, 16 games at 16 simulations) cut;
  - the arena tools (``tool_phases``, phase 28) through their ``main`` on
    the shipped checkpoints (``checkpoints/``): ``int8_ab``,
    ``compare_snapshots``, ``cross_net_arena``, ``gumbel_ab``, ``reuse_ab``,
    ``kleaf_ab``, ``harvest_run`` and ``strength_probe``, each with the
    games asked for, its pairs adding up, and its searches' kernels;
  - the probes and microbenchmarks (``probe_tool_phases``, phase 29)
    through their ``main``, cut small, on ``checkpoints/`` and on the
    replay buffer phase 22 wrote: ``tactics_probe`` (both games),
    ``distill_net`` (a 4x96 student), ``policy_entropy_probe``,
    ``int8_calib_sensitivity``, ``tt_rate_probe``,
    ``tree_kernel_microbench``, ``search_cost_split``, ``hbm_budget``,
    ``net_microbench``, ``int8_probe`` at batch 256, ``device_parity
    --quick``, ``gumbel_determinism_probe`` and ``gumbel_flip_probe``, each
    with its lines checked and its path's kernels;
  - the tree kernels' envelope probes (``envelope_phases``, phase 30, the
    port of the JAX repo's ``repro/`` bisects, cut), each on the kernels
    against the plain versions from one seed, bit for bit, its games
    replayed on the host engine: ``select_walk`` and ``backup_paths``
    alone at 1024 lanes x 400 simulations; a PUCT@400 move at 1024 lanes on
    the int8 tower; the ``parent_probe`` rows (zero and parent FPU at caps
    8 and 56, Gumbel@64 and k-leaf k=4 at cap 8, zero FPU and Gumbel at
    cap 1), 2 moves each, the rows of ``MUST_CAP`` with capped walks; and
    games played to their end on 7x7 (some fill the board; 32
    simulations) and on 15x15 (one ``parent_longrun`` batch, 2x32, 16
    simulations), with searches on done roots: kernels ``select_walk``,
    ``backup_paths`` (all three modes), ``gumbel_select_walk`` and
    ``int8_tower``.

The game step's four kernels (``ops/game_kernels.py``: ``step`` in its
two modes, ``encode``, ``legal_mask``, ``terminal_value``; phase 2c,
``game_phases``) are held against the env's plain methods at the cells'
shapes (15x15, 128 lanes, Gomoku at 3 planes and Pente at 3 and 5) and at
1024 lanes, then timed beside their byte bound, an empty kernel's replay
and the host's microseconds a wrapper call; on the PUCT, Gumbel-reuse and
Pente main paths every call of a game method must launch its kernel once.

``width1_slice_write`` is held (exactly) on the repro's shape and on rows
whose byte count is not a multiple of 16, with C at both edges, and timed
by graph replay beside an empty kernel's replay, its floor.  One float32
``train_step`` at 6x128, batch 256, is held against the same step in
float64 on the card, and twenty steps on one batch must lower the loss.

``select_walk`` and ``backup_paths`` (all three modes) are held against
their plain versions and timed on trees of 64 simulations and on PUCT@400's
own tree as its last simulation walks it (399 simulations; k-leaf 396);
``gumbel_select_walk`` on a Gumbel@64 tree at fan 1 and 16, and on the tree
that Gumbel@64 with reuse budget 48 carries over three moves, as the last
search's last simulation walks it.  Each is timed beside its byte bound and
a floor: an empty kernel's graph-replay time plus the longest path times
one dependent L2 load, both measured in the run
(``tools/latency_floor.py``).

Each path's launch counts are set to 0 just before it and read just after;
every kernel a path does not name must launch 0 times on it.  The k-leaf
search and the reuse searches (with ``packed_advance_root`` between moves)
are also held, on the kernels, against the same searches on the plain
versions.  The towers' rates (K5, K4) are printed over the probe's
``wgmma`` rate at their own GEMM shape (M 57600, k 128); K5 is also held
and timed at the k-leaf path's 1024 boards; the ``ptxas`` registers and
spills of the towers' convs, the Gumbel walk and the rate probe are printed
(a spill fails the run); and one Gumbel@64 search on ``fused_tower``,
``fused_tower_plain`` and the plain tower with float64 sums each prints how
many root actions differ between the first two and how many each shares
with the third (a measurement).
Every phase prints its seconds.  Nothing is caught: a failed phase exits
non-zero.  Without a CUDA card it exits 1 before any result.  The last lines
are the card's ``nvidia-smi`` name and power limit, a JSON line with each
kernel's launches on its main path, its error against the plain version and
its times, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import contextlib
import glob
import io
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from alphazero_gomoku_tpu_torch import bench
from alphazero_gomoku_tpu_torch.cli import play_loop
from alphazero_gomoku_tpu_torch.games import make_env, make_host_game
from alphazero_gomoku_tpu_torch.models import (
    NetConfig,
    bundle_of,
    fit_batch_stats,
    init_params,
    make_eval_fn,
    params_from_jax,
)
from alphazero_gomoku_tpu_torch.models import checkpoint as ckpt
from alphazero_gomoku_tpu_torch.models.model import (
    AdamState,
    AZModel,
    Optimizer,
    split_state,
    train_epoch_gather,
    train_step,
)
from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops import fused_net as fn
from alphazero_gomoku_tpu_torch.ops import game_kernels as gk
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8
from alphazero_gomoku_tpu_torch.native import load_puremcts
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.parallel import (
    DataMesh,
    gather_trajectories,
    initialize_distributed,
    make_mesh,
    make_sharded_gather_epoch,
    make_sharded_selfplay,
)
from alphazero_gomoku_tpu_torch.parallel.mesh import fold_in
from alphazero_gomoku_tpu_torch.players import load_player, request_move
from alphazero_gomoku_tpu_torch.repro import (
    bisect_batch512,
    parent_longrun,
    parent_probe,
)
from alphazero_gomoku_tpu_torch.repro import envelope as ev
from alphazero_gomoku_tpu_torch.repro import width1_slice_write as ws
from alphazero_gomoku_tpu_torch.search import (
    MCTSConfig,
    init_packed_carry,
    packed_advance_root,
)
from alphazero_gomoku_tpu_torch.search.gumbel import (
    halving_schedule,
    run_gumbel_mcts,
)
from alphazero_gomoku_tpu_torch.search.pure_mcts import winning_cells
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    run_gumbel_packed_with_tree,
    run_mcts_packed,
    run_mcts_packed_with_tree,
)
from alphazero_gomoku_tpu_torch.selfplay import (
    SelfPlayConfig,
    collect_examples,
    play_games,
    play_games_continuous,
    train_alphazero,
)
from alphazero_gomoku_tpu_torch.selfplay.budget import (
    MemoryBudgetError,
    preflight_memory_check,
    selfplay_memory,
    with_preflight,
)
from alphazero_gomoku_tpu_torch.selfplay.buffer import (
    DeviceBufferMirror,
    ReplayBuffer,
)
from alphazero_gomoku_tpu_torch.tools import (
    compare_snapshots,
    cross_net_arena,
    device_parity,
    distill_net,
    gumbel_ab,
    gumbel_determinism_probe,
    gumbel_flip_probe,
    harvest_run,
    hbm_budget,
    int8_ab,
    int8_calib_sensitivity,
    int8_probe,
    kleaf_ab,
    net_microbench,
    policy_entropy_probe,
    reuse_ab,
    search_cost_split,
    strength_probe,
    tactics_probe,
    tree_kernel_microbench,
    tt_rate_probe,
)
from alphazero_gomoku_tpu_torch.tools.tactics_suites import suite_for
from alphazero_gomoku_tpu_torch.tools import latency_floor as lf
from alphazero_gomoku_tpu_torch.tools.card_timing import (
    card_label as nvidia_smi,
    events_ms as cuda_ms,
    graph_ms,
)
from alphazero_gomoku_tpu_torch.tools import matmul_rate as mr

BOARD = 15
BATCH = 256
SIMS = 400
MOVES = 8
F32_MOVES = 2        # the float32 PUCT path, cut to keep the script's time
GROW_SIMS = 64       # simulations that grow the tree the kernels are held on
PI_BATCH, PI_SIMS = 32, 64   # the search whose pi is held kernels vs plain
# bench.py:127-135, config #3: PUCT@400, batch 256, 6x128, depth cap 56
MAIN_MCTS = MCTSConfig(n_simulations=SIMS, cpuct=1.0, add_noise=True,
                       dirichlet_alpha=0.05, dirichlet_epsilon=0.15,
                       dirichlet_moves=10, max_depth=56)

# bench.py:127-137,358-366, config #6's search: Gumbel@64, m=16, depth cap
# 56, no Dirichlet noise
GUMBEL_SIMS, GUMBEL_M = 64, 16
GUMBEL_MCTS = MCTSConfig(n_simulations=GUMBEL_SIMS, search="gumbel",
                         gumbel_max_considered=GUMBEL_M, add_noise=False,
                         max_depth=56)
PARALLEL_MOVES = 2   # moves of the round-parallel Gumbel search
KLEAF = 4            # leaves per simulation of the k-leaf path (bench.py --kleaf)
REUSE_BUDGET = 48    # the shipped nets' --mcts-reuse-budget (TRAINING_GUIDE.md)
REUSE_MOVES = 3      # moves of the reuse searches held kernels vs plain
FAN = 16             # lanes per tree of the fan-out walk held against plain
# the fused tower against its plain version: both round each conv input to
# bf16 and sum exact bf16 products in float32, in different orders (tensor
# cores here); a sum on the other side of a bf16 rounding boundary moves the
# next conv's input by one bf16 step (2^-8 relative), and such steps add up
# over the 13 convs.  Held on the tower, the kernel's output: within two bf16
# steps of its largest value.  On an H100 over seeds 0-7 the kernel read
# 1.00-1.26 steps from the plain version, and the plain version 0.88-1.19
# from the same tower with float64 sums (``fused_tower_plain(..., float64)``,
# printed each run): any float32 order lands about a step away.  The heads,
# the same float32 ops on both sides, carry the tower's difference on to
# logits and value, which are printed.
FUSED_TOWER_STEPS = 2
# the fused net against the float32 ResNet (tests/test_fused_net.py:75-85)
BF16_VS_F32_TOL = 0.05
# the int8 net against the float32 ResNet: tests/test_int8_net.py:57-73's
# logit correlation bound, and the same bound on the value's correlation.
# That test's value bound, 0.1 at most, was set on a 9x9 2x32 net; the 6x128
# tower's int8 noise (tower correlation about 0.997) moved the worst of 256
# values by 0.11-0.19 over seeds 0-7 on an H100, as it does in the JAX
# package's int8 forward, which this one equals bit for bit.  It is printed.
INT8_VS_F32 = {"logit_corr": 0.98, "value_corr": 0.98}
# the slice write's extra shapes: rows of 4613 and 7 floats (not a multiple
# of 16 bytes, so unaligned heads and tails), C at both edges of the row
W1_SHAPES = (((2, 3, 4613), 0), ((2, 3, 4613), 4612), ((8, 8, 7), 0),
             ((8, 8, 7), 6), ((3, 5, 1), 0))
# the training step: float32 against float64, one step from a fresh
# optimizer state, where Adam's step is about -lr * g' / (|g'| + eps) with
# g' its input (the clipped gradient plus the weight decay).  Where the two
# g' (a, b) agree in sign and |a| > |a - b| + 100 eps, the two steps differ
# by lr * eps * |a - b| / ((|a| + eps)(|b| + eps)) < lr * eps / (100 eps) =
# lr / 100, plus float32's rounding of p + u (2.4e-7 for |p| < 2); the
# others (within float32's error of zero, or across a ReLU's kink) by up to
# 2 lr
TRAIN_BATCH, TRAIN_STEPS = 256, 20
STEP_TOL, CHAOTIC_TOL = 1e-5 + 2.4e-7, 2e-3 + 1e-5
# the training iteration (training_phases)
TRAIN_MOVES = 16        # self-play move cap of each of its iterations
TRAIN_BUFFER = 60000    # the CLI's --buffer-size default
ARENA_GAMES = 16
# Pente (pente_phases): bench config #4 (bench.py:351-354: Pente, PUCT@400
# with config #3's search constants, batch 64, int8) with capture planes,
# the shipped Pente net's input (checkpoints/best_pente.ckpt: 6x128, 5
# planes)
PENTE_BATCH = 64
# continuous self-play (continuous_phases): plies, and the move cap that
# ends every lane's game at least twice in them
CONT_STEPS, CONT_MAX_MOVES = 32, 12
# its training iteration: plies and move cap
CONT_TRAIN_STEPS, CONT_TRAIN_MAX_MOVES = 16, 8
# the players (player_phases): the PUCT player's simulations (the shipped
# variants' 3000, cut), the Gumbel player's, the plies of their game from
# the opening; the tournament's games and its AlphaZero seat's simulations
PLAYER_SIMS, PLAYER_GUMBEL_SIMS, PLAYER_PLIES = 400, 64, 8
LOOP_GAMES, LOOP_SIMS = 2, 64
# a depth argument above any path of player_alpha2's tree: K1 at it against
# K1 at the node capacity times the full-depth path fill
SHORT_DEPTH = 64
# data parallelism (parallel_phases): the shipped recipe's search, its seed,
# the timed train steps, the ring of the iteration on the mesh (cut: 8 steps
# of its epoch, which the trace records op by op) and its arena (games and
# simulations, cut: its games run to the end at batch 1 a rank), and the
# seconds a group of ranks may take
PARALLEL_MCTS = dataclasses.replace(GUMBEL_MCTS, reuse_budget=REUSE_BUDGET)
PARALLEL_SEED = 26
PARALLEL_TRAIN_STEPS = 8
PARALLEL_BUFFER = 8 * TRAIN_BATCH
PARALLEL_ARENA_GAMES, PARALLEL_ARENA_SIMS = 2, 8
PARALLEL_TIMEOUT = 600

# the bench (bench_phases, phase 27): bench.py's configs at full width, each
# cut to a few moves and 2 repeats (after its warm-up call), as
# (label, run_bench arguments)
BENCH_WIDTH = dict(board_size=BOARD, n_res_blocks=6, channels=128)
BENCH_REPEATS = 2
BENCH_RUNS = (
    ("3_int8t", dict(batch_games=128, measure_moves=4, infer="int8t")),
    ("3_int8", dict(batch_games=128, measure_moves=2, infer="int8")),
    ("4_pente", dict(game="pente", batch_games=64, measure_moves=4,
                     infer="int8t", vs_baseline=None)),
    ("6_gumbel64", dict(batch_games=256, n_simulations=64, search="gumbel",
                        measure_moves=8, infer="int8t")),
    ("2_tiny_net", dict(batch_games=1, n_simulations=100, n_res_blocks=2,
                        channels=64, measure_moves=4, vs_baseline=None)),
    ("kleaf4", dict(batch_games=256, measure_moves=2, infer="int8t",
                    leaves_per_sim=KLEAF)),
)
# config #1 and config #5, cut: seconds and games of the host baseline;
# games, simulations and arena games of the training iteration
BENCH_PURE = dict(min_seconds=2, min_games=1, max_moves_per_game=4)
BENCH_TRAIN = dict(games=16, n_simulations=16, eval_games=2)
# the tools (tool_phases, phase 28): games and simulations a tool plays
TOOL_GAMES, TOOL_SIMS = 4, 8
# the probes and microbenchmarks (probe_tool_phases, phase 29), cut: the
# tactics probe's simulations; distillation's student and batch; the
# microbenchmarks' batch, chain depths, timed launches and simulations; the
# flip probe's positions (a batch at each of its plies), search and games;
# the determinism probe's repeats
PROBE_SIMS = 16
DISTILL = dict(blocks=4, channels=96, batch=256, holdout=1024)
MICRO_BATCH, MICRO_DEPTHS, MICRO_ITERS, MICRO_SIMS = 256, (4, 24), 50, 64
FLIP_BATCH, FLIP_PLIES, FLIP_SIMS, FLIP_M, FLIP_GAMES = 128, (6, 16), 16, 4, 4
DETERMINISM_REPEATS = 3
# the envelope probes (envelope_phases, phase 30), cut: the kernels-only
# loop (lanes, simulations, slots); self-play at 1024 lanes on the int8 tower
# (lanes, simulations, moves: one, as the plain int8 tower takes 36 s a
# move there); the parent probe rows' moves (2: the plain walk takes up to
# 4 s a move under parent FPU); full games on 15x15 (one parent_longrun
# batch at a 2x32 net and 16 simulations: at 32 the plain side took 74 s of
# 91 on an H100, its walks 15 hops deep) and on a board small enough that
# some games fill it (board, batch, simulations)
ENV_KERNELS = (1024, 400, 408)
ENV_SELFPLAY = (1024, 400, 1)
ENV_PARENT_MOVES = 2
ENV_LONGRUN = dict(batch=128, sims=16, blocks=2, channels=32)
ENV_SMALL_BOARD, ENV_SMALL_BATCH, ENV_SMALL_SIMS = 7, 64, 32
CHECKPOINTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "checkpoints")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
# (CUDA cores); the dense bf16 FLOP/s and int8 OP/s of its tensor cores are
# the rate probe's
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = mr.PEAK_TFLOPS["bf16"] * 1e12
INT8_OPS_PER_S = mr.PEAK_TFLOPS["int8"] * 1e12

KERNEL_ROWS = {
    "select_walk": dict(
        source="alphazero_gomoku_tpu_torch/csrc/tree_kernels.cu",
        replaces="alphazero_gomoku_tpu/ops/tree_kernels.py:297"),
    "backup_paths": dict(
        source="alphazero_gomoku_tpu_torch/csrc/tree_kernels.cu",
        replaces="alphazero_gomoku_tpu/ops/tree_kernels.py:780"),
    # modes "vl" and "finalize" of the same kernel and pallas_call (branches
    # of _backup_kernel_serial, tree_kernels.py:541)
    "backup_paths_vl": dict(
        source="alphazero_gomoku_tpu_torch/csrc/tree_kernels.cu",
        replaces="alphazero_gomoku_tpu/ops/tree_kernels.py:780"),
    "backup_paths_finalize": dict(
        source="alphazero_gomoku_tpu_torch/csrc/tree_kernels.cu",
        replaces="alphazero_gomoku_tpu/ops/tree_kernels.py:780"),
    "gumbel_select_walk": dict(
        source="alphazero_gomoku_tpu_torch/csrc/tree_kernels.cu",
        replaces="alphazero_gomoku_tpu/ops/tree_kernels.py:497"),
    "fused_tower": dict(
        source="alphazero_gomoku_tpu_torch/csrc/fused_net.cu",
        replaces="alphazero_gomoku_tpu/ops/fused_net.py:344"),
    "int8_tower": dict(
        source="alphazero_gomoku_tpu_torch/csrc/int8_tower.cu",
        replaces="alphazero_gomoku_tpu/ops/int8_tower.py:239"),
    # the int8 and bf16 forms of one kernel, as of one pallas_call
    # (pallas_rate's in_dtype), counted apart
    "matmul_rate_int8": dict(
        source="alphazero_gomoku_tpu_torch/csrc/matmul_rate.cu",
        replaces="tools/mosaic_matmul_rate.py:35"),
    "matmul_rate_bf16": dict(
        source="alphazero_gomoku_tpu_torch/csrc/matmul_rate.cu",
        replaces="tools/mosaic_matmul_rate.py:35"),
    "width1_slice_write": dict(
        source="alphazero_gomoku_tpu_torch/csrc/width1_slice.cu",
        replaces="repro/mosaic_width1_slice_hang.py:31"),
    # the game step's four kernels replace no TPU kernel (the JAX game step
    # is plain jnp); step_safe is the step kernel's other mode
    "game_step": dict(
        source="alphazero_gomoku_tpu_torch/csrc/game_step.cu",
        replaces=None),
    "game_encode": dict(
        source="alphazero_gomoku_tpu_torch/csrc/game_step.cu",
        replaces=None),
    "game_legal_mask": dict(
        source="alphazero_gomoku_tpu_torch/csrc/game_step.cu",
        replaces=None),
    "game_terminal_value": dict(
        source="alphazero_gomoku_tpu_torch/csrc/game_step.cu",
        replaces=None),
}
# the env methods the game kernels serve, by the row of their kernel
GAME_ROWS = {"step": "game_step", "step_safe": "game_step",
             "encode": "game_encode", "legal_mask": "game_legal_mask",
             "terminal_value": "game_terminal_value"}


def log(msg: str):
    print(msg, flush=True)


class Phase:
    """Prints a phase's seconds, synchronising the card at its end."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            torch.cuda.synchronize()
        log(f"== {self.name}: {time.perf_counter() - self.t0:.3f} s")


def latency_floor():
    """An empty kernel's graph-replay ms and one dependent L2 load's ms, the
    two parts of the tree kernels' floor (``tools/latency_floor.py``)."""
    floor = {"empty_ms": lf.empty_ms(), "l2_load_ms": lf.l2_load_ms()}
    log(f"latency floor: empty kernel {floor['empty_ms']:.4f} ms (CUDA graph "
        f"replay), one dependent L2 load {floor['l2_load_ms'] * 1e6:.1f} ns")
    return floor


def path_stats(plen: torch.Tensor, floor) -> dict:
    """``path_len``'s mean and maximum, and the floor: an empty launch plus
    one dependent L2 load for each hop of the longest path."""
    longest = int(plen.max())
    return dict(path_len_mean=float(plen.float().mean()),
                path_len_max=longest,
                floor_ms=lf.floor_ms(longest, floor["empty_ms"],
                                     floor["l2_load_ms"]))


def hold_select(tree, layout, cpuct, depth, floor, fpu_parent=False):
    """``select_walk`` against its plain version on ``tree`` (every output,
    tolerance 0), then its times: CUDA-graph replay, one eager wrapper call,
    the plain version; its bound and floor.  Returns ``(outputs, row)``."""
    sel = tk.select_walk(tree, layout, cpuct, depth, fpu_parent)
    plain = tk.select_walk_plain(tree, layout, cpuct, depth, fpu_parent)
    for name, k, p in zip(("leaf", "action", "path_nodes", "path_actions",
                           "path_len"), sel, plain):
        if not torch.equal(k, p):
            raise AssertionError(f"select_walk {name}: kernel != plain "
                                 f"(tolerance 0)")

    def call():
        return tk.select_walk(tree, layout, cpuct, depth, fpu_parent)

    row = dict(max_abs_err=max_abs_err(sel, plain), ms=graph_ms(call, 50),
               eager_ms=cuda_ms(call, 50),
               plain_ms=cuda_ms(lambda: tk.select_walk_plain(
                   tree, layout, cpuct, depth, fpu_parent), reps=10,
                   warmup=1),
               **path_stats(sel[4], floor))
    row["bound_ms"], row["bound_by"] = select_bound(layout, sel, depth)
    log(f"select_walk: kernel == plain on every output, tolerance 0; "
        f"{timing_summary(row)}")
    return sel, row


def hold_backup(tree, bargs, mode, floor):
    """``backup_paths`` in ``mode`` against its plain version on a copy of
    ``tree`` (the whole packed tree, tolerance 0), then its times on a
    scratch copy (repeated backups keep the path valid), bound and floor.
    Returns ``(the kernel's tree, row)``."""
    got = tk.backup_paths(tree.clone(), *bargs, mode=mode)
    want = tk.backup_paths_plain(tree.clone(), *bargs, mode=mode)
    if not torch.equal(got, want):
        raise AssertionError(f"backup_paths {mode}: kernel != plain "
                             f"(tolerance 0)")
    if torch.equal(got, tree):
        raise AssertionError(f"backup_paths {mode} changed nothing")
    scratch = tree.clone()

    def call():
        return tk.backup_paths(scratch, *bargs, mode=mode)

    plen, expanding = bargs[2], bargs[4]
    row = dict(max_abs_err=float((got - want).abs().max()),
               ms=graph_ms(call, 50), eager_ms=cuda_ms(call, 50),
               plain_ms=cuda_ms(lambda: tk.backup_paths_plain(
                   scratch, *bargs, mode=mode), reps=10, warmup=1),
               **path_stats(plen, floor))
    row["bound_ms"], row["bound_by"] = backup_bound(bargs[6], plen,
                                                    expanding, mode)
    log(f"backup_paths {mode}: kernel == plain on the whole packed tree, "
        f"tolerance 0; {timing_summary(row)}")
    return got, row


def hold_gumbel(tree, root, layout, depth, cv, cs, fan, floor):
    """``gumbel_select_walk`` against its plain version on ``tree`` with the
    forced root actions ``root`` (every output, tolerance 0), then its times
    (CUDA-graph replay, one eager wrapper call, the plain version), bound
    and floor.  Returns the row."""
    walk = tk.gumbel_select_walk(tree, root, layout, depth, cv, cs, fan)
    plain = tk.gumbel_select_walk_plain(tree, root, layout, depth, cv, cs,
                                        fan)
    for name, k, p in zip(("leaf", "action", "path_nodes", "path_actions",
                           "path_len"), walk, plain):
        if not torch.equal(k, p):
            raise AssertionError(f"gumbel_select_walk fan {fan} {name}: "
                                 f"kernel != plain (tolerance 0)")

    def call():
        return tk.gumbel_select_walk(tree, root, layout, depth, cv, cs, fan)

    row = dict(max_abs_err=max_abs_err(walk, plain), ms=graph_ms(call, 50),
               eager_ms=cuda_ms(call, 50),
               plain_ms=cuda_ms(lambda: tk.gumbel_select_walk_plain(
                   tree, root, layout, depth, cv, cs, fan), reps=5,
                   warmup=1),
               **path_stats(walk[4], floor))
    row["bound_ms"], row["bound_by"] = gumbel_bound(layout, walk, depth)
    log(f"gumbel_select_walk fan {fan} ({root.shape[0]} lanes): kernel == "
        f"plain on every output, tolerance 0; {timing_summary(row)}")
    return row


class LastWalk:
    """``gumbel_select_walk`` that keeps a copy of the tree and the root
    actions of its ``at``-th call (the walk of that simulation)."""

    def __init__(self, at: int):
        self.at, self.calls, self.kept = at, 0, None

    def __call__(self, packed, root, *args):
        self.calls += 1
        if self.calls == self.at:
            self.kept = (packed.clone(), root.clone())
        return tk.gumbel_select_walk(packed, root, *args)


def timing_summary(row) -> str:
    return (f"path_len mean {row['path_len_mean']:.2f} max "
            f"{row['path_len_max']}; kernel {row['ms']:.4f} ms (CUDA graph "
            f"replay; eager wrapper call {row['eager_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}), floor {row['floor_ms']:.4f} ms")


def phase_gen(seed: int, tag: int, dev) -> torch.Generator:
    """A generator of its own for each phase (``tag`` its number, 100 more
    for a search's pair of generators), so that what a phase draws does not
    depend on what the phases before it drew."""
    return torch.Generator(device=dev).manual_seed(1000 * seed + tag)


def smoke_weights(cfg: NetConfig, seed: int, dev):
    """``(params, batch_stats)`` of the smoke's net: ``init_params(seed)``
    with each BN's running mean and variance fitted to its input on
    ``random_calib_obs`` boards (seed + 1), as a trained net's are its
    data's (``fit_batch_stats``: with the initial stats the 6x128 net's heads
    are dead or saturated, so that a check of logits or values would hold
    little)."""
    params, stats = init_params(cfg, seed)
    obs = q8.random_calib_obs(cfg, seed=seed + 1)
    return params, fit_batch_stats(cfg, params, stats, obs, device=dev)


def random_states(env, batch, plies, generator, dev):
    """Games advanced by ``plies`` uniformly random legal moves."""
    states = env.init_batch(batch, dev)
    for _ in range(plies):
        legal = env.legal_mask(states)
        u = torch.rand(legal.shape, generator=generator, device=dev)
        states = env.step_safe(states, torch.argmax(
            torch.where(legal, u, -1.0), dim=1))
    return states


def ptxas_kernels(lines):
    """``{function: [registers, spill bytes]}`` from ``nvcc -Xptxas -v``
    (``_build.BuiltLibrary.ptxas``): each function's "Used N registers" and
    its "spill stores" plus "spill loads" bytes, by its mangled name."""
    out, name = {}, None
    for ln in lines:
        if "Compiling entry function '" in ln:
            name = ln.split("'")[1]
        elif "Function properties for " in ln:
            name = ln.split("Function properties for ")[1].strip()
        elif name and "bytes spill stores" in ln:
            out.setdefault(name, [0, 0])[1] += (
                int(ln.split(" bytes spill stores")[0].split()[-1])
                + int(ln.split(" bytes spill loads")[0].split()[-1]))
        elif name and "Used " in ln and " registers" in ln:
            out.setdefault(name, [0, 0])[0] = int(
                ln.split("Used ")[1].split()[0])
    return out


def check_spills(built, match: str):
    """The registers of a library's kernels whose names hold ``match``, and
    their spill bytes summed; raises on a spill."""
    found = {k: v for k, v in ptxas_kernels(built.ptxas).items()
             if match in k}
    if not found:
        raise AssertionError(f"{built.path.name}: no kernel named *{match}* "
                             f"in ptxas's report")
    regs = [r for r, _ in found.values()]
    spills = sum(b for _, b in found.values())
    log(f"{built.path.name}, {match}: {len(found)} kernels, registers {regs}, "
        f"spill stores and loads {spills} bytes")
    if spills:
        raise AssertionError(f"{match}: ptxas spills {spills} bytes")
    return regs, spills


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM and flops over the
    peak rate of their type (float32 CUDA cores unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def select_bound(layout, sel, depth):
    """What ``select_walk`` must move on this tree: per node read, the N, W,
    P rows, the done flag and one child index; the outputs once."""
    _, action, _, _, plen = (x.long() for x in sel)
    hops = torch.where(action >= 0, plen, torch.clamp(plen + 1, max=depth))
    reads = int(hops.sum())
    b = plen.shape[0]
    a = layout.num_actions
    nbytes = reads * (3 * a + 2) * 4 + (3 * b + 2 * depth * b) * 4
    flops = reads * a * 8       # sum N, q, the score, the max: ~8 per action
    return bound(nbytes, flops)


def gumbel_bound(layout, walk, depth):
    """What ``gumbel_select_walk`` must move on this tree: per lane its root
    action; at the root hop the done flag and the child index of the forced
    action; at each deeper hop the N, W, P rows, the done flag, the node
    value and one child index; the outputs once.  About 30 float operations
    per action per deeper hop (completed Q, a log, an exp, the softmax and
    the score)."""
    _, action, _, _, plen = (x.long() for x in walk)
    hops = torch.where(action >= 0, plen, torch.clamp(plen + 1, max=depth))
    root_hops = int(torch.clamp(hops, max=1).sum())
    deep_hops = int(hops.sum()) - root_hops
    lanes = plen.shape[0]
    a = layout.num_actions
    nbytes = (lanes * 4 + root_hops * 2 * 4 + deep_hops * (3 * a + 3) * 4
              + (3 * lanes + 2 * depth * lanes) * 4)
    return bound(nbytes, deep_hops * a * 30)


def tower_flops(cfg: NetConfig, batch: int) -> int:
    """2 * B * H * W * 9 * Cin * Cout summed over the tower's convs."""
    c = cfg.channels
    per_pixel = 9 * (cfg.in_channels * c + 2 * cfg.n_res_blocks * c * c)
    return 2 * batch * cfg.board_size ** 2 * per_pixel


def tower_bound(cfg: NetConfig, batch: int):
    """The tower's FLOPs over the dense bf16 tensor-core peak, against the
    bytes of its observations, bf16 weights, float32 biases and float32
    output."""
    c, hw = cfg.channels, cfg.board_size ** 2
    weights = 9 * (cfg.in_channels * c + 2 * cfg.n_res_blocks * c * c)
    nbytes = (batch * hw * cfg.in_channels * 4 + weights * 2
              + (1 + 2 * cfg.n_res_blocks) * c * 4 + batch * hw * c * 4)
    return bound(nbytes, tower_flops(cfg, batch), BF16_FLOPS_PER_S)


def int8_tower_bound(cfg: NetConfig, batch: int):
    """The int8 tower's operations (``tower_flops``: the stem's 27 real input
    columns, its zero padding is not work) over the dense int8 tensor-core
    peak, against the bytes of its float32 observations, int8 weights,
    float32 scales, biases and requant reciprocals, and float32 output."""
    c, hw = cfg.channels, cfg.board_size ** 2
    weights = 9 * (cfg.in_channels * c + 2 * cfg.n_res_blocks * c * c)
    per_channel = (3 + 2 * 2 * cfg.n_res_blocks + 2 * cfg.n_res_blocks) * c
    nbytes = (batch * hw * cfg.in_channels * 4 + weights
              + (per_channel + cfg.in_channels) * 4 + batch * hw * c * 4)
    return bound(nbytes, tower_flops(cfg, batch), INT8_OPS_PER_S)


def backup_bound(layout, plen, expanding, mode="backup"):
    """What ``backup_paths`` must move: the slot tile's N, W and C rows at
    ``num_actions`` columns, its P row at ``seg`` columns (the -1 padding is
    part of the packed layout that the exact checks compare) and its two meta
    floats, written, and in mode ``"finalize"`` its N, W and C rows read
    too (they are kept); the priors and per-lane inputs read; per hop the
    path entry read, and N and W read and written ("finalize": W only); C
    written on the expansion edge.  Rows 5-7 are left out: they are zero
    from ``init_packed`` (or kept) and nothing reads them."""
    b = plen.shape[0]
    a = layout.num_actions
    hops = int(plen.sum())
    tile = (3 * a + layout.seg + 2) * 4
    kept = b * 3 * a * 4 if mode == "finalize" else 0
    per_hop = 8 + (8 if mode == "finalize" else 16)
    nbytes = (b * tile + kept + b * a * 4 + b * (4 + 4 + 1 + 1)
              + hops * per_hop + int(expanding.sum()) * 4)
    return bound(nbytes, 2 * hops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 26 (run_ranks starts them): "rank,world,port,trace"
    # and the directory of its results
    ap.add_argument("--parallel-worker", nargs=2, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.parallel_worker is not None:
        return parallel_worker(args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    env = make_env("gomoku", BOARD)
    net_cfg = NetConfig.full(BOARD)
    rows = {name: dict(name=name, route="cuda", **meta)
            for name, meta in KERNEL_ROWS.items()}

    with Phase("1 device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi()
        log(f"device: {kind}, count {count}; nvidia-smi: {smi}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"python {sys.version.split()[0]}")
        # TF32 off for matmul and cuDNN in this slice: float32 throughout
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("tf32: matmul off, cudnn off")

    with Phase("2 build (one nvcc per source, at once)"):
        libs = _build.build_all(["tree_kernels", "fused_net", "int8_tower",
                                 "matmul_rate", "width1_slice",
                                 "latency_floor", "game_step"])
        for built in libs.values():
            how = "reused an earlier build" if built.reused else "built"
            log(f"{how}: {built.path.name}, nvcc {built.seconds:.2f} s")
            for line in built.ptxas:
                log(f"  {line}")
        # the towers' convs, and the two kernels redesigned last
        for lib, match, row in (
                ("int8_tower", "conv_kernel", "int8_tower"),
                ("fused_net", "conv_kernel", "fused_tower"),
                ("tree_kernels", "gumbel_select_walk_kernel",
                 "gumbel_select_walk"),
                ("matmul_rate", "rate_resident", "matmul_rate_int8"),
                ("matmul_rate", "rate_streamed", "matmul_rate_int8"),
                ("game_step", "step_kernel", "game_step")):
            regs, spills = check_spills(libs[lib], match)
            rows[row].setdefault("ptxas_registers", {})[match] = regs
            rows[row]["ptxas_spill_bytes"] = (
                rows[row].get("ptxas_spill_bytes", 0) + spills)

    with Phase("2b the 6x128 net: init_params, BN stats fitted to "
               "random_calib_obs boards"):
        weights = smoke_weights(net_cfg, args.seed, dev)
        net = bundle_of(net_cfg, *weights, device=dev)
    eval_fn = make_eval_fn()
    game_phases(args, dev, rows)

    grow = dataclasses.replace(MAIN_MCTS, n_simulations=GROW_SIMS,
                               max_nodes=MAIN_MCTS.node_capacity)
    layout = tk.packed_layout(env.num_actions, grow.node_capacity)
    depth = grow.depth_limit
    with Phase(f"3 select_walk and backup_paths against their plain "
               f"versions (batch {BATCH}, {layout.n_nodes} nodes, seg "
               f"{layout.seg}, depth cap {depth}), on trees of {GROW_SIMS} "
               f"and {SIMS - 1} simulations"):
        floor = latency_floor()
        gen = phase_gen(args.seed, 3, dev)
        states = random_states(env, BATCH, 4, gen, dev)
        moves = torch.full((BATCH,), 4, dtype=torch.int32, device=dev)
        # GROW_SIMS, and PUCT@400's own tree as its last simulation walks it
        for sims in (GROW_SIMS, SIMS - 1):
            cfg = dataclasses.replace(grow, n_simulations=sims)
            tree = run_mcts_packed_with_tree(env, cfg, eval_fn, net, states,
                                             moves, gen)[2].packed
            log(f"grew the tree: {sims} simulations, packed "
                f"{tuple(tree.shape)}")
            sel, walk = hold_select(tree, layout, grow.cpuct, depth, floor)
            _, action, pnodes, pacts, plen = sel
            values = torch.rand(BATCH, generator=gen, device=dev) * 2 - 1
            legal = torch.rand((BATCH, env.num_actions), generator=gen,
                               device=dev) < 0.9
            priors = torch.where(legal, torch.rand(legal.shape, generator=gen,
                                                   device=dev), -1.0)
            done = torch.rand(BATCH, generator=gen, device=dev) < 0.1
            bargs = (pnodes, pacts, plen, values, action >= 0, sims + 1,
                     layout, priors, done)
            _, back = hold_backup(tree, bargs, "backup", floor)
            for name, t in (("select_walk", walk), ("backup_paths", back)):
                if sims == GROW_SIMS:
                    rows[name].update(t, library_ms=None)
                else:
                    rows[name][f"tree{SIMS}"] = t
            del tree
        log("no single PyTorch call computes the walk or the backup, so "
            "library_ms is null")

    with Phase(f"4 search pi, kernels against plain (batch {PI_BATCH}, "
               f"{PI_SIMS} sims, 6x128, cudnn deterministic)"):
        torch.backends.cudnn.deterministic = True
        cfg64 = dataclasses.replace(MAIN_MCTS, n_simulations=PI_SIMS)
        states = random_states(env, PI_BATCH, 6, phase_gen(args.seed, 4, dev),
                               dev)
        moves = torch.full((PI_BATCH,), 6, dtype=torch.int32, device=dev)
        out = {}
        for label, ops in (("kernels", tk.KERNELS), ("plain", tk.PLAIN)):
            g = phase_gen(args.seed, 104, dev)
            out[label] = run_mcts_packed(env, cfg64, eval_fn, net, states,
                                         moves, g, ops=ops)
        if not torch.equal(out["kernels"][0], out["plain"][0]):
            raise AssertionError("search pi: kernels != plain")
        qdiff = float((out["kernels"][1] - out["plain"][1]).abs().max())
        log(f"search pi: kernels == plain exactly over {PI_BATCH} lanes; "
            f"root_q max "
            f"abs diff {qdiff}")
        torch.backends.cudnn.deterministic = False

    sp_cfg = SelfPlayConfig(batch_games=BATCH, mcts=MAIN_MCTS,
                            temp_threshold=10, max_moves=F32_MOVES)
    gen = phase_gen(args.seed, 5, dev)
    with Phase(f"5a main path warm-up (batch {BATCH}, 1 move, 8 sims)"):
        warm = dataclasses.replace(
            sp_cfg, max_moves=1,
            mcts=dataclasses.replace(MAIN_MCTS, n_simulations=8))
        play_games(env, warm, eval_fn, net, gen, dev)

    with Phase(f"5b main path: play_games batch {BATCH}, 6x128, "
               f"{BOARD}x{BOARD}, PUCT@{SIMS} float32, {F32_MOVES} moves (cut "
               f"from {MOVES}; the int8 tower's PUCT path runs {MOVES})"):
        reset_launch_counts()
        counted = CountingEnv(env)
        t0 = time.perf_counter()
        traj = play_games(counted, sp_cfg, eval_fn, net, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        expect_game_launches("PUCT main path", counted, rows, "puct400")
        moves_done = int(torch.clamp(traj.moves_played, max=F32_MOVES).sum())
        log(f"main path: {moves_done} moves in {seconds:.3f} s = "
            f"{moves_done / seconds:.2f} moves/s (batch {BATCH}, 6x128, "
            f"PUCT@{SIMS}, {BOARD}x{BOARD}, fp32, TF32 off) on {smi}")
        expect_launches("PUCT main path", launches, {
            "select_walk": F32_MOVES * SIMS, "backup_paths": F32_MOVES * SIMS,
            "gumbel_select_walk": 0, "fused_tower": 0, "int8_tower": 0})
        for name, n in launches.items():
            rows[name]["launches_by_path"] = {"puct400": n}
        check_trajectories(env, traj, F32_MOVES)
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")

    gumbel_phases(args, env, net_cfg, weights, net, dev, rows, smi)
    int8_bundle, int8_rate = int8_phases(args, env, net_cfg, weights, net,
                                         dev, rows, smi)
    extension_phases(args, env, net_cfg, weights, net, dev, rows, smi,
                     int8_bundle, int8_rate)
    probe_phases(args, net_cfg, dev, rows, smi)
    with tempfile.TemporaryDirectory() as kept:
        buffer_path = training_phases(args, env, net_cfg, dev, rows, smi,
                                      kept)
        pente_phases(args, dev, rows, smi)
        continuous_phases(args, env, net_cfg, dev, rows, smi, int8_bundle)
        player_phases(args, net_cfg, weights, dev, rows, smi)
        parallel_phases(args, env, net_cfg, dev, rows, smi, int8_bundle)
        bench_phases(dev, rows)
        tool_phases(dev, rows, smi)
        probe_tool_phases(dev, rows, smi, buffer_path)
    envelope_phases(dev, rows, smi)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    log(json.dumps({"kernels": [rows[k] for k in KERNEL_ROWS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def bench_launches(kw: dict, calls: int) -> dict:
    """The launches ``calls`` calls of ``run_bench(**kw)`` make, no game
    ending: a walk and a backup a simulation (k-leaf: a walk, a ``vl`` and
    a ``finalize`` backup), and with ``int8t`` a tower call a network call
    (the root's and one a simulation, or one a k-leaf step)."""
    sims = kw.get("n_simulations", 400)
    k = kw.get("leaves_per_sim", 1)
    n = calls * kw["measure_moves"]
    want = {}
    if kw.get("search") == "gumbel":
        want.update(gumbel_select_walk=n * sims, backup_paths=n * sims)
    elif k > 1:
        want.update(select_walk=n * sims, backup_paths_vl=n * sims,
                    backup_paths_finalize=n * sims)
    else:
        want.update(select_walk=n * sims, backup_paths=n * sims)
    if kw.get("infer") == "int8t":
        want["int8_tower"] = n * (1 + sims // k)
    return want


def bench_phases(dev, rows):
    """Phase 27: the bench (``alphazero_gomoku_tpu_torch/bench.py``) on the
    card at its configs' shapes and full width, 15x15 with the 6x128 net
    (config #2: 2x64), each cut to a few moves (``BENCH_RUNS``) and
    ``BENCH_REPEATS`` repeats after its warm-up call, no quiesce wait; then
    config #1 (``bench_pure_mcts``, host only) and config #5
    (``bench_training_iteration``, ``int8t``) cut.  Each result's JSON line
    is printed; its moves are batch x moves (no game ends in 8 moves), its
    ``mfu_pct`` within (0, 100), its ``detail.device`` names the card, and
    each config launches the kernels of its path (``bench_launches``) and
    no other."""
    name = torch.cuda.get_device_name(0)

    def check_device(r):
        if not r["detail"]["device"].startswith(name):
            raise AssertionError(f"device {r['detail']['device']!r} does "
                                 f"not name {name!r}")

    for label, kw in BENCH_RUNS:
        kw = {**BENCH_WIDTH, **kw}
        with Phase(f"27 bench {label}: run_bench({kw}), "
                   f"{BENCH_REPEATS} repeats"):
            reset_launch_counts()
            r = bench.run_bench(**kw, repeats=BENCH_REPEATS,
                                quiesce_max_wait=0, device=dev)
            torch.cuda.synchronize()
            launches = launch_counts()
            log(json.dumps(r))
            expect_launches(f"bench {label}", launches,
                            bench_launches(kw, 1 + BENCH_REPEATS))
            for kernel, n in launches.items():
                rows[kernel].setdefault("launches_by_path", {})[
                    f"bench_{label}"] = n
            d = r["detail"]
            moves = kw["batch_games"] * kw["measure_moves"]
            if d["moves"] != moves or len(d["runs_moves_per_sec"]) !=                     BENCH_REPEATS or r["value"] != max(d["runs_moves_per_sec"]):
                raise AssertionError(f"bench {label}: {d['moves']} moves, "
                                     f"expected {moves}; runs "
                                     f"{d['runs_moves_per_sec']}")
            if not 0 < d["mfu_pct"] < 100:
                raise AssertionError(f"bench {label}: mfu_pct "
                                     f"{d['mfu_pct']}")
            check_device(r)

    with Phase(f"27 bench 1_pure_mcts: bench_pure_mcts({BENCH_PURE}), "
               f"host only"):
        reset_launch_counts()
        r = bench.bench_pure_mcts(**BENCH_PURE)
        log(json.dumps(r))
        expect_launches("bench 1_pure_mcts", launch_counts(), {})
        if r["detail"]["games"] < 1 or not r["value"] > 0:
            raise AssertionError(f"bench 1_pure_mcts: {r}")

    with Phase(f"27 bench 5_training_loop: bench_training_iteration("
               f"{BENCH_TRAIN}), int8t, 6x128, two iterations"):
        reset_launch_counts()
        r = bench.bench_training_iteration(**BENCH_TRAIN, device=dev)
        torch.cuda.synchronize()
        launches = launch_counts()
        log(json.dumps(r))
        expect_launches("bench 5_training_loop", launches, {},
                        some=("select_walk", "backup_paths", "int8_tower"))
        for kernel, n in launches.items():
            rows[kernel].setdefault("launches_by_path", {})[
                "bench_5_training_loop"] = n
        d = r["detail"]
        if not (d["selfplay_moves"] > 0 and d["buffer_size"] > 0
                and r["value"] > 0):
            raise AssertionError(f"bench 5_training_loop: {r}")
        check_device(r)


def run_tool(main, argv, dev):
    """A tool's ``main(argv)`` on ``dev``; its printed lines, each logged,
    and the JSON ones parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if main(argv, device=dev) != 0:
            raise AssertionError(f"{main.__module__} {argv} failed")
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"  {line}")
    return [json.loads(x) for x in lines if x.startswith("{")]


def check_tally(tool: str, r: dict, games: int, played: int):
    """``played`` is the games asked for, and the mirrored pairs add up."""
    pairs = r["pairs"]
    if played != games or pairs["n"] != games // 2 or \
            pairs["win_both"] + pairs["loss_both"] + pairs["split"] != \
            pairs["n"]:
        raise AssertionError(f"{tool}: played {played} of {games}, pairs "
                             f"{pairs}")


def tool_phases(dev, rows, smi):
    """Phase 28: each arena tool of ``alphazero_gomoku_tpu_torch/tools/``
    through its ``main`` on the card (``device``), on the shipped
    checkpoints (``checkpoints/``), ``TOOL_GAMES`` games (2 for the three
    search A/Bs) of ``TOOL_SIMS`` simulations: ``int8_ab`` and
    ``compare_snapshots`` on ``best_gomoku.ckpt``, ``cross_net_arena``
    (Gumbel) of ``distill_4x96.ckpt`` against it, ``gumbel_ab``,
    ``reuse_ab``, ``kleaf_ab``; ``harvest_run`` over three 6x128 snapshots
    written in the phase; ``strength_probe``, one game capped at 6 plies.
    Each plays the games asked for, its pairs add up, and it launches the
    kernels of its searches."""
    best = os.path.join(CHECKPOINTS, "best_gomoku.ckpt")
    student = os.path.join(CHECKPOINTS, "distill_4x96.ckpt")
    games, sims = str(TOOL_GAMES), str(TOOL_SIMS)
    puct = ("select_walk", "backup_paths")
    gumbel = ("gumbel_select_walk", "backup_paths")
    runs = (
        ("int8_ab", int8_ab.main, [best, "--games", games, "--sims", sims],
         TOOL_GAMES, "games", puct + ("int8_tower",)),
        ("compare_snapshots", compare_snapshots.main,
         [best, best, "--games", games, "--sims", sims], TOOL_GAMES,
         "played", puct),
        ("cross_net_arena", cross_net_arena.main,
         [student, best, "--games", games, "--sims", sims, "--search",
          "gumbel"], TOOL_GAMES, "played", gumbel),
        ("gumbel_ab", gumbel_ab.main,
         [best, "--games", "2", "--gumbel-sims", sims, "--puct-sims",
          str(2 * TOOL_SIMS), "--round-parallel"], 2, "games",
         puct + gumbel),
        ("reuse_ab", reuse_ab.main, [best, "--games", "2", "--sims", sims],
         2, "games", puct),
        ("kleaf_ab", kleaf_ab.main,
         ["--model", best, "--games", "2", "--sims", sims, "--k", "4"], 2,
         "games", puct + ("backup_paths_vl", "backup_paths_finalize")),
    )
    for tool, main, argv, n, key, some in runs:
        with Phase(f"28 {tool} {' '.join(argv)}"):
            reset_launch_counts()
            [r] = run_tool(main, argv, dev)
            torch.cuda.synchronize()
            launches = launch_counts()
            expect_launches(tool, launches, {}, some=some)
            for kernel, c in launches.items():
                rows[kernel].setdefault("launches_by_path", {})[
                    f"tool_{tool}"] = c
            check_tally(tool, r, n, r[key])

    with tempfile.TemporaryDirectory() as tmp:
        with Phase(f"28 harvest_run over 3 snapshots (best_gomoku.ckpt "
                   f"saved thrice), 2 games of {sims} sims a match, "
                   f"baseline best_gomoku.ckpt"):
            model = AZModel.from_checkpoint(best, device=dev)
            for it in (10, 20, 30):
                model.save(os.path.join(tmp, f"snapshot_iter{it}_x.ckpt"))
            reset_launch_counts()
            lines = run_tool(harvest_run.main,
                             [tmp, "--games", "2", "--sims", sims,
                              "--every", "10", "--baseline", best], dev)
            launches = launch_counts()
            expect_launches("harvest_run", launches, {}, some=puct)
            for kernel, c in launches.items():
                rows[kernel].setdefault("launches_by_path", {})[
                    "tool_harvest_run"] = c
            matches, last = lines[:-1], lines[-1]
            if len(matches) != 3 or not last["path"].startswith(tmp):
                raise AssertionError(f"harvest_run: {lines}")
            for r in matches[:2] + [matches[2]["vs_baseline"]]:
                check_tally("harvest_run", r, 2, 2 * r["pairs"]["n"])

        with Phase(f"28 strength_probe: best_gomoku.ckpt at {sims} sims "
                   f"against player_mcts, 1 game capped at 6 plies"):
            reset_launch_counts()
            [r] = run_tool(strength_probe.main,
                           ["--model", best, "--sims", sims, "--games", "1",
                            "--max-moves", "6"], dev)
            launches = launch_counts()
            expect_launches("strength_probe", launches, {}, some=puct)
            for kernel, c in launches.items():
                rows[kernel].setdefault("launches_by_path", {})[
                    "tool_strength_probe"] = c
            if r["az_wins"] + r["draws"] + r["mcts_wins"] != 1:
                raise AssertionError(f"strength_probe: {r}")
    log(f"tools on {smi}")


def probe_tool_phases(dev, rows, smi, buffer_path: str):
    """Phase 29: the probes and microbenchmarks of
    ``alphazero_gomoku_tpu_torch/tools/`` through their ``main`` on the
    card, cut small, on the shipped checkpoints (``checkpoints/``) and on
    the replay buffer phase 22's training iteration wrote:

      - ``tactics_probe``, both suites (``best_gomoku.ckpt``,
        ``best_pente.ckpt`` with capture planes) at ``PROBE_SIMS``
        simulations: a PUCT walk and a backup a simulation a position;
      - ``distill_net``: a 4x96 student, one epoch on the buffer (no
        kernel), its checkpoint read back; ``policy_entropy_probe`` of
        ``best_gomoku.ckpt`` against it, and ``int8_calib_sensitivity`` of
        ``best_gomoku.ckpt`` on random-play and buffer calibration sets
        (K5 once a set); ``tt_rate_probe`` (float32 at batch 1, no kernel);
      - the microbenchmarks at batch ``MICRO_BATCH``:
        ``tree_kernel_microbench`` at one depth pair (K1, K2),
        ``search_cost_split`` and ``hbm_budget`` (PUCT@``MICRO_SIMS`` on
        K5), ``net_microbench`` (every inference mode: K4, K5) and
        ``int8_probe`` (K5, K4);
      - ``device_parity --quick`` (K1, K2, K5 against their plain
        versions), ``gumbel_determinism_probe`` (``DETERMINISM_REPEATS``
        kernel runs: K3, K2, K5) and ``gumbel_flip_probe`` on ``FLIP_BATCH``
        positions at each of ``FLIP_PLIES`` and ``FLIP_GAMES`` games (K3,
        K2, K4).

    Each tool's lines are printed and checked, and each launches the
    kernels of its path and no other: the counts the data fixes are held
    exactly, the others must be at least one."""
    best = os.path.join(CHECKPOINTS, "best_gomoku.ckpt")
    pente = os.path.join(CHECKPOINTS, "best_pente.ckpt")
    puct = ("select_walk", "backup_paths")

    def run(tool, main, argv, want=None, some=()):
        with Phase(f"29 {tool} {' '.join(argv)}"):
            reset_launch_counts()
            lines = run_tool(main, argv, dev)
            torch.cuda.synchronize()
            launches = launch_counts()
            expect_launches(tool, launches, want or {}, some=some)
            for kernel, c in launches.items():
                rows[kernel].setdefault("launches_by_path", {})[
                    f"tool_{tool}"] = c
        return lines

    for game, ckpt in (("gomoku", best), ("pente", pente)):
        n = len(suite_for(game))
        lines = run(f"tactics_probe_{game}", tactics_probe.main,
                    ["--model", ckpt, "--sims", str(PROBE_SIMS), "--game",
                     game],
                    {k: n * PROBE_SIMS for k in puct})
        if lines[-1]["total"] != n or len(lines) != n + 1:
            raise AssertionError(f"tactics_probe {game}: {lines[-1]}")

    with tempfile.TemporaryDirectory() as tmp:
        student = os.path.join(tmp, "student.ckpt")
        lines = run("distill_net", distill_net.main,
                    [buffer_path, "--epochs", "1", "--out", student]
                    + [f"--{k}={v}" for k, v in DISTILL.items()])
        if not (len(lines) == 1 and math.isfinite(lines[0]["train_loss"])):
            raise AssertionError(f"distill_net: {lines}")
        model = AZModel.from_checkpoint(student, device=dev)
        if (model.cfg.n_res_blocks, model.cfg.channels) != (
                DISTILL["blocks"], DISTILL["channels"]):
            raise AssertionError(f"distill_net saved {model.cfg}")

        lines = run("policy_entropy_probe", policy_entropy_probe.main,
                    [best, student, "--buffer", buffer_path])
        if len(lines) != 3 or not all(
                0 < r["mean_entropy_nats"] < math.log(225) + 1e-6
                for r in lines[:2]):
            raise AssertionError(f"policy_entropy_probe: {lines}")

    lines = run("int8_calib_sensitivity", int8_calib_sensitivity.main,
                [best, "--buffer", buffer_path], {"int8_tower": 3})
    if [r["route"] for r in lines] != ["int8", "int8t"] * 3 or any(
            a[k] != b[k] for a, b in zip(lines[::2], lines[1::2])
            for k in ("top1_agree", "value_mae")):
        raise AssertionError(f"int8_calib_sensitivity: the int8 tower's "
                             f"lines differ from torch._int_mm's: {lines}")

    [r] = run("tt_rate_probe", tt_rate_probe.main,
              ["--ckpt", best, "--sims", "64", "--moves", "4"])
    if not (r["expansions"] > 0 and 0 <= r["tt_rate"] <= 1):
        raise AssertionError(f"tt_rate_probe: {r}")

    b, sims = str(MICRO_BATCH), str(MICRO_SIMS)
    timed = 2 * (1 + MICRO_ITERS)          # two depths: a warm-up call each
    lines = run("tree_kernel_microbench", tree_kernel_microbench.main,
                ["--batches", b, "--depths", *map(str, MICRO_DEPTHS),
                 "--iters", str(MICRO_ITERS)],
                {k: timed for k in puct})
    fit = lines[-1]["fit"]
    if not (fit["select_hop_ms"] > 0 and fit["backup_hop_ms"] > 0):
        raise AssertionError(f"tree_kernel_microbench: {fit}")

    moves = 2
    # a warm-up and a timed call, with the real net and with the null net
    [r] = run("search_cost_split", search_cost_split.main,
              ["--batches", b, "--moves", str(moves), "--sims", sims],
              {"select_walk": 4 * moves * MICRO_SIMS,
               "backup_paths": 4 * moves * MICRO_SIMS,
               "int8_tower": 2 * moves * (1 + MICRO_SIMS)})
    if not 0 < r["nn_share"] < 1:
        raise AssertionError(f"search_cost_split: {r}")

    [r] = run("hbm_budget", hbm_budget.main,
              [b, sims, "int8t", "--moves", str(moves)],
              {"select_walk": moves * MICRO_SIMS,
               "backup_paths": moves * MICRO_SIMS,
               "int8_tower": moves * (1 + MICRO_SIMS)})
    if not 0 < r["measured_peak_mb"] <= 2 * r["reckoned_peak_mb"] + \
            r["resident_before_mb"]:
        raise AssertionError(f"hbm_budget: {r}")

    calls = 3 + 20                          # events_ms's warm-up and reps
    lines = run("net_microbench", net_microbench.main,
                ["--batches", b, "--iters", "20"],
                {"fused_tower": calls, "int8_tower": calls})
    if len(lines) != 5 or not all(r["ms_per_eval"] > 0 for r in lines):
        raise AssertionError(f"net_microbench: {lines}")

    lines = run("int8_probe", int8_probe.main,
                ["--batch", b, "--reps", "10"],
                {"fused_tower": 13, "int8_tower": 13})
    if len(lines) != 6 or not all(r["us_per_conv"] > 0 for r in lines[:5]):
        raise AssertionError(f"int8_probe: {lines}")

    lines = run("device_parity", device_parity.main, ["--quick"],
                some=puct + ("int8_tower",))
    if lines[-1]["all_ok"] is not True:
        raise AssertionError(f"device_parity: {lines}")

    [r] = run("gumbel_determinism_probe", gumbel_determinism_probe.main,
              [str(DETERMINISM_REPEATS)],
              some=("gumbel_select_walk", "backup_paths", "int8_tower"))
    if not (r["kernels_deterministic"] and r["kernels_equal_plain"]):
        raise AssertionError(f"gumbel_determinism_probe: {r}")

    lines = run("gumbel_flip_probe", gumbel_flip_probe.main,
                ["--ckpt", best, "--sims", str(FLIP_SIMS), "--m",
                 str(FLIP_M), "--batch", str(FLIP_BATCH), "--plies",
                 *map(str, FLIP_PLIES), "--arena-games", str(FLIP_GAMES)],
                some=("gumbel_select_walk", "backup_paths", "fused_tower"))
    fr = lines[-2]["flip_rate_summary"]
    ar = lines[-1]["cross_backend_arena"]
    if fr["positions"] < 1:
        raise AssertionError(f"gumbel_flip_probe: {fr}")
    check_tally("gumbel_flip_probe", ar, FLIP_GAMES, ar["played"])
    log(f"probes and microbenchmarks on {smi}")


def envelope_phases(dev, rows, smi):
    """Phase 30: the envelope probes of ``alphazero_gomoku_tpu_torch/repro/``
    (``envelope.probe_kernels``, ``envelope.probe_selfplay``), cut: each
    runs the kernels and then the plain versions from one seed and must
    match bit for bit, replay its games on the host engine without a
    disagreement, and reach its axis (capped walks; won games, full boards
    and searches on done roots).  The plain runs launch no kernel, so each
    sub-phase's counts are its kernels' run."""
    def run(label, key, what, fn, want=None, some=()):
        with Phase(f"30{label} {what}"):
            reset_launch_counts()
            line = fn()
            torch.cuda.synchronize()
            launches = launch_counts()
            log(json.dumps(line))
            expect_launches(f"envelope {label}", launches, want or {},
                            some=some)
            for kernel, c in launches.items():
                rows[kernel].setdefault("launches_by_path", {})[
                    f"envelope_{key}"] = c
        if not (line["ok"] and line["match"]):
            raise AssertionError(f"phase 30{label}: {line}")
        return line

    b, sims, nodes = ENV_KERNELS
    line = run("a", "kernels1024", f"select_walk and backup_paths alone, "
               f"{b} lanes x {sims} simulations, {nodes} slots",
               lambda: bisect_batch512.kernels(b, sims, nodes, device=dev),
               {"select_walk": sims, "backup_paths": sims})
    if line["root_visits"] != b * sims:
        raise AssertionError(f"phase 30a: root visits {line}")

    b, sims, moves = ENV_SELFPLAY
    line = run("b", "selfplay1024", f"play_games {b} lanes, PUCT@{sims} "
               f"int8t, 6x128, {moves} moves",
               lambda: bisect_batch512.selfplay(b, sims, moves, "int8t",
                                                device=dev),
               {"select_walk": sims * moves, "backup_paths": sims * moves,
                "int8_tower": (sims + 1) * moves})
    log(f"30b peak {line.get('peak_mb')} MiB against the reckoning "
        f"{line['reckoned_peak_mb']} MiB on {smi}")

    moves = ENV_PARENT_MOVES
    for kind, cap, _ in parent_probe.CONFIGS + parent_probe.EXTRA:
        if kind == "gumbel":
            n = parent_probe.GUMBEL_SIMS * moves
            want = {"gumbel_select_walk": n, "backup_paths": n}
        elif kind == "kleaf4":
            n = parent_probe.SIMS * moves
            want = {"select_walk": n, "backup_paths_vl": n,
                    "backup_paths_finalize": n}
        else:
            n = parent_probe.SIMS * moves
            want = {"select_walk": n, "backup_paths": n}
        line = run("c", f"parent_{kind}_cap{cap}",
                   f"parent_probe {kind}@cap{cap}, {moves} moves",
                   lambda: parent_probe.probe(kind, cap, moves, device=dev),
                   want)
        log(f"30c {kind}@cap{cap}: {line['capped_walks']} capped walks of "
            f"{line['walks']}, deepest path {line['deepest_path']}")

    size, batch = ENV_SMALL_BOARD, ENV_SMALL_BATCH
    env = make_env("gomoku", size)
    puct = ("select_walk", "backup_paths")

    def small_board():
        net_cfg, eval_fn, bundle = ev.make_net(
            "f32", parent_probe.BLOCKS, parent_probe.CHANNELS,
            parent_probe.NET_SEED, board_size=size, device=dev)
        cfg = ev.selfplay_config(batch, ENV_SMALL_SIMS, size * size,
                                 fpu_mode="parent")
        return ev.probe_selfplay(
            env, cfg, ev.make_sides("f32", net_cfg, eval_fn), bundle,
            parent_longrun.SEED_BASE, net_cfg=net_cfg,
            expect=("won", "full_board", "done_root_plies"),
            device=dev).line

    run("d", f"full_games_{size}x{size}", f"games to their end, {size}x{size}"
        f", batch {batch}, parent FPU", small_board, some=puct)
    line = run("e", "longrun_batch",
               f"one parent_longrun batch, 15x15, {ENV_LONGRUN}",
               lambda: parent_longrun.longrun(1, device=dev,
                                              **ENV_LONGRUN)[0],
               some=puct)
    if not (line["won"] > 0 and line["done_root_plies"] > 0):
        raise AssertionError(f"phase 30e: an axis not reached: {line}")
    log(f"envelope probes on {smi}")


def reset_launch_counts():
    gk.reset_launch_counts()
    tk.reset_launch_counts()
    fn.reset_launch_counts()
    t8.reset_launch_counts()
    mr.reset_launch_counts()
    ws.reset_launch_counts()


def launch_counts():
    """Each row's launches: ``backup_paths`` counts its modes apart,
    ``matmul_rate`` its dtypes."""
    modes = tk.backup_paths.mode_launches
    return {"select_walk": tk.select_walk.launches,
            "backup_paths": modes["backup"],
            "backup_paths_vl": modes["vl"],
            "backup_paths_finalize": modes["finalize"],
            "gumbel_select_walk": tk.gumbel_select_walk.launches,
            "fused_tower": fn.fused_tower.launches,
            "int8_tower": t8.int8_tower.launches,
            "matmul_rate_int8": mr.matmul_rate.dtype_launches["int8"],
            "matmul_rate_bf16": mr.matmul_rate.dtype_launches["bf16"],
            "width1_slice_write": ws.width1_slice_write.launches}


def expect_launches(path: str, got, want, some=()):
    """``want`` gives the kernels a path launches and how often, ``some``
    those it launches a number of times the data decides (at least once);
    every other one must launch 0 times."""
    log(f"launches on the {path}: {got}")
    for name, n in got.items():
        if name in some:
            if n < 1:
                raise AssertionError(f"{path}: {name} never launched")
        elif n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")


class CountingEnv:
    """The env with its calls of the game kernels' methods counted."""

    def __init__(self, env):
        self._env = env
        self.calls = dict.fromkeys(GAME_ROWS, 0)

    def __getattr__(self, name):
        method = getattr(self._env, name)
        if name not in GAME_ROWS:
            return method

        def call(*args, **kwargs):
            self.calls[name] += 1
            return method(*args, **kwargs)
        return call


def expect_game_launches(path: str, counted: CountingEnv, rows, key: str):
    """Every call of a game method on ``path`` launched its kernel once
    (the game kernels launch on every path, so ``launch_counts`` and
    ``expect_launches`` leave them out)."""
    want = dict.fromkeys(GAME_ROWS.values(), 0)
    for method, n in counted.calls.items():
        want[GAME_ROWS[method]] += n
    got = gk.launch_counts()
    log(f"game kernel launches on the {path}: {got}; env method calls "
        f"{counted.calls}")
    if got != want or not all(got.values()):
        raise AssertionError(f"{path}: game kernel launches {got}, calls "
                             f"{want}")
    for name, n in got.items():
        rows[name].setdefault("launches_by_path", {})[key] = n


def game_bytes(name: str, env, batch: int) -> int:
    """The bytes a game kernel must move: each input read once, each output
    written once (int32 scalars, bool flags, int8 boards)."""
    cells = env.num_actions
    pente = env.name == "pente"
    scalars = batch * (4 * 4 + 1 + (8 if pente else 0))   # a state's
    if name in ("step", "step_safe"):
        return 2 * (batch * cells + scalars) + 4 * batch
    if name == "encode":
        return (batch * (cells + 4 + (8 if env.obs_channels == 5 else 0))
                + 4 * batch * cells * env.obs_channels)
    if name == "legal_mask":
        return 2 * batch * cells + batch
    return 8 * batch                                      # terminal_value


def host_us(fn, calls: int = 400) -> float:
    """The host's microseconds a call of ``fn()``, the card keeping up (a
    game kernel's device time is below a wrapper call's host time)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def game_phases(args, dev, rows):
    """Phase 2c: the four game kernels against the env's plain methods at
    the cells' shapes (15x15 Gomoku at 3 planes, Pente at 3 and 5; 128
    lanes) and at 1024 lanes, on positions of 40 random plies (played by
    the plain methods): every output bit for bit, then the times (CUDA-graph
    replay of 50 calls, one eager call, the host's microseconds a wrapper
    call, the plain version), the byte bound and the floor (an empty
    kernel's replay)."""
    with Phase("2c game kernels against the env's plain methods (15x15; "
               "128 and 1024 lanes)"):
        empty = lf.empty_ms()
        gen = phase_gen(args.seed, 2, dev)
        for game, planes in (("gomoku", 3), ("pente", 3), ("pente", 5)):
            env = make_env(game, BOARD, capture_planes=planes == 5)
            for batch in (128, 1024):
                states = env.init_batch(batch, dev)
                for _ in range(40):
                    legal = env.legal_mask_plain(states)
                    u = torch.rand(legal.shape, generator=gen, device=dev)
                    states = env.step_safe_plain(states, torch.argmax(
                        torch.where(legal, u, -1.0), dim=1))
                legal = env.legal_mask_plain(states)
                u = torch.rand(legal.shape, generator=gen, device=dev)
                action = torch.argmax(torch.where(legal, u, -1.0), dim=1)
                done = int(states.done.sum())
                for method, row in GAME_ROWS.items():
                    args_ = (action,) if method.startswith("step") else ()
                    kernel = getattr(env, method)
                    plain = getattr(env, method + "_plain")
                    got, want = kernel(states, *args_), plain(states, *args_)
                    for g, w in zip(*((got, want) if isinstance(got, tuple)
                                      else ((got,), (want,)))):
                        if not (g.dtype == w.dtype and torch.equal(g, w)):
                            raise AssertionError(
                                f"{game} {planes} planes {method}: kernel "
                                f"!= plain (tolerance 0)")

                    def call(kernel=kernel, args_=args_):
                        return kernel(states, *args_)

                    t = dict(ms=graph_ms(call, 50), eager_ms=cuda_ms(call, 50),
                             host_us=host_us(call),
                             plain_ms=cuda_ms(lambda plain=plain, args_=args_:
                                              plain(states, *args_), reps=20,
                                              warmup=2),
                             plain_host_us=host_us(
                                 lambda plain=plain, args_=args_:
                                 plain(states, *args_), calls=50),
                             bound_ms=game_bytes(method, env, batch)
                             / HBM_BYTES_PER_S * 1e3,
                             floor_ms=empty)
                    rows[row][f"{game}{planes}_b{batch}"
                              + ("_safe" if method == "step_safe" else "")] = t
                    log(f"{method} {game} {planes} planes, {batch} lanes "
                        f"({done} done): kernel == plain, tolerance 0; kernel "
                        f"{t['ms']:.4f} ms (CUDA graph replay; eager call "
                        f"{t['eager_ms']:.4f} ms; host {t['host_us']:.1f} us "
                        f"a call), plain {t['plain_ms']:.4f} ms (host "
                        f"{t['plain_host_us']:.1f} us a call), bound "
                        f"{t['bound_ms']:.6f} ms (bytes), floor "
                        f"{empty:.4f} ms")


def gumbel_phases(args, env, net_cfg, weights, net, dev, rows, smi):
    """Phases 6-10: the Gumbel path's kernels, search and self-play."""
    params, stats = weights
    folded = fn.fold_bn(net_cfg, params, stats, device=dev)
    fused_eval = fn.make_fused_eval_fn(net_cfg)
    _, phases = halving_schedule(GUMBEL_SIMS, GUMBEL_M)
    rounds = sum(visits for _, visits in phases)

    layout = tk.packed_layout(env.num_actions, GUMBEL_MCTS.node_capacity)
    depth = GUMBEL_MCTS.depth_limit
    cv, cs = GUMBEL_MCTS.gumbel_c_visit, GUMBEL_MCTS.gumbel_c_scale
    with Phase(f"6 gumbel_select_walk against its plain version (batch "
               f"{BATCH}, fan 1 and {FAN}, {layout.n_nodes} nodes, depth cap "
               f"{depth}), on a tree of {GUMBEL_SIMS} simulations and on the "
               f"tree carried with reuse budget {REUSE_BUDGET} over "
               f"{REUSE_MOVES} moves as its last simulation walks it"):
        floor = latency_floor()
        gen = phase_gen(args.seed, 6, dev)
        states = random_states(env, BATCH, 4, gen, dev)
        tree = run_gumbel_packed_with_tree(env, GUMBEL_MCTS, fused_eval,
                                           folded, states, gen)[3].packed
        log(f"grew the tree: Gumbel@{GUMBEL_SIMS} m={GUMBEL_M}, packed "
            f"{tuple(tree.shape)}")
        legal = tree[:, tk.SL_P, :layout.num_actions] >= 0
        u = torch.rand(legal.shape, generator=gen, device=dev)
        order = torch.argsort(torch.where(legal, u, -1.0), dim=1,
                              descending=True)
        for fan in (1, FAN):
            # distinct legal root actions per tree, as one halving round has
            root = order[:, :fan].reshape(-1).int().contiguous()
            row = hold_gumbel(tree, root, layout, depth, cv, cs, fan, floor)
            if fan == 1:
                rows["gumbel_select_walk"].update(row, library_ms=None)
            else:
                rows["gumbel_select_walk"][f"fan{FAN}"] = row
        del tree

        reuse = dataclasses.replace(GUMBEL_MCTS, reuse_budget=REUSE_BUDGET)
        last = LastWalk(GUMBEL_SIMS)
        carry = init_packed_carry(env, reuse, states)
        for move in range(REUSE_MOVES):
            ops = (tk.TreeOps(tk.select_walk, tk.backup_paths, last)
                   if move == REUSE_MOVES - 1 else tk.KERNELS)
            _, _, act, carry = run_gumbel_packed_with_tree(
                env, reuse, fused_eval, folded, states, gen, ops=ops,
                carry=carry)
            if move < REUSE_MOVES - 1:
                act = torch.where(states.done, 0, act)
                carry = packed_advance_root(env, reuse, carry, act)
                states = env.step_safe(states, act)
        tree, root = last.kept
        log(f"carried the tree: Gumbel@{GUMBEL_SIMS} m={GUMBEL_M} with reuse "
            f"budget {REUSE_BUDGET}, {REUSE_MOVES} searches with "
            f"packed_advance_root between them; the last search's "
            f"{GUMBEL_SIMS}th walk, packed {tuple(tree.shape)}")
        rows["gumbel_select_walk"][f"reuse{REUSE_BUDGET}"] = hold_gumbel(
            tree, root, tk.packed_layout(env.num_actions, reuse.node_capacity),
            reuse.depth_limit, cv, cs, 1, floor)
        log("no single PyTorch call computes the walk, so library_ms is null")
        del tree, carry

    with Phase(f"7 fused_tower against its plain version (batch {BATCH}, "
               f"6x128, {BOARD}x{BOARD}, bf16 inputs, fp32 sums)"):
        obs = env.encode(random_states(env, BATCH, 30,
                                       phase_gen(args.seed, 7, dev), dev))
        tower = fn.fused_tower(folded, obs)
        tower_plain = fn.fused_tower_plain(folded, obs)
        logits, value = fn.fused_predict(net_cfg, folded, obs)
        plain_logits, plain_value = fn.folded_apply_plain(net_cfg, folded,
                                                          obs)
        errs = {"tower": float((tower - tower_plain).abs().max()),
                "logits": float((logits - plain_logits).abs().max()),
                "value": float((value - plain_value).abs().max())}
        step = 2.0 ** -8 * float(tower_plain.abs().max())
        with torch.no_grad():
            tower_f64 = fn.fused_tower_plain(folded, obs, torch.float64)
        f64_logits, f64_value = fn.folded_apply_plain(net_cfg, folded, obs,
                                                      torch.float64)
        f64_errs = {"tower": float((tower_plain - tower_f64).abs().max()),
                    "logits": float((plain_logits - f64_logits).abs().max()),
                    "value": float((plain_value - f64_value).abs().max())}
        k64_errs = {"tower": float((tower - tower_f64).abs().max()),
                    "logits": float((logits - f64_logits).abs().max()),
                    "value": float((value - f64_value).abs().max())}
        log(f"fused_tower: max abs err against plain {errs}, "
            f"{errs['tower'] / step:.3f} bf16 steps of the tower's largest "
            f"value ({float(tower_plain.abs().max()):.3f}); tolerance "
            f"{FUSED_TOWER_STEPS} steps.  Against float64 sums: the plain "
            f"version {f64_errs}, {f64_errs['tower'] / step:.3f} steps; the "
            f"kernel {k64_errs}, {k64_errs['tower'] / step:.3f} steps")
        if not errs["tower"] <= FUSED_TOWER_STEPS * step:
            raise AssertionError(f"fused_tower: max abs err {errs['tower']} > "
                                 f"{FUSED_TOWER_STEPS} bf16 steps ({step})")
        if not torch.equal(fn.fused_tower(folded, obs), tower):
            raise AssertionError("fused_tower is not deterministic")
        with torch.no_grad():
            ref_logits, ref_value = net(obs)
        p_err = float((torch.softmax(logits, -1)
                       - torch.softmax(ref_logits, -1)).abs().max())
        v_err = float((value - ref_value).abs().max())
        log(f"fused net against the float32 ResNet: probabilities max abs "
            f"err {p_err}, value {v_err} (tolerance {BF16_VS_F32_TOL})")
        if not (p_err <= BF16_VS_F32_TOL and v_err <= BF16_VS_F32_TOL):
            raise AssertionError("fused net too far from the float32 ResNet")

        ms = cuda_ms(lambda: fn.fused_tower(folded, obs), reps=20)
        plain_ms = cuda_ms(lambda: fn.fused_tower_plain(folded, obs),
                           reps=5, warmup=1)
        xla = fn.fold_bn_xla(net_cfg, params, stats, device=dev)
        with torch.no_grad():
            library_ms = cuda_ms(lambda: fn.folded_xla_tower(xla, obs),
                                 reps=20)
        bound_ms, bound_by = tower_bound(net_cfg, BATCH)
        tflops = tower_flops(net_cfg, BATCH) / ms / 1e9
        rows["fused_tower"].update(max_abs_err=errs["logits"], ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=library_ms,
                                   max_abs_err_value=errs["value"],
                                   max_abs_err_tower=errs["tower"])
        log(f"fused_tower: kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, library (folded_xla_tower: im2col and a "
            f"bf16 mm with float32 output per conv) "
            f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")

    with Phase(f"8 Gumbel search, kernels against plain (batch {PI_BATCH}, "
               f"Gumbel@{GUMBEL_SIMS} m={GUMBEL_M}, fused eval)"):
        states = random_states(env, PI_BATCH, 6, phase_gen(args.seed, 8, dev),
                               dev)
        out = {}
        for label, ops in (("kernels", tk.KERNELS), ("plain", tk.PLAIN)):
            g = phase_gen(args.seed, 108, dev)
            out[label] = run_gumbel_mcts(env, GUMBEL_MCTS, fused_eval, folded,
                                         states, g, ops=ops)
        for name, k, p in zip(("pi_target", "root_q", "action"),
                              out["kernels"], out["plain"]):
            if not torch.equal(k, p):
                raise AssertionError(f"Gumbel search {name}: kernels != "
                                     f"plain")
        log(f"Gumbel search: actions, pi_target and root_q equal exactly "
            f"over {PI_BATCH} lanes")

    with Phase(f"8b C6: a Gumbel@{GUMBEL_SIMS} m={GUMBEL_M} search (batch "
               f"{BATCH}) on fused_tower, on fused_tower_plain and on the "
               f"plain tower with float64 sums, the same states and "
               f"generator: root actions that differ, and that each shares "
               f"with float64"):
        states = random_states(env, BATCH, 6, phase_gen(args.seed, 208, dev),
                               dev)

        def plain_eval(sum_dtype):
            def eval_fn(bundle, obs):
                logits, value = fn.folded_apply_plain(net_cfg, bundle, obs,
                                                      sum_dtype)
                return torch.softmax(logits, dim=-1), value
            return eval_fn

        out = {}
        for label, eval_fn in (("fused_tower", fused_eval),
                               ("fused_tower_plain",
                                plain_eval(torch.float32)),
                               ("float64", plain_eval(torch.float64))):
            g = phase_gen(args.seed, 308, dev)
            out[label] = run_gumbel_mcts(env, GUMBEL_MCTS, eval_fn, folded,
                                         states, g)
        kern, plain, f64 = (out[k][2] for k in ("fused_tower",
                                                "fused_tower_plain",
                                                "float64"))
        c6 = dict(root_actions_differ=int((kern != plain).sum()),
                  kernel_shares_with_float64=int((kern == f64).sum()),
                  plain_shares_with_float64=int((plain == f64).sum()))
        pi_err = float((out["fused_tower"][0]
                        - out["fused_tower_plain"][0]).abs().max())
        rows["fused_tower"]["c6"] = c6
        log(f"C6: {c6['root_actions_differ']} of {BATCH} root actions differ "
            f"between the search on fused_tower and on fused_tower_plain "
            f"(pi_target max abs difference {pi_err}); the search on the "
            f"float64 tower shares {c6['kernel_shares_with_float64']} of "
            f"{BATCH} with fused_tower's and "
            f"{c6['plain_shares_with_float64']} with fused_tower_plain's; a "
            f"measurement, no tolerance")

    sp_cfg = SelfPlayConfig(batch_games=BATCH, mcts=GUMBEL_MCTS,
                            max_moves=MOVES)
    gen = phase_gen(args.seed, 9, dev)
    with Phase(f"9a Gumbel main path warm-up (batch {BATCH}, 1 move)"):
        play_games(env, dataclasses.replace(sp_cfg, max_moves=1), fused_eval,
                   folded, gen, dev)

    with Phase(f"9b Gumbel main path: play_games batch {BATCH}, 6x128 fused "
               f"bf16, {BOARD}x{BOARD}, Gumbel@{GUMBEL_SIMS} m={GUMBEL_M}, "
               f"{MOVES} moves"):
        reset_launch_counts()
        counted = CountingEnv(env)
        t0 = time.perf_counter()
        traj = play_games(counted, sp_cfg, fused_eval, folded, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        expect_game_launches("Gumbel reuse main path", counted, rows,
                             "gumbel64_reuse48")
        moves_done = int(torch.clamp(traj.moves_played, max=MOVES).sum())
        log(f"Gumbel main path: {moves_done} moves in {seconds:.3f} s = "
            f"{moves_done / seconds:.2f} moves/s (batch {BATCH}, 6x128 fused "
            f"bf16, Gumbel@{GUMBEL_SIMS}, {BOARD}x{BOARD}) on {smi}")
        expect_launches("Gumbel main path", launches, {
            "gumbel_select_walk": MOVES * GUMBEL_SIMS,
            "backup_paths": MOVES * GUMBEL_SIMS,
            "fused_tower": MOVES * (1 + GUMBEL_SIMS), "select_walk": 0,
            "int8_tower": 0})
        for name in ("gumbel_select_walk", "fused_tower"):
            rows[name]["launches"] = launches[name]
        for name, n in launches.items():
            rows[name]["launches_by_path"]["gumbel64"] = n
        check_trajectories(env, traj, MOVES)

    par = dataclasses.replace(
        sp_cfg, max_moves=PARALLEL_MOVES,
        mcts=dataclasses.replace(GUMBEL_MCTS, gumbel_round_parallel=True))
    with Phase(f"10 round-parallel Gumbel: play_games batch {BATCH}, "
               f"{PARALLEL_MOVES} moves, {rounds} rounds a move"):
        gen = phase_gen(args.seed, 10, dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        traj = play_games(env, par, fused_eval, folded, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        moves_done = int(torch.clamp(traj.moves_played,
                                     max=PARALLEL_MOVES).sum())
        log(f"round-parallel Gumbel: {moves_done} moves in {seconds:.3f} s = "
            f"{moves_done / seconds:.2f} moves/s (first move's compile "
            f"and cuDNN set-up at the larger batches included)")
        expect_launches("round-parallel Gumbel path", launch_counts(), {
            "gumbel_select_walk": PARALLEL_MOVES * rounds,
            "backup_paths": PARALLEL_MOVES * GUMBEL_SIMS,
            "fused_tower": PARALLEL_MOVES * (1 + rounds), "select_walk": 0,
            "int8_tower": 0})
        check_trajectories(env, traj, PARALLEL_MOVES)
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")


def int8_phases(args, env, net_cfg, weights, net, dev, rows, smi):
    """Phases 11-14: the int8 net, the int8 tower kernel against its plain
    version and ``int8_apply``, a search on it, and PUCT@400 self-play on
    it."""
    params, stats = weights
    with Phase("11 quantize the 6x128 net (random_calib_obs boards, "
               "residual f32) and hold it against the float32 ResNet"):
        q = q8.quantize_int8(net_cfg, params, stats,
                             q8.random_calib_obs(net_cfg), device=dev)
        packed = t8.pack_tower_bundle(net_cfg, q)
        obs = env.encode(random_states(env, BATCH, 30,
                                       phase_gen(args.seed, 11, dev), dev))
        logits, value = q8.int8_apply(net_cfg, q, obs)
        with torch.no_grad():
            ref_logits, ref_value = net(obs)
        corr = {"tower": correlation(q8.int8_tower_mm(q, obs),
                                     resnet_tower(net, obs)),
                "logits": correlation(logits, ref_logits),
                "value": correlation(value, ref_value)}
        v_err = (value - ref_value).abs()
        zero = int((ref_logits.abs().amax(dim=1) == 0).sum())
        log(f"int8 net against the float32 ResNet: correlation {corr} (the "
            f"float32 logits are all 0 on {zero} of {BATCH} boards; logit std "
            f"{float(ref_logits.std()):.4f}, value in "
            f"[{float(ref_value.min()):.4f}, {float(ref_value.max()):.4f}]), "
            f"value abs err max {float(v_err.max())} mean "
            f"{float(v_err.mean())}; bounds {INT8_VS_F32}")
        if not (corr["logits"] > INT8_VS_F32["logit_corr"]
                and corr["value"] > INT8_VS_F32["value_corr"]):
            raise AssertionError("int8 net too far from the float32 ResNet")

    with Phase(f"12 int8_tower against its plain version and int8_apply "
               f"(batch {BATCH} and {KLEAF * BATCH}, 6x128, {BOARD}x{BOARD}, "
               f"tolerance 0)"):
        tower = t8.int8_tower(packed, obs)
        tower_plain = t8.int8_tower_plain(packed, obs)
        tower_mm = q8.int8_tower_mm(q, obs)
        k_logits, k_value = t8.int8_tower_apply(net_cfg, packed, obs)
        p_logits, p_value = q8.int8_heads(net_cfg, packed, tower_plain)
        errs = {"tower": max_abs_err([tower], [tower_plain]),
                "tower_vs_int8_apply": max_abs_err([tower], [tower_mm]),
                "logits": max_abs_err([k_logits], [p_logits]),
                "value": max_abs_err([k_value], [p_value]),
                "logits_vs_int8_apply": max_abs_err([k_logits], [logits]),
                "value_vs_int8_apply": max_abs_err([k_value], [value])}
        log(f"int8_tower: max abs err {errs} (tower values up to "
            f"{float(tower_plain.abs().max()):.3f}); tolerance 0")
        for name, got, want in (
                ("tower", tower, tower_plain), ("tower", tower, tower_mm),
                ("logits", k_logits, p_logits), ("value", k_value, p_value),
                ("logits", k_logits, logits), ("value", k_value, value)):
            if not torch.equal(got, want):
                raise AssertionError(f"int8_tower {name}: kernel differs "
                                     f"(tolerance 0)")
        if not torch.equal(t8.int8_tower(packed, obs), tower):
            raise AssertionError("int8_tower is not deterministic")

        ms = cuda_ms(lambda: t8.int8_tower(packed, obs), reps=20)
        plain_ms = cuda_ms(lambda: t8.int8_tower_plain(packed, obs), reps=3,
                           warmup=1)
        library_ms = cuda_ms(lambda: q8.int8_tower_mm(q, obs), reps=20)
        bound_ms, bound_by = int8_tower_bound(net_cfg, BATCH)
        tops = tower_flops(net_cfg, BATCH) / ms / 1e9
        rows["int8_tower"].update(max_abs_err=errs["logits"], ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=library_ms,
                                  max_abs_err_value=errs["value"])
        log(f"int8_tower: kernel {ms:.4f} ms ({tops:.1f} TOP/s int8), plain "
            f"{plain_ms:.4f} ms, library (int8_tower_mm: im2col + "
            f"torch._int_mm per conv) {library_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by})")

        # the k-leaf path's shape: KLEAF leaves of each of BATCH games
        big = KLEAF * BATCH
        obs_big = env.encode(random_states(env, big, 30,
                                           phase_gen(args.seed, 212, dev),
                                           dev))
        tower_big = t8.int8_tower(packed, obs_big)
        for name, want in (("int8_tower_plain",
                            t8.int8_tower_plain(packed, obs_big)),
                           ("int8_tower_mm", q8.int8_tower_mm(q, obs_big))):
            if not torch.equal(tower_big, want):
                raise AssertionError(f"int8_tower at {big} boards differs "
                                     f"from {name} (tolerance 0)")
        big_ms = cuda_ms(lambda: t8.int8_tower(packed, obs_big), reps=10)
        big_bound, big_by = int8_tower_bound(net_cfg, big)
        big_tops = tower_flops(net_cfg, big) / big_ms / 1e9
        rows["int8_tower"].update(boards_kleaf=big, ms_kleaf=big_ms,
                                  bound_ms_kleaf=big_bound)
        log(f"int8_tower at {big} boards (the k-leaf shape): == plain and "
            f"int8_tower_mm, tolerance 0; kernel {big_ms:.4f} ms "
            f"({big_tops:.1f} TOP/s int8), bound {big_bound:.6f} ms "
            f"({big_by})")

    tower_eval = t8.make_int8_tower_eval_fn(net_cfg)
    with Phase(f"13 PUCT search on int8_tower against the same search on "
               f"int8_apply (batch {PI_BATCH}, {PI_SIMS} sims, 6x128)"):
        cfg64 = dataclasses.replace(MAIN_MCTS, n_simulations=PI_SIMS)
        states = random_states(env, PI_BATCH, 6,
                               phase_gen(args.seed, 13, dev), dev)
        moves = torch.full((PI_BATCH,), 6, dtype=torch.int32, device=dev)
        out = {}
        for label, eval_fn, bundle in (
                ("int8_tower", tower_eval, packed),
                ("int8_apply", q8.make_int8_eval_fn(net_cfg), q)):
            g = phase_gen(args.seed, 113, dev)
            out[label] = run_mcts_packed(env, cfg64, eval_fn, bundle, states,
                                         moves, g)
        for name, k, p in zip(("pi", "root_q"), out["int8_tower"],
                              out["int8_apply"]):
            if not torch.equal(k, p):
                raise AssertionError(f"search {name}: int8_tower != "
                                     f"int8_apply")
        if not torch.equal(out["int8_tower"][0].argmax(dim=1),
                           out["int8_apply"][0].argmax(dim=1)):
            raise AssertionError("search actions: int8_tower != int8_apply")
        log(f"search on int8_tower == search on int8_apply exactly over "
            f"{PI_BATCH} lanes (pi, root_q, greedy actions)")

    sp_cfg = SelfPlayConfig(batch_games=BATCH, mcts=MAIN_MCTS,
                            temp_threshold=10, max_moves=MOVES)
    gen = phase_gen(args.seed, 14, dev)
    with Phase(f"14a int8 main path warm-up (batch {BATCH}, 1 move, 8 sims)"):
        warm = dataclasses.replace(
            sp_cfg, max_moves=1,
            mcts=dataclasses.replace(MAIN_MCTS, n_simulations=8))
        play_games(env, warm, tower_eval, packed, gen, dev)

    with Phase(f"14b int8 main path: play_games batch {BATCH}, 6x128 int8 "
               f"tower, {BOARD}x{BOARD}, PUCT@{SIMS}, {MOVES} moves"):
        reset_launch_counts()
        counted = CountingEnv(env)
        t0 = time.perf_counter()
        traj = play_games(counted, sp_cfg, tower_eval, packed, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        expect_game_launches("Pente PUCT main path", counted, rows,
                             f"pente_puct{SIMS}_b{PENTE_BATCH}")
        moves_done = int(torch.clamp(traj.moves_played, max=MOVES).sum())
        log(f"int8 main path: {moves_done} moves in {seconds:.3f} s = "
            f"{moves_done / seconds:.2f} moves/s (batch {BATCH}, 6x128 int8 "
            f"tower, PUCT@{SIMS}, {BOARD}x{BOARD}) on {smi}")
        expect_launches("int8 PUCT main path", launches, {
            "select_walk": MOVES * SIMS, "backup_paths": MOVES * SIMS,
            "int8_tower": MOVES * (1 + SIMS), "gumbel_select_walk": 0,
            "fused_tower": 0})
        for name in ("select_walk", "backup_paths", "int8_tower"):
            rows[name]["launches"] = launches[name]
        for name, n in launches.items():
            rows[name]["launches_by_path"]["int8t_puct400"] = n
        check_trajectories(env, traj, MOVES)
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")
    return (tower_eval, packed), moves_done / seconds


def extension_phases(args, env, net_cfg, weights, net, dev, rows, smi,
                     int8_bundle, int8_rate):
    """Phases 15-18: ``backup_paths`` modes ``"vl"`` and ``"finalize"``
    against their plain versions, the k-leaf and reuse searches on the
    kernels against the plain versions, and self-play on both paths."""
    eval_fn = make_eval_fn()
    kleaf = dataclasses.replace(MAIN_MCTS, leaves_per_sim=KLEAF)
    grow = dataclasses.replace(kleaf, n_simulations=GROW_SIMS,
                               max_nodes=MAIN_MCTS.node_capacity)
    layout = tk.packed_layout(env.num_actions, grow.node_capacity)
    depth = grow.depth_limit
    with Phase(f"15 backup_paths modes vl and finalize against their plain "
               f"versions (batch {BATCH}, trees of {GROW_SIMS} and "
               f"{SIMS - KLEAF} k-leaf sims, k={KLEAF}, {layout.n_nodes} "
               f"nodes)"):
        floor = latency_floor()
        gen = phase_gen(args.seed, 15, dev)
        states = random_states(env, BATCH, 4, gen, dev)
        moves = torch.full((BATCH,), 4, dtype=torch.int32, device=dev)
        # GROW_SIMS, and PUCT@400 k-leaf's own tree at its last macro step
        for sims in (GROW_SIMS, SIMS - KLEAF):
            cfg = dataclasses.replace(grow, n_simulations=sims)
            tree = run_mcts_packed_with_tree(env, cfg, eval_fn, net, states,
                                             moves, gen)[2].packed
            _, action, pnodes, pacts, plen = tk.select_walk(
                tree, layout, grow.cpuct, depth)
            expanding = action >= 0
            slot = sims + 1
            legal = torch.rand((BATCH, env.num_actions), generator=gen,
                               device=dev) < 0.9
            placeholder = torch.where(
                legal, 1.0 / legal.sum(dim=1, keepdim=True), -1.0)
            priors = torch.where(legal, torch.rand(legal.shape, generator=gen,
                                                   device=dev), -1.0)
            values = torch.rand(BATCH, generator=gen, device=dev) * 2 - 1
            done = torch.rand(BATCH, generator=gen, device=dev) < 0.1
            zeros = torch.zeros(BATCH, device=dev)
            mode_args = {
                "vl": (pnodes, pacts, plen, zeros, expanding, slot, layout,
                       placeholder, done),
                "finalize": (pnodes, pacts, plen, values, expanding, slot,
                             layout, priors, done)}
            for mode, bargs in mode_args.items():
                # finalize reads the tile vl left: the macro step's order
                tree, row = hold_backup(tree, bargs, mode, floor)
                if sims == GROW_SIMS:
                    rows[f"backup_paths_{mode}"].update(row, library_ms=None)
                else:
                    rows[f"backup_paths_{mode}"][f"tree{SIMS}"] = row
            del tree
        log("no single PyTorch call computes the backup, so library_ms is "
            "null")

    params, stats = weights
    folded = fn.fold_bn(net_cfg, params, stats, device=dev)
    fused_eval = fn.make_fused_eval_fn(net_cfg)
    with Phase(f"16 k-leaf and reuse searches, kernels against plain (batch "
               f"{PI_BATCH}, {PI_SIMS} sims, k={KLEAF}; {REUSE_MOVES} moves "
               f"with reuse budget {REUSE_BUDGET}; cudnn deterministic)"):
        torch.backends.cudnn.deterministic = True
        states = random_states(env, PI_BATCH, 6,
                               phase_gen(args.seed, 16, dev), dev)
        moves = torch.full((PI_BATCH,), 6, dtype=torch.int32, device=dev)
        cfg = dataclasses.replace(kleaf, n_simulations=PI_SIMS)
        out = {}
        for label, ops in (("kernels", tk.KERNELS), ("plain", tk.PLAIN)):
            g = phase_gen(args.seed, 116, dev)
            pi, q, tree = run_mcts_packed_with_tree(
                env, cfg, eval_fn, net, states, moves, g, ops=ops)
            out[label] = (pi, q, tree.packed)
        for name, k, p in zip(("pi", "root_q", "packed tree"),
                              out["kernels"], out["plain"]):
            if not torch.equal(k, p):
                raise AssertionError(f"k-leaf search {name}: kernels != plain")
        log(f"k-leaf search (k={KLEAF}): pi, root_q and the packed tree equal "
            f"exactly over {PI_BATCH} lanes")
        puct = dataclasses.replace(MAIN_MCTS, n_simulations=PI_SIMS,
                                   reuse_budget=REUSE_BUDGET)
        gumbel = dataclasses.replace(GUMBEL_MCTS, reuse_budget=REUSE_BUDGET)
        for label, cfg, ev, bundle in (
                ("PUCT", puct, eval_fn, net),
                ("Gumbel serial", gumbel, fused_eval, folded),
                ("Gumbel round-parallel",
                 dataclasses.replace(gumbel, gumbel_round_parallel=True),
                 fused_eval, folded)):
            traces = [reuse_trace(env, cfg, ev, bundle, states, moves,
                                  phase_gen(args.seed, 216, dev), ops)
                      for ops in (tk.KERNELS, tk.PLAIN)]
            for i, (k, p) in enumerate(zip(*traces)):
                if not torch.equal(k, p):
                    raise AssertionError(f"{label} reuse search: kernels != "
                                         f"plain at output {i}")
            log(f"{label} with reuse over {REUSE_MOVES} moves: pi, root_q, "
                f"actions and every carry field after each search and "
                f"advance equal exactly over {PI_BATCH} lanes")
        torch.backends.cudnn.deterministic = False

    tower_eval, packed = int8_bundle
    sp_cfg = SelfPlayConfig(batch_games=BATCH, mcts=kleaf, temp_threshold=10,
                            max_moves=MOVES)
    gen = phase_gen(args.seed, 17, dev)
    macro = SIMS // KLEAF
    with Phase(f"17a k-leaf main path warm-up (batch {BATCH}, 1 move, 8 sims)"):
        warm = dataclasses.replace(
            sp_cfg, max_moves=1,
            mcts=dataclasses.replace(kleaf, n_simulations=8))
        play_games(env, warm, tower_eval, packed, gen, dev)

    with Phase(f"17b k-leaf main path: play_games batch {BATCH}, 6x128 int8 "
               f"tower, {BOARD}x{BOARD}, PUCT@{SIMS} k={KLEAF} ({macro} "
               f"network calls of {KLEAF * BATCH} boards a move), {MOVES} "
               f"moves"):
        reset_launch_counts()
        t0 = time.perf_counter()
        traj = play_games(env, sp_cfg, tower_eval, packed, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        moves_done = int(torch.clamp(traj.moves_played, max=MOVES).sum())
        log(f"k-leaf main path: {moves_done} moves in {seconds:.3f} s = "
            f"{moves_done / seconds:.2f} moves/s (batch {BATCH}, 6x128 int8 "
            f"tower, PUCT@{SIMS} k={KLEAF}, {BOARD}x{BOARD}) on {smi}; "
            f"k=1 in this run: {int8_rate:.2f} moves/s")
        expect_launches("k-leaf int8 PUCT main path", launches, {
            "select_walk": MOVES * SIMS, "backup_paths_vl": MOVES * SIMS,
            "backup_paths_finalize": MOVES * SIMS,
            "int8_tower": MOVES * (1 + macro)})
        for name in ("backup_paths_vl", "backup_paths_finalize"):
            rows[name]["launches"] = launches[name]
        for name, n in launches.items():
            rows[name]["launches_by_path"]["int8t_puct400_kleaf4"] = n
        check_trajectories(env, traj, MOVES)

    sp_cfg = SelfPlayConfig(batch_games=BATCH, mcts=gumbel, max_moves=MOVES)
    gen = phase_gen(args.seed, 18, dev)
    with Phase(f"18a reuse main path warm-up (batch {BATCH}, 1 move)"):
        play_games(env, dataclasses.replace(sp_cfg, max_moves=1), fused_eval,
                   folded, gen, dev)

    with Phase(f"18b reuse main path: play_games batch {BATCH}, 6x128 fused "
               f"bf16, {BOARD}x{BOARD}, Gumbel@{GUMBEL_SIMS} m={GUMBEL_M}, "
               f"reuse budget {REUSE_BUDGET}, {MOVES} moves"):
        reset_launch_counts()
        t0 = time.perf_counter()
        traj = play_games(env, sp_cfg, fused_eval, folded, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        moves_done = int(torch.clamp(traj.moves_played, max=MOVES).sum())
        log(f"reuse main path: {moves_done} moves in {seconds:.3f} s = "
            f"{moves_done / seconds:.2f} moves/s (batch {BATCH}, 6x128 fused "
            f"bf16, Gumbel@{GUMBEL_SIMS} m={GUMBEL_M}, reuse "
            f"{REUSE_BUDGET}, {BOARD}x{BOARD}) on {smi}")
        expect_launches("Gumbel reuse main path", launches, {
            "gumbel_select_walk": MOVES * GUMBEL_SIMS,
            "backup_paths": MOVES * GUMBEL_SIMS,
            "fused_tower": MOVES * (1 + GUMBEL_SIMS)})
        for name, n in launches.items():
            rows[name]["launches_by_path"]["gumbel64_reuse48"] = n
        check_trajectories(env, traj, MOVES)
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")


def probe_phases(args, net_cfg, dev, rows, smi):
    """Phases 19-20: the rate probe and the slice-write repro, each kernel
    against its plain version, then each entry point's work with the launch
    counts read around it."""
    with Phase(f"19a matmul_rate against its plain version (M "
               f"{mr.ROW_COUNTS}, (k, reps) {mr.SHAPES}, 2 steps; int8 and "
               f"integer bf16 tolerance 0, bf16 within "
               f"{mr.BF16_REL_TOL} of sum |x*w|)"):
        gen = phase_gen(args.seed, 19, dev)
        errs = dict.fromkeys(("int8", "bf16_integer", "bf16",
                              "bf16_share_of_tolerance"), 0.0)
        for m in mr.ROW_COUNTS:
            for k, reps in mr.SHAPES:
                inputs = mr.make_inputs(m, k, reps, gen, dev)
                xi, wi = inputs["int8"]
                xb, wb = inputs["bf16"]
                for label, x, w in (
                        ("int8", xi, wi),
                        ("bf16_integer", xi.to(torch.bfloat16),
                         wi.to(torch.bfloat16))):
                    err = max_abs_err([mr.matmul_rate(x, w, reps, 2)],
                                      [mr.matmul_rate_plain(x, w, reps, 2)])
                    errs[label] = max(errs[label], err)
                    if not err == 0.0:
                        raise AssertionError(f"matmul_rate {label} M {m} k "
                                             f"{k}: max abs err {err} "
                                             f"(tolerance 0)")
                err = (mr.matmul_rate(xb, wb, reps, 2).double()
                       - mr.matmul_rate_plain(xb, wb, reps, 2).double()).abs()
                share = float((err / mr.bf16_bound(xb, wb, reps)).max())
                if not share <= 1.0:
                    raise AssertionError(f"matmul_rate bf16 M {m} k {k}: "
                                         f"{share} of the tolerance")
                errs["bf16"] = max(errs["bf16"], float(err.max()))
                errs["bf16_share_of_tolerance"] = max(
                    errs["bf16_share_of_tolerance"], share)
                log(f"matmul_rate M {m} k {k} reps {reps}: int8 and integer "
                    f"bf16 == plain (max abs err {errs['int8']}, "
                    f"{errs['bf16_integer']}); bf16 max abs err "
                    f"{float(err.max())}, {share} of the tolerance")
        # the per-step times beside the rates, at the towers' GEMM shape
        m, (k, reps) = mr.M_CARD, mr.SHAPES[0]
        inputs = mr.make_inputs(m, k, reps, gen, dev)
        step_ms = {}
        for name, (x, w) in inputs.items():
            eager_ms = cuda_ms(lambda x=x, w=w: mr.matmul_rate(x, w, reps, 1),
                               reps=20)
            plain_ms = cuda_ms(lambda x=x, w=w: mr.matmul_rate_plain(
                x, w, reps, 1), reps=3, warmup=1)
            step_ms[name] = (eager_ms, plain_ms)
            log(f"matmul_rate {name} M {m} k {k} reps {reps}, one step: "
                f"eager wrapper call {eager_ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms")
        del inputs

    with Phase(f"19b rate probe path: tools.matmul_rate.measure, "
               f"{len(mr.ROW_COUNTS) * len(mr.SHAPES)} shapes x (kernel, "
               f"library) x (int8, bf16), steps {mr.HI} and {mr.LO}"):
        reset_launch_counts()
        results = mr.measure(dev)
        torch.cuda.synchronize()
        launches = launch_counts()
        shapes = len(mr.ROW_COUNTS) * len(mr.SHAPES)
        expect_launches("rate probe path", launches, {
            "matmul_rate_int8": mr.CALLS_PER_RATE * shapes,
            "matmul_rate_bf16": mr.CALLS_PER_RATE * shapes})
        for name in ("int8", "bf16"):
            row = rows[f"matmul_rate_{name}"]
            head = results[f"cuda_{name}_k{k}_m{m}"]
            ops = 2.0 * m * k * mr.N * reps
            nbytes = ((m + reps) * k + k * mr.N) * (1 if name == "int8" else 2)
            nbytes += m * mr.N * 4
            # one step of a call of HI steps: its bytes spread over them
            bound_ms, bound_by = bound(nbytes / mr.HI, ops,
                                       mr.PEAK_TFLOPS[name] * 1e12)
            row.update(
                launches=launches[f"matmul_rate_{name}"],
                max_abs_err=errs[name], ms=head["ms_per_step"],
                eager_ms=step_ms[name][0], plain_ms=step_ms[name][1],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=results[f"torch_{name}_k{k}_m{m}"]["ms_per_step"],
                tflops={mode: r["tflops"] for mode, r in results.items()
                        if f"_{name}_" in mode})
        rows["matmul_rate_bf16"].update(
            max_abs_err_integer_inputs=errs["bf16_integer"],
            bf16_share_of_tolerance=errs["bf16_share_of_tolerance"])
        for name, n in launches.items():
            rows[name]["launches_by_path"]["matmul_rate"] = n
        for name, tower in (("int8", "int8_tower"), ("bf16", "fused_tower")):
            rate = tower_flops(net_cfg, BATCH) / rows[tower]["ms"] / 1e9
            probe = results[f"cuda_{name}_k{k}_m{m}"]["tflops"]
            library = results[f"torch_{name}_k{k}_m{m}"]["tflops"]
            rows[f"matmul_rate_{name}"][f"{tower}_over_probe"] = rate / probe
            log(f"{tower}: {rate:.2f} T/s in this run = {rate / probe:.4f} of "
                f"the probe's {name} wgmma rate {probe:.2f} T/s at M {m}, "
                f"k {k}, reps {reps} (the library's {library:.2f} T/s) on "
                f"{smi}")

    b, g, r, c = ws.B, ws.G, ws.R, ws.C
    with Phase(f"20a width1_slice_write against its plain version ([{b}, {g}, "
               f"{r}] float32, column {c}, and {len(W1_SHAPES)} shapes with "
               f"unaligned rows or C at an edge; both variants, tolerance "
               f"0)"):
        x = torch.randn((b, g, r), generator=phase_gen(args.seed, 20, dev),
                        device=dev)
        times, w1_err = {}, 0.0
        for shape, col in ((x.shape, c),) + W1_SHAPES:
            xs = x if shape == x.shape else torch.randn(
                shape, generator=phase_gen(args.seed, 120, dev), device=dev)
            for ok in (False, True):
                got = ws.width1_slice_write(xs, col, ok)
                err = max_abs_err([got],
                                  [ws.width1_slice_write_plain(xs, col, ok)])
                w1_err = max(w1_err, err)
                if not err == 0.0:
                    raise AssertionError(
                        f"width1_slice_write {tuple(shape)} C={col} ok={ok}: "
                        f"max abs err {err} (tolerance 0)")
                if torch.equal(got, xs):
                    raise AssertionError("width1_slice_write changed nothing")
        log(f"width1_slice_write == plain on {1 + len(W1_SHAPES)} shapes, "
            f"both variants")
        # the floor: an empty kernel's replay, in this run
        floor_ms = lf.empty_ms()
        for ok in (False, True):
            def call(ok=ok):
                return ws.width1_slice_write(x, c, ok)

            times[ok] = (graph_ms(call, reps=50), cuda_ms(call, reps=50),
                         cuda_ms(lambda ok=ok: ws.width1_slice_write_plain(
                             x, c, ok), reps=20))
            log(f"width1_slice_write {'ok' if ok else 'width-1'}: kernel "
                f"{times[ok][0]:.5f} ms (CUDA graph replay; eager wrapper "
                f"call {times[ok][1]:.5f} ms), plain {times[ok][2]:.5f} ms; "
                f"an empty kernel {floor_ms:.5f} ms (graph replay), "
                f"{(times[ok][0] - floor_ms) * 1e3:.3f} us above it, on "
                f"{smi}")

    with Phase("20b slice-write repro path: repro.width1_slice_write.main, "
               "both variants"):
        reset_launch_counts()
        for argv in ([], ["--ok"]):
            ws.main(argv)
        torch.cuda.synchronize()
        launches = launch_counts()
        expect_launches("slice-write repro path", launches,
                        {"width1_slice_write": 2})
        nbytes = 2 * b * g * r * 4
        bound_ms, bound_by = bound(nbytes, 2 * b * g)
        rows["width1_slice_write"].update(
            launches=launches["width1_slice_write"], max_abs_err=w1_err,
            ms=times[False][0], eager_ms=times[False][1],
            plain_ms=times[False][2], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, ok_ms=times[True][0],
            ok_plain_ms=times[True][2], floor_ms=floor_ms)
        for name, n in launches.items():
            rows[name]["launches_by_path"]["width1_repro"] = n
        log(f"width1_slice_write: bound {bound_ms:.6f} ms ({bound_by}); no "
            f"single PyTorch call computes the function, so library_ms is "
            f"null")


def training_phases(args, env, net_cfg, dev, rows, smi, kept):
    """The training step and the training iteration, 6x128, 15x15; returns
    the path of a copy, in ``kept``, of the replay buffer the iteration
    wrote (phase 29's tools read it).

    21a: one float32 ``train_step`` (TF32 off) at batch 256 against the same
    step on float64 copies of the params, batch and optimizer state
    (``STEP_TOL``, ``CHAOTIC_TOL``); 21b: twenty steps on one batch lower the
    loss, timed by CUDA events.

    22: ``train_alphazero`` with the shipped recipe's search
    (``TRAINING_GUIDE.md:136-145``: Gumbel@64, m=16, reuse 48, track gate)
    on the int8 tower, cut to size:
      - 2 iterations of 256 games, each capped at ``TRAIN_MOVES`` moves (the
        recipe plays 128 games to the end, 200 iterations);
      - batch 256 (the recipe's 128), 1 epoch (the loop's len // batch
        steps), a ``TRAIN_BUFFER`` ring (the recipe's 160000);
      - an arena of 16 games at 64 simulations on the second iteration only
        (``eval_every=2``; the recipe's 64 games at 384); no anchor arena,
        no pretrained start (random weights from the seed);
      - then a resume from the second iteration's snapshot: 1 iteration,
        ``next_iteration_continuation=3`` (no arena: 3 % 2 != 0).
    Launches: ``gumbel_select_walk``, ``backup_paths`` and ``int8_tower``,
    nothing else.  Checks: finite losses, the snapshot, best and buffer
    files, the history's keys, and a saved model that reloads and saves to
    the same arrays bit for bit.  Prints each phase's seconds and the
    self-play moves/s.
    """
    net_name = f"{net_cfg.n_res_blocks}x{net_cfg.channels}"
    with Phase(f"21a train_step against float64 ({net_name}, batch "
               f"{TRAIN_BATCH}, {BOARD}x{BOARD}, TF32 off)"):
        gen = phase_gen(args.seed, 21, dev)
        params, stats = init_params(net_cfg, args.seed)
        p, s = split_state({k: v.to(dev) for k, v in
                            params_from_jax(params, stats).items()})
        states = random_states(env, TRAIN_BATCH, 12, gen, dev)
        x = env.encode(states)
        pi = torch.rand((TRAIN_BATCH, env.num_actions), generator=gen,
                        device=dev)
        pi = torch.where(pi < 0.5, 0.0, pi)
        pi = pi / pi.sum(dim=1, keepdim=True)
        z = torch.randint(-1, 2, (TRAIN_BATCH, 1), generator=gen,
                          device=dev).float()
        tx = Optimizer()
        o = tx.init(p)

        def f64(d):
            return {k: v.double() if v.is_floating_point() else v
                    for k, v in d.items()}

        batch64 = (x.double(), pi.double(), z.double())
        new32, _, o32, m32 = train_step(net_cfg, tx, p, s, o, x, pi, z)
        new64, _, o64, m64 = train_step(net_cfg, tx, f64(p), f64(s),
                                        AdamState(o.count, f64(o.mu),
                                                  f64(o.nu)), *batch64)
        worst, worst_chaotic, n_chaotic, n_zero, n = 0.0, 0.0, 0, 0, 0
        for k in p:
            # Adam's input g', from a fresh state's first moment
            a32 = o32.mu[k].double() / (1 - tx.b1)
            a64 = o64.mu[k] / (1 - tx.b1)
            chaotic = a64.abs() <= (a32 - a64).abs() + 1e-6
            diff = (new32[k].double() - new64[k]).abs()
            worst = max(worst, float(torch.where(chaotic, 0.0, diff).max()))
            worst_chaotic = max(worst_chaotic,
                                float(torch.where(chaotic, diff, 0.0).max()))
            n_chaotic += int(chaotic.sum())
            n_zero += int((a64.abs() <= 1e-6).sum())
            n += chaotic.numel()
        loss_diff = abs(float(m32["total_loss"]) - float(m64["total_loss"]))
        log(f"train_step float32 vs float64: {n} parameters; {n - n_chaotic}"
            f" with Adam's inputs g' agreeing in sign moved within "
            f"{worst:.3e} "
            f"(tolerance {STEP_TOL}); {n_chaotic} sign-chaotic ({n_zero} "
            f"with g' within 100 eps of zero) within {worst_chaotic:.3e} "
            f"(tolerance "
            f"{CHAOTIC_TOL}); loss {float(m32['total_loss']):.6f}, float64 "
            f"{float(m64['total_loss']):.6f}")
        if not (worst <= STEP_TOL and worst_chaotic <= CHAOTIC_TOL
                and loss_diff <= 1e-4):
            raise AssertionError("train_step: float32 step off the float64 "
                                 "step beyond its tolerances")

    with Phase(f"21b {TRAIN_STEPS} train_steps on one batch ({net_name}, "
               f"batch {TRAIN_BATCH})"):
        params_t, stats_t, opt_t = p, s, o
        losses = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        train_step(net_cfg, tx, p, s, o, x, pi, z)       # warm-up
        torch.cuda.synchronize()
        start.record()
        for _ in range(TRAIN_STEPS):
            params_t, stats_t, opt_t, m = train_step(
                net_cfg, tx, params_t, stats_t, opt_t, x, pi, z)
            losses.append(m["total_loss"])
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / TRAIN_STEPS
        losses = [float(v) for v in losses]
        log(f"train_step: {step_ms:.3f} ms a step (CUDA events over "
            f"{TRAIN_STEPS} steps; 6x128, batch {TRAIN_BATCH}, float32, TF32 "
            f"off) on {smi}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"train_step: {TRAIN_STEPS} steps on one "
                                 f"batch did not lower the loss: {losses}")

    common = dict(
        board_size=BOARD, games_per_iteration=BATCH,
        n_simulations=GUMBEL_SIMS, mcts_search="gumbel",
        gumbel_max_considered=GUMBEL_M, mcts_reuse_budget=REUSE_BUDGET,
        mcts_backend="pallas", inference="int8t",
        n_res_blocks=net_cfg.n_res_blocks, channels=net_cfg.channels,
        buffer_size=TRAIN_BUFFER, batch_size=TRAIN_BATCH, epochs_per_iter=1,
        selfplay_max_moves=TRAIN_MOVES, eval_games=ARENA_GAMES,
        eval_mcts_simulations=GUMBEL_SIMS, eval_every=2, gate_mode="track",
        seed=args.seed, device=dev)
    want_keys = {"iteration", "winners", "moves", "selfplay_seconds",
                 "eval_seconds", "train_seconds", "loss", "win_rate",
                 "win_rate_ci95", "arena_pairs", "anchor", "draws",
                 "accepted", "buffer_size", "snapshot", "phase_seconds",
                 "moves_per_second"}
    some = ("gumbel_select_walk", "backup_paths", "int8_tower")
    with tempfile.TemporaryDirectory() as tmp:
        common["model_dir"] = tmp
        with Phase(f"22a training iteration: train_alphazero, 2 iterations "
                   f"of {BATCH} games capped at {TRAIN_MOVES} moves, "
                   f"Gumbel@{GUMBEL_SIMS} m={GUMBEL_M} reuse {REUSE_BUDGET}, "
                   f"int8t, 6x128, batch {TRAIN_BATCH}, arena {ARENA_GAMES} "
                   f"games at {GUMBEL_SIMS} sims"):
            reset_launch_counts()
            hist = train_alphazero(num_iterations=2, **common)
            torch.cuda.synchronize()
            launches = launch_counts()
            expect_launches("training iteration", launches, {}, some=some)
            for name, n in launches.items():
                rows[name].setdefault("launches_by_path", {})[
                    "train_iteration"] = n
            check_history(hist, want_keys, tmp, smi)
            if hist[1]["arena_pairs"]["n"] != ARENA_GAMES // 2:
                raise AssertionError(f"arena: {hist[1]['arena_pairs']}")

        with Phase("22b resume from the snapshot: 1 iteration, "
                   "next_iteration_continuation=3"):
            snap = hist[-1]["snapshot"]
            reset_launch_counts()
            hist2 = train_alphazero(num_iterations=1,
                                    pretrained_model_path=snap,
                                    candidate_model_path=snap,
                                    next_iteration_continuation=3, **common)
            torch.cuda.synchronize()
            expect_launches("resumed training iteration", launch_counts(),
                            {}, some=some)
            check_history(hist2, want_keys, tmp, smi)
            if hist2[0]["iteration"] != 3 or \
                    hist2[0]["buffer_size"] < hist[-1]["buffer_size"]:
                raise AssertionError(f"resume: {hist2[0]}")

        with Phase("22c a saved model reloads bit for bit"):
            model = AZModel.from_checkpoint(snap, device=dev)
            again = os.path.join(tmp, "again.ckpt")
            model.save(again)
            a, b = ckpt.load_checkpoint(snap)[0], ckpt.load_checkpoint(
                again)[0]
            if not trees_equal(a, b):
                raise AssertionError("a reloaded snapshot saved different "
                                     "arrays")
            log(f"{snap}: reloaded and saved again, every array equal")
        return shutil.copy(os.path.join(tmp, "replay_buffer_latest.npz"),
                           kept)


def pente_obs(env, batch, plies, generator, dev):
    """Pente encodings with capture planes: ``plies`` random legal moves,
    then captured pairs k = 0..4 of both sides spread over the lanes (the
    planes hold k / 5, the int8 observation quantization's first inputs
    that are neither 0 nor 1)."""
    states = random_states(env, batch, plies, generator, dev)
    order = torch.randperm(2 * batch, generator=generator, device=dev)
    k = (order.reshape(batch, 2) % 5).to(torch.int32)
    return env.encode(states._replace(captures=k))


def pente_phases(args, dev, rows, smi):
    """Phases 23a-c: Pente 15x15 with capture planes at bench config #4's
    shape, on a 6x128 net of 5 input planes (``init_params`` from the seed,
    BN fitted to Pente boards as ``smoke_weights`` fits the Gomoku net's):
    K5 and K4 at cin 5 against their plain versions at batch 64 and 256;
    one PUCT@400 search on the kernels against the same search on the plain
    versions; PUCT@400 self-play at batch 64 on K5."""
    env = make_env("pente", BOARD, capture_planes=True)
    cfg = NetConfig.full(BOARD, in_channels=env.obs_channels)
    params, stats = init_params(cfg, args.seed)
    calib = pente_obs(env, 256, 30, phase_gen(args.seed, 123, dev), dev)
    stats = fit_batch_stats(cfg, params, stats, calib, device=dev)
    q = q8.quantize_int8(cfg, params, stats, calib.cpu(), device=dev)
    packed = t8.pack_tower_bundle(cfg, q)
    folded = fn.fold_bn(cfg, params, stats, device=dev)
    xla = fn.fold_bn_xla(cfg, params, stats, device=dev)
    with Phase(f"23a int8_tower (tolerance 0) and fused_tower (the C4 "
               f"criterion against float64) at cin {cfg.in_channels}: Pente "
               f"{BOARD}x{BOARD} with capture planes, k = 0..4, 6x128, "
               f"batch {PENTE_BATCH} and {BATCH}"):
        log(f"Pente int8 bundle: inv_obs {q['inv_obs'].tolist()}; stems: "
            f"int8 {tuple(packed['stem_w'].shape)}, bf16 "
            f"{tuple(folded['stem_w'].shape)} (9 x cin x C)")
        for batch in (PENTE_BATCH, BATCH):
            obs = pente_obs(env, batch, 30,
                            phase_gen(args.seed, 23 + batch, dev), dev)
            ks = torch.unique(torch.round(obs[:, 0, 0, 3:] * 5))
            if ks.tolist() != [0.0, 1.0, 2.0, 3.0, 4.0]:
                raise AssertionError(f"capture planes hold k = {ks}")
            tower = t8.int8_tower(packed, obs)
            plain = t8.int8_tower_plain(packed, obs)
            k_logits, k_value = t8.int8_tower_apply(cfg, packed, obs)
            p_logits, p_value = q8.int8_heads(cfg, packed, plain)
            for name, got, want in (
                    ("tower", tower, plain),
                    ("tower vs int8_tower_mm", tower,
                     q8.int8_tower_mm(q, obs)),
                    ("logits", k_logits, p_logits),
                    ("value", k_value, p_value)):
                if not torch.equal(got, want):
                    raise AssertionError(f"int8_tower at cin 5, batch "
                                         f"{batch}, {name}: kernel differs "
                                         f"(tolerance 0)")
            c4 = hold_fused_c4(cfg, folded, obs)
            log(f"batch {batch}: int8_tower == plain and int8_tower_mm "
                f"(tower, logits, value); fused_tower against float64 "
                f"(kernel, plain, one bf16 step of the scale, kernel against "
                f"plain): {c4}")
            if batch != PENTE_BATCH:
                continue
            row = {"batch": batch, "cin": cfg.in_channels,
                   "max_abs_err": 0.0,
                   "ms": cuda_ms(lambda: t8.int8_tower(packed, obs), reps=20),
                   "plain_ms": cuda_ms(lambda: t8.int8_tower_plain(packed,
                                                                   obs),
                                       reps=3, warmup=1),
                   "library_ms": cuda_ms(lambda: q8.int8_tower_mm(q, obs),
                                         reps=20)}
            row["bound_ms"], row["bound_by"] = int8_tower_bound(cfg, batch)
            rows["int8_tower"][f"pente_b{batch}"] = row
            frow = {"batch": batch, "cin": cfg.in_channels,
                    "max_abs_err": c4["logits"][3],
                    "ms": cuda_ms(lambda: fn.fused_tower(folded, obs),
                                  reps=20),
                    "plain_ms": cuda_ms(lambda: fn.fused_tower_plain(folded,
                                                                     obs),
                                        reps=3, warmup=1),
                    "library_ms": cuda_ms(lambda: fn.folded_xla_tower(
                        xla, obs), reps=20)}
            frow["bound_ms"], frow["bound_by"] = tower_bound(cfg, batch)
            rows["fused_tower"][f"pente_b{batch}"] = frow
            log(f"at batch {batch}: int8_tower {row['ms']:.4f} ms (plain "
                f"{row['plain_ms']:.4f}, int8_tower_mm "
                f"{row['library_ms']:.4f}, bound {row['bound_ms']:.6f} "
                f"{row['bound_by']}); "
                f"fused_tower {frow['ms']:.4f} ms (plain "
                f"{frow['plain_ms']:.4f}, folded_xla_tower "
                f"{frow['library_ms']:.4f}, bound {frow['bound_ms']:.6f} "
                f"{frow['bound_by']}) on {smi}")

    tower_eval = t8.make_int8_tower_eval_fn(cfg)

    def plain_eval(p, obs):
        logits, value = q8.int8_heads(cfg, p, t8.int8_tower_plain(p, obs))
        return torch.softmax(logits, dim=-1), value

    with Phase(f"23b Pente PUCT@{SIMS} search on the kernels (tree kernels, "
               f"int8_tower) against the same search on the plain versions "
               f"(batch {PENTE_BATCH})"):
        g = phase_gen(args.seed, 223, dev)
        states = random_states(env, PENTE_BATCH, 12, g, dev)
        # captured pairs at the roots, so that every node's capture planes
        # are read
        states = states._replace(captures=torch.randint(
            0, 5, (PENTE_BATCH, 2), generator=g, device=dev,
            dtype=torch.int32))
        moves = torch.full((PENTE_BATCH,), 12, dtype=torch.int32, device=dev)
        out = {}
        for label, ops, eval_fn in (("kernels", tk.KERNELS, tower_eval),
                                    ("plain", tk.PLAIN, plain_eval)):
            g = phase_gen(args.seed, 323, dev)
            out[label] = run_mcts_packed_with_tree(
                env, MAIN_MCTS, eval_fn, packed, states, moves, g, ops=ops)
        for name, k, p in zip(("pi", "root_q"), out["kernels"][:2],
                              out["plain"][:2]):
            if not torch.equal(k, p):
                raise AssertionError(f"Pente search {name}: kernels != "
                                     f"plain")
        caps = out["kernels"][2].states.captures
        log(f"Pente search: kernels == plain exactly over {PENTE_BATCH} "
            f"lanes (pi, root_q); {int((caps.sum(dim=-1) > 0).sum())} of "
            f"{caps.shape[0] * caps.shape[1]} tree nodes hold captures")

    sp_cfg = SelfPlayConfig(batch_games=PENTE_BATCH, mcts=MAIN_MCTS,
                            temp_threshold=10, max_moves=MOVES)
    gen = phase_gen(args.seed, 23, dev)
    with Phase(f"23c Pente warm-up (batch {PENTE_BATCH}, 1 move, 8 sims)"):
        warm = dataclasses.replace(
            sp_cfg, max_moves=1,
            mcts=dataclasses.replace(MAIN_MCTS, n_simulations=8))
        play_games(env, warm, tower_eval, packed, gen, dev)
    with Phase(f"23c Pente main path: play_games batch {PENTE_BATCH}, 6x128 "
               f"int8 tower at cin 5, {BOARD}x{BOARD} with capture planes, "
               f"PUCT@{SIMS}, {MOVES} moves"):
        reset_launch_counts()
        t0 = time.perf_counter()
        traj = play_games(env, sp_cfg, tower_eval, packed, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        moves_done = int(torch.clamp(traj.moves_played, max=MOVES).sum())
        log(f"Pente main path: {moves_done} moves in {seconds:.3f} s = "
            f"{moves_done / seconds:.2f} moves/s (batch {PENTE_BATCH}, 6x128 "
            f"int8 tower, PUCT@{SIMS}, {BOARD}x{BOARD}, capture planes) on "
            f"{smi}")
        expect_launches("Pente PUCT main path", launches, {
            "select_walk": MOVES * SIMS, "backup_paths": MOVES * SIMS,
            "int8_tower": MOVES * (1 + SIMS)})
        for name, n in launches.items():
            rows[name]["launches_by_path"][
                f"pente_puct{SIMS}_b{PENTE_BATCH}"] = n
        check_trajectories(env, traj, MOVES, PENTE_BATCH)
        log(f"captured pairs by ply {MOVES}: "
            f"{int(traj.captures[MOVES - 1].sum())}")


def hold_fused_c4(cfg, folded, obs):
    """``fused_tower`` (tower, logits, value) against a float64 evaluation
    with the same bf16 storage points: the kernel at most twice as far from
    it as the plain version, or one bf16 step (2^-8) of the output's scale
    (its largest magnitude; 1 for the value), whichever is larger (the card
    tests' C4 criterion).  Returns each output's distances from float64
    (the kernel's, the plain version's), the bf16 step, and the kernel's
    distance from the plain version."""
    kernel = (fn.fused_tower(folded, obs), *fn.fused_predict(cfg, folded,
                                                             obs))
    plain = (fn.fused_tower_plain(folded, obs),
             *fn.folded_apply_plain(cfg, folded, obs))
    with torch.no_grad():
        ref = (fn.fused_tower_plain(folded, obs, torch.float64),
               *fn.folded_apply_plain(cfg, folded, obs, torch.float64))
    out = {}
    for name, k, p, r in zip(("tower", "logits", "value"), kernel, plain,
                             ref):
        k_err = float((k.double() - r.double()).abs().max())
        p_err = float((p.double() - r.double()).abs().max())
        step = 2.0 ** -8 * (1.0 if name == "value"
                            else float(r.abs().max()))
        out[name] = (k_err, p_err, step,
                     float((k.double() - p.double()).abs().max()))
        if not k_err <= max(2 * p_err, step):
            raise AssertionError(f"fused_tower {name}: {k_err} from float64, "
                                 f"plain {p_err}, bf16 step {step}")
    return out


def check_stream(rec, steps: int, batch: int):
    """A continuous stream by ``tests/test_continuous.py``'s invariants:
    after each end an empty board and player 1; players alternate within a
    segment; each full ply's pi sums to 1; every lane ends twice."""
    ended = rec.ended
    if ended.shape != (steps, batch):
        raise AssertionError(f"ended shape {tuple(ended.shape)}")
    if not (ended.sum(dim=0) >= 2).all():
        raise AssertionError("a lane ended fewer than twice")
    after = ended[:-1]
    if (rec.boards[1:][after] != 0).any() or (rec.players[1:][after]
                                              != 1).any():
        raise AssertionError("a reset lane did not start a fresh game")
    # each ply's player: 1 on a segment's first ply, alternating after
    seg = torch.zeros(batch, dtype=torch.int64, device=ended.device)
    for t in range(steps):
        if not torch.equal(rec.players[t].long(), seg % 2 + 1):
            raise AssertionError(f"ply {t}: players do not alternate")
        seg = torch.where(ended[t], 0, seg + 1)
    sums = rec.pis.sum(dim=-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-4):
        raise AssertionError("a pi row does not sum to 1")
    if not (torch.isfinite(rec.root_qs).all()
            and rec.root_qs.abs().max() <= 1.0 + 1e-6):
        raise AssertionError("root_q not finite or outside [-1, 1]")


def continuous_phases(args, env, net_cfg, dev, rows, smi, int8_bundle):
    """Phases 24a-b: continuous self-play (``play_games_continuous``,
    Gomoku, the 6x128 int8 tower), and one training iteration on Pente with
    capture planes in continuous mode (``train_alphazero``: 256 lanes,
    Gumbel@64 m=16, int8t, no arena), then its snapshot reloaded bit for
    bit."""
    tower_eval, packed = int8_bundle
    sp_cfg = SelfPlayConfig(batch_games=BATCH, mcts=GUMBEL_MCTS,
                            max_moves=CONT_MAX_MOVES)
    gen = phase_gen(args.seed, 24, dev)
    with Phase(f"24a continuous warm-up (batch {BATCH}, 1 ply)"):
        play_games_continuous(env, sp_cfg, tower_eval, packed, gen, 1, dev)
    with Phase(f"24a continuous self-play: play_games_continuous batch "
               f"{BATCH}, Gumbel@{GUMBEL_SIMS} m={GUMBEL_M}, 6x128 int8 "
               f"tower, {BOARD}x{BOARD}, {CONT_STEPS} plies, games capped "
               f"at {CONT_MAX_MOVES} moves"):
        reset_launch_counts()
        t0 = time.perf_counter()
        rec = play_games_continuous(env, sp_cfg, tower_eval, packed, gen,
                                    CONT_STEPS, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        plies = CONT_STEPS * BATCH
        log(f"continuous path: {plies} moves in {seconds:.3f} s = "
            f"{plies / seconds:.2f} moves/s (batch {BATCH}, 6x128 int8 "
            f"tower, Gumbel@{GUMBEL_SIMS}, {BOARD}x{BOARD}); "
            f"{int(rec.ended.sum())} games ended, "
            f"{int((rec.winners != 0).sum())} won, on {smi}")
        expect_launches("continuous Gumbel path", launches, {
            "gumbel_select_walk": CONT_STEPS * GUMBEL_SIMS,
            "backup_paths": CONT_STEPS * GUMBEL_SIMS,
            "int8_tower": CONT_STEPS * (1 + GUMBEL_SIMS)})
        for name, n in launches.items():
            rows[name]["launches_by_path"][
                f"continuous_gumbel{GUMBEL_SIMS}"] = n
        check_stream(rec, CONT_STEPS, BATCH)

    want_keys = {"iteration", "winners", "moves", "selfplay_seconds",
                 "eval_seconds", "train_seconds", "loss", "win_rate",
                 "win_rate_ci95", "arena_pairs", "anchor", "draws",
                 "accepted", "buffer_size", "snapshot", "phase_seconds",
                 "moves_per_second"}
    with tempfile.TemporaryDirectory() as tmp:
        with Phase(f"24b training iteration on Pente with capture planes, "
                   f"continuous: train_alphazero, 1 iteration of {BATCH} "
                   f"lanes x {CONT_TRAIN_STEPS} plies capped at "
                   f"{CONT_TRAIN_MAX_MOVES} moves, Gumbel@{GUMBEL_SIMS} "
                   f"m={GUMBEL_M}, int8t, 6x128 at cin 5, no arena"):
            reset_launch_counts()
            hist = train_alphazero(
                game_name="pente", pente_capture_planes=True,
                selfplay_mode="continuous", selfplay_steps=CONT_TRAIN_STEPS,
                selfplay_max_moves=CONT_TRAIN_MAX_MOVES, inference="int8t",
                mcts_search="gumbel", n_simulations=GUMBEL_SIMS,
                gumbel_max_considered=GUMBEL_M, board_size=BOARD,
                games_per_iteration=BATCH, num_iterations=1, eval_every=2,
                n_res_blocks=net_cfg.n_res_blocks, channels=net_cfg.channels,
                buffer_size=TRAIN_BUFFER, batch_size=TRAIN_BATCH,
                epochs_per_iter=1, seed=args.seed, model_dir=tmp, device=dev)
            torch.cuda.synchronize()
            launches = launch_counts()
            expect_launches("Pente continuous training iteration", launches,
                            {}, some=("gumbel_select_walk", "backup_paths",
                                      "int8_tower"))
            for name, n in launches.items():
                rows[name]["launches_by_path"]["pente_continuous_train"] = n
            check_history(hist, want_keys, tmp, smi)
            if hist[0]["moves"] != CONT_TRAIN_STEPS * BATCH:
                raise AssertionError(f"moves {hist[0]['moves']}")
            snap = hist[0]["snapshot"]
        with Phase("24c the Pente snapshot reloads bit for bit"):
            model = AZModel.from_checkpoint(snap, device=dev)
            if model.cfg.in_channels != 5:
                raise AssertionError(f"in_channels {model.cfg.in_channels}")
            again = os.path.join(tmp, "again.ckpt")
            model.save(again)
            if not trees_equal(ckpt.load_checkpoint(snap)[0],
                               ckpt.load_checkpoint(again)[0]):
                raise AssertionError("a reloaded Pente snapshot saved "
                                     "different arrays")
            log(f"{snap}: 5-plane net reloaded and saved again, every array "
                f"equal")


def player_phases(args, net_cfg, weights, dev, rows, smi):
    """Phases 25a-d: the players and the play entry points, on the card
    (``device=None``), with the smoke's 6x128 net saved as an AZTPU1 file and
    loaded by its path, as ``--p1-model`` loads one.

    25a: ``player`` (PUCT, ``PLAYER_SIMS`` simulations, reuse on) against
    ``player_alpha`` with ``search="gumbel"`` (``PLAYER_GUMBEL_SIMS``,
    round-parallel), ``PLAYER_PLIES`` plies of one game from the opening
    through ``request_move``, as ``cli.play.run_match`` drives them: each
    player's think time per move, and its launches (PUCT: ``select_walk``
    and ``backup_paths``; Gumbel: ``gumbel_select_walk`` and
    ``backup_paths``; nothing else).  25b: both players of 25a at
    25a's settings over three moves each (the PUCT player's fresh search,
    then two resumes through ``packed_advance_root``) on the kernels against
    the same players on the plain versions (``tree_ops``), pi bit for bit;
    K1 and K2 held and timed on the PUCT player's last tree, K3 on the
    Gumbel player's last tree at each fan its rounds walk.  25c:
    ``player_alpha2`` at its defaults (5000 simulations, reuse 5000: depth
    argument 10002, ``backup_paths``' shared-memory opt-in) plays two moves,
    the second resumed; the carried tree's nodes; K1 and K2 held and timed
    on its tree, and K1 timed at depth ``SHORT_DEPTH`` on it (the
    full-depth path fill).  25d: ``cli.play_loop.main``,
    ``LOOP_GAMES`` games of ``player`` against ``player_mcts`` in a
    temporary working directory: the metrics file, every move legal, the
    native scans loaded."""
    a = BOARD * BOARD
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.ckpt")
        model = AZModel(board_size=BOARD, n_res_blocks=net_cfg.n_res_blocks,
                        channels=net_cfg.channels, device=dev)
        model.params, model.batch_stats = split_state(
            {k: v.to(dev) for k, v in params_from_jax(*weights).items()})
        model.save(path)

        with Phase(f"25a the players: player PUCT@{PLAYER_SIMS} (reuse "
                   f"{PLAYER_SIMS}) against player_alpha Gumbel@"
                   f"{PLAYER_GUMBEL_SIMS} (round-parallel), 6x128 float32, "
                   f"{PLAYER_PLIES} plies through request_move"):
            seats = {1: load_player("player", "gomoku", BOARD,
                                    model_path=path,
                                    n_simulations=PLAYER_SIMS),
                     2: load_player("player_alpha", "gomoku", BOARD,
                                    model_path=path, search="gumbel",
                                    n_simulations=PLAYER_GUMBEL_SIMS)}
            labels = {1: "player_puct", 2: "player_gumbel"}
            game = make_host_game("gomoku", BOARD)
            think = {1: [], 2: []}
            searched = {1: 0, 2: 0}
            got = {1: dict.fromkeys(launch_counts(), 0),
                   2: dict.fromkeys(launch_counts(), 0)}
            for turn in range(1, PLAYER_PLIES + 1):
                seat = game.current_player
                # a move the tactical guard makes runs no search
                searched[seat] += not (winning_cells(game, seat).any()
                                       or winning_cells(game, 3 - seat).any())
                reset_launch_counts()
                t0 = time.perf_counter()
                if request_move(seats[seat], game, turn, log=log) is None:
                    raise AssertionError(f"seat {seat} forfeited")
                think[seat].append(time.perf_counter() - t0)
                for name, n in launch_counts().items():
                    got[seat][name] += n
            _, phases = halving_schedule(PLAYER_GUMBEL_SIMS, GUMBEL_M)
            rounds = sum(visits for _, visits in phases)
            want = {1: {"select_walk": PLAYER_SIMS * searched[1],
                        "backup_paths": PLAYER_SIMS * searched[1]},
                    2: {"gumbel_select_walk": rounds * searched[2],
                        "backup_paths": PLAYER_GUMBEL_SIMS * searched[2]}}
            for seat, sims in ((1, PLAYER_SIMS), (2, PLAYER_GUMBEL_SIMS)):
                expect_launches(f"{labels[seat]} path", got[seat],
                                want[seat])
                for name, n in got[seat].items():
                    rows[name]["launches_by_path"][labels[seat]] = n
                times = think[seat]
                log(f"{labels[seat]}: think time per move median "
                    f"{statistics.median(times):.3f} s, max "
                    f"{max(times):.3f} s over {len(times)} moves "
                    f"({searched[seat]} searched); "
                    f"{statistics.median(times) / sims * 1e3:.3f} ms of "
                    f"wall a simulation (median move), batch 1, on {smi}")
            log(f"game after {PLAYER_PLIES} plies:\n"
                + "\n".join(" ".join(".XO"[v] for v in row)
                            for row in game.board))

        with Phase(f"25b the players' searches over 3 moves, kernels "
                   f"against plain (batch 1, PUCT@{PLAYER_SIMS} with reuse, "
                   f"Gumbel@{PLAYER_GUMBEL_SIMS} round-parallel, cudnn "
                   f"deterministic)"):
            torch.backends.cudnn.deterministic = True
            traces = []
            for ops in (tk.KERNELS, tk.PLAIN):
                player = load_player("player", "gomoku", BOARD,
                                     model_path=path,
                                     n_simulations=PLAYER_SIMS)
                player.tree_ops = ops
                traces.append(player_trace(player, 3))
            (km, ks), (pm, ps) = traces
            if [n for n, _, _ in ks] != ["_search_fresh", "_search_resume",
                                         "_search_resume"]:
                raise AssertionError(f"searches {[n for n, _, _ in ks]}")
            for (_, kpi, _), (_, ppi, _) in zip(ks, ps):
                if not (kpi == ppi).all():
                    raise AssertionError("PUCT player pi: kernels != plain")
            if km != pm:
                raise AssertionError(f"PUCT player moves: kernels {km} != "
                                     f"plain {pm}")
            log(f"PUCT player, fresh then 2 resumes: pi equal bit for bit "
                f"on the kernels and the plain versions; moves {km}")
            floor = latency_floor()
            tree_rows = hold_player_tree(player.cfg, player.c_puct,
                                         ks[-1][2][1], floor, args.seed)
            rows["select_walk"]["player_tree"] = tree_rows[0]
            rows["backup_paths"]["player_tree"] = tree_rows[1]

            traces, walks = [], FanWalks()
            for ops in (tk.KERNELS._replace(gumbel_select_walk=walks),
                        tk.PLAIN):
                player = load_player("player_alpha", "gomoku", BOARD,
                                     model_path=path, search="gumbel",
                                     n_simulations=PLAYER_GUMBEL_SIMS)
                player.tree_ops = ops
                traces.append(gumbel_trace(player, 3))
            (km, kpis), (pm, ppis) = traces
            for kpi, ppi in zip(kpis, ppis):
                if not (kpi == ppi).all():
                    raise AssertionError("Gumbel player pi: kernels != plain")
            if km != pm:
                raise AssertionError(f"Gumbel player moves: kernels {km} != "
                                     f"plain {pm}")
            log(f"Gumbel player, 3 moves: pi equal bit for bit on the "
                f"kernels and the plain versions; moves {km}")
            gumbel_rows = {}
            for fan, (tree, root, *walk_args) in sorted(walks.kept.items()):
                gumbel_rows[f"fan{fan}"] = hold_gumbel(tree, root, *walk_args,
                                                       fan, floor)
            rows["gumbel_select_walk"]["player_gumbel_tree"] = gumbel_rows
            torch.backends.cudnn.deterministic = False

        with Phase("25c player_alpha2 at its defaults (5000 sims, reuse "
                   "5000, depth argument 10002): 2 moves, the second "
                   "resumed; K1 and K2 on its tree"):
            strong = load_player("player_alpha2", "gomoku", BOARD,
                                 model_path=path)
            depth = strong.cfg.depth_limit
            think = []
            reset_launch_counts()
            moves, searches = player_trace(strong, 2, think)
            launches = launch_counts()
            expect_launches("player_alpha2 path", launches, {
                "select_walk": 2 * strong.n_simulations,
                "backup_paths": 2 * strong.n_simulations})
            for name, n in launches.items():
                rows[name]["launches_by_path"]["player_alpha2"] = n
            if [n for n, _, _ in searches] != ["_search_fresh",
                                               "_search_resume"]:
                raise AssertionError(f"searches {[n for n, _, _ in searches]}")
            resumed, grown = searches[1][2]
            log(f"player_alpha2: think time {think[0]:.3f} s (fresh), "
                f"{think[1]:.3f} s (resumed); "
                f"{think[1] / strong.n_simulations * 1e3:.3f} ms of wall a "
                f"simulation; carried tree after "
                f"packed_advance_root: {tree_nodes(resumed)} nodes, after "
                f"the search {tree_nodes(grown)} of {depth}; moves {moves}; "
                f"on {smi}")
            floor = latency_floor()
            walk, back = hold_player_tree(strong.cfg, strong.c_puct, grown,
                                          floor, args.seed)
            rows["select_walk"]["player_alpha2_tree"] = walk
            rows["backup_paths"]["player_alpha2_tree"] = back
            # the path fill: the same walk at a depth argument above the
            # tree's longest path
            if walk["path_len_max"] >= SHORT_DEPTH:
                raise AssertionError(f"a path of {walk['path_len_max']} hops")
            layout = tk.packed_layout(a, strong.cfg.node_capacity)
            tree = grown.packed
            sel = tk.select_walk(tree, layout, strong.c_puct, depth, True)
            short = tk.select_walk(tree, layout, strong.c_puct, SHORT_DEPTH,
                                   True)
            for name, x, y in zip(("leaf", "action", "path_len"),
                                  (short[0], short[1], short[4]),
                                  (sel[0], sel[1], sel[4])):
                if not torch.equal(x, y):
                    raise AssertionError(f"select_walk at depth "
                                         f"{SHORT_DEPTH}: {name} differs")
            walk["ms_depth64"] = graph_ms(lambda: tk.select_walk(
                tree, layout, strong.c_puct, SHORT_DEPTH, True), 50)
            walk["hop_ms_depth64"] = ((walk["ms_depth64"] - floor["empty_ms"])
                                      / walk["path_len_max"])
            log(f"batch 1, {tree_nodes(grown)}-node tree: select_walk "
                f"{walk['ms']:.4f} ms at depth {depth}, "
                f"{walk['ms_depth64']:.4f} ms at depth {SHORT_DEPTH} "
                f"({walk['hop_ms_depth64'] * 1e6:.1f} ns a hop); "
                f"backup_paths {back['ms']:.4f} ms at depth {depth} "
                f"(CUDA graph replay, on {smi})")

        with Phase(f"25d cli.play_loop: {LOOP_GAMES} games of player "
                   f"(PUCT@{LOOP_SIMS}, the smoke's checkpoint) against "
                   f"player_mcts, {BOARD}x{BOARD}"):
            if load_puremcts() is None:
                raise AssertionError("the native scans did not load")
            cwd = os.getcwd()
            work = os.path.join(tmp, "play_loop")
            os.makedirs(work)
            os.chdir(work)
            try:
                reset_launch_counts()
                with open("play_loop.log", "w") as out, \
                        contextlib.redirect_stdout(out):
                    play_loop.main(["player", "player_mcts", str(LOOP_GAMES),
                                    "--size", str(BOARD), "--p1-sims",
                                    str(LOOP_SIMS), "--p1-model", path,
                                    "--seed", str(args.seed)])
                launches = launch_counts()
                files = glob.glob("metrics/*.json")
                with open("play_loop.log") as f:
                    tail = f.read().splitlines()[-3:]
            finally:
                os.chdir(cwd)
            expect_launches("play_loop", launches, {},
                            some=("select_walk", "backup_paths"))
            for name, n in launches.items():
                rows[name]["launches_by_path"]["play_loop"] = n
            if len(files) != 1:
                raise AssertionError(f"metrics files {files}")
            check_tournament(os.path.join(work, files[0]))
            log(f"{os.path.basename(files[0])}: " + "; ".join(tail))


def parallel_phases(args, env, net_cfg, dev, rows, smi, int8_bundle):
    """Phases 26a-d: data parallelism over ``torch.distributed``
    (``parallel/``), one process per rank, each started from this script
    (``--parallel-worker``, ``parallel_worker``) and run on the shipped
    recipe's search, Gumbel@64 m=16 with reuse 48, on the int8 tower
    (phase 11's bundle, saved and loaded by every rank), 6x128, 15x15,
    ``BATCH`` games in all, ``MOVES`` moves.

    26a: a group of ``torch.cuda.device_count()`` ranks over NCCL (one rank
    on a one-card machine).  Each rank plays its share of the games
    (``make_sharded_selfplay``; its K2, K3 and K5 launches counted), the
    shards are all-gathered (``gather_trajectories``) and must equal the
    unsharded ``play_games`` on the same seed bit for bit (a world of one is
    the unsharded path; with more ranks each shard's own run); one sharded
    train step (``make_sharded_gather_epoch``, global batch norm, the
    gradient all-reduce before the clip) at batch ``TRAIN_BATCH`` on a ring
    of those games' samples, held against ``train_epoch_gather`` by phase
    21a's criterion, then ``PARALLEL_TRAIN_STEPS`` steps timed, beside the
    same steps of the rank's slice with the collectives made the identity
    (their difference is what the collectives cost a step); one
    ``train_alphazero`` iteration on the mesh (a mesh of one rank given
    explicitly: ``mesh="auto"`` runs a lone rank unsharded), traced
    (``profile_trace_dir``: 26c) and without its arena, which would fill
    the trace with the arena's batch-1 searches.
    26b: on a one-card machine, the same at 2 ranks sharing the card over
    gloo (NCCL refuses two ranks on a device; gloo moves the CUDA tensors
    through host memory), held against each shard's own unsharded run, and
    ``train_alphazero(mesh="auto")`` with its arena split over the ranks
    (``PARALLEL_ARENA_GAMES`` games of ``PARALLEL_ARENA_SIMS`` simulations).
    26c: the traced iteration's Chrome trace names the CUDA kernels
    ``gumbel_select_walk``, ``backup_paths`` and the int8 tower's conv.
    26d: the memory preflight (``selfplay/budget.py``) passes for this
    config, its reckoning printed beside ``torch.cuda.max_memory_allocated``
    of the real call; a config reckoned over the card's memory raises before
    it allocates.
    Prints moves/s per rank, all-gather ms and train ms a step, with the
    backend and world size of each group."""
    tower_eval, packed = int8_bundle
    cfg = SelfPlayConfig(batch_games=BATCH, mcts=PARALLEL_MCTS,
                         max_moves=MOVES)
    count = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(packed, os.path.join(tmp, "bundle.pt"))
        with Phase(f"26d preflight: the reckoning of Gumbel@{GUMBEL_SIMS} "
                   f"m={GUMBEL_M} reuse {REUSE_BUDGET}, int8t, batch {BATCH}"
                   f", {MOVES} moves against the card, then the real call's "
                   f"peak (the unsharded reference run)"):
            reck = selfplay_memory(env, cfg, net_cfg)
            acct = preflight_memory_check(reck, label="smoke self-play",
                                          device=dev)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ref = play_games(env, cfg, tower_eval, packed,
                             torch.Generator(device=dev).manual_seed(
                                 PARALLEL_SEED), dev)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            gib = 2 ** 30
            log(f"preflight passed: reckoned {reck['peak_bytes'] / gib:.4f} "
                f"GiB ({', '.join(f'{k} {v / gib:.4f}' for k, v in reck.items() if k != 'peak_bytes')}"
                f") against {acct['margin']} x {acct['limit_bytes'] / gib:.2f}"
                f" GiB; the real call's torch.cuda.max_memory_allocated "
                f"above its start {peak / gib:.4f} GiB (ratio "
                f"{peak / reck['peak_bytes']:.3f}) on {smi}")
            # a batch reckoned at twice the card's memory or more
            scale = 2 * -(-acct["limit_bytes"] // reck["peak_bytes"])
            big = dataclasses.replace(cfg, batch_games=BATCH * scale)
            big_reck = selfplay_memory(env, big, net_cfg)
            before = torch.cuda.memory_allocated()
            ran = []
            try:
                with_preflight(ran.append, big_reck, label="over-budget",
                               device=dev)(big)
            except MemoryBudgetError as e:
                log(f"over-budget config (batch {big.batch_games}) refused "
                    f"before it ran: {e}")
            if ran or torch.cuda.memory_allocated() != before:
                raise AssertionError("the preflight let an over-budget "
                                     "config through")
        ref = {k: (None if v is None else v.cpu())
               for k, v in ref._asdict().items()}

        groups = [("26a", "nccl", count)]
        if count == 1:
            groups.append(("26b", "gloo", 2))
        for phase, backend, world in groups:
            with Phase(f"{phase} {world} rank(s) over {backend}: sharded "
                       f"Gumbel@{GUMBEL_SIMS} m={GUMBEL_M} reuse "
                       f"{REUSE_BUDGET} self-play on int8t, batch {BATCH} in "
                       f"all, {MOVES} moves; a sharded train step held and "
                       f"{PARALLEL_TRAIN_STEPS} timed at batch {TRAIN_BATCH};"
                       f" 1 train_alphazero iteration on the mesh"
                       + (" (traced: 26c)" if phase == "26a" else "")):
                out = os.path.join(tmp, phase)
                results = run_ranks(args, world, out, trace=phase == "26a")
                if phase == "26a":
                    want = ref
                else:
                    want = shard_references(env, cfg, tower_eval, packed,
                                            world, dev)
                check_parallel(phase, backend, world, results, want, net_cfg,
                               dev, rows, smi)
                if phase == "26a":
                    with Phase("26c the traced iteration's kernels"):
                        check_trace(results[0]["trace"])


def run_ranks(args, world: int, out: str, trace: bool):
    """Start ``world`` rank processes of this script on a free port, wait
    for them (``PARALLEL_TIMEOUT`` seconds), print their output, and load
    each rank's results."""
    os.makedirs(out, exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(args.seed),
         "--parallel-worker", f"{rank},{world},{port},{int(trace)}", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PARALLEL_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if not line.startswith("[W"):
                log(f"  [rank {rank}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of {world} exited "
                                 f"{p.returncode}")
    return [torch.load(os.path.join(out, f"rank{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def shard_references(env, cfg, eval_fn, bundle, world: int, dev):
    """Each rank's games as one process plays them: ``play_games`` of its
    share on the generator ``fold_in(seed, rank)``, gathered."""
    shard = dataclasses.replace(cfg, batch_games=cfg.batch_games // world)
    runs = [play_games(env, shard, eval_fn, bundle,
                       torch.Generator(device=dev).manual_seed(
                           fold_in(PARALLEL_SEED, rank)), dev)
            for rank in range(world)]
    return {k: torch.cat([getattr(r, k).cpu() for r in runs],
                         dim=0 if getattr(runs[0], k).dim() == 1 else 1)
            for k in runs[0]._fields}


def check_parallel(phase, backend, world, results, want, net_cfg, dev, rows,
                   smi):
    """A group's results: the gathered records against ``want`` on every
    active record, bit for bit, the same on every rank; each rank's
    launches; the train step against ``train_epoch_gather`` (phase 21a's
    criterion); the loop's history equal on every rank."""
    active = want["active"]
    for rank, r in enumerate(results):
        if r["backend"] != backend or r["world"] != world:
            raise AssertionError(f"rank {rank}: {r['backend']} world "
                                 f"{r['world']}, expected {backend} {world}")
        got = r["traj"]
        if not torch.equal(got["active"], active):
            raise AssertionError(f"rank {rank}: active records differ")
        for k, v in want.items():
            if v is None or k == "active":
                continue
            g = got[k]
            same = (torch.equal(g, v) if v.dim() == 1
                    else torch.equal(g[active], v[active]))
            if not same:
                raise AssertionError(f"{phase} rank {rank}: gathered {k} "
                                     f"differs from the unsharded run")
        expect_launches(f"{phase} sharded self-play, rank {rank}",
                        r["launches"], {
                            "gumbel_select_walk": MOVES * GUMBEL_SIMS,
                            "backup_paths": MOVES * GUMBEL_SIMS,
                            "int8_tower": MOVES * (1 + GUMBEL_SIMS)})
        for name, n in r["launches"].items():
            rows[name].setdefault("launches_by_path", {})[
                f"sharded_{backend}{world}_rank{rank}"] = n
        log(f"{phase} rank {rank} of {world} ({backend}, {r['mesh']}): "
            f"{r['moves']} moves in {r['seconds']:.3f} s = "
            f"{r['moves'] / r['seconds']:.2f} moves/s; all-gather "
            f"{r['gather_ms']:.3f} ms; train step {r['step_ms']:.3f} ms, "
            f"the same step with its collectives the identity "
            f"{r['alone_ms']:.3f} ms (the collectives' share of the step "
            f"{1 - r['alone_ms'] / r['step_ms']:.4f}; each of the two runs,"
            f" ms a step: {r['step_times']}); on {smi}")
    log(f"{phase}: gathered records equal the unsharded run on every active "
        f"record ({int(active.sum())} of {active.numel()}), bit for bit, on "
        f"every rank")
    first = results[0]
    for rank, r in enumerate(results[1:], 1):
        for part in ("step", "hist"):
            if not trees_equal(r[part], first[part]):
                raise AssertionError(f"{phase}: rank {rank}'s {part} "
                                     f"differs from rank 0's")
    # one sharded step against the single-process epoch on the same ring
    ring, idx = first["ring"], first["idx"]
    model = AZModel(board_size=BOARD, n_res_blocks=net_cfg.n_res_blocks,
                    channels=net_cfg.channels, seed=PARALLEL_SEED, device=dev)
    p, s, o, m = train_epoch_gather(
        model.cfg, model.tx, model.params, model.batch_stats, model.opt_state,
        *(t.to(dev) for t in ring), idx.to(dev), torch.ones(3, device=dev))
    got = first["step"]
    worst, worst_chaotic, n_chaotic = 0.0, 0.0, 0
    for k in p:
        a = got["mu"][k].to(dev).double() / (1 - model.tx.b1)
        b = o.mu[k].double() / (1 - model.tx.b1)
        chaotic = b.abs() <= (a - b).abs() + 1e-6
        diff = (got["params"][k].to(dev).double() - p[k].double()).abs()
        worst = max(worst, float(torch.where(chaotic, 0.0, diff).max()))
        worst_chaotic = max(worst_chaotic,
                            float(torch.where(chaotic, diff, 0.0).max()))
        n_chaotic += int(chaotic.sum())
    loss_diff = abs(got["metrics"]["total_loss"] - float(m["total_loss"]))
    log(f"{phase} sharded train step against train_epoch_gather: "
        f"{n_chaotic} sign-chaotic elements within {worst_chaotic:.3e} "
        f"(tolerance {CHAOTIC_TOL}), the others within {worst:.3e} "
        f"(tolerance {STEP_TOL}); loss {got['metrics']['total_loss']:.6f} "
        f"against {float(m['total_loss']):.6f}")
    if not (worst <= STEP_TOL and worst_chaotic <= CHAOTIC_TOL
            and loss_diff <= 1e-4):
        raise AssertionError(f"{phase}: the sharded train step is off "
                             f"train_epoch_gather beyond phase 21a's "
                             f"tolerances")
    hist, timing = first["hist"], first["hist_timing"]
    log(f"{phase} train_alphazero on the mesh: {hist['moves']} moves at "
        f"{timing['moves_per_second']:.2f} moves/s (rank 0), loss "
        f"{hist['loss']}, win_rate {hist['win_rate']}, phases "
        f"{timing['phase_seconds']}; every rank the same loss and win rate; "
        f"files of rank 0: {first['files']}, of the others: "
        f"{[r['files'] for r in results[1:]]}")
    if hist["loss"] is None or not all(map(math.isfinite,
                                           hist["loss"].values())):
        raise AssertionError(f"{phase}: loss {hist['loss']}")
    if "best_latest.ckpt" not in first["files"] or any(
            r["files"] for r in results[1:]):
        raise AssertionError(f"{phase}: only rank 0 writes the model")


def check_trace(path: str):
    """The Chrome trace names the three kernels of the iteration's path."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    regions = {e["name"] for e in events
               if e.get("name") in ("selfplay", "train")}
    want = {"gumbel_select_walk": "gumbel_select_walk",
            "backup_paths": "backup_paths",
            "int8_tower": "Int8Op"}
    found = {}
    for row, part in want.items():
        names = sorted(n for n in kernels if part in n)
        if not names:
            raise AssertionError(f"the trace names no {row} kernel; its "
                                 f"kernels: {sorted(kernels)[:40]}")
        found[row] = names[0][:120]
    log(f"trace {path} ({os.path.getsize(path) / 2 ** 20:.1f} MiB, "
        f"{len(events)} events, {len(kernels)} kernel names): {found}; "
        f"regions {sorted(regions)}")
    if regions != {"selfplay", "train"}:
        raise AssertionError(f"trace regions {regions}")


def parallel_worker(args) -> int:
    """One rank of phase 26 (``run_ranks``): joins the group, plays its
    share of the games, gathers them, runs the train step and the timed
    steps on a ring of the gathered samples, and one ``train_alphazero``
    iteration; saves what the main process checks."""
    rank, world, port, trace = (int(x) for x in args.parallel_worker[0]
                                .split(","))
    out = args.parallel_worker[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ranks that outnumber the cards share one over gloo (NCCL refuses two
    # ranks on a device), asked for explicitly
    initialize_distributed(
        f"localhost:{port}", world, rank,
        backend="gloo" if world > torch.cuda.device_count() else "nccl")
    try:
        mesh = make_mesh()
        result = parallel_rank(args, mesh, out, trace)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{mesh.rank}.pt"))
    print(f"rank {mesh.rank} done", flush=True)
    return 0


def parallel_rank(args, mesh, out, trace: bool):
    dev = mesh.device
    env = make_env("gomoku", BOARD)
    net_cfg = NetConfig.full(BOARD)
    tower_eval = t8.make_int8_tower_eval_fn(net_cfg)
    packed = torch.load(os.path.join(os.path.dirname(out), "bundle.pt"),
                        map_location=dev, weights_only=False)
    cfg = SelfPlayConfig(batch_games=BATCH, mcts=PARALLEL_MCTS,
                         max_moves=MOVES)
    print(f"mesh: {mesh.describe()}; {torch.cuda.get_device_name(dev)}",
          flush=True)
    selfplay = make_sharded_selfplay(env, cfg, tower_eval, mesh)
    warm = make_sharded_selfplay(
        env, dataclasses.replace(cfg, max_moves=1), tower_eval, mesh)
    warm(packed, PARALLEL_SEED)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    reset_launch_counts()
    t0 = time.perf_counter()
    local = selfplay(packed, PARALLEL_SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    moves = int(local.moves_played.clamp(max=MOVES).sum())
    gather_trajectories(local, mesh)            # a warm-up of the gather
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = gather_trajectories(local, mesh)
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) * 1e3

    # a ring of the gathered games' samples, the same on every rank
    states, pis, zs, _ = collect_examples(traj)
    buffer = ReplayBuffer(capacity=len(zs), board_size=BOARD, channels=3)
    buffer.add(states, pis, zs)
    mirror = DeviceBufferMirror(buffer, device=dev)
    draws = np.random.default_rng(PARALLEL_SEED)
    idx = torch.as_tensor(np.stack([
        draws.choice(len(buffer), size=TRAIN_BATCH, replace=False)
        for _ in range(PARALLEL_TRAIN_STEPS)]), device=dev)
    ring = (mirror.states, mirror.pis, mirror.zs)
    model = AZModel(board_size=BOARD, n_res_blocks=net_cfg.n_res_blocks,
                    channels=net_cfg.channels, seed=PARALLEL_SEED,
                    device=dev)
    epoch = make_sharded_gather_epoch(model.cfg, model.tx, mesh)
    start = (model.params, model.batch_stats, model.opt_state)
    p, s, o, m = epoch(*start, *ring, idx[:1], mirror.inv_scales)
    step = {"params": p, "mu": o.mu,
            "metrics": {k: float(v) for k, v in m.items()}}
    # what the collectives cost a step: the same step of this rank's slice
    # with them made the identity (a mesh of one member, no group), timed
    # in turn with the sharded one, each after a barrier
    per = TRAIN_BATCH // mesh.size
    runs = {"step": (epoch, idx),
            "alone": (make_sharded_gather_epoch(model.cfg, model.tx,
                                                DataMesh(1, 0, dev)),
                      idx[:, mesh.rank * per:(mesh.rank + 1) * per])}
    for fn, rows in runs.values():                          # warm
        fn(*start, *ring, rows[:1], mirror.inv_scales)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = {k: [] for k in runs}
    for k in ("step", "alone", "alone", "step"):
        fn, rows = runs[k]
        torch.distributed.barrier()
        torch.cuda.synchronize()
        begin.record()
        fn(*start, *ring, rows, mirror.inv_scales)
        end.record()
        torch.cuda.synchronize()
        times[k].append(begin.elapsed_time(end) / PARALLEL_TRAIN_STEPS)
    step_ms, alone_ms = min(times["step"]), min(times["alone"])

    model_dir = os.path.join(out, f"model{mesh.rank}")
    hist = train_alphazero(
        board_size=BOARD, games_per_iteration=BATCH,
        n_simulations=GUMBEL_SIMS, mcts_search="gumbel",
        gumbel_max_considered=GUMBEL_M, mcts_reuse_budget=REUSE_BUDGET,
        mcts_backend="pallas", inference="int8t",
        n_res_blocks=net_cfg.n_res_blocks, channels=net_cfg.channels,
        buffer_size=PARALLEL_BUFFER, batch_size=TRAIN_BATCH,
        epochs_per_iter=1, selfplay_max_moves=MOVES,
        eval_games=PARALLEL_ARENA_GAMES,
        eval_mcts_simulations=PARALLEL_ARENA_SIMS, eval_every=1 + trace,
        gate_mode="track",
        num_iterations=1, seed=args.seed, model_dir=model_dir,
        mesh=mesh if mesh.size == 1 else "auto",
        profile_trace_dir=os.path.join(out, "trace") if trace else None,
        verbose=mesh.rank == 0)[0]
    result = {
        "backend": mesh.backend, "world": mesh.size, "mesh": mesh.describe(),
        "traj": {k: (None if v is None else v.cpu())
                 for k, v in traj._asdict().items()},
        "launches": launches, "moves": moves, "seconds": seconds,
        "gather_ms": gather_ms, "step_ms": step_ms, "alone_ms": alone_ms,
        "step_times": times,
        "step": {"params": {k: v.cpu() for k, v in step["params"].items()},
                 "mu": {k: v.cpu() for k, v in step["mu"].items()},
                 "metrics": step["metrics"]},
        "ring": tuple(t.cpu() for t in ring), "idx": idx[:1].cpu(),
        "hist": {k: hist[k] for k in ("loss", "win_rate", "moves",
                                       "buffer_size", "winners")},
        "files": sorted(os.listdir(model_dir)) if os.path.isdir(model_dir)
        else []}
    result["hist_timing"] = {
        "moves_per_second": hist["moves_per_second"],
        "phase_seconds": {k: round(v, 3)
                          for k, v in hist["phase_seconds"].items()}}
    if trace and mesh.rank == 0:
        result["trace"] = glob.glob(os.path.join(out, "trace",
                                                 "trace_*.json"))[0]
    return result


def player_trace(player, moves: int, think=None):
    """``moves`` moves of ``player`` (P2) from a stone at the centre, each
    answered by the reply its carried tree expects (``principal_reply``):
    ``(its moves, [(search, pi, (the carry it started from, the carry it
    returned)), ...])``; appends each move's seconds to ``think``."""
    searches = []
    for name in ("_search_fresh", "_search_resume"):
        def run(*args, name=name, search=getattr(player, name)):
            pi, carry = search(*args)
            searches.append((name, pi, (args[0], carry)))
            return pi, carry
        setattr(player, name, run)
    board = np.zeros((BOARD, BOARD), np.int8)
    board[BOARD // 2, BOARD // 2] = 1
    played = []
    for turn in range(moves):
        t0 = time.perf_counter()
        move = player.play(board.copy(), 2 * turn + 1, None)
        if think is not None:
            think.append(time.perf_counter() - t0)
        board[move] = 2
        played.append(move)
        board[principal_reply(player, board)] = 1
    return played, searches


def gumbel_trace(player, moves: int):
    """``moves`` moves of a Gumbel ``player`` (P2) from a stone at the
    centre, each answered on the first empty point: ``(its moves, [pi of
    each search])``."""
    pis = []
    search = player._search

    def run(*args):
        pi = search(*args)
        pis.append(pi)
        return pi

    player._search = run
    board = np.zeros((BOARD, BOARD), np.int8)
    board[BOARD // 2, BOARD // 2] = 1
    played = []
    for turn in range(moves):
        move = player.play(board.copy(), 2 * turn + 1, None)
        board[move] = 2
        played.append(move)
        board[divmod(int(np.flatnonzero(board.reshape(-1) == 0)[0]),
                     BOARD)] = 1
    return played, pis


class FanWalks:
    """``gumbel_select_walk`` that keeps a copy of the tree, the root
    actions and the other arguments of its last call at each fan."""

    def __init__(self):
        self.kept = {}

    def __call__(self, packed, root, *args):
        self.kept[args[-1]] = (packed.clone(), root.clone(), *args[:-1])
        return tk.gumbel_select_walk(packed, root, *args)


def hold_player_tree(cfg, c_puct, carry, floor, seed: int):
    """K1 (fpu parent, as the players walk) and K2 (mode backup, at depth
    ``cfg.depth_limit``) held against their plain versions and timed on a
    player's lane-0 tree ``carry``: ``(K1's row, K2's row)``, each with
    ``hop_ms``, its graph-replay time less an empty launch per hop of the
    longest path."""
    a = BOARD * BOARD
    layout = tk.packed_layout(a, cfg.node_capacity)
    tree, depth = carry.packed, cfg.depth_limit
    sel, walk = hold_select(tree, layout, c_puct, depth, floor,
                            fpu_parent=True)
    _, action, pnodes, pacts, plen = sel
    gen = phase_gen(seed, 25, tree.device)
    legal = torch.rand((1, a), generator=gen, device=tree.device) < 0.9
    priors = torch.where(legal, torch.rand(legal.shape, generator=gen,
                                           device=tree.device), -1.0)
    bargs = (pnodes, pacts, plen, torch.full((1,), 0.25, device=tree.device),
             action >= 0, cfg.node_capacity - 1, layout, priors,
             torch.zeros(1, dtype=torch.bool, device=tree.device))
    _, back = hold_backup(tree, bargs, "backup", floor)
    walk["hop_ms"] = (walk["ms"] - floor["empty_ms"]) / walk["path_len_max"]
    log(f"batch 1, {tree_nodes(carry)}-node tree of {cfg.node_capacity} "
        f"slots ({tree.numel() * tree.element_size() / 1e6:.1f} MB packed): "
        f"select_walk {walk['hop_ms'] * 1e6:.1f} ns a hop over "
        f"{walk['path_len_max']} hops")
    return walk, back


def principal_reply(player, board):
    """The reply a player's carried tree expects (its root's most visited
    action), else the first empty point: the opponent plays the principal
    variation, so the next search resumes a grown subtree."""
    carry = player._carry
    if carry is not None:
        visits = carry.packed[0, tk.SL_N, :board.size]
        if float(visits.sum()) > 0:
            return divmod(int(torch.argmax(visits)), BOARD)
    return divmod(int(np.flatnonzero(board.reshape(-1) == 0)[0]), BOARD)


def tree_nodes(carry) -> int:
    """Nodes of a lane-0 tree: the root and every slot with a parent."""
    return 1 + int((carry.parent[0] >= 0).sum())


def check_tournament(path: str):
    """The tournament's metrics: its games, wins plus draws, every recorded
    move legal when the games are replayed from their seats' move lists."""
    with open(path) as f:
        m = json.load(f)
    if m["n_games"] != LOOP_GAMES or (
            m["draws"] + sum(m["wins"].values()) != LOOP_GAMES):
        raise AssertionError(f"metrics: {m['n_games']} games, wins "
                             f"{m['wins']}, draws {m['draws']}")
    names = [m["player1"][0], m["player2"][0]]
    for i in range(1, LOOP_GAMES + 1):
        key = f"game_{i}"
        first = m["starting_player_per_game"][key]
        second = names[1] if first == names[0] else names[0]
        a, b = m["move_made"][first][key], m["move_made"][second][key]
        if len(a) - len(b) not in (0, 1):
            raise AssertionError(f"{key}: {len(a)} and {len(b)} moves")
        game = make_host_game(m["game"], BOARD)
        for k in range(len(a) + len(b)):
            move = (a if k % 2 == 0 else b)[k // 2]
            if not game.do_move(tuple(move)):
                raise AssertionError(f"{key}: illegal move {move} at ply "
                                     f"{k}")
        if not game.is_game_over():
            raise AssertionError(f"{key}: not over after {k + 1} plies")
        log(f"{key}: {first} first, {k + 1} plies, winner "
            f"{game.get_winner()}")


def check_history(hist, want_keys, model_dir, smi):
    """The history's keys, finite losses, the files each iteration wrote;
    prints each iteration's phases and self-play moves/s."""
    for h in hist:
        if set(h) != want_keys:
            raise AssertionError(f"history keys {sorted(h)}")
        loss = h["loss"]
        if loss is None or not all(map(math.isfinite, loss.values())):
            raise AssertionError(f"iteration {h['iteration']}: loss {loss}")
        if not os.path.exists(h["snapshot"]):
            raise AssertionError(f"no snapshot {h['snapshot']}")
        phases = ", ".join(f"{k} {v:.3f} s"
                           for k, v in h["phase_seconds"].items())
        log(f"iteration {h['iteration']}: {h['moves']} self-play moves at "
            f"{h['moves_per_second']:.2f} moves/s; phases: {phases}; loss "
            f"{loss['total_loss']:.4f}; win_rate {h['win_rate']}; on {smi}")
    for name in ("best_latest.ckpt", "replay_buffer_latest.npz"):
        if not os.path.exists(os.path.join(model_dir, name)):
            raise AssertionError(f"no {name} written")


def trees_equal(a, b) -> bool:
    """Two checkpoint state dicts (or nested dicts of tensors and numbers)
    hold the same keys and equal arrays and values."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(trees_equal(a[k], b[k]) for k in a))
    if not hasattr(a, "dtype"):
        return a == b
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool((a == b).all()))


def reuse_trace(env, cfg, eval_fn, bundle, states, moves, generator, ops):
    """``REUSE_MOVES`` searches with reuse, each followed by
    ``packed_advance_root`` with the greedy (PUCT) or halving (Gumbel) move:
    every output and every carry field, in order."""
    carry = init_packed_carry(env, cfg, states)
    out = []
    for _ in range(REUSE_MOVES):
        if cfg.search == "gumbel":
            pi, q, act, carry = run_gumbel_packed_with_tree(
                env, cfg, eval_fn, bundle, states, generator, ops=ops,
                carry=carry)
        else:
            pi, q, carry = run_mcts_packed_with_tree(
                env, cfg, eval_fn, bundle, states, moves, generator, ops=ops,
                carry=carry)
            act = pi.argmax(dim=1)
        act = torch.where(states.done, 0, act)
        out += [pi, q, act, carry.packed, *carry.states, carry.parent,
                carry.parent_action]
        carry = packed_advance_root(env, cfg, carry, act)
        out += [carry.packed, *carry.states, carry.parent,
                carry.parent_action]
        states = env.step_safe(states, act)
        moves = moves + 1
    return out


def correlation(x: torch.Tensor, y: torch.Tensor) -> float:
    """Pearson correlation of two tensors' entries, in float64."""
    return float(torch.corrcoef(torch.stack(
        [x.flatten(), y.flatten()]).double())[0, 1])


def resnet_tower(net, obs: torch.Tensor) -> torch.Tensor:
    """The float32 ``ResNet``'s last block output, NHWC."""
    with torch.no_grad():
        h = torch.relu(net.stem_bn(net.stem(obs.permute(0, 3, 1, 2))))
        for blk in net.blocks:
            h = blk(h)
    return h.permute(0, 2, 3, 1)


def check_trajectories(env, traj, moves: int, batch: int = BATCH):
    """A main path's output, by the repo's own means: pi is a distribution
    over legal moves, boards gain one stone a ply (less two for each pair
    captured, in Pente), values are finite."""
    pis = traj.pis[:moves]
    if pis.shape != (moves, batch, env.num_actions):
        raise AssertionError(f"pis shape {tuple(pis.shape)}")
    if not (torch.isfinite(pis).all() and torch.isfinite(traj.root_qs).all()):
        raise AssertionError("non-finite pi or root_q")
    if not traj.active[:moves].all():
        raise AssertionError(f"a game ended within {moves} moves")
    sums = pis.sum(dim=-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        raise AssertionError("pi rows do not sum to 1")
    for t in range(moves):
        board = traj.boards[t].reshape(batch, -1)
        stones = (t - 2 * traj.captures[t].sum(dim=1)).long()
        if not torch.equal((board != 0).sum(dim=1), stones):
            raise AssertionError(f"ply {t}: wrong stone count")
        if (pis[t][board != 0] != 0).any():
            raise AssertionError(f"ply {t}: pi on an occupied point")
        acts = traj.actions[t].long()
        if (board.gather(1, acts[:, None]) != 0).any():
            raise AssertionError(f"ply {t}: a move on an occupied point")
    if traj.root_qs[:moves].abs().max() > 1.0 + 1e-6:
        raise AssertionError("root_q outside [-1, 1]")
    log(f"trajectories: {moves} plies x {batch} games checked; "
        f"root_q mean {float(traj.root_qs[:moves].mean()):.4f}, pi max mean "
        f"{float(pis.max(dim=-1).values.mean()):.4f}")


if __name__ == "__main__":
    sys.exit(main())
