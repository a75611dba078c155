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
    ``main``, both variants): kernel ``width1_slice_write``.

Each path's launch counts are set to 0 just before it and read just after;
every kernel a path does not name must launch 0 times on it.  The k-leaf
search and the reuse searches (with ``packed_advance_root`` between moves)
are also held, on the kernels, against the same searches on the plain
versions.  The towers' rates (K5, K4) are printed over the probe's
``mma.sync`` rate at their own GEMM shape (M 57600, k 128).
Every phase prints its seconds.  Nothing is caught: a failed phase exits
non-zero.  Without a CUDA card it exits 1 before any result.  The last lines
are the card's ``nvidia-smi`` name and power limit, a JSON line with each
kernel's launches on its main path, its error against the plain version and
its times, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import (
    NetConfig,
    bundle_of,
    init_params,
    make_eval_fn,
)
from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops import fused_net as fn
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
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
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    run_gumbel_packed_with_tree,
    run_mcts_packed,
    run_mcts_packed_with_tree,
)
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games
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
# from the same tower with float64 sums (``fused_tower_f64``, printed each
# run): any float32 order lands about a step away.  The heads, the same
# float32 ops on both sides, carry the tower's difference on to logits and
# value, which are printed.
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
}


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


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn()`` by CUDA events around a loop of
    eager calls: the host's launch cost counts where it exceeds the work."""
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


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn()``: ``reps`` calls captured in
    one CUDA graph and replayed, so the host's launch cost is left out."""
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_gen(seed: int, tag: int, dev) -> torch.Generator:
    """A generator of its own for each phase (``tag`` its number, 100 more
    for a search's pair of generators), so that what a phase draws does not
    depend on what the phases before it drew."""
    return torch.Generator(device=dev).manual_seed(1000 * seed + tag)


def smoke_weights(cfg: NetConfig, seed: int, dev):
    """``(params, batch_stats)`` of the smoke's net: ``init_params(seed)``
    with each BN's running mean and variance set to the batch statistics of
    its input on ``random_calib_obs`` boards (seed + 1), layer by layer, as a
    trained net's are its data's.  With the initial stats (mean 0, var 1)
    the random tower's outputs grow block by block and its heads are dead or
    saturated: the 15x15 6x128 net's policy logits are exactly 0 on most
    boards, its value 0 or +-1, so that a check of logits or values would
    hold little."""
    params, stats = init_params(cfg, seed)
    net = bundle_of(cfg, params, stats, device=dev)
    obs = torch.from_numpy(q8.random_calib_obs(cfg, seed=seed + 1)).to(dev)

    def fit(bn, x, st):
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
        st["mean"] = mean.cpu().numpy()
        st["var"] = var.cpu().numpy()
        return bn(x)

    with torch.no_grad():
        h = torch.relu(fit(net.stem_bn, net.stem(obs.permute(0, 3, 1, 2)),
                           stats["stem_bn"]))
        for blk, st in zip(net.blocks, stats["blocks"]):
            m = torch.relu(fit(blk.bn1, blk.conv1(h), st["bn1"]))
            h = torch.relu(fit(blk.bn2, blk.conv2(m), st["bn2"]) + h)
        fit(net.policy_bn, net.policy_conv(h), stats["policy_bn"])
        fit(net.value_bn, net.value_conv(h), stats["value_bn"])
    return params, stats


def random_states(env, batch, plies, generator, dev):
    """Games advanced by ``plies`` uniformly random legal moves."""
    states = env.init_batch(batch, dev)
    for _ in range(plies):
        legal = env.legal_mask(states)
        u = torch.rand(legal.shape, generator=generator, device=dev)
        states = env.step_safe(states, torch.argmax(
            torch.where(legal, u, -1.0), dim=1))
    return states


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
    args = ap.parse_args()
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
        for built in _build.build_all(["tree_kernels", "fused_net",
                                       "int8_tower", "matmul_rate",
                                       "width1_slice"]).values():
            how = "reused an earlier build" if built.reused else "built"
            log(f"{how}: {built.path.name}, nvcc {built.seconds:.2f} s")
            for line in built.ptxas:
                log(f"  {line}")

    with Phase("2b the 6x128 net: init_params, BN stats fitted to "
               "random_calib_obs boards"):
        weights = smoke_weights(net_cfg, args.seed, dev)
        net = bundle_of(net_cfg, *weights, device=dev)
    eval_fn = make_eval_fn()

    grow = dataclasses.replace(MAIN_MCTS, n_simulations=GROW_SIMS,
                               max_nodes=MAIN_MCTS.node_capacity)
    layout = tk.packed_layout(env.num_actions, grow.node_capacity)
    depth = grow.depth_limit
    with Phase(f"3 kernels against their plain versions (batch {BATCH}, "
               f"{layout.n_nodes} nodes, seg {layout.seg}, depth cap {depth})"):
        gen = phase_gen(args.seed, 3, dev)
        states = random_states(env, BATCH, 4, gen, dev)
        moves = torch.full((BATCH,), 4, dtype=torch.int32, device=dev)
        tree = run_mcts_packed_with_tree(env, grow, eval_fn, net, states,
                                         moves, gen)[2].packed
        log(f"grew the tree: {grow.n_simulations} simulations, packed "
            f"{tuple(tree.shape)}")

        sel = tk.select_walk(tree, layout, grow.cpuct, depth)
        sel_plain = tk.select_walk_plain(tree, layout, grow.cpuct, depth)
        for name, k, p in zip(("leaf", "action", "path_nodes",
                               "path_actions", "path_len"), sel, sel_plain):
            if not torch.equal(k, p):
                raise AssertionError(f"select_walk {name}: kernel != plain "
                                 f"(tolerance 0)")
        err = max_abs_err(sel, sel_plain)
        plen = sel[4]
        log(f"select_walk: kernel == plain on every output, tolerance 0 "
            f"(max abs err "
            f"{err}); path_len mean {plen.float().mean():.2f} max "
            f"{int(plen.max())}")
        def select_call():
            return tk.select_walk(tree, layout, grow.cpuct, depth)

        ms = graph_ms(select_call, reps=50)
        eager_ms = cuda_ms(select_call, reps=50)
        plain_ms = cuda_ms(lambda: tk.select_walk_plain(
            tree, layout, grow.cpuct, depth), reps=10, warmup=1)
        bound_ms, bound_by = select_bound(layout, sel, depth)
        rows["select_walk"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=None)
        log(f"select_walk: kernel {ms:.4f} ms (CUDA graph replay; eager "
            f"wrapper call {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}); no single PyTorch call computes "
            f"the walk, so library_ms is null")

        leaf, action, pnodes, pacts, plen = sel
        values = torch.rand(BATCH, generator=gen, device=dev) * 2 - 1
        legal = torch.rand((BATCH, env.num_actions), generator=gen,
                           device=dev) < 0.9
        priors = torch.where(legal, torch.rand(legal.shape, generator=gen,
                                               device=dev), -1.0)
        done = torch.rand(BATCH, generator=gen, device=dev) < 0.1
        expanding = action >= 0
        slot = grow.n_simulations + 1
        bargs = (pnodes, pacts, plen, values, expanding, slot, layout, priors,
                 done)
        got = tk.backup_paths(tree.clone(), *bargs)
        want = tk.backup_paths_plain(tree.clone(), *bargs)
        if not torch.equal(got, want):
            raise AssertionError("backup_paths: kernel != plain (tolerance 0)")
        if torch.equal(got, tree):
            raise AssertionError("backup_paths changed nothing")
        err = float((got - want).abs().max())
        log(f"backup_paths: kernel == plain on the whole packed tree, "
            f"tolerance 0 (max abs err {err})")
        # repeated backups on one scratch tree: the path stays valid
        scratch = tree.clone()
        def backup_call():
            return tk.backup_paths(scratch, *bargs)

        ms = graph_ms(backup_call, reps=50)
        eager_ms = cuda_ms(backup_call, reps=50)
        plain_ms = cuda_ms(lambda: tk.backup_paths_plain(scratch, *bargs),
                           reps=10, warmup=1)
        bound_ms, bound_by = backup_bound(layout, plen, expanding)
        rows["backup_paths"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=None)
        log(f"backup_paths: kernel {ms:.4f} ms (CUDA graph replay; eager "
            f"wrapper call {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}); no single PyTorch call computes "
            f"the backup, so library_ms is null")
        del tree, scratch, got, want

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
        t0 = time.perf_counter()
        traj = play_games(env, sp_cfg, eval_fn, net, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
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

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    log(json.dumps({"kernels": [rows[k] for k in KERNEL_ROWS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def reset_launch_counts():
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


def expect_launches(path: str, got, want):
    """``want`` gives the kernels a path launches; every other one must
    launch 0 times."""
    log(f"launches on the {path}: {got}")
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")


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
               f"{depth})"):
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
            walk = tk.gumbel_select_walk(tree, root, layout, depth, cv, cs,
                                         fan)
            plain = tk.gumbel_select_walk_plain(tree, root, layout, depth, cv,
                                                cs, fan)
            for name, k, p in zip(("leaf", "action", "path_nodes",
                                   "path_actions", "path_len"), walk, plain):
                if not torch.equal(k, p):
                    raise AssertionError(f"gumbel_select_walk fan {fan} "
                                         f"{name}: kernel != plain "
                                         f"(tolerance 0)")
            err = max_abs_err(walk, plain)
            plen = walk[4]

            def call(root=root, fan=fan):
                return tk.gumbel_select_walk(tree, root, layout, depth, cv,
                                             cs, fan)

            ms = graph_ms(call, reps=50)
            eager_ms = cuda_ms(call, reps=50)
            plain_ms = cuda_ms(lambda root=root, fan=fan:
                               tk.gumbel_select_walk_plain(
                                   tree, root, layout, depth, cv, cs, fan),
                               reps=5, warmup=1)
            bound_ms, bound_by = gumbel_bound(layout, walk, depth)
            log(f"gumbel_select_walk fan {fan} ({BATCH * fan} lanes): kernel "
                f"== plain on every output, tolerance 0 (max abs err {err}); "
                f"path_len mean {plen.float().mean():.2f} max "
                f"{int(plen.max())}; kernel {ms:.4f} ms (CUDA graph replay; "
                f"eager wrapper call {eager_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
            if fan == 1:
                rows["gumbel_select_walk"].update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            else:
                rows["gumbel_select_walk"].update(
                    fan16_ms=ms, fan16_plain_ms=plain_ms,
                    fan16_bound_ms=bound_ms)
        log("no single PyTorch call computes the walk, so library_ms is null")
        del tree

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
            tower_f64 = fused_tower_f64(folded, obs)
            f64_logits, f64_value = fn._heads(net_cfg, folded, tower_f64)
        f64_errs = {"tower": float((tower_plain - tower_f64).abs().max()),
                    "logits": float((plain_logits - f64_logits).abs().max()),
                    "value": float((plain_value - f64_value).abs().max())}
        log(f"fused_tower: max abs err against plain {errs}, "
            f"{errs['tower'] / step:.3f} bf16 steps of the tower's largest "
            f"value ({float(tower_plain.abs().max()):.3f}); tolerance "
            f"{FUSED_TOWER_STEPS} steps.  The plain version against float64 "
            f"sums: {f64_errs}, {f64_errs['tower'] / step:.3f} steps")
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
        t0 = time.perf_counter()
        traj = play_games(env, sp_cfg, fused_eval, folded, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
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
               f"(batch {BATCH}, 6x128, {BOARD}x{BOARD}, tolerance 0)"):
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
        t0 = time.perf_counter()
        traj = play_games(env, sp_cfg, tower_eval, packed, gen, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
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
               f"versions (batch {BATCH}, tree of {GROW_SIMS} k-leaf sims, "
               f"k={KLEAF}, {layout.n_nodes} nodes)"):
        gen = phase_gen(args.seed, 15, dev)
        states = random_states(env, BATCH, 4, gen, dev)
        moves = torch.full((BATCH,), 4, dtype=torch.int32, device=dev)
        _, _, grown = run_mcts_packed_with_tree(env, grow, eval_fn, net,
                                                states, moves, gen)
        tree = grown.packed
        _, action, pnodes, pacts, plen = tk.select_walk(tree, layout,
                                                        grow.cpuct, depth)
        expanding = action >= 0
        slot = GROW_SIMS + 1
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
            got = tk.backup_paths(tree.clone(), *bargs, mode=mode)
            want = tk.backup_paths_plain(tree.clone(), *bargs, mode=mode)
            if not torch.equal(got, want):
                raise AssertionError(f"backup_paths {mode}: kernel != plain "
                                     f"(tolerance 0)")
            if torch.equal(got, tree):
                raise AssertionError(f"backup_paths {mode} changed nothing")
            err = float((got - want).abs().max())
            # finalize reads the tile vl left: the macro step's order
            tree = got
            scratch = tree.clone()

            def call(bargs=bargs, mode=mode):
                return tk.backup_paths(scratch, *bargs, mode=mode)

            ms = graph_ms(call, reps=50)
            eager_ms = cuda_ms(call, reps=50)
            plain_ms = cuda_ms(lambda bargs=bargs, mode=mode:
                               tk.backup_paths_plain(scratch, *bargs,
                                                     mode=mode),
                               reps=10, warmup=1)
            bound_ms, bound_by = backup_bound(layout, plen, expanding, mode)
            rows[f"backup_paths_{mode}"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)
            log(f"backup_paths {mode}: kernel == plain on the whole packed "
                f"tree, tolerance 0 (max abs err {err}); kernel {ms:.4f} ms "
                f"(CUDA graph replay; eager wrapper call {eager_ms:.4f} ms), "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
                f"({bound_by}); no single PyTorch call computes the backup, "
                f"so library_ms is null")
        del tree, scratch, grown

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
                f"the probe's {name} mma.sync rate {probe:.2f} T/s at M {m}, "
                f"k {k}, reps {reps} (the library's {library:.2f} T/s) on "
                f"{smi}")

    b, g, r, c = ws.B, ws.G, ws.R, ws.C
    with Phase(f"20a width1_slice_write against its plain version ([{b}, {g}, "
               f"{r}] float32, column {c}, both variants, tolerance 0)"):
        x = torch.randn((b, g, r), generator=phase_gen(args.seed, 20, dev),
                        device=dev)
        times, w1_err = {}, 0.0
        for ok in (False, True):
            got = ws.width1_slice_write(x, c, ok)
            err = max_abs_err([got], [ws.width1_slice_write_plain(x, c, ok)])
            w1_err = max(w1_err, err)
            if not err == 0.0:
                raise AssertionError(f"width1_slice_write ok={ok}: max abs err"
                                     f" {err} (tolerance 0)")
            if torch.equal(got, x):
                raise AssertionError("width1_slice_write changed nothing")

            def call(ok=ok):
                return ws.width1_slice_write(x, c, ok)

            times[ok] = (graph_ms(call, reps=50), cuda_ms(call, reps=50),
                         cuda_ms(lambda ok=ok: ws.width1_slice_write_plain(
                             x, c, ok), reps=20))
            log(f"width1_slice_write {'ok' if ok else 'width-1'}: kernel == "
                f"plain, tolerance 0; kernel {times[ok][0]:.4f} ms (CUDA "
                f"graph replay; eager wrapper call {times[ok][1]:.4f} ms), "
                f"plain {times[ok][2]:.4f} ms")

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
            ok_plain_ms=times[True][2])
        for name, n in launches.items():
            rows[name]["launches_by_path"]["width1_repro"] = n
        log(f"width1_slice_write: bound {bound_ms:.6f} ms ({bound_by}); no "
            f"single PyTorch call computes the function, so library_ms is "
            f"null")


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


def fused_tower_f64(folded, obs: torch.Tensor) -> torch.Tensor:
    """``fused_tower_plain`` with its sums in float64, each conv's output
    rounded once to float32: how far a float32 summation order alone moves
    the tower."""

    def conv(x, taps, bias):
        b, h, w, cin = x.shape
        pad = F.pad(x.to(torch.bfloat16).double(), (0, 0, 1, 1, 1, 1))
        out = sum(pad[:, k // 3:k // 3 + h, k % 3:k % 3 + w, :]
                  .reshape(b * h * w, cin) @ taps[k].double()
                  for k in range(9))
        return (out + bias.double()).float().reshape(b, h, w, -1)

    x = torch.relu(conv(obs.float(), folded["stem_w"], folded["stem_b"]))
    for w, bias in zip(folded["block_w"], folded["block_b"]):
        y = torch.relu(conv(x, w[0], bias[0]))
        x = torch.relu(conv(y, w[1], bias[1]) + x)
    return x


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


def check_trajectories(env, traj, moves: int):
    """A main path's output, by the repo's own means: pi is a distribution
    over legal moves, boards gain one stone a ply, values are finite."""
    pis = traj.pis[:moves]
    if pis.shape != (moves, BATCH, env.num_actions):
        raise AssertionError(f"pis shape {tuple(pis.shape)}")
    if not (torch.isfinite(pis).all() and torch.isfinite(traj.root_qs).all()):
        raise AssertionError("non-finite pi or root_q")
    if not traj.active[:moves].all():
        raise AssertionError(f"a game ended within {moves} moves")
    sums = pis.sum(dim=-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        raise AssertionError("pi rows do not sum to 1")
    for t in range(moves):
        board = traj.boards[t].reshape(BATCH, -1)
        if not torch.equal((board != 0).sum(dim=1),
                           torch.full((BATCH,), t, device=board.device)):
            raise AssertionError(f"ply {t}: wrong stone count")
        if (pis[t][board != 0] != 0).any():
            raise AssertionError(f"ply {t}: pi on an occupied point")
        acts = traj.actions[t].long()
        if (board.gather(1, acts[:, None]) != 0).any():
            raise AssertionError(f"ply {t}: a move on an occupied point")
    if traj.root_qs[:moves].abs().max() > 1.0 + 1e-6:
        raise AssertionError("root_q outside [-1, 1]")
    log(f"trajectories: {moves} plies x {BATCH} games checked; "
        f"root_q mean {float(traj.root_qs[:moves].mean()):.4f}, pi max mean "
        f"{float(pis.max(dim=-1).values.mean()):.4f}")


if __name__ == "__main__":
    sys.exit(main())
