"""The six BASELINE configs on the card: self-play moves/s, and the rest.

Counterpart of the JAX repo's root ``bench.py``:

    python -m alphazero_gomoku_tpu_torch.bench [--all] [--out PATH]

prints one JSON line a config with ``bench.py``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline``, ``detail``).  Without ``--all`` it
runs one :func:`run_bench` at the flags (config #3's search at batch 256 by
default); ``--all`` runs the six configs of :func:`run_all`:

  1. pure-MCTS self-play on the host CPU (:func:`bench_pure_mcts`);
  2. a 2x64 net, one game, PUCT@100, 24 moves;
  3. the 6x128 net, 128 games, PUCT@400, 24 moves;
  4. Pente, the 6x128 net, 64 games, PUCT@400, 24 moves;
  5. one training iteration, 128 games at 400 simulations
     (:func:`bench_training_iteration`, the second of two);
  6. Gumbel@64 (m=16), 256 games, 48 moves.

Measured as ``bench.py`` measures (``bench.py:162-198`` there): the memory
preflight reckoned from the shapes (``selfplay/budget.py``), the host
quiesce wait, one untimed warm-up call of ``play_games`` ending in a
synchronize, then ``repeats`` timed calls, each from ``time.perf_counter()``
to a synchronize, counting ``sum(min(moves_played, measure_moves))``; the
value is the best repeat and every repeat is in
``detail.runs_moves_per_sec``.

Where the port differs:

  - **Inference.** ``bench.py`` names ``int8`` for configs #3, #4 and #6 and
    as its CLI default: on the TPU that was the fast path.  Here ``int8`` is
    ``int8_apply`` on ``torch._int_mm`` (7.6 ms a forward at batch 256,
    PERF.md §5), and ``int8t``, the int8 tower kernel (0.48 ms), computes
    the same function bit for bit; ``--all`` and the CLI default use
    ``int8t``, and ``--infer int8`` stays selectable.  ``bench.py``'s
    ``--int8t-tile`` has no counterpart: the kernel's tiling is its own.
  - **Roofline.** The peaks are an H100's (:data:`PEAK_TFLOPS`), named in
    ``detail.mfu_peak_ref`` beside the card's name.  The network's TFLOP/s
    count one leaf evaluation a simulation whatever ``leaves_per_sim`` is
    (k-leaf runs n/k calls of k leaves): ``nn_tflops_per_sec = value x
    n_simulations x net_flops_per_eval / 1e12``.  ``bench.py:208``
    multiplies by ``leaves_per_sim`` as well, which overstates k-leaf's
    rate k-fold (ROADMAP Queue C, P2).
  - **Devices.** Every entry point runs on the card unless it is given
    ``device="cpu"`` (the tests); with no card it raises.  On the CPU the
    roofline fields are None: they are device metrics.
  - ``--backend`` is accepted as ``train_alphazero`` accepts it: both values
    run the packed search on the kernels.  ``--trace DIR`` writes a
    ``torch.profiler`` trace of one timed repeat.
  - :func:`run_all` writes no ``BASELINE.json``; with ``--out PATH`` it
    writes ``{"date", "device", "results"}`` to that path.

``vs_baseline`` divides by the reference CPU engine's 8.6 moves/s at 400
simulations (``BASELINE.md``).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import subprocess
import tempfile
import time
from typing import Optional

import torch

from alphazero_gomoku_tpu_torch import selfplay
from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env, make_host_game
from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.search.pure_mcts import MCTSGomoku
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games
from alphazero_gomoku_tpu_torch.selfplay.budget import (
    preflight_memory_check,
    selfplay_memory,
)
from alphazero_gomoku_tpu_torch.utils.profiling import (
    start_profiler_trace,
    stop_profiler_trace,
)

BASELINE_MOVES_PER_SEC = 8.6  # reference CPU engine @ 400 sims (BASELINE.md)

# NVIDIA H100 SXM5 datasheet, dense (no sparsity), at the 700 W limit:
# float32 on the CUDA cores (the ResNet runs with TF32 off), bf16 and int8
# on the tensor cores.  The rate probe (K6, tools/matmul_rate.py) measured
# 1893-1897 TOP/s int8 and 917 TFLOP/s bf16 on an H100 80GB HBM3 at 700 W
# with the towers' wgmma forms (PERF.md §6).
PEAK_TFLOPS = {"f32": 66.9, "bf16": 989.4, "fused": 989.4,
               "int8": 1978.9, "int8t": 1978.9}
PEAK_SOURCE = "NVIDIA H100 SXM5 datasheet, dense"


def net_flops_per_eval(board_size: int, n_res_blocks: int, channels: int,
                       cin: int = 3) -> float:
    """FLOPs of one leaf evaluation (the BASELINE.md roofline formula).

    2*H*W*9*Cin*Cout per 3x3 SAME conv; two convs per res block; heads
    are <1% (counted coarsely).  6x128 on 15x15 evaluates to ~8.0e8,
    matching the hand-derived figure in BASELINE.md.
    """
    hw = board_size * board_size
    stem = 2 * hw * 9 * cin * channels
    tower = n_res_blocks * 2 * (2 * hw * 9 * channels * channels)
    heads = 2 * hw * channels * 3 + 2 * (2 * hw) * (hw + 1) + 2 * hw * 64
    return float(stem + tower + heads)


def nn_tflops_per_sec(moves_per_sec: float, n_simulations: int,
                      flops: float) -> float:
    """The network's TFLOP/s implied by a move rate: one leaf evaluation a
    simulation, whatever ``leaves_per_sim`` (P2 repaired)."""
    return moves_per_sec * n_simulations * flops / 1e12


def _quiesce(threshold: float = 1.5, max_wait: float = 90.0):
    """Wait for host CPU contention to clear before timing.

    The per-move orchestration runs on the host, so a busy host core reads
    as a phantom device slowdown.  Block until 1-min loadavg <
    ``threshold`` or ``max_wait`` is spent; return (final_load,
    seconds_waited) so the published result records the conditions it was
    measured under.
    """
    waited = 0.0
    load = os.getloadavg()[0]
    while load > threshold and waited < max_wait:
        time.sleep(5.0)
        waited += 5.0
        load = os.getloadavg()[0]
    return load, waited


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, after
    ``torch.cuda.get_device_name``; ``"cpu"`` on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return (f"{torch.cuda.get_device_name(dev)}; nvidia-smi: "
            f"{smi[index]}")


@contextlib.contextmanager
def tf32_off():
    """TF32 off for matmul and cuDNN, as the port runs the float32 ResNet
    (``chip_smoke.py`` phase 1); the flags are restored afterwards."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_bench(batch_games: int = 256, n_simulations: int = 400,
              board_size: int = 15, n_res_blocks: int = 6,
              channels: int = 128, measure_moves: int = 48, seed: int = 0,
              dtype: str = "float32", infer: str = "f32",
              backend: str = "pallas", game: str = "gomoku",
              leaves_per_sim: int = 1, search: str = "puct",
              gumbel_parallel: bool = False,
              vs_baseline: Optional[float] = BASELINE_MOVES_PER_SEC,
              trace_dir: Optional[str] = None, repeats: int = 3,
              int8_skip: str = "f32", quiesce_max_wait: float = 90.0,
              device=None) -> dict:
    """Lockstep self-play throughput (configs #2, #3, #4 and #6).

    ``infer`` picks the search's forward (``models.make_inference``):
    ``f32`` (the float32 ``ResNet``, TF32 off), ``bf16`` (the folded bf16
    forward), ``fused`` (the bf16 tower kernel), ``int8`` (``int8_apply``)
    or ``int8t`` (the int8 tower kernel); the int8 nets are calibrated on
    ``random_calib_obs`` boards, as ``bench.py`` calibrates them.  The net
    has random weights from ``seed``.  The value is the BEST of ``repeats``
    timed calls after the host-quiesce wait (at most ``quiesce_max_wait``
    seconds); each call's moves/s is in ``detail.runs_moves_per_sec``.
    ``backend`` is recorded and changes nothing.
    """
    dev = resolve_device(device)
    env = make_env(game, board_size)
    cin = env.obs_channels
    model = AZModel(board_size=board_size, n_res_blocks=n_res_blocks,
                    channels=channels, seed=seed,
                    compute_dtype={"float32": torch.float32,
                                   "bfloat16": torch.bfloat16}[dtype],
                    in_channels=cin, device=dev)
    eval_fn, bundle = make_inference(infer, model.cfg, *model.jax_params(),
                                     device=dev, int8_skip=int8_skip)
    cfg = SelfPlayConfig(
        batch_games=batch_games,
        temp_threshold=10,
        max_moves=measure_moves,
        mcts=MCTSConfig(n_simulations=n_simulations, cpuct=1.0,
                        add_noise=(search == "puct"), dirichlet_alpha=0.05,
                        dirichlet_epsilon=0.15, dirichlet_moves=10,
                        max_depth=56, leaves_per_sim=leaves_per_sim,
                        search=search,
                        gumbel_round_parallel=(gumbel_parallel
                                               and search == "gumbel")),
    )
    # a config reckoned over the card's memory raises here, before it
    # allocates (None on the CPU: no limit to check)
    preflight_memory_check(selfplay_memory(env, cfg, model.cfg),
                           label=f"bench selfplay batch={batch_games} "
                                 f"sims={n_simulations} infer={infer}",
                           device=dev)
    load, load_wait = _quiesce(max_wait=quiesce_max_wait)
    n_reps = max(1, repeats) if not trace_dir else 1
    with tf32_off():
        play_games(env, cfg, eval_fn, bundle,
                   torch.Generator(device=dev).manual_seed(2), dev)
        _sync(dev)
        gens = [torch.Generator(device=dev).manual_seed(3 + rep)
                for rep in range(n_reps)]

        if trace_dir:
            start_profiler_trace(trace_dir)
        runs = []
        moves = 0
        dt = float("inf")
        for rep in range(n_reps):
            t0 = time.perf_counter()
            traj = play_games(env, cfg, eval_fn, bundle, gens[rep], dev)
            _sync(dev)
            rep_dt = time.perf_counter() - t0
            rep_moves = int(torch.clamp(traj.moves_played,
                                        max=measure_moves).sum())
            runs.append(round(rep_moves / rep_dt, 2))
            if rep_moves / rep_dt > moves / dt:
                moves, dt = rep_moves, rep_dt
        if trace_dir:
            stop_profiler_trace()

    value = moves / dt
    flops = net_flops_per_eval(board_size, n_res_blocks, channels, cin=cin)
    tflops = mfu = None
    peak_ref = "not measured (cpu)"
    if dev.type == "cuda":
        tflops = nn_tflops_per_sec(value, n_simulations, flops)
        peak = PEAK_TFLOPS[infer]
        mfu = 100.0 * tflops / peak
        peak_ref = (f"{torch.cuda.get_device_name(dev)} {infer} {peak} TF/s "
                    f"({PEAK_SOURCE})")
    return {
        "metric": (
            f"self-play moves/sec @ {n_simulations} sims "
            f"({game} {board_size}x{board_size}, {n_res_blocks}x{channels} "
            f"net, batch {batch_games}, 1 card)"
        ),
        "value": round(value, 2),
        "unit": "moves/sec",
        "vs_baseline": (round(value / vs_baseline, 2)
                        if vs_baseline else None),
        "detail": {
            "moves": moves,
            "seconds": round(dt, 3),
            "leaf_evals_per_sec": round(value * n_simulations, 0),
            "backend": backend,
            "inference": infer,
            "leaves_per_sim": leaves_per_sim,
            "search": search,
            "device": device_name(dev),
            "nn_tflops_per_sec": tflops,
            "mfu_pct": mfu,
            "mfu_peak_ref": peak_ref,
            "runs_moves_per_sec": runs,
            "host_load_1min": round(load, 2),
            "quiesce_wait_s": load_wait,
        },
    }


def bench_pure_mcts(n_playout: int = 200, board_size: int = 15,
                    min_seconds: float = 60.0, min_games: int = 3,
                    max_moves_per_game: int = 60) -> dict:
    """Config #1: the network-free heuristic MCTS baseline (host CPU).

    Plays whole self-play games (each capped at ``max_moves_per_game``)
    until at least ``min_seconds`` of search time and ``min_games`` games
    have gone by, and publishes the per-game moves/s spread; the value is
    total moves over total think time.
    """
    warm = make_host_game("gomoku", board_size)
    MCTSGomoku(n_playout=n_playout).get_move(warm)  # numpy allocs, C scans
    total_moves, total_dt = 0, 0.0
    per_game = []
    winners = []
    while total_dt < min_seconds or len(per_game) < min_games:
        game = make_host_game("gomoku", board_size)
        bot = MCTSGomoku(n_playout=n_playout)
        g_moves, g_t0 = 0, time.perf_counter()
        while not game.is_game_over() and g_moves < max_moves_per_game:
            game.do_move(bot.get_move(game))
            g_moves += 1
        g_dt = time.perf_counter() - g_t0
        total_moves += g_moves
        total_dt += g_dt
        per_game.append(round(g_moves / g_dt, 2))
        winners.append(game.get_winner() if game.is_game_over() else None)
    value = total_moves / total_dt
    return {
        "metric": (f"pure-MCTS self-play moves/sec @ {n_playout} playouts "
                   f"(Gomoku {board_size}x{board_size}, host CPU)"),
        "value": round(value, 2),
        "unit": "moves/sec",
        "vs_baseline": None,
        "detail": {"moves": total_moves, "seconds": round(total_dt, 3),
                   "games": len(per_game),
                   "moves_per_sec_per_game": per_game,
                   "winners": winners},
    }


def bench_training_iteration(games: int = 128, n_simulations: int = 400,
                             eval_games: int = 16,
                             inference: str = "int8t", device=None) -> dict:
    """Config #5: one training-loop iteration on the card.

    Lockstep self-play -> replay buffer -> one training epoch -> gating
    arena (``selfplay/loop.train_alphazero``), on ``inference``'s forward;
    two iterations, of which the second is reported (the first builds and
    warms up).  ``BASELINE.json``'s config #5 names 1024 games over eight
    chips; one card plays a chip's slice of 128.
    """
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as td, tf32_off():
        hist = selfplay.train_alphazero(
            game_name="gomoku", board_size=15,
            num_iterations=2, games_per_iteration=games,
            n_simulations=n_simulations, buffer_size=200000,
            batch_size=128, epochs_per_iter=1, temp_threshold=10,
            eval_games=eval_games, eval_mcts_simulations=n_simulations,
            n_res_blocks=6, channels=128,
            mcts_backend="pallas", mcts_max_depth=56,
            inference=inference, model_dir=td, seed=7, verbose=False,
            device=dev,
        )
    it = hist[1]
    total = (it["selfplay_seconds"] + it["train_seconds"]
             + it["eval_seconds"])
    return {
        "metric": (f"training iteration seconds ({games} parallel games @ "
                   f"{n_simulations} sims -> buffer -> train -> "
                   f"{eval_games}-game gating arena, 6x128 net)"),
        "value": round(total, 2),
        "unit": "seconds/iteration",
        "vs_baseline": None,
        "detail": {
            "selfplay_seconds": round(it["selfplay_seconds"], 2),
            "train_seconds": round(it["train_seconds"], 2),
            "eval_seconds": round(it["eval_seconds"], 2),
            "selfplay_moves": it["moves"],
            "buffer_size": it["buffer_size"],
            "devices": 1,
            "device": device_name(dev),
            "inference": inference,
        },
    }


def run_all(out: Optional[str] = None, device=None) -> dict:
    """The six configs; returns ``{config_name: result}``, each printed as
    it finishes.  Writes no ``BASELINE.json``; with ``out``, writes
    ``{"date", "device", "results"}`` there."""
    dev = resolve_device(device)
    runs = (
        ("1_pure_mcts_cpu", bench_pure_mcts, {}),
        ("2_tiny_net_single_game", run_bench, dict(
            batch_games=1, n_simulations=100, n_res_blocks=2, channels=64,
            measure_moves=24, vs_baseline=None)),
        ("3_full_net_batched", run_bench, dict(
            batch_games=128, measure_moves=24, infer="int8t")),
        ("4_pente_full_net", run_bench, dict(
            game="pente", batch_games=64, measure_moves=24, infer="int8t",
            vs_baseline=None)),
        ("5_training_loop", bench_training_iteration, {}),
        # config #6: Gumbel@64 (m=16), which the JAX repo's arena measured
        # at strength parity with PUCT@400 on the shipped net
        # (tools/gumbel_ab.py there: 0.469 [0.31, 0.64] over 32 games); the
        # same self-play at 6.25x fewer simulations a move
        ("6_gumbel_equal_strength", run_bench, dict(
            batch_games=256, n_simulations=64, search="gumbel",
            measure_moves=48, infer="int8t")),
    )
    results = {}
    for name, fn, kw in runs:
        if fn is not bench_pure_mcts:
            kw = dict(kw, device=dev)
        results[name] = fn(**kw)
        print(json.dumps(results[name]), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump({"date": datetime.date.today().isoformat(),
                       "device": device_name(dev), "results": results}, f,
                      indent=2)
    return results


def main(argv=None, device=None) -> int:
    """The CLI; ``device`` None is the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="run all six configs")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="with --all: write the results as JSON to PATH")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", type=int, default=400)
    ap.add_argument("--infer", default="int8t",
                    choices=["f32", "bf16", "fused", "int8", "int8t"],
                    help="int8t (default): the int8 tower kernel; int8 is "
                    "the same function on torch._int_mm")
    ap.add_argument("--int8-skip", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="skip-track storage for --infer int8 (int8t has "
                    "the f32 track only)")
    ap.add_argument("--backend", default="pallas", choices=["xla", "pallas"],
                    help="accepted; both run the packed search on the "
                    "kernels")
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--moves", type=int, default=48)
    ap.add_argument("--kleaf", type=int, default=1,
                    help="leaves per network call (virtual-loss batching)")
    ap.add_argument("--search", default="puct", choices=["puct", "gumbel"],
                    help="root search algorithm (gumbel: sequential "
                         "halving, noise off)")
    ap.add_argument("--gumbel-parallel", action="store_true",
                    help="batch each halving round's sims into one network "
                         "call")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one timed repeat "
                    "into DIR")
    a = ap.parse_args(argv)
    if a.all:
        run_all(a.out, device=device)
    else:
        print(json.dumps(run_bench(
            batch_games=a.batch, n_simulations=a.sims, infer=a.infer,
            backend=a.backend, n_res_blocks=a.blocks, channels=a.channels,
            game=a.game, measure_moves=a.moves, leaves_per_sim=a.kleaf,
            search=a.search, gumbel_parallel=a.gumbel_parallel,
            trace_dir=a.trace, int8_skip=a.int8_skip,
            device=device)), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
