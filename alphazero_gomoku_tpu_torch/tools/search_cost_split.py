"""Split a self-play move's cost into the network and everything else.

Counterpart of the JAX repo's ``tools/search_cost_split.py``.  It runs the
real lockstep self-play (``play_games``, PUCT) twice at each batch size:
once with the real network, and once with a null network that still reads
the observations (one reduction a board, so that nothing of the move's
other work can be skipped).  The difference is the network's share; the
null-network time is the tree kernels, the game steps, the encoding and the
host's glue.

The real network is a seeded 6x128 net in inference mode ``--infer``
(``int8t``, the int8 tower kernel, as the port's bench runs it).
``--backend pallas`` runs the kernels, ``xla`` the plain versions
(``tools/backends.py``).  Times are the host's clock around a synchronised
run, after a warm-up run.

    python -m alphazero_gomoku_tpu_torch.tools.search_cost_split
        [--batches 64 128] [--moves 16]

A JSON line a batch size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import (
    INFERENCE_MODES,
    AZModel,
    make_inference,
)
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games
from alphazero_gomoku_tpu_torch.tools.backends import BACKENDS, backend


def null_eval(bundle, obs):
    """One reduction over ``obs`` -> uniform priors and a value near 0 that
    depend on the boards."""
    del bundle
    s = obs.sum(dim=(1, 2, 3))                                  # [B]
    a = obs.shape[1] * obs.shape[2]
    probs = torch.softmax((s[:, None] * 1e-6).expand(obs.shape[0], a),
                          dim=-1)
    return probs, torch.tanh(s * 1e-6)[:, None]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(env, cfg, eval_fn, bundle, moves, dev, ops=tk.KERNELS):
    """``(moves/s, seconds, moves)`` of one ``play_games`` call capped at
    ``moves`` moves, after a warm-up call."""
    meas_cfg = dataclasses.replace(cfg, max_moves=moves)

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return play_games(env, meas_cfg, eval_fn, bundle, gen, dev, ops=ops)

    run(2)
    _sync(dev)
    t0 = time.time()
    traj = run(3)
    n = int(torch.clamp(traj.moves_played, max=moves).sum())
    _sync(dev)
    dt = time.time() - t0
    return n / dt, dt, n


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--moves", type=int, default=16)
    ap.add_argument("--sims", type=int, default=400)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--backend", default="pallas", choices=BACKENDS,
                    help="pallas: the kernels; xla: their plain versions")
    ap.add_argument("--infer", default="int8t", choices=INFERENCE_MODES,
                    help="the real network's inference mode")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    env = make_env("gomoku", 15)
    model = AZModel(board_size=15, n_res_blocks=args.blocks,
                    channels=args.channels, seed=0, device=dev)
    real_eval, bundle = make_inference(args.infer, model.cfg,
                                       *model.jax_params(), device=dev)
    real_eval, ops = backend(args.backend, args.infer, model.cfg, real_eval)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))

    for b in args.batches:
        cfg = SelfPlayConfig(
            batch_games=b, temp_threshold=10,
            mcts=MCTSConfig(n_simulations=args.sims, cpuct=1.0,
                            add_noise=True, dirichlet_alpha=0.05,
                            dirichlet_epsilon=0.15, dirichlet_moves=10,
                            max_depth=56),
        )
        mv_real, _, _ = measure(env, cfg, real_eval, bundle, args.moves, dev,
                                ops)
        mv_null, _, _ = measure(env, cfg, null_eval, None, args.moves, dev,
                                ops)
        ms_real = b / mv_real / args.sims * 1e3
        ms_null = b / mv_null / args.sims * 1e3
        print(json.dumps({
            "batch": b, "sims": args.sims,
            "moves_per_s_real": round(mv_real, 1),
            "moves_per_s_nullnet": round(mv_null, 1),
            "ms_per_sim_real": round(ms_real, 4),
            "ms_per_sim_tree_glue": round(ms_null, 4),
            "ms_per_sim_nn": round(ms_real - ms_null, 4),
            "nn_share": round(1 - ms_null / ms_real, 3),
            "infer": args.infer, "backend": args.backend, "device": name,
        }), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
