"""How often do the Gumbel search on the fused bf16 tower kernel and the same
search on the plain versions choose a different move, and does it cost
games?

Counterpart of the JAX repo's ``tools/gumbel_flip_probe.py``, which bounded
the Mosaic-against-XLA Gumbel divergence on the TPU.  Here it measures the
port's open question C6 (``ROADMAP.md``): K4 (``fused_tower``) and its plain
version (``fused_tower_plain``) sum in different orders, and a float32
difference of a ulp can flip a sequential-halving tie, so the two searches
part ways.  The two sides, on the same checkpoint:

  - the kernels: Gumbel on K3 and K2 with K4;
  - the plain versions: Gumbel on ``tk.PLAIN`` with ``fused_tower_plain``.

1. **Flip rate**: over ``len(--plies) x --batch`` random-play positions at
   mixed plies, how often the two searches' policies have a different
   argmax, and the pi difference when they do.  Both sides draw their root
   uniforms from a generator seeded the same.
2. **Strength**: a mirrored-opening arena of the two
   (``selfplay/arena.sides_half``, ``tools/ab_arena.py``), each side playing
   its policy's argmax; the divergence is harmless if this is about 0.5.

    python -m alphazero_gomoku_tpu_torch.tools.gumbel_flip_probe
        --ckpt checkpoints/best_gomoku.ckpt [--sims 64] [--m 16]
        [--batch 192] [--arena-games 64]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.tools.ab_arena import Side, mirrored
from alphazero_gomoku_tpu_torch.tools.device_parity import (
    make_sides,
    random_states,
    search,
)

INFER = "fused"


def flip_rate(env, cfg, sides, bundle, batch, plies_grid, seed0, device):
    total = flips = 0
    pi_deltas = []
    q_deltas = []
    flip_pi_deltas = []
    for i, plies in enumerate(plies_grid):
        states = random_states(env, batch, plies, seed0 + i, device)
        live = ~states.done.cpu().numpy()
        out = search(env, cfg, sides, bundle, states, plies,
                     seed0 + 100 + i)
        (pi_k, q_k, _), (pi_p, q_p, _) = out["kernels"], out["plain"]
        row_flip = (pi_k.argmax(-1) != pi_p.argmax(-1)) & live
        row_delta = np.abs(pi_k - pi_p).max(-1)
        total += int(live.sum())
        flips += int(row_flip.sum())
        pi_deltas.extend(row_delta[live].tolist())
        q_deltas.extend(np.abs(q_k - q_p)[live].tolist())
        flip_pi_deltas.extend(row_delta[row_flip].tolist())
        print(json.dumps({
            "plies": plies, "live": int(live.sum()),
            "flips": int(row_flip.sum()),
            "pi_max_delta": float(row_delta[live].max(initial=0.0)),
        }), flush=True)
    pi_deltas = np.array(pi_deltas)
    return {
        "positions": total,
        "argmax_flips": flips,
        "flip_rate": round(flips / max(total, 1), 4),
        "pi_delta_p50": float(np.percentile(pi_deltas, 50)),
        "pi_delta_p95": float(np.percentile(pi_deltas, 95)),
        "pi_delta_max": float(pi_deltas.max(initial=0.0)),
        "pi_delta_frac_zero": float((pi_deltas == 0).mean()),
        "q_delta_max": float(np.max(q_deltas, initial=0.0)),
        "flip_pi_delta_mean": (float(np.mean(flip_pi_deltas))
                               if flip_pi_deltas else 0.0),
    }


def cross_backend_arena(env, cfg, sides, bundle, n_games, seed, device):
    """Mirrored arena of the kernels' side against the plain side, the same
    net: the kernels' side is P1 in the first half and P2 in the second,
    both halves on ``seed`` (the same openings)."""
    (k_eval, k_ops), (p_eval, p_ops) = sides["kernels"], sides["plain"]
    r = mirrored(env, Side(cfg, k_eval, bundle, ops=k_ops),
                 Side(cfg, p_eval, bundle, ops=p_ops), n_games, seed,
                 device)
    return {
        "kernel_wins": r["wins"], "played": r["played"],
        "draws": r["draws"],
        "kernel_win_rate": round(r["win_rate"], 4),
        "ci95": [round(x, 4) for x in r["ci95"]],
        "pairs": r["pairs"],
    }


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="checkpoints/best_gomoku.ckpt")
    ap.add_argument("--sims", type=int, default=64)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--plies", type=int, nargs="+",
                    default=[2, 6, 10, 16, 22, 30])
    ap.add_argument("--arena-games", type=int, default=64)
    ap.add_argument("--skip-arena", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    model = AZModel.from_checkpoint(args.ckpt, board_size=15, device=dev)
    env = make_env("gomoku", 15, capture_planes=model.cfg.in_channels == 5)
    eval_fn, bundle = make_inference(INFER, model.cfg, *model.jax_params(),
                                     device=dev)
    sides = make_sides(model.cfg, eval_fn, INFER)
    cfg = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False,
                     max_depth=56, search="gumbel",
                     gumbel_max_considered=args.m)

    fr = flip_rate(env, cfg, sides, bundle, args.batch, args.plies,
                   args.seed, dev)
    print(json.dumps({"flip_rate_summary": fr}), flush=True)

    if not args.skip_arena:
        ar = cross_backend_arena(env, cfg, sides, bundle, args.arena_games,
                                 args.seed + 7, dev)
        print(json.dumps({"cross_backend_arena": ar}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
