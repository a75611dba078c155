"""Arena A/B: k leaves a simulation against the sequential (k=1) search.

Counterpart of the JAX repo's ``tools/kleaf_ab.py``: both sides use the same
network and parameters; side A evaluates ``--k`` leaves in each network call
with virtual loss (``leaves_per_sim``), side B is the k=1 search, at equal
leaf evaluations a move (equal network work), through ``ab_arena`` with the
seats swapped between the halves.  Strength-neutral: the Wilson interval
holds 0.5.

    python -m alphazero_gomoku_tpu_torch.tools.kleaf_ab [--model ckpt]
        [--games 32] [--sims 128] [--k 4] [--size 15] [--blocks 6]
        [--channels 128]

Without ``--model`` the net has random weights (``AZModel(seed=--seed)``,
numpy's draw, not the JAX package's).  Prints one JSON line, under the JAX
tool's keys.  ``--backend`` is accepted and changes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_eval_fn
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.tools.ab_arena import (
    Side,
    mirrored,
    rounded,
)


def main(argv=None, device=None, openings=None):
    """``device`` None is the card; ``openings`` replaces the random
    openings (tests inject the JAX tool's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None,
                    help="checkpoint (default: random weights)")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--sims", type=int, default=128)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--backend", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    env = make_env(args.game, args.size)
    if args.model:
        model = AZModel.from_checkpoint(args.model, board_size=args.size,
                                        device=dev)
    else:
        model = AZModel(board_size=args.size, n_res_blocks=args.blocks,
                        channels=args.channels, seed=args.seed, device=dev)
    eval_fn, bundle = make_eval_fn(), model.eval_net()
    cfg_a = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False,
                       max_depth=56, leaves_per_sim=args.k)
    cfg_b = dataclasses.replace(cfg_a, leaves_per_sim=1)
    r = mirrored(env, Side(cfg_a, eval_fn, bundle),
                 Side(cfg_b, eval_fn, bundle), 2 * (args.games // 2),
                 args.seed, dev, openings=openings)
    lo, hi = r["ci95"]
    rate, ci95 = rounded(r)
    print(json.dumps({
        "k": args.k, "sims": args.sims, "games": r["played"],
        "k_wins": r["wins"], "draws": r["draws"],
        "win_rate": rate, "ci95": ci95,
        "pairs": r["pairs"],
        "neutral": lo <= 0.5 <= hi,
    }))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
