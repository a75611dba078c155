"""Strength A/B: cross-move subtree reuse against a fresh search a move.

Counterpart of the JAX repo's ``tools/reuse_ab.py``: an arena (``ab_arena``)
between two searches of the SAME checkpoint at equal simulations a move.
The reuse side carries a ``PackedCarry`` through
``run_search`` (``MCTSConfig.reuse_budget``) and re-roots it
with ``packed_advance_root`` at every ply, its own and the opponent's, as
the players do; the other side searches a fresh tree every move.  The JAX
tool runs the reuse side on its XLA array tree, which that package holds
bit-identical to its packed one; the port has only the packed tree
(ROADMAP Queue A, entry 5).

    python -m alphazero_gomoku_tpu_torch.tools.reuse_ab
        [checkpoints/best_gomoku.ckpt] [--games 32] [--sims 256]
        [--budget 256]

Prints one JSON line: the reuse side's win rate with its Wilson interval
and the pair tally.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("ckpt", nargs="?", default="checkpoints/best_gomoku.ckpt")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--sims", type=int, default=256)
    ap.add_argument("--budget", type=int, default=0,
                    help="reuse_budget (0 = same as sims)")
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--max-depth", type=int, default=56)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    model = AZModel.from_checkpoint(args.ckpt, device=dev)
    env = make_env(args.game, args.size)
    eval_fn, bundle = make_eval_fn(), model.eval_net()
    budget = args.budget or args.sims
    cfg_f = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False,
                       max_depth=args.max_depth)
    cfg_r = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False,
                       max_depth=args.max_depth, reuse_budget=budget)
    r = mirrored(env, Side(cfg_r, eval_fn, bundle),
                 Side(cfg_f, eval_fn, bundle), 2 * (args.games // 2),
                 args.seed, dev, openings=openings)
    rate, ci95 = rounded(r)
    print(json.dumps({
        "ckpt": args.ckpt, "games": r["played"], "sims": args.sims,
        "reuse_budget": budget,
        "reuse_win_rate": rate, "ci95": ci95,
        "draws": r["draws"], "pairs": r["pairs"],
    }))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
