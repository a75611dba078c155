"""Strength A/B: Gumbel sequential halving against PUCT at unequal budgets.

Counterpart of the JAX repo's ``tools/gumbel_ab.py``: an arena (``ab_arena``)
between two searches of the SAME checkpoint.  The Gumbel side runs
``--gumbel-sims`` simulations a move (``run_search``; with
``--round-parallel`` each halving round in one walk and one forward) and
plays its halving winner; the PUCT side runs ``--puct-sims``
(``run_search``'s PUCT, first-play urgency ``--fpu``) and
plays its visit argmax.  If ``gumbel@N`` matches ``puct@kN``, self-play
buys k times the moves at equal strength (Danihelka et al., ICLR 2022):
bench config #6's premise.

    python -m alphazero_gomoku_tpu_torch.tools.gumbel_ab
        [checkpoints/best_gomoku.ckpt] [--games 32] [--gumbel-sims 64]
        [--puct-sims 400] [--m 16]

Prints one JSON line: the Gumbel side's win rate with its Wilson interval
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


def main(argv=None, device=None, openings=None, uniforms=None):
    """``device`` None is the card; ``openings`` and ``uniforms`` replace
    the random openings and the Gumbel root uniforms (tests inject the JAX
    tool's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?", default="checkpoints/best_gomoku.ckpt")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--gumbel-sims", type=int, default=64)
    ap.add_argument("--puct-sims", type=int, default=400)
    ap.add_argument("--m", type=int, default=16,
                    help="gumbel_max_considered")
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--max-depth", type=int, default=56)
    ap.add_argument("--fpu", default="zero", choices=["zero", "parent"],
                    help="PUCT side's first-play urgency")
    ap.add_argument("--round-parallel", action="store_true",
                    help="gumbel side: batch each halving round's sims "
                         "into one forward (serial-exact off the endgame "
                         "duplicate case)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    model = AZModel.from_checkpoint(args.ckpt, device=dev)
    env = make_env(args.game, args.size,
                   capture_planes=model.cfg.in_channels == 5)
    eval_fn, bundle = make_eval_fn(), model.eval_net()
    cfg_g = MCTSConfig(n_simulations=args.gumbel_sims, search="gumbel",
                       gumbel_max_considered=args.m, add_noise=False,
                       gumbel_round_parallel=args.round_parallel,
                       max_depth=args.max_depth)
    cfg_p = MCTSConfig(n_simulations=args.puct_sims, cpuct=1.0,
                       add_noise=False, max_depth=args.max_depth,
                       fpu_mode=args.fpu)
    r = mirrored(env, Side(cfg_g, eval_fn, bundle, play_winner=True),
                 Side(cfg_p, eval_fn, bundle), 2 * (args.games // 2),
                 args.seed, dev, openings=openings, uniforms=uniforms)
    rate, ci95 = rounded(r)
    print(json.dumps({
        "ckpt": args.ckpt, "games": r["played"],
        "gumbel_sims": args.gumbel_sims, "puct_sims": args.puct_sims,
        "m": args.m, "fpu": args.fpu,
        "gumbel_win_rate": rate, "ci95": ci95,
        "draws": r["draws"], "pairs": r["pairs"],
    }))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
