"""Head-to-head arena between two checkpoints on the card.

Counterpart of the JAX repo's ``tools/compare_snapshots.py``: loads two
snapshots (AZTPU1, written by either package) and runs the mirrored-opening
arena (``selfplay.arena.evaluate_params_detailed``) between them, the quick
way to pick which snapshot of a run to promote.

    python -m alphazero_gomoku_tpu_torch.tools.compare_snapshots A.ckpt B.ckpt
        [--games 32] [--sims 256] [--search puct|gumbel] [--seed 0]

Prints one JSON line: A's win rate over B with its Wilson interval and the
pair tally, under the JAX tool's keys.  ``--backend`` is accepted and
changes nothing (the port has one search, the packed tree on the kernels).
"""

from __future__ import annotations

import argparse
import json

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_eval_fn
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import evaluate_params_detailed
from alphazero_gomoku_tpu_torch.tools.ab_arena import rounded


def main(argv=None, device=None, openings=None):
    """``device`` None is the card; ``openings`` replaces the random
    openings (tests inject the JAX tool's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_a")
    ap.add_argument("ckpt_b")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--sims", type=int, default=256)
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--backend", default="pallas",
                    choices=["xla", "pallas"])
    ap.add_argument("--search", default="puct", choices=["puct", "gumbel"],
                    help="arena search mode for BOTH sides (gumbel uses "
                         "sequential halving at --sims with m=16)")
    ap.add_argument("--max-depth", type=int, default=56)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    ma = AZModel.from_checkpoint(args.ckpt_a, board_size=args.size,
                                 device=dev)
    mb = AZModel.from_checkpoint(args.ckpt_b, board_size=args.size,
                                 device=dev)
    env = make_env(args.game, args.size,
                   capture_planes=ma.cfg.in_channels == 5)
    if ma.cfg != mb.cfg:
        raise SystemExit(f"architecture mismatch: {ma.cfg} vs {mb.cfg}")
    cfg = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False,
                     max_depth=args.max_depth, search=args.search,
                     gumbel_round_parallel=args.search == "gumbel")
    r = evaluate_params_detailed(
        env, cfg, make_eval_fn(), ma.eval_net(), mb.eval_net(), args.games,
        args.seed, device=dev, net_cfgs=(ma.cfg, mb.cfg), openings=openings)
    rate, ci95 = rounded(r)
    print(json.dumps({
        "a": args.ckpt_a, "b": args.ckpt_b, "sims": args.sims,
        "search": args.search,
        "a_wins": r["wins"], "played": r["played"], "draws": r["draws"],
        "a_win_rate": rate, "ci95": ci95,
        "pairs": r["pairs"],
    }))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
