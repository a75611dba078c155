"""Mirrored-opening arena between two nets of different architectures.

Counterpart of the JAX repo's ``tools/cross_net_arena.py``: a student (say
``distill_4x96.ckpt``) against its teacher (the 6x128 ``best_gomoku.ckpt``),
each side with its own net, through ``ab_arena``, with the arena's protocol.
``--sims-b`` gives B its own budget (an equal-wall-clock A/B between nets of
unequal cost); ``--search gumbel --m M`` runs Gumbel sequential halving on
both sides.  Nets that read different observation planes (``in_channels``)
are refused, as the port's arena refuses them (ROADMAP Queue C, P3).

    python -m alphazero_gomoku_tpu_torch.tools.cross_net_arena
        checkpoints/distill_4x96.ckpt checkpoints/best_gomoku.ckpt
        --games 64 --sims 64 --search gumbel

Prints one JSON line: A's win rate over B with its Wilson interval and the
pair tally, under the JAX tool's keys.  ``--backend`` is accepted and
changes nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

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
    ap.add_argument("ckpt_a")
    ap.add_argument("ckpt_b")
    ap.add_argument("--games", type=int, default=64)
    ap.add_argument("--sims", type=int, default=400)
    ap.add_argument("--sims-b", type=int, default=None,
                    help="B's simulation budget (default: --sims); use "
                         "for equal-wall-clock A/Bs between unequal nets")
    ap.add_argument("--game", default="gomoku")
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--search", default="puct", choices=["puct", "gumbel"])
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--backend", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--max-depth", type=int, default=56)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    ma = AZModel.from_checkpoint(args.ckpt_a, board_size=args.size,
                                 device=dev)
    mb = AZModel.from_checkpoint(args.ckpt_b, board_size=args.size,
                                 device=dev)
    if ma.cfg.in_channels != mb.cfg.in_channels:
        raise SystemExit(f"the nets read different observation planes: "
                         f"in_channels {ma.cfg.in_channels} and "
                         f"{mb.cfg.in_channels}")
    env = make_env(args.game, args.size,
                   capture_planes=ma.cfg.in_channels == 5)

    def mcts(sims):
        return MCTSConfig(n_simulations=sims, cpuct=1.0, add_noise=False,
                          max_depth=args.max_depth, search=args.search,
                          gumbel_max_considered=args.m)

    sims_b = args.sims_b or args.sims
    r = mirrored(env, Side(mcts(args.sims), make_eval_fn(), ma.eval_net()),
                 Side(mcts(sims_b), make_eval_fn(), mb.eval_net()),
                 2 * (args.games // 2), args.seed, dev, openings=openings,
                 uniforms=uniforms)
    rate, ci95 = rounded(r)
    print(json.dumps({
        "a_wins": r["wins"], "played": r["played"], "draws": r["draws"],
        "a_win_rate": rate, "ci95": ci95,
        "pairs": r["pairs"],
        "a": args.ckpt_a, "b": args.ckpt_b, "sims": args.sims,
        "sims_b": sims_b, "search": args.search,
        "arch_a": f"{ma.cfg.n_res_blocks}x{ma.cfg.channels}",
        "arch_b": f"{mb.cfg.n_res_blocks}x{mb.cfg.channels}",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
