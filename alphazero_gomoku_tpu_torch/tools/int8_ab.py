"""Strength A/B: int8 quantized inference against the float32 forward.

Counterpart of the JAX repo's ``tools/int8_ab.py``: a mirrored-opening arena
(``ab_arena``) between the SAME checkpoint evaluated through int8 and
through float32, at equal simulations: whether quantized inference costs
games (policy agreement alone does not settle it).

The int8 side is ``make_inference("int8t", ...)``, the int8 tower kernel,
calibrated on ``random_play_calib_obs`` boards; the float32 side is
``make_inference("f32", ...)``.  The int8 tower has only the float32 skip
track, so ``--skip f32`` (the default here) runs it; ``--skip bf16`` or
``int8`` (the JAX tool's default is bf16) runs ``int8`` (``int8_apply`` on
``torch._int_mm``) with that track, and the JSON's ``int8_inference`` says
which ran.

    python -m alphazero_gomoku_tpu_torch.tools.int8_ab
        [checkpoints/best_gomoku.ckpt] [--games 32] [--sims 256]

Prints one JSON line: the int8 side's win rate over float32 with its Wilson
interval and the pair tally.  Strength-neutral: the interval straddles 0.5
with no skew in the decisive pairs.
"""

from __future__ import annotations

import argparse
import json

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.ops.int8_net import random_play_calib_obs
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
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--backend", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--max-depth", type=int, default=56)
    ap.add_argument("--calib", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="skip-track storage of the int8 side: f32 runs the "
                         "int8 tower (int8t), the others int8_apply")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    model = AZModel.from_checkpoint(args.ckpt, device=dev)
    cfg = model.cfg
    env = make_env(args.game, args.size)
    weights = model.jax_params()
    mode = "int8t" if args.skip == "f32" else "int8"
    q_eval, q_bundle = make_inference(
        mode, cfg, *weights, device=dev, int8_skip=args.skip,
        calib_obs=random_play_calib_obs(cfg, game=args.game, n=args.calib))
    f_eval, f_bundle = make_inference("f32", cfg, *weights, device=dev)
    mcts = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False,
                      max_depth=args.max_depth)
    r = mirrored(env, Side(mcts, q_eval, q_bundle),
                 Side(mcts, f_eval, f_bundle), args.games, args.seed, dev,
                 openings=openings)
    rate, ci95 = rounded(r)
    print(json.dumps({
        "ckpt": args.ckpt, "games": r["played"], "sims": args.sims,
        "int8_win_rate": rate, "ci95": ci95,
        "draws": r["draws"], "pairs": r["pairs"],
        "int8_inference": mode, "skip": args.skip,
    }))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
