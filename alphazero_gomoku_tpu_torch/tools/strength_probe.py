"""Strength probe: an AlphaZero checkpoint against the pure-MCTS baseline.

Counterpart of the JAX repo's ``tools/strength_probe.py``: N quick games
between the port's ``AlphaZeroPlayer`` (any snapshot, any simulation count;
its searches on the card) and its pure-MCTS player (``player_mcts``, host
only), seats alternating, a line a game and a summary JSON line.

    python -m alphazero_gomoku_tpu_torch.tools.strength_probe
        --model runs/models_run4/best_latest.ckpt --sims 400 --games 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.players.alpha_base import AlphaZeroPlayer
from alphazero_gomoku_tpu_torch.players.player_mcts import (
    Player as MctsPlayer,
)


def main(argv=None, device=None):
    """``device`` None is the card (the AlphaZero player's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--sims", type=int, default=400)
    ap.add_argument("--playouts", type=int, default=25)
    ap.add_argument("--games", type=int, default=10)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--game", default="gomoku")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-moves", type=int, default=0,
                    help="declare a draw after this many plies (0 = size^2)")
    args = ap.parse_args(argv)

    az = AlphaZeroPlayer(args.game, args.size, n_simulations=args.sims,
                         model_path=args.model, device=device)
    mcts = MctsPlayer(args.game, args.size, n_playout=args.playouts)
    max_moves = args.max_moves or args.size * args.size
    np.random.seed(args.seed)

    az_wins = draws = 0
    for g in range(args.games):
        game = make_host_game(args.game, args.size)
        az_seat = 1 if g % 2 == 0 else 2  # alternate who moves first
        players = {az_seat: az, 3 - az_seat: mcts}
        turn, last, t0 = 0, None, time.time()
        while not game.is_game_over() and turn < max_moves:
            mover = players[game.current_player]
            mv = mover.play(game.board.copy(), turn, last)
            if mv is None or not game.do_move(tuple(mv)):
                break  # forfeit: scored below from the board state
            last = tuple(mv)
            turn += 1
        w = game.get_winner() if game.is_game_over() else 0
        if w == az_seat:
            az_wins += 1
            res = "AZ"
        elif w == 0:
            draws += 1
            res = "draw"
        else:
            res = "MCTS"
        print(f"game {g + 1}/{args.games}: {res} wins in {turn} plies "
              f"(az_seat={az_seat}, {time.time() - t0:.1f}s)", flush=True)

    out = {
        "model": args.model, "sims": args.sims, "playouts": args.playouts,
        "games": args.games, "az_wins": az_wins, "draws": draws,
        "mcts_wins": args.games - az_wins - draws,
        "az_win_rate": round(az_wins / args.games, 3),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
