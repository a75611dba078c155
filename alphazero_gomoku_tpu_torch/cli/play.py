"""CLI match runner: ``python -m alphazero_gomoku_tpu_torch.cli.play
<player1> <player2> [--game pente]``.

Counterpart of ``alphazero_gomoku_tpu/cli/play.py`` (the reference's
``play.py``, C1 in SURVEY.md §2): dynamic player loading by module name
(the port's ``players/`` first), a turn loop with per-move timing and
invalid-move retry, coloured board rendering and a winner announcement.
The AlphaZero players search on the CUDA card.
"""

from __future__ import annotations

import argparse
import sys

from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.players import load_player, request_move

RED, BLUE, RESET = "\033[31m", "\033[34m", "\033[0m"


def run_match(player1_name: str, player2_name: str, game_name: str = "gomoku",
              size: int = 15, max_retries_per_turn: int = 20,
              p1_kwargs=None, p2_kwargs=None) -> int:
    """Play one match; returns the winner (0/1/2)."""
    game = make_host_game(game_name, size)
    players = {
        1: load_player(player1_name, game_name, size, **(p1_kwargs or {})),
        2: load_player(player2_name, game_name, size, **(p2_kwargs or {})),
    }
    print(f"\nStarting {game_name.capitalize()}")
    print(f"{RED}●{RESET} player 1: {player1_name}")
    print(f"{BLUE}●{RESET} player 2: {player2_name}\n")
    game.display()

    turn_number = 0
    while not game.is_game_over():
        turn_number += 1
        seat = game.current_player
        move = request_move(players[seat], game, turn_number,
                            max_retries_per_turn)
        if move is None:
            return 3 - seat  # forfeit
        game.display()

    print("\nfinal position:")
    game.display()
    winner = game.get_winner()
    if winner == 0:
        print("\nDraw — no winner.")
    else:
        dot = f"{RED}●{RESET}" if winner == 1 else f"{BLUE}●{RESET}"
        print(f"\n🏆 player {winner} ({dot}) wins!")
    return winner


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Play a match between two player modules",
        usage="python -m alphazero_gomoku_tpu_torch.cli.play <player1> "
              "<player2> [--game gomoku|pente] [--size N]",
    )
    ap.add_argument("player1")
    ap.add_argument("player2")
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--p1-model", default=None,
                    help="checkpoint path override for player1 (AlphaZero "
                         "variants; .pt reference snapshots accepted)")
    ap.add_argument("--p2-model", default=None)
    ap.add_argument("--p1-sims", type=int, default=None,
                    help="n_simulations (alpha) / n_playout (mcts) override")
    ap.add_argument("--p2-sims", type=int, default=None)
    ap.add_argument("--p1-search", default=None, choices=["puct", "gumbel"],
                    help="search algorithm override (AlphaZero variants)")
    ap.add_argument("--p2-search", default=None, choices=["puct", "gumbel"])
    args = ap.parse_args(argv)

    def kw(name, model, sims, search):
        out = {}
        if model is not None:
            out["model_path"] = model
        if sims is not None:
            out["n_playout" if "mcts" in name else "n_simulations"] = sims
        if search is not None:
            out["search"] = search
        return out

    run_match(args.player1, args.player2, args.game, args.size,
              p1_kwargs=kw(args.player1, args.p1_model, args.p1_sims,
                           args.p1_search),
              p2_kwargs=kw(args.player2, args.p2_model, args.p2_sims,
                           args.p2_search))
    return 0


if __name__ == "__main__":
    sys.exit(main())
