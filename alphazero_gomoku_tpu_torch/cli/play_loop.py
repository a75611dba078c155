"""Tournament runner with metrics: ``python -m
alphazero_gomoku_tpu_torch.cli.play_loop <p1> <p2> <n>``.

Counterpart of ``alphazero_gomoku_tpu/cli/play_loop.py`` (the reference's
``play_loop.py``, C2 in SURVEY.md §2), with the same metrics keys and file
name: alternates seat assignment per game, opens each game with a random
first move over the full board, records per-move coordinates and think
times, per-game durations, wins/draws and starting players, then writes
``metrics/<p1>_<sims>_<p2>_<sims>_3.json`` (relative to the working
directory).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from pathlib import Path

import numpy as np

from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.players import load_player, request_move

METRICS_DIR = Path("metrics")
RED, BLUE, RESET = "\033[31m", "\033[34m", "\033[0m"


def _sims_of(player) -> object:
    for attr in ("n_simulations", "n_playout"):
        if hasattr(player, attr):
            return getattr(player, attr)
    return None


def initiate_metrics(p1_name, p2_name, p1, p2, game_name, n_games):
    metrics = {
        "total_duration": 0,
        "player1": (p1_name, _sims_of(p1), getattr(p1, "model_path", None)),
        "player2": (p2_name, _sims_of(p2), getattr(p2, "model_path", None)),
        "game": game_name,
        "n_games": n_games,
        "total_duration_minutes": 0,
        "move_made": {p1_name: {}, p2_name: {}},
        "time_for_each_move": {p1_name: {}, p2_name: {}},
        "game_duration_seconds": {},
        "wins": {},
        "draws": 0,
        "starting_player_per_game": {},
    }
    for i in range(1, n_games + 1):
        key = f"game_{i}"
        for p in (p1_name, p2_name):
            metrics["move_made"][p][key] = []
            metrics["time_for_each_move"][p][key] = []
        metrics["game_duration_seconds"][key] = 0
        metrics["starting_player_per_game"][key] = None
    return metrics


def to_json_safe(obj):
    if isinstance(obj, dict):
        return {k: to_json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_json_safe(x) for x in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def play_one_game(first_name, second_name, game, game_name, size, metrics,
                  game_iter, rng, player_kwargs=None, modules=None):
    """One game with ``first_name`` seated as player 1. Returns winner name.

    ``first_name``/``second_name`` are metric LABELS; ``modules`` maps a
    label to its player module (labels get a ``[seat]`` suffix when both
    seats load the same module with different overrides, so per-seat
    kwargs and win tallies never collapse onto one key)."""
    pk = player_kwargs or {}
    mods = modules or {first_name: first_name, second_name: second_name}
    seats = {
        1: load_player(mods[first_name], game_name, size,
                       **pk.get(first_name, {})),
        2: load_player(mods[second_name], game_name, size,
                       **pk.get(second_name, {})),
    }
    metrics["starting_player_per_game"][f"game_{game_iter}"] = first_name
    key = f"game_{game_iter}"

    # random opening move anywhere on the board (reference play_loop.py:49-51)
    r, c = rng.randrange(size), rng.randrange(size)
    game.do_move((r, c))
    metrics["move_made"][first_name][key].append((r, c))
    metrics["time_for_each_move"][first_name][key].append(0)
    game.display()

    turn_number = 0
    while not game.is_game_over():
        mover_name = first_name if game.current_player == 1 else second_name
        t0 = time.time()
        move = request_move(seats[game.current_player], game, turn_number)
        if move is None:
            # forfeit: credit the opposing seat, consistent with
            # play.run_match and gui.engine (`return 3 - seat` semantics)
            loser = game.current_player
            name = first_name if loser == 2 else second_name
            print(f"\n🏆 {name} wins by forfeit "
                  f"(opponent failed to produce a move)")
            return name
        metrics["move_made"][mover_name][key].append(move)
        metrics["time_for_each_move"][mover_name][key].append(
            time.time() - t0)
        turn_number += 1
        game.display()

    winner = game.get_winner()
    if winner == 0:
        print("\nDraw.")
        return None
    name = first_name if winner == 1 else second_name
    dot = f"{RED}●{RESET}" if winner == 1 else f"{BLUE}●{RESET}"
    print(f"\n🏆 player {winner} ({name}) ({dot}) wins!")
    return name


def loop_for_n_games(p1_name, p2_name, n_games, game_name="gomoku", size=15,
                     pause_seconds=0.0, seed=None,
                     p1_kwargs=None, p2_kwargs=None):
    os.makedirs(METRICS_DIR, exist_ok=True)
    rng = random.Random(seed)
    # seat-qualified labels so a same-module matchup (e.g. two snapshots of
    # player_alpha) keeps distinct kwargs, metrics and win tallies
    if p1_name == p2_name:
        label1, label2 = f"{p1_name}[1]", f"{p2_name}[2]"
    else:
        label1, label2 = p1_name, p2_name
    modules = {label1: p1_name, label2: p2_name}
    player_kwargs = {label1: p1_kwargs or {}, label2: p2_kwargs or {}}
    p1 = load_player(p1_name, game_name, size, **player_kwargs[label1])
    p2 = load_player(p2_name, game_name, size, **player_kwargs[label2])
    wins = {label1: 0, label2: 0}
    metrics = initiate_metrics(label1, label2, p1, p2, game_name, n_games)

    t_start = time.time()
    for i in range(n_games):
        game = make_host_game(game_name, size)
        first, second = (label1, label2) if i % 2 == 0 else (label2, label1)
        t_game = time.time()
        winner = play_one_game(first, second, game, game_name, size,
                               metrics, i + 1, rng,
                               player_kwargs=player_kwargs, modules=modules)
        metrics["game_duration_seconds"][f"game_{i + 1}"] = time.time() - t_game
        if winner:
            wins[winner] += 1
        print(f"finished game {i + 1}/{n_games}")
        if pause_seconds:
            time.sleep(pause_seconds)

    metrics["total_duration"] = round(time.time() - t_start, 3)
    metrics["total_duration_minutes"] = (time.time() - t_start) // 60
    metrics["wins"] = wins
    metrics["draws"] = n_games - sum(wins.values())
    for name, w in wins.items():
        print(f"{name} won {w} times")

    # reference naming for gomoku (play_loop.py:238-241); other games get
    # a qualifier so a pente tournament cannot overwrite gomoku metrics
    tag = "" if game_name == "gomoku" else f"{game_name}_"
    fname = (f"{p1_name}_{metrics['player1'][1]}_"
             f"{p2_name}_{metrics['player2'][1]}_{tag}3.json")
    path = METRICS_DIR / fname
    with open(path, "w") as f:
        json.dump(to_json_safe(metrics), f, indent=4)
    print(f"metrics written to {path}")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run an n-game tournament between two player modules",
        usage="python -m alphazero_gomoku_tpu_torch.cli.play_loop <player1> "
              "<player2> <n_games> [--game ...]",
    )
    ap.add_argument("player1")
    ap.add_argument("player2")
    ap.add_argument("n_games", type=int)
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--pause", type=float, default=0.0,
                    help="seconds to sleep between games (reference used 3)")
    ap.add_argument("--seed", type=int, default=None)
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

    loop_for_n_games(args.player1, args.player2, args.n_games,
                     args.game, args.size, args.pause, args.seed,
                     p1_kwargs=kw(args.player1, args.p1_model, args.p1_sims,
                           args.p1_search),
                     p2_kwargs=kw(args.player2, args.p2_model, args.p2_sims,
                           args.p2_search))
    return 0


if __name__ == "__main__":
    sys.exit(main())
