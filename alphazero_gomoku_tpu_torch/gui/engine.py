"""Terminal engine + spawned mirror UI (reference ``gui.py`` equivalent).

Counterpart of ``alphazero_gomoku_tpu/gui/engine.py``: runs the
authoritative game in the terminal, auto-spawns the port's pygame mirror
(``gui/interface.py``) as a subprocess (``gui.py:87-99``), accepts human
moves by polling ``input_log.txt`` (``gui.py:111-134``) and bot moves from
the port's player plugins, and appends every accepted move to
``mirror_log.txt`` (``gui.py:157-160``), in the working directory.  Importing
it needs no pygame: only the spawned mirror draws.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Optional

from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.gui.mirror_ipc import (
    INPUT_LOG,
    MIRROR_LOG,
    MoveLogTailer,
    MoveLogWriter,
)
from alphazero_gomoku_tpu_torch.players import load_player, request_move

POLL_SECONDS = 0.05  # reference gui.py polls at 50 ms


def run_engine(game_name: str = "gomoku", size: int = 15,
               p1: str = "human", p2: str = "player_mcts",
               spawn_mirror: bool = True,
               max_moves: Optional[int] = None) -> int:
    game = make_host_game(game_name, size)
    mirror_out = MoveLogWriter(MIRROR_LOG)
    human_in = MoveLogTailer(INPUT_LOG)
    with open(INPUT_LOG, "w"):
        pass

    kinds = {1: p1, 2: p2}
    bots = {
        seat: (None if kind == "human" else load_player(kind, game_name, size))
        for seat, kind in kinds.items()
    }

    proc = None
    if spawn_mirror:
        mirror_kinds = ["human" if kinds[s] == "human" else "bot"
                        for s in (1, 2)]
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "alphazero_gomoku_tpu_torch.gui.interface",
             "mirror", game_name, *mirror_kinds, str(size)]
        )

    turn_number = 0
    try:
        while not game.is_game_over():
            if max_moves is not None and turn_number >= max_moves:
                break
            seat = game.current_player
            bot = bots[seat]
            if bot is None:
                move = None
                while move is None:
                    for clicked in human_in.poll():
                        if (0 <= clicked[0] < size and 0 <= clicked[1] < size
                                and game.board[clicked] == 0):
                            move = clicked
                            break
                    if move is None:
                        time.sleep(POLL_SECONDS)
                if not game.do_move(move):
                    print(f"rejected illegal move {move}")
                    continue
            else:
                move = request_move(bot, game, turn_number)
                if move is None:  # bot forfeits -> opponent wins
                    print(f"bot (seat {seat}) forfeits")
                    winner = 3 - seat
                    print(f"player {winner} wins")
                    return winner
            turn_number += 1
            mirror_out.append(move)
            game.display()
        winner = game.get_winner()
        print("draw" if winner == 0 else f"player {winner} wins")
        return winner
    finally:
        if proc is not None:
            time.sleep(1.0)
            proc.terminate()
            proc.wait(timeout=30)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Terminal engine + mirror GUI")
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--p1", default="human")
    ap.add_argument("--p2", default="player_mcts")
    ap.add_argument("--no-mirror", action="store_true")
    args = ap.parse_args(argv)
    run_engine(args.game, args.size, args.p1, args.p2,
               spawn_mirror=not args.no_mirror)
    return 0


if __name__ == "__main__":
    sys.exit(main())
