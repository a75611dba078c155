"""Terminal human player (reference ``players/player_human.py``): prompts
for a 1-based "row,col"; 'q' quits.

A copy of ``alphazero_gomoku_tpu/players/player_human.py``."""

from __future__ import annotations

from typing import Optional, Tuple


class Player:
    def __init__(self, rules: str = "gomoku", board_size: int = 15):
        self.rules = rules
        self.board_size = board_size

    def play(self, board, turn_number: int,
             last_opponent_move) -> Optional[Tuple[int, int]]:
        while True:
            raw = input("your move (row,col — 1-based; q to quit): ").strip()
            if raw.lower() in ("q", "quit", "exit"):
                return None
            try:
                r_s, c_s = raw.replace(" ", "").split(",")
                r, c = int(r_s) - 1, int(c_s) - 1
            except ValueError:
                print("could not parse; expected e.g. 8,8")
                continue
            if not (0 <= r < self.board_size and 0 <= c < self.board_size):
                print(f"out of range 1..{self.board_size}")
                continue
            return (r, c)
