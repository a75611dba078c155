"""Heuristic pure-MCTS player (reference ``players/player_mcts.py``).

Counterpart (a copy) of ``alphazero_gomoku_tpu/players/player_mcts.py``, on
the port's ``search/pure_mcts.py``: host code, no card."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.search.pure_mcts import MCTSGomoku, MCTSPente


class Player:
    def __init__(self, rules: str = "gomoku", board_size: int = 15,
                 n_playout: int = 25, c_puct: float = 1.4):
        self.rules = str(rules).lower()
        self.board_size = board_size
        self.n_playout = n_playout
        if self.rules == "pente":
            self.mcts = MCTSPente(n_playout=n_playout, c_puct=c_puct)
        else:
            self.mcts = MCTSGomoku(n_playout=n_playout, c_puct=c_puct)

    def play(self, board, turn_number: int,
             last_opponent_move) -> Optional[Tuple[int, int]]:
        from alphazero_gomoku_tpu_torch.players.alpha_base import (
            infer_to_move,
        )

        game = make_host_game(self.rules, self.board_size)
        raw = np.asarray(board if isinstance(board, (list, np.ndarray))
                         else board.board, dtype=np.int8)
        game.board = raw.copy()
        caps = getattr(board, "captures", None)
        if self.rules == "pente" and isinstance(caps, dict):
            game.captures = {1: int(caps.get(1, 0)), 2: int(caps.get(2, 0))}
        game.current_player = infer_to_move(
            raw, (game.captures[1], game.captures[2])
            if hasattr(game, "captures") else (0, 0)
        )
        game.last_move = (tuple(last_opponent_move)
                          if last_opponent_move is not None else None)
        if game.is_game_over():
            return None
        return self.mcts.get_move(game)
