"""Host-side NumPy rule engines with the reference-compatible object API.

A copy of ``alphazero_gomoku_tpu/games/host.py`` (the port imports nothing of
the JAX package; that module imports no JAX either, so the copy is
verbatim below this docstring).  The port uses it for the int8 calibration
boards of the training loop (``ops/int8_net.random_play_calib_obs``), and as
the game of the play CLIs, the GUI and the pure-MCTS player
(``games.make_host_game``).

  - board: ``int8[size, size]``, 0 = empty, 1/2 = players.
  - actions: flat index ``r * size + c``.
  - ``get_valid_moves`` -> ``float32[action_size]`` 0/1 mask.
  - ``get_encoded_state`` -> ``float32[3, size, size]``: (current player's
    stones, opponent's stones, constant-ones plane).
  - win: 5-in-a-row through the last move; Pente additionally wins at
    five captured pairs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# The four line axes used for 5-in-a-row detection.
_LINE_DIRS = ((1, 0), (0, 1), (1, 1), (1, -1))
# All 8 rays used for Pente capture detection.
_CAPTURE_DIRS = (
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, 1), (-1, -1), (1, -1), (-1, 1),
)


def _run_length(board: np.ndarray, r: int, c: int, dr: int, dc: int,
                player: int) -> int:
    """Length of the maximal same-colour run through (r, c) along +/-(dr, dc)."""
    size = board.shape[0]
    n = 1
    for sign in (1, -1):
        k = 1
        while True:
            rr, cc = r + sign * k * dr, c + sign * k * dc
            if not (0 <= rr < size and 0 <= cc < size):
                break
            if board[rr, cc] != player:
                break
            n += 1
            k += 1
    return n


class Gomoku:
    """Five-in-a-row on a ``size`` x ``size`` board (default 15)."""

    def __init__(self, size: int = 15):
        self.size = size
        self.board = np.zeros((size, size), dtype=np.int8)
        self.current_player = 1
        self.move_history: List[Tuple[int, int]] = []
        self.last_move: Optional[Tuple[int, int]] = None

    # -- action <-> move ---------------------------------------------------
    @property
    def action_size(self) -> int:
        return self.size * self.size

    def action_to_move(self, action: int) -> Tuple[int, int]:
        return divmod(int(action), self.size)

    def move_to_action(self, move: Tuple[int, int]) -> int:
        r, c = move
        return int(r) * self.size + int(c)

    # -- copying -----------------------------------------------------------
    def clone(self) -> "Gomoku":
        g = Gomoku(self.size)
        g.board = self.board.copy()
        g.current_player = int(self.current_player)
        g.move_history = list(self.move_history)
        g.last_move = None if self.last_move is None else tuple(self.last_move)
        return g

    # -- moves -------------------------------------------------------------
    def do_move(self, move: Tuple[int, int]) -> bool:
        r, c = int(move[0]), int(move[1])
        if not (0 <= r < self.size and 0 <= c < self.size):
            return False
        if self.board[r, c] != 0:
            return False
        self.board[r, c] = self.current_player
        self.move_history.append((r, c))
        self.last_move = (r, c)
        self.current_player = 3 - self.current_player
        return True

    def undo_move(self) -> None:
        if not self.move_history:
            return
        r, c = self.move_history.pop()
        self.board[r, c] = 0
        self.current_player = 3 - self.current_player
        self.last_move = self.move_history[-1] if self.move_history else None

    # -- legality ----------------------------------------------------------
    def get_legal_moves(self) -> List[Tuple[int, int]]:
        rs, cs = np.nonzero(self.board == 0)
        return list(zip(rs.tolist(), cs.tolist()))

    def has_legal_moves(self) -> bool:
        return bool((self.board == 0).any())

    def get_valid_moves(self) -> np.ndarray:
        return (self.board.reshape(-1) == 0).astype(np.float32)

    # -- state encoding ----------------------------------------------------
    def get_state(self) -> np.ndarray:
        return self.board.copy()

    def get_encoded_state(self) -> np.ndarray:
        me = self.current_player
        planes = np.stack(
            [
                (self.board == me).astype(np.float32),
                (self.board == 3 - me).astype(np.float32),
                np.ones((self.size, self.size), dtype=np.float32),
            ],
            axis=0,
        )
        return planes

    # -- terminal checks ---------------------------------------------------
    def check_winner(self) -> int:
        if self.last_move is None:
            return 0
        r, c = self.last_move
        player = int(self.board[r, c])
        if player == 0:
            return 0
        for dr, dc in _LINE_DIRS:
            if _run_length(self.board, r, c, dr, dc, player) >= 5:
                return player
        return 0

    def is_game_over(self) -> bool:
        return self.check_winner() != 0 or not self.has_legal_moves()

    def get_winner(self) -> int:
        return self.check_winner()

    # -- rendering ---------------------------------------------------------
    def display(self) -> None:
        print(render_board(self.board, self.current_player))


class Pente:
    """Pente: 5-in-a-row OR 5 captured pairs; custodial pair captures."""

    def __init__(self, size: int = 15):
        self.size = size
        self.board = np.zeros((size, size), dtype=np.int8)
        self.current_player = 1
        self.last_move: Optional[Tuple[int, int]] = None
        self.captures = {1: 0, 2: 0}
        self.move_history: List[Tuple[int, int]] = []
        self.capture_history: List[List[Tuple[int, int]]] = []

    # -- action <-> move ---------------------------------------------------
    @property
    def action_size(self) -> int:
        return self.size * self.size

    def action_to_move(self, action: int) -> Tuple[int, int]:
        return divmod(int(action), self.size)

    def move_to_action(self, move: Tuple[int, int]) -> int:
        r, c = move
        return int(r) * self.size + int(c)

    # -- copying -----------------------------------------------------------
    def clone(self) -> "Pente":
        g = Pente(self.size)
        g.board = self.board.copy()
        g.current_player = int(self.current_player)
        g.last_move = None if self.last_move is None else tuple(self.last_move)
        g.captures = dict(self.captures)
        g.move_history = list(self.move_history)
        g.capture_history = [list(x) for x in self.capture_history]
        return g

    # -- moves -------------------------------------------------------------
    def do_move(self, move: Tuple[int, int]) -> bool:
        r, c = int(move[0]), int(move[1])
        if not (0 <= r < self.size and 0 <= c < self.size):
            return False
        if self.board[r, c] != 0:
            return False
        me = self.current_player
        self.board[r, c] = me
        self.last_move = (r, c)
        self.move_history.append((r, c))
        self.capture_history.append(self._apply_captures(r, c, me))
        self.current_player = 3 - me
        return True

    def _apply_captures(self, r: int, c: int, me: int) -> List[Tuple[int, int]]:
        """Remove captured pairs around (r, c); return removed coordinates."""
        opp = 3 - me
        size = self.size
        removed: List[Tuple[int, int]] = []
        for dr, dc in _CAPTURE_DIRS:
            r3, c3 = r + 3 * dr, c + 3 * dc
            if not (0 <= r3 < size and 0 <= c3 < size):
                continue
            r1, c1, r2, c2 = r + dr, c + dc, r + 2 * dr, c + 2 * dc
            if (self.board[r1, c1] == opp and self.board[r2, c2] == opp
                    and self.board[r3, c3] == me):
                self.board[r1, c1] = 0
                self.board[r2, c2] = 0
                self.captures[me] += 1
                removed += [(r1, c1), (r2, c2)]
        return removed

    def undo_move(self) -> None:
        if not self.move_history:
            return
        self.current_player = 3 - self.current_player
        r, c = self.move_history.pop()
        removed = self.capture_history.pop()
        self.board[r, c] = 0
        if removed:
            for rr, cc in removed:
                self.board[rr, cc] = 3 - self.current_player
            self.captures[self.current_player] -= len(removed) // 2
        self.last_move = self.move_history[-1] if self.move_history else None

    # -- legality ----------------------------------------------------------
    def get_legal_moves(self) -> List[Tuple[int, int]]:
        rs, cs = np.nonzero(self.board == 0)
        return list(zip(rs.tolist(), cs.tolist()))

    def has_legal_moves(self) -> bool:
        return bool((self.board == 0).any())

    def get_valid_moves(self) -> np.ndarray:
        return (self.board.reshape(-1) == 0).astype(np.float32)

    # -- state encoding ----------------------------------------------------
    def get_state(self) -> np.ndarray:
        return self.board.copy()

    def get_encoded_state(self, capture_planes: bool = False) -> np.ndarray:
        """[3|5, size, size] NCHW planes; mirrors ``PenteEnv.encode``."""
        me = self.current_player
        planes = [
            (self.board == me).astype(np.float32),
            (self.board == 3 - me).astype(np.float32),
            np.ones((self.size, self.size), dtype=np.float32),
        ]
        if capture_planes:
            ones = np.ones((self.size, self.size), dtype=np.float32)
            planes += [ones * (self.captures[me] / 5.0),
                       ones * (self.captures[3 - me] / 5.0)]
        return np.stack(planes, axis=0)

    # -- terminal checks ---------------------------------------------------
    def check_winner(self) -> int:
        if self.last_move is None:
            return 0
        r, c = self.last_move
        player = int(self.board[r, c])
        if player == 0:
            return 0
        if self.captures[player] >= 5:
            return player
        for dr, dc in _LINE_DIRS:
            if _run_length(self.board, r, c, dr, dc, player) >= 5:
                return player
        return 0

    def is_game_over(self) -> bool:
        return self.check_winner() != 0 or not self.has_legal_moves()

    def get_winner(self) -> int:
        return self.check_winner()

    # -- rendering ---------------------------------------------------------
    def display(self) -> None:
        print(render_board(self.board, self.current_player))
        print(f"Captured pairs — P1: {self.captures[1]}   P2: {self.captures[2]}")


def render_board(board: np.ndarray, current_player: int) -> str:
    """ANSI-coloured terminal rendering of a board (P1 red, P2 blue)."""
    red, blue, reset = "\033[31m", "\033[34m", "\033[0m"
    size = board.shape[0]
    glyph = {0: " - ", 1: f" {red}●{reset} ", 2: f" {blue}●{reset} "}
    lines = ["", "    " + " ".join(f"{i + 1:2}" for i in range(size))]
    for r in range(size):
        lines.append(f"{r + 1:2}  " + "".join(glyph[int(v)] for v in board[r]))
    dot = glyph[current_player].strip()
    lines += ["", f"Current player: {dot} (player {current_player})"]
    return "\n".join(lines)
