"""Batched Gomoku transition functions on tensors.

Counterpart of ``alphazero_gomoku_tpu/games/gomoku.py:33-166``.  The JAX
engine is written for one game and vmapped; here every field carries the
batch dimension ``[B, ...]`` and every function works on the whole batch.

Semantics as in the JAX engine:
  - board int8, 0 empty / 1 / 2; actions are flat ``r * size + c``.
  - win = 5-in-a-row through the last move; draw = board full, no winner.
  - ``encode`` gives NHWC float32 ``[B, H, W, 3]`` planes (stones of the side
    to move, stones of the opponent, constant ones), as the JAX function does.
  - ``terminal_value`` is -1 for the side to move after any win, 0 on a draw.

Functions return new states; none writes into the state it is given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.ops.lines import full_board_winner, wins_at


class GomokuState(NamedTuple):
    """Batched game state; every field has the leading batch axis ``[B]``."""

    board: torch.Tensor        # int8 [B, size, size]; 0 empty, 1, 2
    to_move: torch.Tensor      # int32 [B]; 1 or 2
    last_action: torch.Tensor  # int32 [B]; flat action of last move, -1 if none
    move_count: torch.Tensor   # int32 [B]
    winner: torch.Tensor       # int32 [B]; 0 none, 1, 2
    done: torch.Tensor         # bool [B]


def where_state(cond: torch.Tensor, a, b):
    """Per-lane select of two states of one type (``GomokuState``,
    ``PenteState``): lane ``i`` from ``a`` where ``cond[i]``, else ``b``."""
    def pick(x, y):
        return torch.where(cond.view((-1,) + (1,) * (x.dim() - 1)), x, y)
    return type(a)(*(pick(x, y) for x, y in zip(a, b)))


@dataclasses.dataclass(frozen=True)
class GomokuEnv:
    """Batched Gomoku environment (frozen, like the JAX one)."""

    size: int = 15

    @property
    def num_actions(self) -> int:
        return self.size * self.size

    @property
    def obs_channels(self) -> int:
        return 3

    @property
    def obs_plane_scales(self):
        """Per-plane integer scales of the exact uint8 replay storage
        (``selfplay/buffer.py``): every plane is binary, scale 1."""
        return (1.0, 1.0, 1.0)

    @property
    def name(self) -> str:
        return "gomoku"

    def init_batch(self, batch: int, device=None) -> GomokuState:
        dev = resolve_device(device)

        def full(value, dtype):
            return torch.full((batch,), value, dtype=dtype, device=dev)

        return GomokuState(
            board=torch.zeros((batch, self.size, self.size), dtype=torch.int8,
                              device=dev),
            to_move=full(1, torch.int32),
            last_action=full(-1, torch.int32),
            move_count=full(0, torch.int32),
            winner=full(0, torch.int32),
            done=full(False, torch.bool),
        )

    def from_board(self, board, to_move, move_count=None) -> GomokuState:
        """States of raw boards ``[B, size, size]`` (no history): the winner
        by a full line scan, ``last_action`` -1, ``move_count`` the stone
        count unless given (``alphazero_gomoku_tpu/games/gomoku.py:85``
        batched).  ``to_move`` and ``move_count`` are ints or ``[B]``."""
        board = torch.as_tensor(board).to(torch.int8)
        b = board.shape[0]
        dev = board.device

        def lanes(x):
            return torch.as_tensor(x, device=dev).to(torch.int32).expand(b)

        stones = (board != 0).reshape(b, -1).sum(dim=1).to(torch.int32)
        winner = full_board_winner(board)
        return GomokuState(
            board=board,
            to_move=lanes(to_move).clone(),
            last_action=torch.full((b,), -1, dtype=torch.int32, device=dev),
            move_count=(stones if move_count is None
                        else lanes(move_count).clone()),
            winner=winner,
            done=(winner != 0) | (stones >= self.num_actions),
        )

    def legal_mask(self, state: GomokuState) -> torch.Tensor:
        """bool ``[B, A]``: the point is empty and the game is not over."""
        empty = (state.board == 0).reshape(state.board.shape[0], -1)
        return empty & ~state.done[:, None]

    def step(self, state: GomokuState, action: torch.Tensor) -> GomokuState:
        """Apply one move per lane (assumed legal; see ``step_safe``).

        The winner is found incrementally from the placed stone.
        """
        action = action.to(torch.int32)
        a64 = action.long()
        r, c = a64 // self.size, a64 % self.size
        me = state.to_move
        b = state.board.shape[0]
        board = state.board.clone()
        lanes = torch.arange(b, device=board.device)
        board[lanes, r, c] = me.to(torch.int8)
        won = wins_at(board, r, c, me)
        winner = torch.where(won, me, torch.zeros_like(me))
        move_count = state.move_count + 1
        done = won | (move_count >= self.num_actions)
        return GomokuState(
            board=board,
            to_move=(3 - me).to(torch.int32),
            last_action=action,
            move_count=move_count,
            winner=winner,
            done=done,
        )

    def step_safe(self, state: GomokuState,
                  action: torch.Tensor) -> GomokuState:
        """Like ``step`` but a no-op on finished games (lockstep batches)."""
        return where_state(state.done, state, self.step(state, action))

    def encode(self, state: GomokuState) -> torch.Tensor:
        """float32 ``[B, size, size, 3]`` NHWC observation for the network."""
        me = state.to_move.to(torch.int8).view(-1, 1, 1)
        board = state.board
        return torch.stack(
            [
                (board == me).float(),
                (board == 3 - me).float(),
                torch.ones(board.shape, dtype=torch.float32,
                           device=board.device),
            ],
            dim=-1,
        )

    def terminal_value(self, state: GomokuState) -> torch.Tensor:
        """f32 ``[B]``: -1 for the side to move after a win, 0 on a draw."""
        return torch.where(state.winner == 0, 0.0, -1.0).to(torch.float32)
