"""Batched Pente transition functions on tensors.

Counterpart of ``alphazero_gomoku_tpu/games/pente.py:36-229``.  Pente is
Gomoku plus custodial captures: a move that makes ``mine-opp-opp-mine``
along any of the 8 rays removes the opponent's pair and scores one captured
pair; ``pairs_to_win`` captured pairs win, as does 5 in a row.

``step`` reads the 8 rays of every lane at once (one clipped gather of the
cells at distance 1, 2 and 3) and removes the pairs of the rays that match.
That equals the JAX engine's loop over the rays, one after another, because
the cells a capture removes (distance 1 and 2 on its ray) lie on no other
ray's distance 1, 2 or 3, and the anchor (distance 3) is the mover's stone,
which no capture removes: no ray's capture makes or unmakes another's.  A
ray that leaves the board has no match (its distance-3 cell is off the
board), and its clipped cells are never written, so a clipped index that
lands on another ray's pair, or on the placed stone, changes nothing.  One
move that matches on several rays scores one pair for each.

Unlike Gomoku, a game is not over when ``move_count`` reaches the number of
points: captures free squares, so the draw is a full board after the
captures.  With ``capture_planes`` the observation has two more planes, the
side to move's and the opponent's captured pairs over ``pairs_to_win``.

As in ``gomoku.py``, the game methods launch one kernel each on the card
(``ops/game_kernels.py``) and run the ``*_plain`` methods on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games.gomoku import where_state
from alphazero_gomoku_tpu_torch.ops import game_kernels as gk
from alphazero_gomoku_tpu_torch.ops.lines import full_board_winner, wins_at

# the 8 rays of capture detection, in the JAX engine's order
CAPTURE_DIRS = (
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, 1), (-1, -1), (1, -1), (-1, 1),
)


@functools.lru_cache(maxsize=None)
def _ray_steps(device: torch.device):
    """``(dr, dc)`` int64 ``[8, 3]``: the offsets of the cells at distance
    1, 2 and 3 along each capture ray, made once per device (a tensor made
    from a Python list is a copy from host memory, which on a card waits for
    the stream's queued work)."""
    dirs = torch.tensor(CAPTURE_DIRS, device=device)             # [8, 2]
    dist = torch.arange(1, 4, device=device)                    # [3]
    return dirs[:, 0, None] * dist, dirs[:, 1, None] * dist


class PenteState(NamedTuple):
    """Batched Pente state: ``GomokuState``'s fields and the captures."""

    board: torch.Tensor        # int8 [B, size, size]; 0 empty, 1, 2
    to_move: torch.Tensor      # int32 [B]; 1 or 2
    last_action: torch.Tensor  # int32 [B]; -1 if none
    move_count: torch.Tensor   # int32 [B]
    winner: torch.Tensor       # int32 [B]; 0 none, 1, 2
    done: torch.Tensor         # bool [B]
    captures: torch.Tensor     # int32 [B, 2]; pairs taken by player 1, 2


@dataclasses.dataclass(frozen=True)
class PenteEnv:
    """Batched Pente environment (frozen, like the JAX one)."""

    size: int = 15
    pairs_to_win: int = 5
    # two more observation planes with each side's captured pairs; a net
    # trained with one setting reads the other's boards wrong (its
    # ``in_channels`` is in the checkpoint's metadata)
    capture_planes: bool = False

    @property
    def num_actions(self) -> int:
        return self.size * self.size

    @property
    def obs_channels(self) -> int:
        return 5 if self.capture_planes else 3

    @property
    def obs_plane_scales(self):
        """Per-plane integer scales of the exact uint8 replay storage: the
        captured-pair planes hold k / 5 (k <= 4 in a recorded position: the
        game ends at 5), so scale 5 stores k."""
        if self.capture_planes:
            return (1.0, 1.0, 1.0, 5.0, 5.0)
        return (1.0, 1.0, 1.0)

    @property
    def name(self) -> str:
        return "pente"

    def init_batch(self, batch: int, device=None) -> PenteState:
        dev = resolve_device(device)

        def full(value, dtype):
            return torch.full((batch,), value, dtype=dtype, device=dev)

        return PenteState(
            board=torch.zeros((batch, self.size, self.size), dtype=torch.int8,
                              device=dev),
            to_move=full(1, torch.int32),
            last_action=full(-1, torch.int32),
            move_count=full(0, torch.int32),
            winner=full(0, torch.int32),
            done=full(False, torch.bool),
            captures=torch.zeros((batch, 2), dtype=torch.int32, device=dev),
        )

    def from_board(self, board, to_move, captures=(0, 0),
                   move_count=None) -> PenteState:
        """States of raw boards ``[B, size, size]`` and capture counts (an
        int pair or ``[B, 2]``): the winner by the capture threshold
        (player 1 first), else a full line scan.  ``to_move`` and
        ``move_count`` are ints or ``[B]``."""
        board = torch.as_tensor(board).to(torch.int8)
        b = board.shape[0]
        dev = board.device

        def lanes(x):
            return torch.as_tensor(x, device=dev).to(torch.int32).expand(b)

        captures = torch.as_tensor(captures, device=dev).to(
            torch.int32).expand(b, 2).clone()
        stones = (board != 0).reshape(b, -1).sum(dim=1).to(torch.int32)
        winner = torch.where(
            captures[:, 0] >= self.pairs_to_win, 1,
            torch.where(captures[:, 1] >= self.pairs_to_win, 2,
                        full_board_winner(board))).to(torch.int32)
        return PenteState(
            board=board,
            to_move=lanes(to_move).clone(),
            last_action=torch.full((b,), -1, dtype=torch.int32, device=dev),
            move_count=(stones if move_count is None
                        else lanes(move_count).clone()),
            winner=winner,
            done=(winner != 0) | (board != 0).reshape(b, -1).all(dim=1),
            captures=captures,
        )

    def legal_mask(self, state: PenteState) -> torch.Tensor:
        """bool ``[B, A]``: the point is empty and the game is not over."""
        if state.board.is_cpu:
            return self.legal_mask_plain(state)
        return gk.legal_mask(state)

    def step(self, state: PenteState, action: torch.Tensor) -> PenteState:
        """Apply one move per lane (assumed legal; see ``step_safe``):
        place, capture on every matching ray, then the win (captures first,
        then 5 in a row through the stone) and the full-board draw.  One
        launch of ``ops/game_kernels.py`` on the card, ``step_plain`` on
        the CPU."""
        if state.board.is_cpu:
            return self.step_plain(state, action)
        return PenteState(*gk.step(state, action, self.pairs_to_win, False))

    def step_safe(self, state: PenteState,
                  action: torch.Tensor) -> PenteState:
        """Like ``step`` but a no-op on finished games (lockstep batches)."""
        if state.board.is_cpu:
            return self.step_safe_plain(state, action)
        return PenteState(*gk.step(state, action, self.pairs_to_win, True))

    def encode(self, state: PenteState) -> torch.Tensor:
        """float32 ``[B, size, size, 3 | 5]`` NHWC observation: Gomoku's
        planes, and with ``capture_planes`` the side to move's and the
        opponent's captured pairs over ``pairs_to_win``."""
        if state.board.is_cpu:
            return self.encode_plain(state)
        return gk.encode(state, self.obs_channels, self.pairs_to_win)

    def terminal_value(self, state: PenteState) -> torch.Tensor:
        """f32 ``[B]``: -1 for the side to move after a win, 0 on a draw."""
        if state.winner.is_cpu:
            return self.terminal_value_plain(state)
        return gk.terminal_value(state.winner)

    # The plain versions, on any device: the CPU's path, and what the card's
    # tests hold the kernels against.
    def legal_mask_plain(self, state: PenteState) -> torch.Tensor:
        empty = (state.board == 0).reshape(state.board.shape[0], -1)
        return empty & ~state.done[:, None]

    def step_plain(self, state: PenteState,
                   action: torch.Tensor) -> PenteState:
        size = self.size
        action = action.to(torch.int32)
        a64 = action.long()
        r, c = a64 // size, a64 % size
        me = state.to_move
        b = state.board.shape[0]
        dev = state.board.device
        lanes = torch.arange(b, device=dev)
        me8 = me.to(torch.int8)
        board = state.board.clone()
        board[lanes, r, c] = me8

        # cells at distance 1, 2, 3 of each ray: [B, 8, 3]
        dr, dc = _ray_steps(dev)
        rr = r[:, None, None] + dr
        cc = c[:, None, None] + dc
        inb = ((rr[..., 2] >= 0) & (rr[..., 2] < size)
               & (cc[..., 2] >= 0) & (cc[..., 2] < size))           # [B, 8]
        idx = rr.clamp(0, size - 1) * size + cc.clamp(0, size - 1)
        flat = board.reshape(b, -1)
        cells = flat.gather(1, idx.reshape(b, -1)).reshape(idx.shape)
        opp8 = (3 - me).to(torch.int8)[:, None]
        hit = (inb & (cells[..., 0] == opp8) & (cells[..., 1] == opp8)
               & (cells[..., 2] == me8[:, None]))                   # [B, 8]
        # only a matching ray's pair is written; the others' (maybe
        # clipped) cells go to a spare column
        spare = size * size
        taken = torch.where(hit[..., None], idx[..., :2], spare)
        removed = torch.zeros((b, spare + 1), dtype=torch.bool, device=dev)
        removed.scatter_(1, taken.reshape(b, -1), True)
        board = torch.where(removed[:, :spare].reshape(board.shape),
                            torch.zeros_like(board), board)

        pairs = hit.sum(dim=1).to(torch.int32)
        captures = state.captures.clone()
        captures[lanes, me.long() - 1] += pairs
        won_caps = captures[lanes, me.long() - 1] >= self.pairs_to_win
        won_line = wins_at(board, r, c, me)
        winner = torch.where(won_caps | won_line, me,
                             torch.zeros_like(me)).to(torch.int32)
        board_full = (board != 0).reshape(b, -1).all(dim=1)
        return PenteState(
            board=board,
            to_move=(3 - me).to(torch.int32),
            last_action=action,
            move_count=state.move_count + 1,
            winner=winner,
            done=(winner != 0) | board_full,
            captures=captures,
        )

    def step_safe_plain(self, state: PenteState,
                        action: torch.Tensor) -> PenteState:
        return where_state(state.done, state, self.step_plain(state, action))

    def encode_plain(self, state: PenteState) -> torch.Tensor:
        me = state.to_move.to(torch.int8).view(-1, 1, 1)
        board = state.board
        ones = torch.ones(board.shape, dtype=torch.float32,
                          device=board.device)
        planes = [(board == me).float(), (board == 3 - me).float(), ones]
        if self.capture_planes:
            # a divisor held in a tensor on the state's device: a Python
            # number would make CUDA multiply by its rounded reciprocal,
            # which differs from k / pairs_to_win from k = 9 (pairs_to_win
            # 5); the CPU divides either way
            caps = state.captures.float() / state.captures.new_full(
                (), self.pairs_to_win, dtype=torch.float32)
            lanes = torch.arange(board.shape[0], device=board.device)
            mine = caps[lanes, state.to_move.long() - 1]
            theirs = caps[lanes, 2 - state.to_move.long()]
            planes += [ones * mine.view(-1, 1, 1),
                       ones * theirs.view(-1, 1, 1)]
        return torch.stack(planes, dim=-1)

    def terminal_value_plain(self, state: PenteState) -> torch.Tensor:
        return torch.where(state.winner == 0, 0.0, -1.0).to(torch.float32)
