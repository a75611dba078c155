"""Gomoku and Pente rules in plain PyTorch, batched over lanes.

Written for the benchmark's reference from the rules themselves, not from
the program's engines:

  - a move places the mover's stone on an empty point (flat index
    ``r * size + c``);
  - Pente only: every ray of the 8 that reads ``opp, opp, mine`` at
    distances 1, 2, 3 from the new stone removes that pair and scores one
    captured pair for the mover;
  - the mover wins with 5 in a row through the new stone, or (Pente) with
    ``pairs_to_win`` captured pairs;
  - the game is drawn when the board is full after the move (in Gomoku that
    is the move count reaching the number of points).

``State.captures`` is ``[B, 2]`` (pairs taken by players 1 and 2), zero for
Gomoku.  No function writes into the state it is given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CAPTURE_RAYS = ((1, 0), (-1, 0), (0, 1), (0, -1),
                (1, 1), (-1, -1), (1, -1), (-1, 1))
LINE_AXES = ((1, 0), (0, 1), (1, 1), (1, -1))
# both directions of each axis, axis by axis
LINE_RAYS = tuple((dy * sg, dx * sg) for dy, dx in LINE_AXES for sg in (1, -1))


class State(NamedTuple):
    board: torch.Tensor       # int8 [B, S, S]
    to_move: torch.Tensor     # int32 [B], 1 or 2
    move_count: torch.Tensor  # int32 [B]
    winner: torch.Tensor      # int32 [B], 0 none
    done: torch.Tensor        # bool [B]
    captures: torch.Tensor    # int32 [B, 2]


def where(cond: torch.Tensor, a: State, b: State) -> State:
    """Lane ``i`` of ``a`` where ``cond[i]``, else of ``b``."""
    def pick(x, y):
        return torch.where(cond.view((-1,) + (1,) * (x.dim() - 1)), x, y)
    return State(*(pick(x, y) for x, y in zip(a, b)))


def take(state: State, idx) -> State:
    return State(*(x[idx] for x in state))


class Game:
    """One game's rules: ``name`` is ``"gomoku"`` or ``"pente"``."""

    def __init__(self, name: str, size: int = 15, pairs_to_win: int = 5,
                 capture_planes: bool = False):
        if name not in ("gomoku", "pente"):
            raise ValueError(f"unknown game {name!r}")
        self.name = name
        self.size = size
        self.pairs_to_win = pairs_to_win
        self.capture_planes = capture_planes and name == "pente"
        self.num_actions = size * size
        self._made = {}

    def initial(self, batch: int, device) -> State:
        i32 = torch.int32
        return State(
            board=torch.zeros((batch, self.size, self.size),
                              dtype=torch.int8, device=device),
            to_move=torch.ones(batch, dtype=i32, device=device),
            move_count=torch.zeros(batch, dtype=i32, device=device),
            winner=torch.zeros(batch, dtype=i32, device=device),
            done=torch.zeros(batch, dtype=torch.bool, device=device),
            captures=torch.zeros((batch, 2), dtype=i32, device=device))

    def legal(self, state: State) -> torch.Tensor:
        """bool ``[B, A]``: empty point of a game still running."""
        empty = (state.board == 0).reshape(state.board.shape[0], -1)
        return empty & ~state.done[:, None]

    def _cells(self, board, r, c, dr, dc):
        """``(values, on_board)`` of the cells ``(r + dr, c + dc)``: ``r``,
        ``c`` are ``[B]``, ``dr``, ``dc`` offsets of any shape; 0 off the
        board."""
        s = self.size
        b = board.shape[0]
        shape = (b,) + (1,) * dr.dim()
        rr = r.view(shape) + dr
        cc = c.view(shape) + dc
        inb = (rr >= 0) & (rr < s) & (cc >= 0) & (cc < s)
        idx = (rr.clamp(0, s - 1) * s + cc.clamp(0, s - 1)).reshape(b, -1)
        vals = board.reshape(b, -1).gather(1, idx).reshape(rr.shape)
        return torch.where(inb, vals, torch.zeros_like(vals)), inb, idx

    def _offsets(self, dirs, dists, device):
        key = (dirs, dists, str(device))
        if key not in self._made:
            d = torch.tensor(dirs, device=device)
            k = torch.tensor(dists, device=device)
            self._made[key] = (d[:, 0, None] * k, d[:, 1, None] * k)
        return self._made[key]

    def step(self, state: State, action: torch.Tensor) -> State:
        """One move a lane; the move is assumed legal."""
        s = self.size
        b = state.board.shape[0]
        dev = state.board.device
        lanes = torch.arange(b, device=dev)
        a = action.long()
        r, c = a // s, a % s
        me = state.to_move
        board = state.board.clone()
        board[lanes, r, c] = me.to(torch.int8)
        captures = state.captures.clone()
        mine = lanes, me.long() - 1
        if self.name == "pente":
            # rays x distances 1, 2, 3: opp, opp, mine takes the pair
            dr, dc = self._offsets(CAPTURE_RAYS, (1, 2, 3), dev)
            v, inb, idx = self._cells(board, r, c, dr, dc)
            v = v.to(torch.int32)
            opp = (3 - me).view(b, 1)
            hit = (inb[..., 2] & (v[..., 0] == opp) & (v[..., 1] == opp)
                   & (v[..., 2] == me.view(b, 1)))                 # [B, 8]
            gone = torch.zeros((b, s * s + 1), dtype=torch.bool, device=dev)
            taken = torch.where(hit[..., None], idx.view(b, 8, 3)[..., :2],
                                s * s)
            gone.scatter_(1, taken.reshape(b, -1), True)
            board = torch.where(gone[:, :-1].view(b, s, s),
                                torch.zeros_like(board), board)
            captures[mine] += hit.sum(dim=1).to(torch.int32)
        # 5 in a row through the stone: the runs on both sides of each axis
        dr, dc = self._offsets(LINE_RAYS, (1, 2, 3, 4), dev)
        v, _, _ = self._cells(board, r, c, dr, dc)
        same = (v.to(torch.int32) == me.view(b, 1, 1)).to(torch.int32)
        runs = torch.cumprod(same, dim=-1).sum(dim=-1).view(b, 4, 2)
        won = (1 + runs.sum(dim=-1)).max(dim=-1).values >= 5
        if self.name == "pente":
            won = won | (captures[mine] >= self.pairs_to_win)
        full = (board != 0).reshape(b, -1).all(dim=1)
        winner = torch.where(won, me, torch.zeros_like(me))
        return State(board=board, to_move=(3 - me).to(torch.int32),
                     move_count=state.move_count + 1, winner=winner,
                     done=won | full, captures=captures)

    def step_safe(self, state: State, action: torch.Tensor) -> State:
        """``step`` on running games; finished games stay as they are."""
        return where(state.done, state, self.step(state, action))

    def encode(self, state: State) -> torch.Tensor:
        """NHWC float32 planes: the mover's stones, the opponent's, ones,
        and with capture planes each side's captured pairs over
        ``pairs_to_win`` (the mover's first)."""
        me = state.to_move.to(torch.int8).view(-1, 1, 1)
        board = state.board
        ones = torch.ones(board.shape, dtype=torch.float32,
                          device=board.device)
        planes = [(board == me).float(), (board == 3 - me).float(), ones]
        if self.capture_planes:
            lanes = torch.arange(board.shape[0], device=board.device)
            caps = state.captures.float() / float(self.pairs_to_win)
            mine = caps[lanes, state.to_move.long() - 1]
            theirs = caps[lanes, 2 - state.to_move.long()]
            planes += [ones * mine.view(-1, 1, 1),
                       ones * theirs.view(-1, 1, 1)]
        return torch.stack(planes, dim=-1)

    def terminal_value(self, state: State) -> torch.Tensor:
        """-1 for the side to move after a win, 0 on a draw."""
        return torch.where(state.winner == 0, 0.0, -1.0).to(torch.float32)
