"""Five-in-a-row detection through a placed stone, batched.

Counterpart of ``alphazero_gomoku_tpu/ops/lines.py:20-84``
(``run_length_through`` / ``wins_at``): the 4-cell rays on both sides of the
stone along the four line axes are read with one clipped gather, and the run
length through the centre is the sum of the cumulative products of
"same colour and on the board" along each ray.  The batch dimension is
written out where JAX vmaps a single-board function.
"""

from __future__ import annotations

import torch

# Line axes for n-in-a-row checks: vertical, horizontal, two diagonals.
LINE_DIRS = ((1, 0), (0, 1), (1, 1), (1, -1))


def _ray_offsets(need: int, device):
    """(dr, dc) of shape [4 axes, 2 signs, need-1 steps], int64."""
    ks = torch.arange(1, need, device=device)
    dirs = torch.tensor(LINE_DIRS, device=device)            # [4, 2]
    signs = torch.tensor([1, -1], device=device)              # [2]
    step = signs[None, :, None] * ks[None, None, :]           # [1, 2, K]
    return dirs[:, 0, None, None] * step, dirs[:, 1, None, None] * step


def run_length_through(board: torch.Tensor, r, c, player,
                       need: int = 5) -> torch.Tensor:
    """Max same-colour run length through ``(r, c)`` over the 4 line axes.

    Args:
        board: int ``[B, H, W]`` with 0 empty / 1 / 2.
        r, c: int ``[B]`` coordinates of the stone to check through.
        player: int ``[B]`` colour expected on the run.
        need: the ray length is ``need - 1`` (5-in-a-row -> 4).

    Returns:
        int32 ``[B]``.  The centre cell counts as ``player``'s whatever the
        board holds there, as in the JAX version (the caller places first).
    """
    b, h, w = board.shape
    dr, dc = _ray_offsets(need, board.device)                 # [4, 2, K]
    rr = r.long().view(b, 1, 1, 1) + dr                       # [B, 4, 2, K]
    cc = c.long().view(b, 1, 1, 1) + dc
    inb = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
    idx = rr.clamp(0, h - 1) * w + cc.clamp(0, w - 1)
    vals = board.reshape(b, h * w).gather(1, idx.view(b, -1)).view(idx.shape)
    same = (inb & (vals == player.view(b, 1, 1, 1).to(vals.dtype))).int()
    # consecutive run starting at distance 1: sum of the cumulative product
    per_ray = torch.cumprod(same, dim=-1).sum(dim=-1)        # [B, 4, 2]
    total = 1 + per_ray.sum(dim=-1)                            # [B, 4]
    return total.max(dim=-1).values.int()


def wins_at(board: torch.Tensor, r, c, player, need: int = 5) -> torch.Tensor:
    """bool ``[B]``: a stone at ``(r, c)`` gives ``player`` ``need`` in a row."""
    return run_length_through(board, r, c, player, need) >= need


def has_line(board: torch.Tensor, player, need: int = 5) -> torch.Tensor:
    """bool ``[B]``: ``player`` has ``need`` in a row anywhere on the board.

    ``alphazero_gomoku_tpu/ops/lines.py:57`` batched: the AND of ``need``
    shifted copies of the player's stones, on a board padded by ``need - 1``
    empty cells, is non-empty along one of the four line axes.  For boards
    that come without a last move (``from_board``).  ``player`` is an int or
    an int ``[B]``.
    """
    b, h, w = board.shape
    player = torch.as_tensor(player, device=board.device).to(board.dtype)
    mine = board == player.reshape(-1, 1, 1)
    pad = need - 1
    big = torch.nn.functional.pad(mine, (pad, pad, pad, pad))
    found = torch.zeros(b, dtype=torch.bool, device=board.device)
    for dr, dc in LINE_DIRS:
        acc = torch.ones((b, h, w), dtype=torch.bool, device=board.device)
        for k in range(need):
            r0, c0 = pad + k * dr, pad + k * dc
            acc = acc & big[:, r0:r0 + h, c0:c0 + w]
        found = found | acc.reshape(b, -1).any(dim=1)
    return found


def full_board_winner(board: torch.Tensor, need: int = 5) -> torch.Tensor:
    """int32 ``[B]`` winner (0 / 1 / 2) of raw boards by a full line scan;
    player 1 where both have a line, as in the JAX function."""
    w1 = has_line(board, 1, need)
    w2 = has_line(board, 2, need)
    zero = torch.zeros_like(w1, dtype=torch.int32)
    return torch.where(w1, 1, torch.where(w2, 2, zero)).to(torch.int32)
