"""The game step as CUDA kernels: ``step`` (and ``step_safe``), ``encode``,
``legal_mask`` and ``terminal_value``, one launch each.

The env methods of ``games/gomoku.py`` and ``games/pente.py`` call these
wrappers for CUDA tensors; CPU tensors take the env's plain methods
(``step_plain``, ``step_safe_plain``, ``encode_plain``, ``legal_mask_plain``,
``terminal_value_plain``), which run on any device and which the card's tests
hold the kernels against, bit for bit.  A tensor on any other device raises
here: there is no fallback.  The kernels are in ``csrc/game_step.cu``; no TPU
kernel corresponds to them (the JAX game step is plain ``jnp``).

What the path depends on is what the inputs show: the device, whether the
state has ``captures`` (Pente), the number of planes, the board size (at
most ``MAX_CELLS`` points, the tree kernels' ``PUCT_MAX_ACTIONS``) and the
batch.  Fields are read through their lane stride, so the ``x[:, 0]`` slices
of a node-state stack (``packed_advance_root``) are not copied; a board whose
points are not contiguous within a lane, or a ``captures`` whose pair is
not, is copied first.  The step's outputs are views of one new buffer.  Each
wrapper counts its launches in its ``launches`` attribute
(:func:`reset_launch_counts`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops.tree_kernels import (
    PUCT_MAX_ACTIONS,
    _launch,
    _raise_on,
)

MAX_CELLS = PUCT_MAX_ACTIONS

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build("game_step").lib
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.game_step_launch.argtypes = [p, s] * 7 + [p, s, i, i, i, i, i,
                                                      p, p, p, p]
        lib.game_encode_launch.argtypes = [p, s] * 3 + [i, i, i, i, p, p]
        lib.game_legal_mask_launch.argtypes = [p, s, p, s, i, i, p, p]
        lib.game_terminal_value_launch.argtypes = [p, s, i, p, p]
        for fn in (lib.game_step_launch, lib.game_encode_launch,
                   lib.game_legal_mask_launch,
                   lib.game_terminal_value_launch):
            fn.restype = i
        _LIB = lib
    return _LIB


def _device(board: torch.Tensor, what: str) -> torch.device:
    dev = board.device
    if dev.type != "cuda":
        raise ValueError(f"game {what}: unsupported device {dev}")
    return dev


def _board(board: torch.Tensor, index: int) -> Tuple[torch.Tensor, int, int]:
    """``(board, batch, size)`` of an int8 ``[B, size, size]`` board on
    device ``index``, its points contiguous within a lane (copied if not)."""
    if board.dtype != torch.int8:
        raise TypeError(f"board has dtype {board.dtype}, expected int8")
    if board.dim() != 3 or board.shape[1] != board.shape[2]:
        raise ValueError(f"board must be [B, size, size], got "
                         f"{tuple(board.shape)}")
    b, size = board.shape[0], board.shape[1]
    if b < 1:
        raise ValueError("board needs at least one lane")
    if size * size > MAX_CELLS:
        raise ValueError(f"the game kernels take at most {MAX_CELLS} points, "
                         f"got {size}x{size}")
    if board.stride(2) != 1 or board.stride(1) != size:
        board = board.contiguous()
    return board, b, size


def _lanes(t: torch.Tensor, name: str, dtype, shape, index: int
           ) -> torch.Tensor:
    """``t`` checked as a ``shape`` field of ``dtype`` on device ``index``
    (any lane stride)."""
    if t.dtype == dtype and t.shape == shape and t.get_device() == index:
        return t
    if t.get_device() != index:
        raise ValueError(f"{name} is on {t.device}, expected cuda:{index}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                     f"{tuple(shape)}")


def _captures(captures: torch.Tensor, b: int, index: int) -> torch.Tensor:
    captures = _lanes(captures, "captures", torch.int32, (b, 2), index)
    return captures if captures.stride(1) == 1 else captures.contiguous()


def step(state, action: torch.Tensor, pairs_to_win: Optional[int],
         safe: bool) -> tuple:
    """The fields of ``env.step(state, action)`` (``env.step_safe`` with
    ``safe``), in the state's field order.

    ``state`` is a ``GomokuState`` (``pairs_to_win`` None) or a
    ``PenteState`` whose game ends at ``pairs_to_win`` captured pairs, on
    one card; ``action`` int32 or int64 ``[B]`` (other dtypes are converted,
    as the plain step converts them), assumed legal.  With ``safe`` the
    lanes whose game is over come out as they went in.  One launch; the
    outputs are views of one new buffer.
    """
    dev = _device(state.board, "step")
    index = dev.index
    board, b, size = _board(state.board, index)
    lane = (b,)
    to_move = _lanes(state.to_move, "to_move", torch.int32, lane, index)
    last = _lanes(state.last_action, "last_action", torch.int32, lane, index)
    moves = _lanes(state.move_count, "move_count", torch.int32, lane, index)
    winner = _lanes(state.winner, "winner", torch.int32, lane, index)
    done = _lanes(state.done, "done", torch.bool, lane, index)
    pente = pairs_to_win is not None
    captures = _captures(state.captures, b, index) if pente else None
    if action.dtype != torch.int32 and action.dtype != torch.int64:
        action = action.to(torch.int32)
    action = _lanes(action, "action", action.dtype, lane, index)

    cells = size * size
    n_int = (6 if pente else 4) * b
    out = torch.empty(4 * n_int + b + b * cells, dtype=torch.uint8,
                      device=dev)
    ints, done_out, board_out = out.split_with_sizes((4 * n_int, b,
                                                      b * cells))
    err = _launch(
        dev, _library().game_step_launch,
        board.data_ptr(), board.stride(0),
        to_move.data_ptr(), to_move.stride(0),
        last.data_ptr(), last.stride(0),
        moves.data_ptr(), moves.stride(0),
        winner.data_ptr(), winner.stride(0),
        done.data_ptr(), done.stride(0),
        captures.data_ptr() if pente else None,
        captures.stride(0) if pente else 0,
        action.data_ptr(), action.stride(0),
        int(action.dtype == torch.int64), b, size, int(pairs_to_win or 0),
        int(safe), board_out.data_ptr(), ints.data_ptr(),
        done_out.data_ptr())
    _raise_on(err, "game step")
    step.launches += 1
    fields = ints.view(torch.int32).split_with_sizes(
        (b, b, b, b, 2 * b) if pente else (b, b, b, b))
    head = (board_out.view(torch.int8).view(b, size, size), *fields[:4],
            done_out.view(torch.bool))
    return head + (fields[4].view(b, 2),) if pente else head


step.launches = 0


def encode(state, planes: int, pairs_to_win: int) -> torch.Tensor:
    """float32 ``[B, size, size, planes]``, ``env.encode(state)``: 3 planes,
    or 5 with the captured pairs (``state.captures`` over
    ``pairs_to_win``)."""
    dev = _device(state.board, "encode")
    index = dev.index
    board, b, size = _board(state.board, index)
    to_move = _lanes(state.to_move, "to_move", torch.int32, (b,), index)
    if planes == 5:
        captures = _captures(state.captures, b, index)
        caps_ptr, caps_stride = captures.data_ptr(), captures.stride(0)
    elif planes == 3:
        caps_ptr, caps_stride = None, 0
    else:
        raise ValueError(f"encode gives 3 or 5 planes, not {planes}")
    out = torch.empty((b, size, size, planes), dtype=torch.float32,
                      device=dev)
    err = _launch(dev, _library().game_encode_launch, board.data_ptr(),
                  board.stride(0), to_move.data_ptr(), to_move.stride(0),
                  caps_ptr, caps_stride, b, size * size, planes,
                  int(pairs_to_win), out.data_ptr())
    _raise_on(err, "game encode")
    encode.launches += 1
    return out


encode.launches = 0


def legal_mask(state) -> torch.Tensor:
    """bool ``[B, A]``, ``env.legal_mask(state)``: the point is empty and the
    game is not over."""
    dev = _device(state.board, "legal_mask")
    index = dev.index
    board, b, size = _board(state.board, index)
    done = _lanes(state.done, "done", torch.bool, (b,), index)
    out = torch.empty((b, size * size), dtype=torch.bool, device=dev)
    err = _launch(dev, _library().game_legal_mask_launch, board.data_ptr(),
                  board.stride(0), done.data_ptr(), done.stride(0), b,
                  size * size, out.data_ptr())
    _raise_on(err, "game legal_mask")
    legal_mask.launches += 1
    return out


legal_mask.launches = 0


def terminal_value(winner: torch.Tensor) -> torch.Tensor:
    """f32 ``[B]``, ``env.terminal_value(state)`` of ``state.winner``: -1
    for the side to move after a win, 0 otherwise."""
    dev = _device(winner, "terminal_value")
    if winner.dim() != 1 or winner.shape[0] < 1:
        raise ValueError(f"winner must be [B], got {tuple(winner.shape)}")
    b = winner.shape[0]
    winner = _lanes(winner, "winner", torch.int32, (b,), dev.index)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    err = _launch(dev, _library().game_terminal_value_launch,
                  winner.data_ptr(), winner.stride(0), b, out.data_ptr())
    _raise_on(err, "game terminal_value")
    terminal_value.launches += 1
    return out


terminal_value.launches = 0


def reset_launch_counts():
    step.launches = 0
    encode.launches = 0
    legal_mask.launches = 0
    terminal_value.launches = 0


def launch_counts() -> dict:
    return {"game_step": step.launches,
            "game_encode": encode.launches,
            "game_legal_mask": legal_mask.launches,
            "game_terminal_value": terminal_value.launches}

