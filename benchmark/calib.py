"""Calibration boards for the int8 net: positions of random legal play.

Random games, each of a random length of 4 to 59 moves, stopped at a win;
every position after a move is a board, encoded from the side to move's
view as the net reads it (with Pente's capture planes filled where the
configuration has them).  The configuration fixes the count and the seed,
so every run calibrates on the same boards, and the program and the
reference are given the same array.  Written for the benchmark on the
reference's rules (``reference/games.py``), as the program's
``random_play_calib_obs`` makes its boards, but with the capture planes,
which that function leaves at zero.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.games import Game


def random_play_boards(game: Game, n: int, seed: int,
                       games_at_once: int = 64) -> np.ndarray:
    """``[n, H, W, planes]`` float32 boards (NHWC), on the CPU."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        state = game.initial(games_at_once, "cpu")
        length = rng.integers(4, 60, size=games_at_once)
        for ply in range(int(length.max())):
            legal = game.legal(state).numpy()
            running = (~state.done.numpy()) & (ply < length) \
                & legal.any(axis=1)
            if not running.any():
                break
            # one uniform legal point a running game
            keys = np.where(legal, rng.random(legal.shape), -1.0)
            move = torch.from_numpy(keys.argmax(axis=1))
            stepped = game.step(state, move)
            keep = torch.from_numpy(running)
            state = type(state)(*(torch.where(
                keep.view((-1,) + (1,) * (new.dim() - 1)), new, old)
                for new, old in zip(stepped, state)))
            fresh = running & ~stepped.done.numpy()
            enc = game.encode(state).numpy()
            out.extend(enc[i] for i in np.flatnonzero(fresh))
    return np.stack(out[:n]).astype(np.float32)
