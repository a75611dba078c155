"""The mirrored arena of two sides, which the A/B tools play through.

The JAX repo's tools write this loop four times (``tools/cross_net_arena.py
:30-100``, ``tools/reuse_ab.py:56-130``, ``tools/kleaf_ab.py:35-73``,
``tools/gumbel_ab.py:76-122``); here it is written once, as the port's arena
(``selfplay/arena.py``) plays it:

  - player 1's opening stone uniform in the centre 9x9, cut to the board
    (ROADMAP Queue C, P5);
  - P2's ply and then P1's in each pair, argmax play, noise off;
  - two halves on the same seed, so the same openings, with the seats
    swapped; the Wilson interval and the tally of the mirrored pairs
    (``win_both``, ``loss_both``, ``split``, ``n``).

A side (``selfplay.arena.Side``) is a search config, an eval function and a
bundle, and with ``reuse_budget > 0`` a tree carried from move to move.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from alphazero_gomoku_tpu_torch.selfplay.arena import (  # noqa: F401
    Side,
    evaluate_params_detailed,
    sides_half,
)


def mirrored(env, side_a: Side, side_b: Side, n_games: int, seed: int,
             device=None, openings: Optional[torch.Tensor] = None,
             uniforms: Optional[torch.Tensor] = None) -> Dict[str, object]:
    """Side A against side B: A is P1 in ceil(n/2) games and P2 in the
    rest, both halves on ``seed`` (:func:`evaluate_params_detailed`).

    ``openings`` and ``uniforms`` replace the random openings and the Gumbel
    root uniforms in both halves (``sides_half``).  Returns ``wins`` (A's),
    ``played``, ``draws``, ``win_rate``, ``ci95`` and ``pairs``.
    """
    def half(p1, p2, n, s):
        return sides_half(env, p1, p2, n, s, device, openings=openings,
                          uniforms=uniforms)

    return evaluate_params_detailed(env, None, None, side_a, side_b, n_games,
                                    seed, arena_half_fn=half, device=device)


def rounded(r: Dict[str, object]) -> Tuple[float, List[float]]:
    """``(win_rate, ci95)`` as the JAX tools print them (4 places)."""
    return round(r["win_rate"], 4), [round(x, 4) for x in r["ci95"]]
