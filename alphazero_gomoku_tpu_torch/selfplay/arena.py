"""Arena evaluation: candidate against best, lockstep games on the device.

Counterpart of ``alphazero_gomoku_tpu/selfplay/arena.py:38-200``:

  - a random opening move for player 1 in the centre 9x9 (radius 4), or
    the whole board where it is smaller;
  - the search with noise off, the move its policy's argmax, both nets'
    searches on the port's packed tree (PUCT, or Gumbel when the config
    says so);
  - the loop advances a pair of plies at a time (P2's move, then P1's), so
    that each search uses one net; finished games are frozen by
    ``step_safe``, and a game unfinished at the cap is a draw;
  - mirrored openings: both seat halves of :func:`evaluate_params_detailed`
    get the same seed, hence the same openings, so game ``i`` of each half
    starts from the same position with the seats swapped; the result has a
    Wilson 95 % interval and the pairs' outcomes.

The JAX arena draws from a PRNG key; here a seed makes a ``torch.Generator``
on the device, for the openings and (Gumbel) the root noise.  Any game's
env plays (Gomoku, or Pente with or without capture planes: the nets read
``env.encode``'s planes).  The two nets must read the same observation
planes: :func:`evaluate_params_detailed` refuses configs whose
``in_channels`` differ (ADVICE.md r5, P3).

The loop itself is :func:`sides_half`, which also plays two *sides* that
differ in search, network or bundle, with a tree carried from move to move
on either (the A/B tools of ``tools/``, ``tools/ab_arena.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.ops.tree_kernels import KERNELS, TreeOps
from alphazero_gomoku_tpu_torch.search.tree import EvalFn, MCTSConfig
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    init_packed_carry,
    packed_advance_root,
    run_search,
)

OPENING_RADIUS = 4  # the centre 9x9


class Side(NamedTuple):
    """One side of an arena: its search config, eval function and bundle.

    A config with ``reuse_budget > 0`` carries the side's tree from move to
    move (a ``PackedCarry`` made at the position after the opening and
    re-rooted by ``packed_advance_root`` at every ply, its own and the
    opponent's).  ``play_winner`` plays a Gumbel search's sequential-halving
    winner; otherwise the side plays its policy's argmax (for Gumbel, the
    improved policy's, as the arena of the training loop does).  ``ops``
    are its searches' tree functions: the kernel wrappers, or
    ``tree_kernels.PLAIN``.
    """

    cfg: MCTSConfig
    eval_fn: EvalFn
    bundle: Any
    play_winner: bool = False
    ops: TreeOps = KERNELS


def centre_openings(env, n_games: int, generator: torch.Generator,
                    device=None) -> torch.Tensor:
    """Player 1's opening actions ``[n_games]``, uniform over the centre 9x9
    cut to the board: rows, then columns, from ``generator``."""
    size = env.size
    center = size // 2
    # the JAX arena draws rows and columns outside a board smaller than 9x9
    # (ROADMAP Queue C, P5)
    lo = max(0, center - OPENING_RADIUS)
    hi = min(size, center + OPENING_RADIUS + 1)
    r0 = torch.randint(lo, hi, (n_games,), generator=generator, device=device)
    c0 = torch.randint(lo, hi, (n_games,), generator=generator, device=device)
    return r0 * size + c0


def sides_half(env, side_p1: Side, side_p2: Side, n_games: int, seed: int,
               device=None, openings: Optional[torch.Tensor] = None,
               uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Play ``n_games`` lockstep games, P1 searching as ``side_p1`` and P2
    as ``side_p2``; the winners ``[n_games]`` (int32: 0 draw, 1, 2).

    ``openings`` (``[>= n_games]`` actions) replaces the random opening, and
    ``uniforms`` (``[n_games, A]``) the root uniforms of every Gumbel search:
    tests inject the JAX package's draws.  Otherwise both come from a
    generator seeded with ``seed``: the openings, then each ply's search.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if openings is None:
        openings = centre_openings(env, n_games, gen, dev)
    states = env.step(env.init_batch(n_games, dev),
                      torch.as_tensor(openings[:n_games], device=dev))
    zeros = torch.zeros((n_games,), dtype=torch.int32, device=dev)
    sides = (side_p1, side_p2)
    carries = [init_packed_carry(env, s.cfg, states)
               if s.cfg.reuse_budget > 0 else None for s in sides]

    def move(i, states):
        side = sides[i]
        pi, _, winner, carry = run_search(
            env, side.cfg, side.eval_fn, side.bundle, states, zeros, gen,
            carry=carries[i], uniforms=uniforms, ops=side.ops)
        if carries[i] is not None:
            carries[i] = carry
        return winner if side.play_winner else torch.argmax(pi, dim=-1)

    for _ in range((env.num_actions + 1) // 2):
        if bool(states.done.all()):
            break
        for i in (1, 0):                # P2 to move first, then P1
            action = move(i, states)
            states = env.step_safe(states, action)
            for j, carry in enumerate(carries):
                if carry is not None:
                    carries[j] = packed_advance_root(env, sides[j].cfg, carry,
                                                     action)
    return states.winner


def arena_half(env, cfg: MCTSConfig, eval_fn: EvalFn, params_p1, params_p2,
               n_games: int, seed: int, device=None,
               openings: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Play ``n_games`` lockstep games, P1 on ``params_p1`` and P2 on
    ``params_p2``, both searching with ``cfg`` (:func:`sides_half`); the
    winners ``[n_games]`` (int32: 0 draw, 1, 2)."""
    return sides_half(env, Side(cfg, eval_fn, params_p1),
                      Side(cfg, eval_fn, params_p2), n_games, seed, device,
                      openings=openings)


def wilson_ci(wins: int, n: int, z: float = 1.96) -> Tuple[float, float]:
    """Wilson score interval for a binomial proportion (95 % by default)."""
    if n == 0:
        return (0.0, 1.0)
    p = wins / n
    z2 = z * z
    denom = 1.0 + z2 / n
    centre = (p + z2 / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z2 / (4 * n * n)) / denom
    return (max(0.0, centre - half), min(1.0, centre + half))


def evaluate_params_detailed(env, cfg: MCTSConfig, eval_fn: EvalFn,
                             params_new, params_best, n_games: int,
                             seed: int, arena_half_fn=None, device=None,
                             net_cfgs=None,
                             openings: Optional[torch.Tensor] = None
                             ) -> Dict[str, object]:
    """Candidate-vs-best arena with mirrored openings.

    The candidate is P1 in ceil(n/2) games and P2 in the rest; both halves
    get ``seed``.  Returns ``wins / played / draws / win_rate`` (draws count
    against), ``ci95`` (Wilson) and ``pairs`` (``win_both / split /
    loss_both / n`` over the mirrored openings).
    ``arena_half_fn(p1, p2, n, seed) -> winners`` replaces
    :func:`arena_half`, to which ``openings`` goes (both halves open with
    them).  ``net_cfgs``, the two nets' ``NetConfig`` where known, must
    agree on ``in_channels``.
    """
    if net_cfgs is not None:
        a, b = (c.in_channels for c in net_cfgs)
        if a != b:
            raise ValueError(f"arena nets read different observation "
                             f"planes: in_channels {a} and {b}")
    n_as_p1 = (n_games + 1) // 2
    n_as_p2 = n_games // 2
    if arena_half_fn is None:
        def arena_half_fn(p1, p2, n, s):
            return arena_half(env, cfg, eval_fn, p1, p2, n, s, device,
                              openings)

    new_wins = draws = played = 0
    w_a = w_b = None
    if n_as_p1 > 0:
        w_a = torch.as_tensor(arena_half_fn(params_new, params_best, n_as_p1,
                                            seed)).cpu()
        new_wins += int((w_a == 1).sum())
        draws += int((w_a == 0).sum())
        played += int(w_a.shape[0])
    if n_as_p2 > 0:
        w_b = torch.as_tensor(arena_half_fn(params_best, params_new, n_as_p2,
                                            seed)).cpu()
        new_wins += int((w_b == 2).sum())
        draws += int((w_b == 0).sum())
        played += int(w_b.shape[0])

    pairs = {"win_both": 0, "split": 0, "loss_both": 0, "n": 0}
    # openings align index for index only when both halves are as long
    if w_a is not None and w_b is not None and w_a.shape == w_b.shape:
        won_a, won_b = w_a == 1, w_b == 2
        pairs["win_both"] = int((won_a & won_b).sum())
        pairs["loss_both"] = int((~won_a & ~won_b).sum())
        pairs["n"] = int(w_a.shape[0])
        pairs["split"] = pairs["n"] - pairs["win_both"] - pairs["loss_both"]

    win_rate = new_wins / float(played) if played else 0.0
    return {"wins": new_wins, "played": played, "draws": draws,
            "win_rate": win_rate, "ci95": wilson_ci(new_wins, played),
            "pairs": pairs}


def evaluate_params(env, cfg: MCTSConfig, eval_fn: EvalFn, params_new,
                    params_best, n_games: int, seed: int,
                    arena_half_fn=None, device=None
                    ) -> Tuple[int, float, int]:
    """``(new_wins, win_rate, draws)`` of :func:`evaluate_params_detailed`."""
    r = evaluate_params_detailed(env, cfg, eval_fn, params_new, params_best,
                                 n_games, seed, arena_half_fn=arena_half_fn,
                                 device=device)
    return r["wins"], r["win_rate"], r["draws"]
