"""Lockstep batched self-play: B games advance one move at a time together.

Counterpart of ``alphazero_gomoku_tpu/selfplay/runner.py:38-318``
(``SelfPlayConfig``, ``Trajectories``, ``sample_actions``, ``play_games``).
The JAX runner is one ``while_loop`` on the device; here the move loop is
Python, and it stops when every game is done or ``max_moves`` is reached, as
the JAX loop does.

Semantics as in the JAX runner:
  - temperature ``temp = max(0, 1 - move/temp_threshold)``;
  - moves sampled from ``pi^(1/T)`` (the Gumbel-max trick), argmax when
    T <= 0, and argmax when a sample lands on an illegal action;
  - with ``search="gumbel"`` the move is the sequential-halving winner (no
    temperature sampling: exploration is the search's root Gumbel sample),
    and the recorded pi is the search's improved-policy target;
  - per-move records of the board before the move, the player to move, pi,
    the root value and an ``active`` flag; finished games are frozen by
    ``step_safe`` and their later records marked inactive.

Not ported yet, each refused with an error: subtree reuse, playout cap
randomization (``pcr_cheap_sims``) and the random opening
(``opening_random_moves``).  ``collect_examples`` and the
symmetry augmentation wait for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.search.gumbel import run_gumbel_mcts
from alphazero_gomoku_tpu_torch.search.tree import (
    EvalFn,
    MCTSConfig,
    run_mcts_with_q,
)

# smallest positive normal f32: the floor of the Gumbel-max uniforms
# (jax.random.gumbel draws them from [tiny, 1))
_F32_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    batch_games: int
    mcts: MCTSConfig
    temp_threshold: int = 10
    max_moves: int = 0  # 0 => board_size ** 2
    opening_random_moves: int = 0
    pcr_cheap_sims: int = 0

    def __post_init__(self):
        if self.opening_random_moves:
            raise NotImplementedError(
                "the random opening (opening_random_moves > 0) is not ported "
                "yet (ROADMAP Queue A item 11)")
        if self.pcr_cheap_sims:
            raise NotImplementedError(
                "playout cap randomization (pcr_cheap_sims > 0) is not "
                "ported yet (ROADMAP Queue A item 11)")

    def resolved_max_moves(self, env) -> int:
        return self.max_moves or env.num_actions


class Trajectories(NamedTuple):
    """Per-move records of a lockstep batch ``[T, B, ...]``, outcomes ``[B]``."""

    boards: torch.Tensor     # int8 [T, B, H, W] board BEFORE the move
    players: torch.Tensor    # int32 [T, B] player to move
    pis: torch.Tensor        # f32 [T, B, A] search policy
    root_qs: torch.Tensor    # f32 [T, B] root value (side-to-move view)
    active: torch.Tensor     # bool [T, B] record valid (game not yet over)
    actions: torch.Tensor    # int32 [T, B] move played (0 for finished games)
    winners: torch.Tensor    # int32 [B]
    moves_played: torch.Tensor  # int32 [B] moves each game lasted


def sample_actions(pi: torch.Tensor, temp: torch.Tensor, legal: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temperature sampling over ``pi [B, A]`` (batched), int64 ``[B]``.

    Samples ``argmax(log(pi + 1e-15) / T + g)`` with Gumbel noise
    ``g = -log(-log(u))``; argmax of ``pi`` where ``T <= 0`` or where the
    sample is illegal.  ``temp`` is an f32 scalar or ``[B]``.  The uniforms
    ``u`` (``[B, A]`` in ``[tiny, 1)``) are ``uniforms`` when given (tests
    inject the JAX package's draw), else a draw from ``generator``.
    """
    temp = torch.as_tensor(temp, dtype=torch.float32, device=pi.device)
    tcol = temp[:, None] if temp.dim() == 1 else temp
    logits = torch.log(pi + 1e-15) / torch.clamp(tcol, min=1e-8)
    if uniforms is None:
        uniforms = torch.rand(pi.shape, generator=generator, device=pi.device)
    gumbel = -torch.log(-torch.log(torch.clamp(uniforms, min=_F32_TINY)))
    sampled = torch.argmax(logits + gumbel, dim=-1)
    greedy = torch.argmax(pi, dim=-1)
    sampled_legal = legal.gather(1, sampled[:, None]).squeeze(1)
    take_greedy = (temp <= 0.0) | ~sampled_legal
    return torch.where(take_greedy, greedy, sampled)


def play_games(env, cfg: SelfPlayConfig, eval_fn: EvalFn, net_params,
               generator: torch.Generator, device=None) -> Trajectories:
    """Play ``cfg.batch_games`` lockstep games until all are done or
    ``max_moves`` moves are played.

    ``generator`` (on ``device``) gives the root noise and the move samples
    (PUCT), or the root Gumbel noise (Gumbel): one ``[B, A]`` draw per move.
    """
    dev = resolve_device(device)
    batch = cfg.batch_games
    max_moves = cfg.resolved_max_moves(env)
    size = env.size
    a = env.num_actions
    states = env.init_batch(batch, dev)

    boards = torch.zeros((max_moves, batch, size, size), dtype=torch.int8,
                         device=dev)
    players = torch.zeros((max_moves, batch), dtype=torch.int32, device=dev)
    pis = torch.zeros((max_moves, batch, a), dtype=torch.float32, device=dev)
    root_qs = torch.zeros((max_moves, batch), dtype=torch.float32, device=dev)
    active_rec = torch.zeros((max_moves, batch), dtype=torch.bool, device=dev)
    actions_rec = torch.zeros((max_moves, batch), dtype=torch.int32,
                              device=dev)

    for t in range(max_moves):
        if bool(states.done.all()):
            break
        active = ~states.done
        if cfg.mcts.search == "gumbel":
            pi, root_q, winner = run_gumbel_mcts(env, cfg.mcts, eval_fn,
                                                 net_params, states, generator)
            actions = torch.where(active, winner, 0)
        else:
            move_nums = torch.full((batch,), t, dtype=torch.int32,
                                   device=dev)
            pi, root_q = run_mcts_with_q(env, cfg.mcts, eval_fn, net_params,
                                         states, move_nums, generator)
            temp = torch.clamp(1.0 - torch.tensor(t, dtype=torch.float32)
                               / cfg.temp_threshold, min=0.0)
            legal = env.legal_mask(states)
            # done games have an all-zero pi; give them a harmless action 0
            safe_pi = torch.where(active[:, None], pi, 1.0)
            actions = sample_actions(safe_pi, temp, legal | ~active[:, None],
                                     generator)
        boards[t] = states.board
        players[t] = states.to_move
        pis[t] = pi
        root_qs[t] = root_q
        active_rec[t] = active
        actions_rec[t] = actions.to(torch.int32)
        states = env.step_safe(states, actions)

    return Trajectories(
        boards=boards,
        players=players,
        pis=pis,
        root_qs=root_qs,
        active=active_rec,
        actions=actions_rec,
        winners=states.winner,
        moves_played=states.move_count,
    )
