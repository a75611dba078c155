"""Lockstep batched self-play: B games advance one move at a time together.

Counterpart of ``alphazero_gomoku_tpu/selfplay/runner.py:38-318``
(``SelfPlayConfig``, ``_pcr_cheap_mcts``, ``center_mask``,
``random_center_actions``, ``Trajectories``, ``sample_actions``,
``play_games``).
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

Options, as in the JAX runner:
  - subtree reuse (``mcts.reuse_budget > 0``, at least 8 games): the
    searched tree is carried from move to move (a ``PackedCarry``, from
    ``init_packed_carry`` at move 0) and re-rooted at the played moves by
    ``packed_advance_root``;
  - playout cap randomization (``pcr_cheap_sims > 0``): each ply is
    searched with the full ``mcts`` with probability ``pcr_full_prob``,
    else with ``pcr_cheap_sims`` simulations and no root noise; the draw is
    one for the whole batch, and a cheap ply records an all-zero pi;
  - the random opening (``opening_random_moves``): the first plies are
    uniform random legal moves in the centre 9x9 (``random_center_actions``)
    and their records are inactive.  The search still runs on those plies,
    so a carried tree follows the game.

``play_games`` draws from its generator in this order each ply: with PCR,
one uniform for the full / cheap draw; the search's draws (the Dirichlet
noise of a PUCT search with root noise on, or a Gumbel search's root
uniforms); with PUCT, the ``[B, A]`` sampling uniforms; on an opening ply,
the ``[B, A]`` opening uniforms.

``encode_board_np`` and ``collect_examples`` (``runner.py:319-405`` there)
flatten the trajectories into training samples on the host, with the
value-target mix, the PCR full-ply records and the 8 symmetries.  The
continuous (auto-reset) self-play, ``play_games_continuous`` and
``collect_examples_continuous``, is not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.ops.symmetry import expand_symmetries_batch_np
from alphazero_gomoku_tpu_torch.search.gumbel import run_gumbel_mcts
from alphazero_gomoku_tpu_torch.search.tree import (
    EvalFn,
    MCTSConfig,
    run_mcts_with_q,
)
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    init_packed_carry,
    packed_advance_root,
    run_gumbel_packed_with_tree,
    run_mcts_packed_with_tree,
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
    # plies played uniformly at random in the centre, and not recorded
    opening_random_moves: int = 0
    # playout cap randomization (KataGo, arXiv:1902.10565 §3.1): a ply is a
    # full search with probability pcr_full_prob, else a cheap one of
    # pcr_cheap_sims simulations without root noise; 0 = off
    pcr_cheap_sims: int = 0
    pcr_full_prob: float = 0.25

    def resolved_max_moves(self, env) -> int:
        return self.max_moves or env.num_actions


def _pcr_cheap_mcts(cfg: SelfPlayConfig) -> MCTSConfig:
    """The cheap search of playout cap randomization: ``pcr_cheap_sims``
    simulations, no root noise, and the full search's node capacity (so a
    carried tree fits both)."""
    if cfg.pcr_cheap_sims >= cfg.mcts.n_simulations:
        raise ValueError(
            f"pcr_cheap_sims={cfg.pcr_cheap_sims} must be below "
            f"n_simulations={cfg.mcts.n_simulations}")
    if cfg.mcts.leaves_per_sim > 1:
        raise ValueError(
            "playout cap randomization is not supported with "
            "leaves_per_sim > 1")
    return dataclasses.replace(
        cfg.mcts, n_simulations=cfg.pcr_cheap_sims, add_noise=False,
        max_nodes=cfg.mcts.node_capacity)


def center_mask(env, device=None) -> torch.Tensor:
    """f32 ``[A]`` mask of the centre 9x9 (the whole board if smaller): the
    random opening's region."""
    size = env.size
    span = min(9, size)
    r0 = (size - span) // 2
    ar = torch.arange(size, device=resolve_device(device))
    rows = (ar >= r0) & (ar < r0 + span)
    return (rows[:, None] & rows[None, :]).reshape(-1).to(torch.float32)


def random_center_actions(legal: torch.Tensor, center: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          uniforms: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """A uniform random legal action in the centre per lane, int64 ``[B]``;
    uniform over the legal actions where the centre is full.

    ``legal`` is f32 ``[B, A]`` (1 = legal), ``center`` f32 ``[A]``.  The
    sample is the argmax of ``where(pool, 0, -1e30) + g`` with Gumbel noise
    ``g = -log(-log(u))``, as ``jax.random.categorical`` takes it; the
    uniforms ``u`` (``[B, A]`` in ``[tiny, 1)``) are ``uniforms`` when given
    (tests inject the JAX package's draw), else a draw from ``generator``.
    """
    in_center = legal * center
    pool = torch.where(in_center.sum(dim=-1, keepdim=True) > 0, in_center,
                       legal)
    logits = torch.where(pool > 0, 0.0, -1e30)
    if uniforms is None:
        uniforms = torch.rand(legal.shape, generator=generator,
                              device=legal.device)
    gumbel = -torch.log(-torch.log(torch.clamp(uniforms, min=_F32_TINY)))
    return torch.argmax(logits + gumbel, dim=-1)


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

    ``generator`` (on ``device``) gives every random draw, in the order the
    module's docstring lists.
    """
    dev = resolve_device(device)
    batch = cfg.batch_games
    max_moves = cfg.resolved_max_moves(env)
    size = env.size
    a = env.num_actions
    states = env.init_batch(batch, dev)
    gumbel = cfg.mcts.search == "gumbel"
    reuse = cfg.mcts.reuse_budget > 0
    if reuse and batch < 8:
        raise ValueError(
            "self-play subtree reuse requires batch_games >= 8, as in the "
            "JAX package (its packed kernels' lane floor)")
    tree = init_packed_carry(env, cfg.mcts, states) if reuse else None
    cheap_mcts = _pcr_cheap_mcts(cfg) if cfg.pcr_cheap_sims > 0 else None
    center = center_mask(env, dev)

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
        full = True
        if cheap_mcts is not None:
            full = bool(torch.rand((), generator=generator, device=dev)
                        < cfg.pcr_full_prob)
        mcfg = cfg.mcts if full else cheap_mcts
        legal = env.legal_mask(states)
        if gumbel:
            if reuse:
                pi, root_q, winner, tree = run_gumbel_packed_with_tree(
                    env, mcfg, eval_fn, net_params, states, generator,
                    carry=tree)
            else:
                pi, root_q, winner = run_gumbel_mcts(
                    env, mcfg, eval_fn, net_params, states, generator)
            # the halving winner is the move: no temperature sampling
            actions = torch.where(active, winner, 0)
        else:
            move_nums = torch.full((batch,), t, dtype=torch.int32,
                                   device=dev)
            if reuse:
                pi, root_q, tree = run_mcts_packed_with_tree(
                    env, mcfg, eval_fn, net_params, states, move_nums,
                    generator, carry=tree)
            else:
                pi, root_q = run_mcts_with_q(env, mcfg, eval_fn, net_params,
                                             states, move_nums, generator)
            temp = torch.clamp(1.0 - torch.tensor(t, dtype=torch.float32)
                               / cfg.temp_threshold, min=0.0)
            # done games have an all-zero pi; give them a harmless action 0
            safe_pi = torch.where(active[:, None], pi, 1.0)
            actions = sample_actions(safe_pi, temp, legal | ~active[:, None],
                                     generator)
        opening = t < cfg.opening_random_moves
        if opening:
            actions = random_center_actions(legal.to(torch.float32), center,
                                            generator)
        boards[t] = states.board
        players[t] = states.to_move
        # a cheap ply's pi is all zero: a policy target of weight 0, while
        # the record still trains the value
        pis[t] = pi if full else torch.zeros_like(pi)
        root_qs[t] = root_q
        # an opening ply's move is not the search's: its record is inactive
        active_rec[t] = active & (not opening)
        actions_rec[t] = actions.to(torch.int32)
        states = env.step_safe(states, actions)
        if reuse:
            tree = packed_advance_root(env, cfg.mcts, tree, actions)

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


def encode_board_np(boards: np.ndarray, players: np.ndarray) -> np.ndarray:
    """Raw boards ``[N, H, W]`` and the players to move ``[N]`` -> NHWC
    float32 planes (the side to move's stones, the opponent's, ones), as
    ``GomokuEnv.encode``; on the host."""
    p = players.reshape(players.shape + (1, 1))
    plane_me = (boards == p).astype(np.float32)
    plane_opp = (boards == (3 - p)).astype(np.float32)
    return np.stack([plane_me, plane_opp, np.ones_like(plane_me)], axis=-1)


def collect_examples(traj: Trajectories, use_symmetries: bool = True,
                     value_target_mix: float = 0.0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Flatten trajectories into training samples (host side).

    z is +1 / -1 / 0 from the side to move's view; with
    ``value_target_mix`` the target is ``(1 - mix) * z + mix * root_q``.
    Inactive records (finished games, the random opening) are dropped
    before encoding; a PCR cheap ply keeps its all-zero pi.  With
    ``use_symmetries`` every sample comes 8 times, variant-major.

    Returns ``(states [N, H, W, 3], pis [N, A], zs [N], winner_stats)``.
    The JAX function's ``capture_planes`` (Pente's) waits for Pente (ROADMAP
    Queue A item 9).
    """
    boards = traj.boards.cpu().numpy()
    players = traj.players.cpu().numpy()
    pis = traj.pis.cpu().numpy()
    active = traj.active.cpu().numpy()
    winners = traj.winners.cpu().numpy()

    t, b = active.shape
    win_per_record = np.broadcast_to(winners[None, :], (t, b))
    z = np.where(win_per_record == 0, 0.0,
                 np.where(win_per_record == players, 1.0, -1.0)
                 ).astype(np.float32)
    if value_target_mix > 0.0:
        root_qs = traj.root_qs.cpu().numpy()
        z = (1.0 - value_target_mix) * z + value_target_mix * root_qs

    mask = active.reshape(-1)
    states = encode_board_np(boards.reshape(-1, *boards.shape[2:])[mask],
                             players.reshape(-1)[mask])
    flat_pis = pis.reshape(-1, pis.shape[-1])[mask].astype(np.float32)
    flat_z = z.reshape(-1)[mask]
    if use_symmetries:
        states, flat_pis = expand_symmetries_batch_np(states, flat_pis)
        flat_z = np.tile(flat_z, 8)
    stats = {k: int((winners == k).sum()) for k in (0, 1, 2)}
    return states, flat_pis, flat_z, stats
