"""Batched self-play: lockstep games, or a stream of auto-reset lanes.

Counterpart of ``alphazero_gomoku_tpu/selfplay/runner.py`` (``SelfPlayConfig``,
``_pcr_cheap_mcts``, ``center_mask``, ``random_center_actions``,
``Trajectories``, ``sample_actions``, ``play_games``, ``encode_board_np``,
``collect_examples``, ``ContinuousRecords``, ``play_games_continuous`` and
``collect_examples_continuous``).
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
    the root value, the captured pairs before the move (Pente's; zeros for
    Gomoku) and an ``active`` flag; finished games are frozen by
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

Spans (``utils.profiling.trace_annotation``: ``record_function`` ranges
while a profiler records, nothing otherwise): each ply of both loops is
``az.head`` (the done check, PCR's draw, the legal mask), ``az.search`` (the
search call; ``search/tree_packed.py`` lists the spans inside it) and
``az.move`` (the temperature, the sampling, the opening and the records).
The env's step follows outside every span, so that a profiler started or
stopped inside it records whole spans; with reuse, ``play_games`` then
re-roots the tree inside ``az.advance_root``.

``encode_board_np`` and ``collect_examples`` (``runner.py:319-405`` there)
flatten the trajectories into training samples on the host, with the
value-target mix, the PCR full-ply records, Pente's capture planes and the
8 symmetries.

Continuous self-play (``play_games_continuous``, ``runner.py:428-522``
there) advances B lanes for a fixed number of plies; a lane whose game ends
(a win, a full board, or the ``max_moves`` cap, which scores a draw) starts
a fresh game in place on the next ply, so no lane idles.  The move counters
are per lane: each lane's ``move_count`` drives its temperature, its
Dirichlet gate and its random opening.  Every ply searches a fresh tree
(no carry), whatever ``mcts.reuse_budget`` says, as the JAX function does
(its searches are ``run_mcts_with_q`` and ``run_gumbel_mcts``); PCR's draw
is one for the whole batch a ply, and a cheap ply records an all-zero pi.
``play_games_continuous`` draws from its generator in this order each ply:
with PCR, one uniform for the full / cheap draw; the search's draws (the
Dirichlet noise of a PUCT search with root noise on, or a Gumbel search's
root uniforms); with PUCT, the ``[B, A]`` sampling uniforms; with
``opening_random_moves > 0``, the ``[B, A]`` opening uniforms (every ply,
used where a lane is still in its opening).  ``collect_examples_continuous``
gives each record the outcome of its lane's next game end and drops the
records of games still running at the stream's end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games.gomoku import where_state
from alphazero_gomoku_tpu_torch.ops.symmetry import expand_symmetries_batch_np
from alphazero_gomoku_tpu_torch.ops.tree_kernels import KERNELS, TreeOps
from alphazero_gomoku_tpu_torch.search.tree import EvalFn, MCTSConfig
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    init_packed_carry,
    packed_advance_root,
    run_mcts_with_q,
    run_search,
)
from alphazero_gomoku_tpu_torch.utils.profiling import trace_annotation

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
    # int32 [T, B, 2] captured pairs of players 1, 2 BEFORE the move (Pente;
    # zeros for Gomoku)
    captures: Optional[torch.Tensor] = None


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
               generator: torch.Generator, device=None,
               ops: TreeOps = KERNELS) -> Trajectories:
    """Play ``cfg.batch_games`` lockstep games until all are done or
    ``max_moves`` moves are played.

    ``generator`` (on ``device``) gives every random draw, in the order the
    module's docstring lists.  ``ops`` picks the searches' tree functions:
    the kernel wrappers, or ``tree_kernels.PLAIN``.
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
    caps_rec = torch.zeros((max_moves, batch, 2), dtype=torch.int32,
                           device=dev)

    for t in range(max_moves):
        with trace_annotation("az.head"):
            if bool(states.done.all()):
                break
            active = ~states.done
            full = True
            if cheap_mcts is not None:
                full = bool(torch.rand((), generator=generator, device=dev)
                            < cfg.pcr_full_prob)
            mcfg = cfg.mcts if full else cheap_mcts
            legal = env.legal_mask(states)
        with trace_annotation("az.search"):
            move_nums = None if gumbel else torch.full(
                (batch,), t, dtype=torch.int32, device=dev)
            if gumbel or reuse:
                pi, root_q, winner, tree = run_search(
                    env, mcfg, eval_fn, net_params, states, move_nums,
                    generator, carry=tree, ops=ops)
                if not reuse:
                    tree = None     # nothing carries it: free it now
            else:
                # through this module's name, which
                # benchmark/tests/test_bench_run.py patches
                pi, root_q = run_mcts_with_q(
                    env, mcfg, eval_fn, net_params, states, move_nums,
                    generator, ops=ops)
        with trace_annotation("az.move"):
            if gumbel:
                # the halving winner is the move: no temperature sampling
                actions = torch.where(active, winner, 0)
            else:
                temp = torch.clamp(1.0 - torch.tensor(t, dtype=torch.float32)
                                   / cfg.temp_threshold, min=0.0)
                # done games have an all-zero pi; give them a harmless
                # action 0
                safe_pi = torch.where(active[:, None], pi, 1.0)
                actions = sample_actions(safe_pi, temp,
                                         legal | ~active[:, None], generator)
            opening = t < cfg.opening_random_moves
            if opening:
                actions = random_center_actions(legal.to(torch.float32),
                                                center, generator)
            boards[t] = states.board
            players[t] = states.to_move
            # a cheap ply's pi is all zero: a policy target of weight 0,
            # while the record still trains the value
            pis[t] = pi if full else torch.zeros_like(pi)
            root_qs[t] = root_q
            # an opening ply's move is not the search's: its record is
            # inactive
            active_rec[t] = active & (not opening)
            actions_rec[t] = actions.to(torch.int32)
            if hasattr(states, "captures"):
                caps_rec[t] = states.captures
        states = env.step_safe(states, actions)
        if reuse:
            with trace_annotation("az.advance_root"):
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
        captures=caps_rec,
    )


def encode_board_np(boards: np.ndarray, players: np.ndarray,
                    captures: Optional[np.ndarray] = None,
                    pairs_to_win: int = 5) -> np.ndarray:
    """Raw boards ``[N, H, W]`` and the players to move ``[N]`` -> NHWC
    float32 planes (the side to move's stones, the opponent's, ones), as
    ``GomokuEnv.encode``; on the host.  With ``captures`` (``[N, 2]``,
    players 1 and 2), the two captured-pair planes over ``pairs_to_win``
    follow, as ``PenteEnv.encode`` with ``capture_planes``."""
    p = players.reshape(players.shape + (1, 1))
    plane_me = (boards == p).astype(np.float32)
    plane_opp = (boards == (3 - p)).astype(np.float32)
    ones = np.ones_like(plane_me)
    planes = [plane_me, plane_opp, ones]
    if captures is not None:
        caps = captures.astype(np.float32) / float(pairs_to_win)
        # a record of player 0 (none in a masked batch) reads player 1's
        pc = np.clip(players, 1, 2).reshape(-1, 1)
        mine = np.take_along_axis(caps, pc - 1, axis=1)[:, 0]
        theirs = np.take_along_axis(caps, 2 - pc, axis=1)[:, 0]
        planes += [ones * mine.reshape(-1, 1, 1),
                   ones * theirs.reshape(-1, 1, 1)]
    return np.stack(planes, axis=-1)


def _samples(boards, players, pis, z, mask, captures, use_symmetries):
    """The masked records encoded (masked first: most lockstep records are
    padding), their pis and value targets, 8 times with symmetries."""
    caps = None if captures is None else captures.reshape(-1, 2)[mask]
    states = encode_board_np(boards.reshape(-1, *boards.shape[2:])[mask],
                             players.reshape(-1)[mask], captures=caps)
    flat_pis = pis.reshape(-1, pis.shape[-1])[mask].astype(np.float32)
    flat_z = z.reshape(-1)[mask]
    if use_symmetries:
        states, flat_pis = expand_symmetries_batch_np(states, flat_pis)
        flat_z = np.tile(flat_z, 8)
    return states, flat_pis, flat_z


def collect_examples(traj: Trajectories, use_symmetries: bool = True,
                     value_target_mix: float = 0.0,
                     capture_planes: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Flatten trajectories into training samples (host side).

    z is +1 / -1 / 0 from the side to move's view; with
    ``value_target_mix`` the target is ``(1 - mix) * z + mix * root_q``.
    Inactive records (finished games, the random opening) are dropped
    before encoding; a PCR cheap ply keeps its all-zero pi.  With
    ``use_symmetries`` every sample comes 8 times, variant-major.

    With ``capture_planes`` the samples carry Pente's two captured-pair
    planes, from ``traj.captures``.

    Returns ``(states [N, H, W, 3 | 5], pis [N, A], zs [N], winner_stats)``.
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

    captures = traj.captures.cpu().numpy() if capture_planes else None
    states, flat_pis, flat_z = _samples(boards, players, pis, z,
                                        active.reshape(-1), captures,
                                        use_symmetries)
    stats = {k: int((winners == k).sum()) for k in (0, 1, 2)}
    return states, flat_pis, flat_z, stats


# ----------------------------------------------------------------------
# continuous (auto-reset) self-play
# ----------------------------------------------------------------------
class ContinuousRecords(NamedTuple):
    """Per-ply records of an auto-reset stream ``[T, B, ...]``.

    Every ply of every lane is a real move: a finished game restarts in
    place.  ``ended`` marks the ply on which a lane's game ended, and
    ``winners`` holds that game's winner there.
    """

    boards: torch.Tensor     # int8 [T, B, H, W] board BEFORE the move
    players: torch.Tensor    # int32 [T, B] player to move
    pis: torch.Tensor        # f32 [T, B, A] search policy (0 on a cheap ply)
    root_qs: torch.Tensor    # f32 [T, B] root value (side-to-move view)
    recorded: torch.Tensor   # bool [T, B] a policy sample (not an opening ply)
    ended: torch.Tensor      # bool [T, B] the game ended (or hit the cap)
    winners: torch.Tensor    # int32 [T, B] its winner where ended (0: draw)
    actions: torch.Tensor    # int32 [T, B] move played
    # int32 [T, B, 2] captured pairs of players 1, 2 BEFORE the move (Pente;
    # zeros for Gomoku)
    captures: Optional[torch.Tensor] = None


def play_games_continuous(env, cfg: SelfPlayConfig, eval_fn: EvalFn,
                          net_params, generator: torch.Generator,
                          total_steps: int, device=None) -> ContinuousRecords:
    """Advance ``cfg.batch_games`` lanes for ``total_steps`` plies, each
    lane starting a fresh game in place when its game ends.

    A lane that reaches ``cfg.max_moves`` without a result ends as a draw.
    ``generator`` (on ``device``) gives every random draw, in the order the
    module's docstring lists.
    """
    dev = resolve_device(device)
    batch = cfg.batch_games
    max_moves = cfg.resolved_max_moves(env)
    size = env.size
    a = env.num_actions
    gumbel = cfg.mcts.search == "gumbel"
    cheap_mcts = _pcr_cheap_mcts(cfg) if cfg.pcr_cheap_sims > 0 else None
    center = center_mask(env, dev)
    fresh = env.init_batch(batch, dev)
    states = fresh

    boards = torch.zeros((total_steps, batch, size, size), dtype=torch.int8,
                         device=dev)
    players = torch.zeros((total_steps, batch), dtype=torch.int32,
                          device=dev)
    pis = torch.zeros((total_steps, batch, a), dtype=torch.float32,
                      device=dev)
    root_qs = torch.zeros((total_steps, batch), dtype=torch.float32,
                          device=dev)
    recorded = torch.zeros((total_steps, batch), dtype=torch.bool,
                           device=dev)
    ended_rec = torch.zeros((total_steps, batch), dtype=torch.bool,
                            device=dev)
    winners = torch.zeros((total_steps, batch), dtype=torch.int32,
                          device=dev)
    actions_rec = torch.zeros((total_steps, batch), dtype=torch.int32,
                              device=dev)
    caps_rec = torch.zeros((total_steps, batch, 2), dtype=torch.int32,
                           device=dev)

    for t in range(total_steps):
        with trace_annotation("az.head"):
            full = True
            if cheap_mcts is not None:
                full = bool(torch.rand((), generator=generator, device=dev)
                            < cfg.pcr_full_prob)
            mcfg = cfg.mcts if full else cheap_mcts
            legal = env.legal_mask(states)
        with trace_annotation("az.search"):
            # the tree goes at once: every ply searches a fresh one
            pi, root_q, actions = run_search(env, mcfg, eval_fn, net_params,
                                             states, states.move_count,
                                             generator)[:3]
        with trace_annotation("az.move"):
            if not gumbel:
                temp = torch.clamp(1.0 - states.move_count.to(torch.float32)
                                   / cfg.temp_threshold, min=0.0)
                actions = sample_actions(pi, temp, legal, generator)
            opening = states.move_count < cfg.opening_random_moves
            if cfg.opening_random_moves:
                actions = torch.where(opening, random_center_actions(
                    legal.to(torch.float32), center, generator), actions)
            boards[t] = states.board
            players[t] = states.to_move
            if hasattr(states, "captures"):
                caps_rec[t] = states.captures
            pis[t] = pi if full else torch.zeros_like(pi)
            root_qs[t] = root_q
            recorded[t] = ~opening
            actions_rec[t] = actions.to(torch.int32)

        states = env.step(states, actions)
        ended = states.done | (states.move_count >= max_moves)
        ended_rec[t] = ended
        winners[t] = torch.where(states.done, states.winner, 0)
        states = where_state(ended, fresh, states)

    return ContinuousRecords(boards=boards, players=players, pis=pis,
                             root_qs=root_qs, recorded=recorded,
                             ended=ended_rec, winners=winners,
                             actions=actions_rec, captures=caps_rec)


def collect_examples_continuous(rec: ContinuousRecords,
                                use_symmetries: bool = True,
                                value_target_mix: float = 0.0,
                                capture_planes: bool = False
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, dict]:
    """Training samples of an auto-reset stream (host side).

    Each record's z is the outcome of its lane's next game end (inclusive),
    from its player's view; records of games still running at the stream's
    end are dropped, as are random-opening plies.  ``value_target_mix``,
    ``capture_planes`` and ``use_symmetries`` as in
    :func:`collect_examples`; the winner stats count the games that ended.
    """
    boards = rec.boards.cpu().numpy()
    players = rec.players.cpu().numpy()
    pis = rec.pis.cpu().numpy()
    ended = rec.ended.cpu().numpy()
    winners = rec.winners.cpu().numpy()
    t, _ = ended.shape

    # each ply's next game end in its lane: a suffix minimum of the end
    # indices, then one gather of the winners there
    idx = np.where(ended, np.arange(t, dtype=np.int64)[:, None], t)
    nxt_idx = np.minimum.accumulate(idx[::-1], axis=0)[::-1]
    has_end = nxt_idx < t
    win_fwd = np.take_along_axis(
        winners, np.minimum(nxt_idx, t - 1), axis=0).astype(np.int32)
    win_fwd = np.where(has_end, win_fwd, 0)

    z = np.where(win_fwd == 0, 0.0,
                 np.where(win_fwd == players, 1.0, -1.0)).astype(np.float32)
    if value_target_mix > 0.0:
        root_qs = rec.root_qs.cpu().numpy()
        z = (1.0 - value_target_mix) * z + value_target_mix * root_qs

    mask = (has_end & rec.recorded.cpu().numpy()).reshape(-1)
    captures = rec.captures.cpu().numpy() if capture_planes else None
    states, flat_pis, flat_z = _samples(boards, players, pis, z, mask,
                                        captures, use_symmetries)
    w_at_ends = winners[ended]
    stats = {k: int((w_at_ends == k).sum()) for k in (0, 1, 2)}
    return states, flat_pis, flat_z, stats
