"""The AlphaZero training loop: self-play -> train -> arena -> gate.

Counterpart of ``alphazero_gomoku_tpu/selfplay/loop.py`` (``gate_decision``
and ``train_alphazero``, ``:129-988``); its ``make_eval_fn``,
``bundle_of`` and epochs (``:60-127``) are ``models/model.py``'s
``make_inference``, ``AZModel.eval_net``, ``train_epoch`` and
``train_epoch_gather``.  Each iteration:

  1. self-play with the candidate -> the replay buffer and its mirror on
     the device: lockstep games (``play_games``: PUCT, k-leaf PUCT or
     Gumbel, subtree reuse, PCR, the random opening) -> ``collect_examples``,
     or with ``selfplay_mode="continuous"`` a stream of ``selfplay_steps``
     plies (0: board², ``play_games_continuous``) of auto-reset lanes ->
     ``collect_examples_continuous``;
  2. once the buffer holds a batch, ``epochs_per_iter`` epochs of
     ``len(buffer) // batch_size`` steps, on batches gathered on the device
     by numpy index draws (``models/model.train_epoch_gather``);
  3. every ``eval_every`` iterations, the candidate-vs-best arena with
     mirrored openings (and, every ``anchor_arena_every``, an anchor arena);
  4. the gate (``gate_stat``, ``gate_mode``);
  5. snapshots of the candidate and of best, and the buffer, on their
     cadences.

The search's network forward is ``inference``'s: ``"f32"`` (the float32
``ResNet``), ``"bf16"`` (the folded bf16 forward), ``"fused"`` (the bf16
tower kernel K4), ``"int8"`` or ``"int8t"`` (the int8 tower kernel K5),
the int8 bundles calibrated on replay samples (random-play boards while the
buffer is short) and re-made whenever the weights change.  Training steps
are always float32 (``NetConfig.compute_dtype`` is float32 here, as in the
JAX loop).

Search backends: the port has one search, the packed tree, with the tree
kernels on the card.  ``mcts_backend`` "xla" and "pallas" both run it; the
JAX package holds its packed search equal in pi to its XLA search
(``tests/test_tree_kernels.py``), and the JAX Pallas path's lane-tile batch
check has no counterpart (the CUDA kernels take any batch).

Randomness: torch generators on the device, seeded as the JAX loop seeds its
keys (self-play ``seed * 100003 + it``, arena ``seed * 7919 + it``, anchor
``seed * 104729 + it``), and numpy generators for the training draws and the
int8 calibration samples, as in the JAX loop.  The numbers differ from
JAX's (threefry is not torch's generator).

Games: ``game_name`` "gomoku" or "pente"; ``pente_capture_planes`` adds
Pente's two captured-pair planes (a 5-plane net; the int8 calibration's
random-play boards get them as zero planes, as in the JAX loop).

Data parallelism (``parallel/``), as the JAX loop's mesh path: with a
:class:`~alphazero_gomoku_tpu_torch.parallel.DataMesh` (``mesh="auto"``
makes one when a process group of more than one rank exists) every rank
runs this loop on its own card; games are rounded up to a multiple of the
ranks, each rank plays its share (``make_sharded_selfplay``, or the
continuous form) and the arena's games are split the same way; with
``replay_sharding="replicated"`` the trajectories are all-gathered so that
every rank holds the same buffer and its mirror, and trains on its slice
of each step's batch (``make_sharded_gather_epoch``; a batch the ranks do
not divide trains unsharded on every rank, as in the JAX loop, and rank
0's result is broadcast); with ``"per_host"``
each rank keeps its own games in a buffer of ``buffer_size / ranks``, its
own file (``replay_buffer_latest.proc{rank}of{size}.npz``), and trains on
its own samples as its slice of the global batch.  The train gate and the
steps per epoch read the global and the smallest buffer lengths, so that
every rank takes the same decision.  Only rank 0 writes the snapshots and
``best_latest.ckpt`` (the state is replicated).  Without a group (one
process, ``mesh=None``) the mesh is one member whose shard is the whole
batch and whose collectives are the identity: the same path, unsharded.

The first self-play call checks its reckoned device memory first
(``selfplay/budget.py``; ranks that share a card divide its margin).  ``profile_trace_dir`` traces the second
iteration (the first when only one runs) with ``torch.profiler`` into that
directory, each phase a named region.
"""

from __future__ import annotations

import functools
import os
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models.model import (
    INFERENCE_MODES,
    AZModel,
    make_inference,
    train_epoch_gather,
)
from alphazero_gomoku_tpu_torch.parallel import distributed as pdist
from alphazero_gomoku_tpu_torch.parallel import mesh as pmesh
from alphazero_gomoku_tpu_torch.search.tree import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay.arena import evaluate_params_detailed
from alphazero_gomoku_tpu_torch.selfplay.budget import (
    DEFAULT_MARGIN,
    selfplay_memory,
    with_preflight,
)
from alphazero_gomoku_tpu_torch.selfplay.buffer import (
    DeviceBufferMirror,
    ReplayBuffer,
    load_replay_buffer,
    save_replay_buffer,
)
from alphazero_gomoku_tpu_torch.selfplay.runner import (
    SelfPlayConfig,
    collect_examples,
    collect_examples_continuous,
)
from alphazero_gomoku_tpu_torch.utils.profiling import (
    PhaseTimer,
    start_profiler_trace,
    stop_profiler_trace,
    trace_annotation,
)


def gate_decision(gate_stat: str, win_rate, ci95, threshold: float,
                  run_arena: bool = True):
    """``(accepted, reset_worthy)`` for one arena result.

    ``"ci_low"``: promote when the Wilson 95 % lower bound clears the
    threshold, reset-worthy when the upper bound falls below it;
    ``"win_rate"``: the point estimate against the threshold, reset on any
    miss.  With ``run_arena`` False both are False.
    """
    if not run_arena:
        return False, False
    if gate_stat == "ci_low":
        lo, hi = ci95
        return lo >= threshold, hi < threshold
    if gate_stat == "win_rate":
        return win_rate >= threshold, win_rate < threshold
    raise ValueError(f"unknown gate_stat: {gate_stat!r}")


def _search_bundles(inference: str, env, seed: int, buffer,
                    timer: PhaseTimer, device):
    """``(eval_fn, search_bundle)`` for an inference mode (``make_inference``);
    ``search_bundle(model)`` re-makes a model's bundle when its weights
    changed (keyed on the identity of its ``params`` dict, which every step
    replaces), timed as the ``quantize`` phase.  int8 bundles are calibrated
    on 256 replay samples, or on random-play boards of ``env``'s game while
    the buffer holds fewer, as in the JAX loop (``_calib_states``): those
    have the 3 base planes, and zero planes are appended up to
    ``env.obs_channels`` (Pente's capture planes, zero at a game's start)."""
    from alphazero_gomoku_tpu_torch.ops.int8_net import random_play_calib_obs

    cache: dict = {}
    calib_rng = np.random.default_rng(seed)
    eval_fn = None

    def calib_boards(cfg):
        obs = random_play_calib_obs(cfg, game=env.name, n=256)
        extra = env.obs_channels - obs.shape[-1]
        if extra > 0:
            obs = np.concatenate(
                [obs, np.zeros(obs.shape[:-1] + (extra,), obs.dtype)],
                axis=-1)
        return obs

    def make(model: AZModel):
        nonlocal eval_fn
        calib = None
        if inference in ("int8", "int8t"):
            calib = (buffer.sample(256, rng=calib_rng)[0] if len(buffer) >= 256
                     else calib_boards(model.cfg))
        eval_fn, bundle = make_inference(inference, model.cfg,
                                         *model.jax_params(), device=device,
                                         calib_obs=calib)
        return bundle

    def search_bundle(model: AZModel):
        cached = cache.get(id(model))
        if cached is None or cached[0] is not model.params:
            with timer.phase("quantize"):
                cached = (model.params, make(model))
            cache[id(model)] = cached
        return cached[1]

    def search_eval_fn(bundle, obs):
        return eval_fn(bundle, obs)

    return search_eval_fn, search_bundle


def train_alphazero(
    game_name: str = "gomoku",
    board_size: int = 15,
    num_iterations: int = 5,
    games_per_iteration: int = 8,
    n_simulations: int = 50,
    buffer_size: int = 10000,
    batch_size: int = 128,
    epochs_per_iter: int = 2,
    temp_threshold: int = 8,
    eval_games: int = 12,
    eval_mcts_simulations: int = 200,
    eval_every: int = 1,
    win_rate_threshold: float = 0.55,
    gate_stat: str = "ci_low",
    cpuct: float = 1.2,
    model_dir: str = "models",
    save_every: int = 1,
    buffer_save_every: int = 1,
    pretrained_model_path: Optional[str] = None,
    candidate_model_path: Optional[str] = None,
    next_iteration_continuation: int = 1,
    dirichlet_alpha: float = 0.03,
    dirichlet_epsilon: float = 0.25,
    dirichlet_n_moves: int = 30,
    mcts_max_depth: int = 64,
    mcts_backend: str = "xla",
    mcts_leaves_per_sim: int = 1,
    mcts_fpu_mode: str = "zero",
    mcts_reuse_budget: int = 0,
    mcts_search: str = "puct",
    gumbel_max_considered: int = 16,
    gumbel_round_parallel: bool = False,
    anchor_arena_every: int = 0,
    anchor_model_path: Optional[str] = None,
    anchor_mcts_simulations: int = 0,
    anchor_search: Optional[str] = None,
    gate_mode: str = "reset",
    n_res_blocks: int = 3,
    channels: int = 64,
    lr: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
    selfplay_num_workers: int = 0,
    selfplay_device: str = "tpu",
    selfplay_games_per_task: int = 1,
    selfplay_base_seed: int = 12345,
    selfplay_torch_threads: int = 1,
    eval_num_workers: int = 0,
    eval_device: str = "tpu",
    eval_games_per_task: int = 1,
    eval_base_seed: int = 54321,
    eval_torch_threads: int = 1,
    value_loss_weight: float = 1.0,
    value_target_mix: float = 0.0,
    opening_random_moves: int = 0,
    pcr_cheap_sims: int = 0,
    pcr_full_prob: float = 0.25,
    selfplay_max_moves: int = 0,
    use_symmetries: bool = True,
    verbose: bool = True,
    profile_trace_dir: Optional[str] = None,
    mesh="auto",
    replay_sharding: str = "replicated",
    use_fused_inference: bool = False,
    inference: str = "f32",
    selfplay_mode: str = "lockstep",
    selfplay_steps: int = 0,
    pente_capture_planes: bool = False,
    device=None,
):
    """Run the training loop; a per-iteration history list.

    The parameters are the JAX ``train_alphazero``'s, with its defaults (its
    docstring and comments give each one's reasons); the reference's worker
    knobs (``selfplay_*`` / ``eval_*`` workers, devices, seeds, threads) are
    accepted and inert, as there.  ``mesh`` is "auto" (a mesh over the
    process group when it has more than one rank), None (this process
    alone) or a ``DataMesh`` (``parallel.make_mesh``), whose device is the
    one the loop runs on.  ``device`` None is the card (the rank's with a
    mesh); the tests pass ``"cpu"``.

    Each history entry has the JAX loop's keys (``iteration``, ``winners``,
    ``moves``, ``selfplay_seconds``, ``eval_seconds``, ``train_seconds``,
    ``loss``, ``win_rate``, ``win_rate_ci95``, ``arena_pairs``, ``anchor``,
    ``draws``, ``accepted``, ``buffer_size``, ``snapshot``), and
    ``phase_seconds`` (each phase's seconds this iteration) and
    ``moves_per_second`` (self-play moves over the self-play phase's
    seconds).
    """
    del selfplay_num_workers, selfplay_device, selfplay_games_per_task
    del selfplay_base_seed, selfplay_torch_threads, eval_num_workers
    del eval_device, eval_games_per_task, eval_base_seed, eval_torch_threads

    def log(*args):
        if verbose:
            print(*args, flush=True)

    if gate_mode not in ("reset", "track"):
        raise ValueError(f"unknown gate_mode: {gate_mode!r}")
    if gate_stat not in ("win_rate", "ci_low"):
        raise ValueError(f"unknown gate_stat: {gate_stat!r}")
    if pente_capture_planes and game_name != "pente":
        raise ValueError(
            f"pente_capture_planes=True requires game_name='pente' "
            f"(got {game_name!r})")
    if replay_sharding not in ("replicated", "per_host"):
        raise ValueError(f"unknown replay_sharding: {replay_sharding!r} "
                         "(expected 'replicated' or 'per_host')")
    if selfplay_mode not in ("lockstep", "continuous"):
        raise ValueError(f"unknown selfplay_mode: {selfplay_mode!r}")
    if mcts_backend not in ("xla", "pallas"):
        raise ValueError(f"unknown mcts_backend: {mcts_backend!r}")
    if use_fused_inference and inference == "f32":
        inference = "fused"  # the JAX loop's alias for the old boolean flag
    anchor_mode = anchor_search or mcts_search
    if anchor_mode not in ("puct", "gumbel"):
        raise ValueError(f"unknown anchor_search: {anchor_search!r}")

    if isinstance(mesh, str) and mesh == "auto":
        mesh = (pmesh.make_mesh(device=device) if pdist.world_size() > 1
                else None)
    elif mesh is not None and not isinstance(mesh, pmesh.DataMesh):
        raise TypeError(f"mesh must be 'auto', None or a DataMesh "
                        f"(parallel.make_mesh), not {type(mesh).__name__}")
    if mesh is None:
        # this process alone: a mesh of one member and no group, whose
        # shard is the whole batch and whose collectives are the identity
        mesh = pmesh.DataMesh(1, 0, resolve_device(device))
    dev, n_ranks = mesh.device, mesh.size
    if mesh.group is not None:
        if games_per_iteration % n_ranks:  # both modes shard the games
            rounded = -(-games_per_iteration // n_ranks) * n_ranks
            log(f"[mesh] rounding games_per_iteration {games_per_iteration}"
                f" -> {rounded} (multiple of {n_ranks} ranks)")
            games_per_iteration = rounded
        log(f"[mesh] data-parallel over {n_ranks} ranks ({mesh.describe()})"
            f": gradient batch sharded, arena games split")
    per_host_replay = replay_sharding == "per_host"
    if per_host_replay:
        if mesh.group is None:
            raise ValueError("replay_sharding='per_host' requires a device "
                             "mesh (it is a multi-process scale-out mode)")
        if batch_size % n_ranks:
            raise ValueError(
                f"replay_sharding='per_host' needs batch_size ({batch_size})"
                f" divisible by the mesh's {n_ranks} ranks")
        # buffer_size keeps its global meaning: each rank owns a slice
        buffer_size = max(batch_size // n_ranks, buffer_size // n_ranks)
        log(f"[replay] per-rank sharded: {n_ranks} rank(s) x {buffer_size} "
            f"samples, no trajectory all-gather")
    primary = mesh.rank == 0
    os.makedirs(model_dir, exist_ok=True)
    env = make_env(game_name, board_size,
                   capture_planes=pente_capture_planes)
    continuous = selfplay_mode == "continuous"
    steps = selfplay_steps or env.num_actions
    timer = PhaseTimer(dev)

    def new_model():
        return AZModel(board_size=board_size, action_size=env.num_actions,
                       n_res_blocks=n_res_blocks, channels=channels, lr=lr,
                       weight_decay=weight_decay, seed=seed,
                       in_channels=env.obs_channels, device=dev)

    model_best = new_model()
    if pretrained_model_path and os.path.exists(pretrained_model_path):
        log(f"loading pretrained model: {pretrained_model_path}")
        model_best.load(pretrained_model_path)
    else:
        log("no pretrained model found; initializing fresh weights")
    model_candidate = new_model()
    if candidate_model_path and os.path.exists(candidate_model_path):
        log(f"loading candidate model: {candidate_model_path}")
        model_candidate.load(candidate_model_path)
    else:
        model_candidate.copy_weights_from(model_best)

    model_anchor = None
    if anchor_arena_every > 0:
        model_anchor = new_model()
        if anchor_model_path:
            if not os.path.exists(anchor_model_path):
                raise FileNotFoundError(
                    f"anchor_model_path {anchor_model_path!r} does not exist")
            log(f"[anchor] loading fixed anchor: {anchor_model_path}")
            model_anchor.load(anchor_model_path)
        else:
            log("[anchor] anchoring to the starting weights")
            model_anchor.copy_weights_from(model_best)

    # per-rank replay: each rank owns a unique slice of the replay
    # distribution, so it persists its own file, keyed by its rank and the
    # world size (a file of another world's slicing is not this rank's)
    buffer_name = (f"replay_buffer_latest.proc{mesh.rank}of{n_ranks}.npz"
                   if per_host_replay and n_ranks > 1
                   else "replay_buffer_latest.npz")
    buffer_path = os.path.join(model_dir, buffer_name)
    plane_scales = env.obs_plane_scales
    buffer = load_replay_buffer(buffer_path, capacity=buffer_size,
                                board_size=board_size,
                                channel_scales=plane_scales)
    if buffer is not None and buffer.channels != env.obs_channels:
        log(f"[Buffer] saved buffer has {buffer.channels} obs channels but "
            f"this run encodes {env.obs_channels}; starting fresh")
        buffer = None
    if buffer is None:
        log("[Buffer] starting with an empty buffer")
        buffer = ReplayBuffer(capacity=buffer_size, board_size=board_size,
                              channels=env.obs_channels,
                              channel_scales=plane_scales)
    # each rank mirrors the (replicated) ring on its own card; the per-rank
    # replay path ships its local samples each epoch instead
    dev_mirror = (None if per_host_replay
                  else DeviceBufferMirror(buffer, device=dev))

    if inference not in INFERENCE_MODES:
        raise ValueError(f"unknown inference mode: {inference!r}")
    eval_fn, search_bundle = _search_bundles(inference, env, seed, buffer,
                                             timer, dev)
    mcts = MCTSConfig(
        n_simulations=n_simulations, cpuct=cpuct,
        dirichlet_alpha=dirichlet_alpha, dirichlet_epsilon=dirichlet_epsilon,
        dirichlet_moves=dirichlet_n_moves, add_noise=True,
        max_depth=mcts_max_depth, leaves_per_sim=mcts_leaves_per_sim,
        fpu_mode=mcts_fpu_mode, reuse_budget=mcts_reuse_budget,
        search=mcts_search, gumbel_max_considered=gumbel_max_considered,
        gumbel_round_parallel=(gumbel_round_parallel
                               and mcts_search == "gumbel"))
    sp_cfg = SelfPlayConfig(
        batch_games=games_per_iteration, mcts=mcts,
        temp_threshold=temp_threshold, max_moves=selfplay_max_moves,
        opening_random_moves=opening_random_moves,
        pcr_cheap_sims=pcr_cheap_sims, pcr_full_prob=pcr_full_prob)

    def match_cfg(sims: int, search: str) -> MCTSConfig:
        return MCTSConfig(
            n_simulations=sims, cpuct=cpuct, add_noise=False,
            max_depth=mcts_max_depth,
            leaves_per_sim=(mcts_leaves_per_sim
                            if sims % mcts_leaves_per_sim == 0 else 1),
            fpu_mode=mcts_fpu_mode, search=search,
            gumbel_max_considered=gumbel_max_considered,
            gumbel_round_parallel=(gumbel_round_parallel
                                   and search == "gumbel"))

    arena_cfg = match_cfg(eval_mcts_simulations, mcts_search)
    anchor_cfg = match_cfg(anchor_mcts_simulations or eval_mcts_simulations,
                           anchor_mode)

    # this rank's games, then the records the buffer takes: every rank's
    # (all-gathered), or its own with per-rank replay; the arenas' games
    # split over the ranks
    if continuous:
        selfplay_fn = pmesh.make_sharded_selfplay_continuous(
            env, sp_cfg, eval_fn, mesh, total_steps=steps)
    else:
        selfplay_fn = pmesh.make_sharded_selfplay(env, sp_cfg, eval_fn, mesh)
    gather_fn = (pmesh.local_trajectory_shards if per_host_replay else
                 functools.partial(pmesh.gather_trajectories, mesh=mesh))
    arena_half_fn = pmesh.make_sharded_arena(env, arena_cfg, eval_fn, mesh)
    anchor_half_fn = (arena_half_fn if anchor_cfg == arena_cfg else
                      pmesh.make_sharded_arena(env, anchor_cfg, eval_fn,
                                               mesh))
    # the check is a process's: ranks on one card share its memory
    sharing = pmesh.ranks_per_device(mesh)
    selfplay_fn = with_preflight(
        selfplay_fn, selfplay_memory(env, pmesh.local_cfg(sp_cfg, mesh),
                                     model_candidate.cfg,
                                     steps if continuous else None),
        label=f"{selfplay_mode} self-play"
              + (f" (one of {sharing} ranks on the card)" if sharing > 1
                 else ""),
        margin=DEFAULT_MARGIN / sharing, device=dev)
    # an epoch over per-rank samples (per-rank replay), or over the ring
    # on the device, its batch sharded over the ranks; a lone process, or
    # a batch the ranks do not divide, trains unsharded (the plain step:
    # global batch norm's separate ops cost a step more than cuDNN's)
    net_cfg, tx = model_candidate.cfg, model_candidate.tx
    unsharded_epoch = not per_host_replay and (mesh.group is None
                                               or batch_size % n_ranks)
    if per_host_replay:
        epoch_fn = pmesh.make_sharded_train_epoch(
            net_cfg, tx, mesh, value_loss_weight=value_loss_weight)
    elif unsharded_epoch:
        if mesh.group is not None:
            log(f"[mesh] batch_size {batch_size} not divisible by "
                f"{n_ranks} ranks; training stays unsharded (every rank "
                f"the whole batch, then rank 0's result)")
        epoch_fn = functools.partial(train_epoch_gather, net_cfg, tx,
                                     value_loss_weight=value_loss_weight)
    else:
        epoch_fn = pmesh.make_sharded_gather_epoch(
            net_cfg, tx, mesh, value_loss_weight=value_loss_weight)

    eval_every = max(1, eval_every)
    rng_np = np.random.default_rng(seed)
    history = []
    end_iter = next_iteration_continuation + num_iterations
    # the second iteration, as the JAX loop's (its first compiles), or the
    # only one
    trace_iter = (next_iteration_continuation + (num_iterations > 1)
                  if profile_trace_dir else None)

    for it in range(next_iteration_continuation, end_iter):
        t_iter = time.perf_counter()
        totals_at_iter_start = dict(timer.totals)
        if it == trace_iter:
            log(f"[profiler] tracing iteration {it} -> "
                f"{start_profiler_trace(profile_trace_dir)}")
        log(f"\n=== ITER {it}/{end_iter - 1}: self-play "
            f"(games={games_per_iteration}, sims={n_simulations}) "
            f"@ {datetime.now().strftime('%Y-%m-%d %H:%M:%S')} ===")

        # ---- phase 1: self-play --------------------------------------
        bundle_cand = search_bundle(model_candidate)
        with timer.phase("selfplay"), trace_annotation("selfplay"):
            traj = gather_fn(selfplay_fn(bundle_cand, seed * 100003 + it))
        with timer.phase("collect"):
            collect = (collect_examples_continuous if continuous
                       else collect_examples)
            states, pis, zs, winners = collect(
                traj, use_symmetries=use_symmetries,
                value_target_mix=value_target_mix,
                capture_planes=pente_capture_planes)
        with timer.phase("buffer"):
            written = buffer.add(states, pis, zs)
            if dev_mirror is not None and len(written) == buffer.capacity:
                dev_mirror = DeviceBufferMirror(buffer, device=dev)
            elif dev_mirror is not None:
                dev_mirror.sync(states, pis, zs, written)
        if continuous:
            n_moves = traj.ended.numel()
            if len(zs) == 0:
                log(f"[selfplay] WARNING: no game finished within {steps} "
                    f"plies — all records dropped; raise selfplay_steps")
        else:
            n_moves = int(traj.moves_played.sum())
        sp_dt = timer.last["selfplay"]
        pcr_note = ""
        if pcr_cheap_sims:
            # cheap (value-only) plies carry all-zero recorded pis
            valid = traj.recorded if continuous else traj.active
            n_valid = max(int(valid.sum()), 1)
            full = int(((traj.pis.sum(dim=-1) > 0.5) & valid).sum())
            pcr_note = (f", pcr full plies {full}/{n_valid} "
                        f"({full / n_valid:.2f})")
        log(f"self-play done: {sp_dt:.1f}s, {n_moves} moves "
            f"({n_moves / max(sp_dt, 1e-9):.1f} moves/s), collect "
            f"{timer.last['collect']:.1f}s, winners={winners}, "
            f"buffer={len(buffer)}{pcr_note}")

        # ---- phase 2: train ------------------------------------------
        loss_info = None
        with timer.phase("train"), trace_annotation("train"):
            effective_len = len(buffer)
            if per_host_replay:
                # the gate and steps per epoch from the global count, and
                # no rank with an empty shard: the ranks must agree, or
                # the sharded epoch deadlocks
                effective_len = pmesh.global_buffer_len(len(buffer))
                if pmesh.min_local_buffer_len(len(buffer)) == 0:
                    effective_len = 0
            if effective_len >= batch_size:
                n_batches = max(1, effective_len // batch_size)
                log(f"training candidate: buffer={len(buffer)}"
                    + (f" local / {effective_len} global"
                       if per_host_replay else "")
                    + f", batch={batch_size}, epochs={epochs_per_iter}, "
                    f"steps/epoch={n_batches}")
                for epoch in range(epochs_per_iter):
                    t1 = time.perf_counter()
                    model = model_candidate
                    if per_host_replay:
                        # this rank's share of every step's batch, from its
                        # own shard
                        batches = pmesh.form_global_batches(
                            mesh, *buffer.sample_many(
                                n_batches, batch_size // n_ranks, rng_np))
                        (model.params, model.batch_stats, model.opt_state,
                         metrics) = epoch_fn(
                            model.params, model.batch_stats,
                            model.opt_state, *batches, local=True)
                    else:
                        # the JAX loop's draws: one without-replacement
                        # choice a step, from the same numpy generator
                        # (every rank draws the same rows of the same ring)
                        idx = torch.as_tensor(np.stack([
                            rng_np.choice(len(buffer), size=batch_size,
                                          replace=False)
                            for _ in range(n_batches)]).astype(np.int64),
                            device=dev)
                        (model.params, model.batch_stats, model.opt_state,
                         metrics) = epoch_fn(
                            model.params, model.batch_stats,
                            model.opt_state, dev_mirror.states,
                            dev_mirror.pis, dev_mirror.zs, idx,
                            dev_mirror.inv_scales)
                        if unsharded_epoch:
                            pmesh.broadcast_from_primary(
                                (model.params, model.batch_stats,
                                 model.opt_state, metrics), mesh)
                    loss_info = {k: float(v) for k, v in metrics.items()}
                    log(f"  epoch {epoch + 1}/{epochs_per_iter}: "
                        f"{time.perf_counter() - t1:.1f}s, "
                        f"last_loss={loss_info}")
            else:
                log(f"not enough samples (buffer={effective_len} < "
                    f"{batch_size}); skipping training this iteration")

        # ---- phase 3: arena ------------------------------------------
        run_arena = it % eval_every == 0
        arena_stats = None
        if run_arena:
            bundle_cand = search_bundle(model_candidate)
            bundle_best = search_bundle(model_best)
            with timer.phase("arena"), trace_annotation("arena"):
                try:
                    arena_stats = evaluate_params_detailed(
                        env, arena_cfg, eval_fn, bundle_cand, bundle_best,
                        eval_games, seed * 7919 + it,
                        arena_half_fn=arena_half_fn, device=dev,
                        net_cfgs=(model_candidate.cfg, model_best.cfg))
                except Exception as e:  # keep training alive, as the JAX loop
                    log(f"evaluation failed: {e!r}")
                    arena_stats = {"wins": 0, "played": 0, "draws": 0,
                                   "win_rate": 0.0, "ci95": (0.0, 1.0),
                                   "pairs": {"win_both": 0, "split": 0,
                                             "loss_both": 0, "n": 0}}
        if arena_stats is not None:
            win_rate = arena_stats["win_rate"]
            draws = arena_stats["draws"]
            ci_lo, ci_hi = arena_stats["ci95"]
            pairs = arena_stats["pairs"]
            eval_dt = timer.last["arena"]
            log(f"eval done: {eval_dt:.1f}s, win_rate={win_rate:.3f} "
                f"({arena_stats['wins']}/{eval_games}), draws={draws}, "
                f"CI95=[{ci_lo:.2f},{ci_hi:.2f}], mirrored pairs "
                f"W/S/L={pairs['win_both']}/{pairs['split']}/"
                f"{pairs['loss_both']}")
        else:
            win_rate = draws = ci_lo = ci_hi = pairs = None
            eval_dt = 0.0
            log(f"arena skipped (eval_every={eval_every})")

        # ---- phase 3b: hold-out anchor arena -------------------------
        anchor_stats = None
        if model_anchor is not None and it % anchor_arena_every == 0:
            with timer.phase("anchor"):
                try:
                    anchor_stats = evaluate_params_detailed(
                        env, anchor_cfg, eval_fn,
                        search_bundle(model_candidate),
                        search_bundle(model_anchor), eval_games,
                        seed * 104729 + it, arena_half_fn=anchor_half_fn,
                        device=dev,
                        net_cfgs=(model_candidate.cfg, model_anchor.cfg))
                    a_lo, a_hi = anchor_stats["ci95"]
                    ap = anchor_stats["pairs"]
                    log(f"anchor arena: "
                        f"win_rate={anchor_stats['win_rate']:.3f}"
                        f" ({anchor_stats['wins']}/{anchor_stats['played']}),"
                        f" CI95=[{a_lo:.2f},{a_hi:.2f}], pairs W/S/L="
                        f"{ap['win_both']}/{ap['split']}/{ap['loss_both']}")
                except Exception as e:
                    log(f"anchor arena failed: {e!r}")

        # ---- phase 4: gate -------------------------------------------
        accepted, reset_worthy = gate_decision(
            gate_stat, win_rate, (ci_lo, ci_hi), win_rate_threshold,
            run_arena=run_arena)
        if not run_arena:
            pass
        elif accepted:
            log(f" candidate ACCEPTED ({gate_stat}) -> promoted to best")
            model_best.copy_weights_from(model_candidate)
        elif gate_mode == "reset" and reset_worthy:
            log(" candidate rejected -> restored from best")
            model_candidate.copy_weights_from(model_best)
        elif gate_mode == "reset":
            log(" arena inconclusive (CI straddles threshold) -> "
                "candidate keeps training, best unchanged")
        else:
            log(" candidate rejected -> best unchanged (track mode)")

        # ---- phase 5: snapshot and buffer ----------------------------
        # only rank 0 writes the model (replicated on every rank); the
        # buffer too, unless each rank holds its own shard
        snapshot_path = None
        with timer.phase("checkpoint"):
            if primary and it % save_every == 0:
                ts = datetime.now().strftime("%Y%m%d_%H%M%S")
                snapshot_path = os.path.join(
                    model_dir, f"snapshot_iter{it}_{ts}.ckpt")
                # the candidate: in track mode the evolving net
                model_candidate.save(snapshot_path)
                model_best.save(os.path.join(model_dir, "best_latest.ckpt"))
                log(f" saved snapshot: {snapshot_path}")
            if (primary or per_host_replay) and (
                    it % buffer_save_every == 0 or it == end_iter - 1):
                save_replay_buffer(buffer, buffer_path)
        if it == trace_iter:
            log(f"[profiler] trace written to {stop_profiler_trace()}")

        it_total = time.perf_counter() - t_iter
        phase_dt = {k: timer.totals[k] - totals_at_iter_start.get(k, 0.0)
                    for k in timer.totals}
        shown = {k: v for k, v in phase_dt.items() if v >= 0.05}
        other_dt = it_total - sum(phase_dt.values())
        log(f"iteration {it} finished in {it_total:.1f}s ("
            + ", ".join(f"{k} {v:.1f}" for k, v in shown.items())
            + f", other {other_dt:.1f}); winners={winners}")
        history.append({
            "iteration": it,
            "winners": winners,
            "moves": n_moves,
            "selfplay_seconds": round(sp_dt, 3),
            "eval_seconds": round(eval_dt, 3),
            "train_seconds": round(timer.last.get("train", 0.0), 3),
            "loss": loss_info,
            "win_rate": win_rate,
            "win_rate_ci95": ([round(ci_lo, 4), round(ci_hi, 4)]
                              if run_arena else None),
            "arena_pairs": pairs,
            "anchor": anchor_stats,
            "draws": draws,
            "accepted": accepted,
            "buffer_size": len(buffer),
            "snapshot": snapshot_path,
            "phase_seconds": phase_dt,
            "moves_per_second": n_moves / max(sp_dt, 1e-9),
        })

    log("\n=== training complete ===")
    log(f"phase totals: {timer.summary()}")
    return history
