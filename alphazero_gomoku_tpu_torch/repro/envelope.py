"""The shared core of the tree kernels' envelope probes.

The JAX repo's ``repro/`` bisects (``bisect_batch512_fault.py``,
``bisect_lockstep_fault.py``, ``parent_pallas_probe.py`` and
``parent_pallas_longrun.py``) drove its Mosaic tree kernels to the edges
that had killed the TPU worker: batches of 512 and more, games played to
their end, depth-capped walks, parent FPU.  A worker that lived was their
only result.  Here the same runs hold the CUDA kernels against their plain
versions (``tools/backends.py``: ``"pallas"`` is K1, K2 and K3 and the
tower kernel of the inference mode, ``"xla"`` the plain versions), so a
probe that lives also says whether the kernels computed what the plain
versions compute, and counts what each run reached.

  - :func:`probe_selfplay` runs ``selfplay/runner.play_games`` on each
    backend from the same generator seed and compares the records bit for
    bit (``pis``, ``actions``, ``active``, ``root_qs``, the boards, the
    winners and the games' lengths), with counters of what the walks and
    the games reached, and the peak device memory beside the reckoning of
    ``selfplay/budget.py``;
  - :func:`probe_kernels` runs ``select_walk`` and ``backup_paths`` alone on
    random priors and values (no network) and compares the final trees;
  - :func:`replay_games` replays every game of a run on the host engine
    (``games/host.py``), an independent check of how each game ended.

Each probe gives one JSON-able line with ``ok``, ``match``, the counters
and the seconds of each backend.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games
from alphazero_gomoku_tpu_torch.selfplay.budget import (
    preflight_memory_check,
    selfplay_memory,
)
from alphazero_gomoku_tpu_torch.tools.backends import BACKENDS, backend

MIB = 2 ** 20
# the records compared between the backends, ply by ply
RECORDS = ("boards", "players", "pis", "root_qs", "active", "actions")
# the JAX KERNELS loop's actions (15x15) and depth cap, and the seed of the
# generator its draws come from here
KERNELS_ACTIONS, KERNELS_DEPTH, KERNELS_SEED = 225, 56, 0


class Run(NamedTuple):
    """A probe's JSON line and what it compared (trajectories or trees, by
    backend)."""

    line: dict
    outputs: dict


def selfplay_config(batch: int, sims: int, moves: int, max_depth: int = 56,
                    fpu_mode: str = "zero", search: str = "puct",
                    leaves_per_sim: int = 1) -> SelfPlayConfig:
    """The JAX scripts' ``SelfPlayConfig``, field for field: cpuct 1, root
    noise alpha 0.05 and epsilon 0.15 on the first 10 plies, temperature to
    ply 10.  ``search="gumbel"`` is Gumbel sequential halving with m = 16
    and no root noise (the bench's config #6)."""
    if search == "gumbel":
        mcts = MCTSConfig(n_simulations=sims, search="gumbel",
                          gumbel_max_considered=16, add_noise=False,
                          max_depth=max_depth)
    else:
        mcts = MCTSConfig(n_simulations=sims, cpuct=1.0, add_noise=True,
                          dirichlet_alpha=0.05, dirichlet_epsilon=0.15,
                          dirichlet_moves=10, max_depth=max_depth,
                          fpu_mode=fpu_mode, leaves_per_sim=leaves_per_sim)
    return SelfPlayConfig(batch_games=batch, mcts=mcts, temp_threshold=10,
                          max_moves=moves)


def make_net(infer: str, blocks: int, channels: int, seed: int,
             board_size: int = 15, device=None):
    """``(net_cfg, eval_fn, bundle)``: the JAX scripts' ``AZModel`` of
    ``blocks`` x ``channels`` made from ``seed``, in inference mode
    ``infer`` (``f32``; ``int8t`` where the JAX scripts name ``int8``)."""
    dev = resolve_device(device)
    model = AZModel(board_size=board_size, n_res_blocks=blocks,
                    channels=channels, seed=seed, device=dev)
    eval_fn, bundle = make_inference(infer, model.cfg, *model.jax_params(),
                                     device=dev)
    return model.cfg, eval_fn, bundle


def make_sides(infer: str, net_cfg, eval_fn) -> dict:
    """Backend name -> ``(eval_fn, tree ops)`` (``tools/backends.py``), the
    kernels first."""
    return {name: backend(name, infer, net_cfg, eval_fn) for name in BACKENDS}


class WalkCounter:
    """The tree ops of a search with each walk's outputs counted on the
    device (no synchronisation): walks that stopped at the depth cap
    (``path_len == depth`` and ``action == -1``), walks from a done root
    (``path_len == 0``: a live root always records its first hop), and the
    deepest path."""

    def __init__(self, ops: tk.TreeOps, device):
        self.inner = ops
        self.capped = torch.zeros((), dtype=torch.int64, device=device)
        self.done_roots = torch.zeros((), dtype=torch.int64, device=device)
        self.deepest = torch.zeros((), dtype=torch.int32, device=device)
        self.walks = 0
        self.ops = tk.TreeOps(self._select, ops.backup_paths, self._gumbel)

    def _count(self, out):
        _, action, pnodes, _, plen = out
        self.capped += ((plen == pnodes.shape[0]) & (action < 0)).sum()
        self.done_roots += (plen == 0).sum()
        self.deepest = torch.maximum(self.deepest, plen.max())
        self.walks += plen.shape[0]
        return out

    def _select(self, *args, **kwargs):
        return self._count(self.inner.select_walk(*args, **kwargs))

    def _gumbel(self, *args, **kwargs):
        return self._count(self.inner.gumbel_select_walk(*args, **kwargs))

    def counts(self) -> dict:
        return {"walks": self.walks, "capped_walks": int(self.capped),
                "done_root_walks": int(self.done_roots),
                "deepest_path": int(self.deepest)}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _deterministic_cudnn(dev: torch.device):
    """cuDNN's deterministic algorithms while both backends run: the float32
    net must give both the same numbers for the same boards."""
    if dev.type != "cuda":
        yield
        return
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def game_counters(traj, num_actions: int) -> dict:
    """What a run's games reached: plies run, games won, games that filled
    the board, games still running at the move cap, lane-plies searched on a
    done root (the move loop searches every lane until every game is done),
    and the lane moves (the JAX scripts' ``lane_moves``)."""
    played = traj.moves_played.long()
    winners = traj.winners
    plies = int(played.max())
    batch = played.shape[0]
    return {"plies": plies,
            "lane_moves": int(played.sum()),
            "won": int((winners != 0).sum()),
            "full_board": int((played == num_actions).sum()),
            "running": int(((winners == 0)
                            & (played < num_actions)).sum()),
            "done_root_plies": plies * batch
                               - int(traj.active[:plies].sum())}


def compare(traj_a, traj_b, plies: int) -> List[str]:
    """The fields of two runs that differ over their first ``plies`` plies
    (empty when they are equal bit for bit): the records ply by ply (the
    board before each move and the move, so the final boards too), and each
    game's length and winner as far as ``plies`` reaches."""
    for traj in (traj_a, traj_b):
        if traj.boards.shape[0] < plies:
            raise ValueError(f"a run of {traj.boards.shape[0]} plies cannot "
                             f"be compared over {plies}")
    diff = [name for name in RECORDS
            if not torch.equal(getattr(traj_a, name)[:plies],
                               getattr(traj_b, name)[:plies])]
    mp_a, mp_b = traj_a.moves_played, traj_b.moves_played
    if not torch.equal(torch.clamp(mp_a, max=plies),
                       torch.clamp(mp_b, max=plies)):
        diff.append("moves_played")
    ended_a, ended_b = mp_a < plies, mp_b < plies
    if not torch.equal(torch.where(ended_a, traj_a.winners, 0),
                       torch.where(ended_b, traj_b.winners, 0)):
        diff.append("winners")
    return diff


def replay_games(traj) -> List[str]:
    """Replay every Gomoku game of ``traj`` move by move on the host engine
    (``make_host_game``) and list each disagreement with the batched run:
    a board record that is not the host's board, a move the host refuses, a
    record marked active after the game's end (or inactive before it), a
    game that ended on the host at another ply, or another winner."""
    boards = traj.boards.cpu().numpy()
    actions = traj.actions.cpu().numpy()
    active = traj.active.cpu().numpy()
    winners = traj.winners.cpu().numpy()
    played = traj.moves_played.cpu().numpy()
    cap, batch = active.shape
    size = boards.shape[-1]
    # plies the move loop ran: it stops when every game is done, and the
    # records after that are never written
    ran = int(played.max())
    errors = []
    for lane in range(batch):
        g = make_host_game("gomoku", size)
        n = int(played[lane])
        for t in range(n):
            if not np.array_equal(boards[t, lane], g.board):
                errors.append(f"game {lane}: board record {t} is not the "
                              f"host's")
                break
            if g.is_game_over():
                errors.append(f"game {lane}: over on the host before ply {t}")
                break
            if not active[t, lane]:
                errors.append(f"game {lane}: ply {t} marked inactive")
                break
            if not g.do_move(g.action_to_move(int(actions[t, lane]))):
                errors.append(f"game {lane}: the host refuses move "
                              f"{int(actions[t, lane])} at ply {t}")
                break
        else:
            over = g.is_game_over()
            ended = bool(winners[lane] != 0 or n == size * size)
            if g.get_winner() != int(winners[lane]):
                errors.append(f"game {lane}: winner {int(winners[lane])}, "
                              f"host {g.get_winner()}")
            if over != ended or (not over and n < cap):
                errors.append(f"game {lane}: {n} moves, host over={over}")
            if active[n:, lane].any():
                errors.append(f"game {lane}: active after its end")
            if n < ran and not np.array_equal(boards[n, lane], g.board):
                errors.append(f"game {lane}: board not frozen after its end")
    return errors


def probe_selfplay(env, cfg: SelfPlayConfig, sides: Dict[str, tuple], bundle,
                   seed: int, net_cfg=None,
                   compared_plies: Optional[int] = None,
                   expect: Sequence[str] = (), device=None) -> Run:
    """``play_games`` of ``cfg`` on each of ``sides`` (backend name ->
    ``(eval_fn, tree ops)``, the first the one counted and reported) from a
    generator seeded ``seed``; the later sides run the first
    ``compared_plies`` plies (all by default) and are compared with the
    first bit for bit.

    With ``net_cfg`` the memory preflight checks the reckoning
    (``selfplay/budget.selfplay_memory``) before the first run, and the
    line gives it beside ``torch.cuda.max_memory_allocated`` of each run.
    ``expect`` names counters that must be above 0 for ``ok`` (the axis
    the probe is for was reached).  Every run's games are replayed on the
    host (``replay_games``).
    """
    dev = resolve_device(device)
    reckoned = None
    if net_cfg is not None:
        terms = selfplay_memory(env, cfg, net_cfg)
        preflight_memory_check(terms, label="probe", device=dev)
        reckoned = terms["peak_bytes"]
    cap = cfg.resolved_max_moves(env)
    plies = cap if compared_plies is None else min(compared_plies, cap)
    trajs, seconds, peaks, counts, errors = {}, {}, {}, None, []
    with _deterministic_cudnn(dev):
        for i, (name, (eval_fn, ops)) in enumerate(sides.items()):
            counter = WalkCounter(ops, dev)
            run_cfg = cfg if i == 0 else dataclasses.replace(cfg,
                                                            max_moves=plies)
            _sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            gen = torch.Generator(device=dev).manual_seed(seed)
            t0 = time.perf_counter()
            traj = play_games(env, run_cfg, eval_fn, bundle, gen, dev,
                              ops=counter.ops)
            _sync(dev)
            seconds[name] = round(time.perf_counter() - t0, 3)
            if dev.type == "cuda":
                peaks[name] = round(torch.cuda.max_memory_allocated(dev)
                                    / MIB, 1)
            if i == 0:
                counts = dict(counter.counts(),
                              **game_counters(traj, env.num_actions))
            errors += [f"{name}: {e}" for e in replay_games(traj)]
            trajs[name] = traj
    names = list(trajs)
    diff = []
    for name in names[1:]:
        diff += [f"{name}.{f}" for f in compare(trajs[names[0]], trajs[name],
                                                plies)]
    match = not diff if len(names) > 1 else None
    reached = all(counts[k] > 0 for k in expect)
    m = cfg.mcts
    line = {"batch": cfg.batch_games, "sims": m.n_simulations,
            "max_moves": cap, "search": m.search, "fpu": m.fpu_mode,
            "max_depth": m.depth_limit, "leaves_per_sim": m.leaves_per_sim,
            "ok": bool(match is not False and not errors and reached),
            "match": match, "mismatch": diff,
            "compared_plies": plies if len(names) > 1 else 0,
            "replay_errors": errors[:8], "n_replay_errors": len(errors),
            "axes_reached": reached, **counts, "seconds": seconds}
    if reckoned is not None:
        line["reckoned_peak_mb"] = round(reckoned / MIB, 1)
    if peaks:
        line["peak_mb"] = peaks
    return Run(line, trajs)


def random_draws(batch: int, sims: int, num_actions: int, generator):
    """The kernels-only loop's randomness: root priors ``[B, A]``, and per
    simulation leaf values ``[B]`` in [-1, 1) and priors ``[B, A]``
    (softmax of normal draws), as the JAX ``KERNELS`` loop draws them."""
    dev = generator.device

    def priors():
        return torch.softmax(torch.randn((batch, num_actions),
                                         generator=generator, device=dev),
                             dim=-1)

    root = priors()
    for _ in range(sims):
        values = torch.rand(batch, generator=generator, device=dev) * 2 - 1
        yield root, values, priors()


def probe_kernels(batch: int, sims: int, nodes: int, draws=None,
                  sides: Optional[Dict[str, tk.TreeOps]] = None,
                  device=None) -> Run:
    """The JAX ``KERNELS`` loop (``bisect_batch512_fault.py:102-147``):
    ``sims`` simulations of ``select_walk`` (cpuct 1, depth cap 56) and
    ``backup_paths`` (mode ``"backup"``, slot ``sim + 1``, nothing done) on
    ``batch`` trees of 225 actions and ``nodes`` slots whose root priors,
    leaf values and leaf priors are random, with no network.  Each backend
    of ``sides`` (name -> tree ops; default the kernels and the plain
    versions) runs the loop on the same draws: ``draws`` (``(root [B, A],
    values [S, B], priors [S, B, A])``, as the tests pass the JAX loop's) or
    the stream of a generator seeded ``KERNELS_SEED`` on the device.  The
    final trees are compared bit for bit."""
    dev = resolve_device(device)
    if sides is None:
        sides = {"pallas": tk.KERNELS, "xla": tk.PLAIN}
    num_actions, depth = KERNELS_ACTIONS, KERNELS_DEPTH
    layout = tk.packed_layout(num_actions, nodes)
    trees, seconds, counts = {}, {}, None
    for i, (name, ops) in enumerate(sides.items()):
        if draws is None:
            stream = random_draws(batch, sims, num_actions,
                                  torch.Generator(device=dev).manual_seed(
                                      KERNELS_SEED))
        else:
            d_root, d_values, d_priors = (torch.tensor(np.asarray(x),
                                                       device=dev)
                                          for x in draws)
            stream = ((d_root, d_values[s], d_priors[s])
                      for s in range(sims))
        counter = WalkCounter(ops, dev)
        tree = tk.init_packed(batch, layout, dev)
        zeros = torch.zeros(batch, dtype=torch.bool, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        for sim, (root, values, priors) in enumerate(stream):
            if sim == 0:
                tree[:, tk.SL_P, :num_actions] = root
            leaf, action, pnodes, pacts, plen = counter.ops.select_walk(
                tree, layout, 1.0, depth)
            counter.ops.backup_paths(tree, pnodes, pacts, plen, values,
                                     action >= 0, sim + 1, layout, priors,
                                     zeros)
        _sync(dev)
        seconds[name] = round(time.perf_counter() - t0, 3)
        if i == 0:
            counts = counter.counts()
        trees[name] = tree
    names = list(trees)
    first = trees[names[0]]
    match = (all(torch.equal(first, trees[n]) for n in names[1:])
             if len(names) > 1 else None)
    diff = max((float((first - trees[n]).abs().max()) for n in names[1:]),
               default=0.0)
    line = {"probe": "kernels", "batch": batch, "sims": sims,
            "nodes": nodes, "max_depth": depth,
            "root_visits": float(first[:, tk.SL_N, :num_actions].sum()),
            "ok": match is not False, "match": match, "max_abs_diff": diff,
            **counts, "seconds": seconds}
    return Run(line, trees)


def print_line(line: dict):
    print(json.dumps(line), flush=True)


def run_one(module: str, argv: Sequence[str], timeout: float,
            device=None) -> Optional[dict]:
    """One config in a process of its own, as the JAX scripts run each: a
    CUDA fault (an illegal address, say) poisons the process's context, as
    a TPU fault killed the worker.  Runs ``python -m
    alphazero_gomoku_tpu_torch.repro.<module> *argv`` from the checkout
    and prints its last JSON line, or a line with ``ok`` false, the exit
    code and the tail of its errors.  Returns the line."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", f"alphazero_gomoku_tpu_torch.repro.{module}",
           *map(str, argv)]
    if device is not None:
        cmd += ["--device", str(device)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=root)
    except subprocess.TimeoutExpired:
        line = {"argv": list(map(str, argv)), "ok": False, "rc": "timeout",
                "timeout_s": timeout}
        print_line(line)
        return line
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if lines:
        line = json.loads(lines[-1])
        if p.returncode != 0:
            line.update(ok=False, rc=p.returncode)
        print_line(line)
        return line
    tail = (p.stderr or p.stdout).strip().splitlines()[-3:]
    line = {"argv": list(map(str, argv)), "ok": False, "rc": p.returncode,
            "tail": tail}
    print_line(line)
    return line
