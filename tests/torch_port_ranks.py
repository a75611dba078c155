"""Multi-rank runs of the port for the tests: gloo process groups on the CPU.

:func:`spawn` starts ``world`` fresh Python processes (no JAX in them), each
joining a gloo group on a free localhost port through the port's own
``initialize_distributed``, and each running one scenario of this module
(``python -m torch_port_ranks <scenario> <rank> <world> <port> <outdir>``).
A rank saves what it computed with ``torch.save`` into ``outdir``; the test
loads every rank's results and holds them against the JAX package and the
port's single-process functions in its own process.

The inputs are made here from seeds with numpy, so that a test builds the
same ones.  The eval function is a table lookup that both frameworks
compute bit for bit (``torch_port_util.TableEval``'s tables), indexed also
by the game's global lane (``LANE_MULT`` times the lane, the rank's first
lane being ``rank * local batch``), so that the lockstep games of one batch
differ without any random draw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SIZE = 7
LANE_MULT = 31.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(scenario: str, world: int, outdir, timeout: float = 300.0):
    """Run ``scenario`` on ``world`` gloo ranks; every rank's results, in
    rank order.  Fails with each rank's output if one exits non-zero."""
    outdir = Path(outdir).resolve()
    outdir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_port_ranks", scenario, str(rank),
         str(world), str(port), str(outdir)],
        env=env, cwd=str(outdir), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-6000:]}"
    return [torch.load(outdir / f"{scenario}_{rank}.pt", weights_only=False)
            for rank in range(world)], outs


# ----------------------------------------------------------------------
# inputs and the eval function, shared by the ranks and the tests
# ----------------------------------------------------------------------
class LaneTable:
    """``TableEval``'s tables, indexed by ``sum(me * W1 + opp * W2) +
    LANE_MULT * lane mod K``, ``lane`` the game's index in the global batch:
    ``offset + arange(N)`` for a call of ``N`` boards."""

    def __init__(self, seed: int = 3, k: int = 97):
        rng = np.random.default_rng(seed)
        a = SIZE * SIZE
        self.k = k
        self.w1 = rng.integers(1, 50, (SIZE, SIZE)).astype(np.float32)
        self.w2 = rng.integers(1, 50, (SIZE, SIZE)).astype(np.float32)
        raw = rng.random((k, a)) ** 3 + 1e-3
        self.probs = (raw / raw.sum(1, keepdims=True)).astype(np.float32)
        self.values = rng.uniform(-0.9, 0.9, (k, 1)).astype(np.float32)

    def torch_fn(self, rank: int = 0, lanes: bool = True):
        """The eval function of rank ``rank`` (its calls' first lane is
        ``rank * N``); with ``lanes`` False, no lane term."""
        def eval_fn(params, obs):
            del params
            n = obs.shape[0]
            lane = (rank * n + torch.arange(n, device=obs.device)) * lanes
            f = (obs[..., 0] * torch.from_numpy(self.w1)
                 + obs[..., 1] * torch.from_numpy(self.w2)).sum(dim=(1, 2))
            idx = torch.remainder(f + LANE_MULT * lane, self.k).long()
            return (torch.from_numpy(self.probs)[idx],
                    torch.from_numpy(self.values)[idx])
        return eval_fn


def greedy_actions(pi, temp, legal, generator=None, uniforms=None):
    """``sample_actions`` at temperature 0: the moves need no draw."""
    del temp, legal, generator, uniforms
    return torch.argmax(pi, dim=-1)


def selfplay_cfgs():
    """``{name: (SelfPlayConfig kwargs, MCTSConfig kwargs, total_steps)}`` of
    the sharded self-play checks (``total_steps`` None: lockstep)."""
    puct = dict(n_simulations=8, cpuct=1.0, add_noise=False, max_depth=49)
    return {
        "lockstep": (dict(batch_games=8, temp_threshold=4), puct, None),
        "continuous": (dict(batch_games=8, temp_threshold=4, max_moves=10),
                       puct, 14),
        "reuse": (dict(batch_games=16, temp_threshold=4),
                  dict(puct, reuse_budget=4), None),
        "noise": (dict(batch_games=8, temp_threshold=4),
                  dict(puct, add_noise=True, dirichlet_alpha=0.3,
                       dirichlet_epsilon=0.25, dirichlet_moves=4), None),
    }


def port_selfplay_cfg(name: str):
    from alphazero_gomoku_tpu_torch.search import MCTSConfig
    from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig

    sp, mc, steps = selfplay_cfgs()[name]
    return SelfPlayConfig(mcts=MCTSConfig(**mc), **sp), steps


SELFPLAY_SEED = 5
ARENA_GAMES, ARENA_SEED = 5, 11
NET = dict(board_size=SIZE, n_res_blocks=1, channels=8, seed=0)
TRAIN_BATCH, TRAIN_STEPS = 16, 2


def train_data(seed: int = 0):
    """``[steps, batch, ...]`` minibatches whose two halves (the ranks'
    slices) differ in their per-channel statistics: the second half's
    observations are shifted and scaled, so that batch norm over one slice
    is not batch norm over the batch.  Normal-distributed observations: on
    binary boards a ReLU's kink splits the frameworks (see
    ``test_torch_port_train_step.py``)."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((TRAIN_STEPS, TRAIN_BATCH, SIZE, SIZE, 3))
    half = TRAIN_BATCH // 2
    xs[:, half:] = xs[:, half:] * 3.0 + 2.0
    pis = rng.random((TRAIN_STEPS, TRAIN_BATCH, SIZE * SIZE))
    pis[pis < 0.5] = 0.0
    pis /= pis.sum(-1, keepdims=True)
    zs = rng.choice([-1.0, 0.0, 1.0], (TRAIN_STEPS, TRAIN_BATCH, 1))
    return (xs.astype(np.float32), pis.astype(np.float32),
            zs.astype(np.float32))


def ring_data(seed: int = 1, n: int = 40):
    """A replay ring (uint8 boards, pis, zs) and ``[steps, batch]`` index
    rows into it for the gather epoch."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 3, (n, SIZE, SIZE))
    states = np.stack([cells == 1, cells == 2, np.ones_like(cells, bool)],
                      axis=-1).astype(np.uint8)
    pis = rng.random((n, SIZE * SIZE)).astype(np.float32)
    pis /= pis.sum(-1, keepdims=True)
    zs = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    idx = np.stack([rng.choice(n, TRAIN_BATCH, replace=False)
                    for _ in range(TRAIN_STEPS)]).astype(np.int64)
    return states, pis, zs, idx


def state_numpy(params, stats, opt, metrics):
    return {"params": {k: v.numpy() for k, v in params.items()},
            "stats": {k: v.numpy() for k, v in stats.items()},
            "mu": {k: v.numpy() for k, v in opt.mu.items()},
            "nu": {k: v.numpy() for k, v in opt.nu.items()},
            "count": int(opt.count),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def records_numpy(traj):
    return {k: (None if v is None else v.numpy())
            for k, v in traj._asdict().items()}


# ----------------------------------------------------------------------
# scenarios (in the rank processes)
# ----------------------------------------------------------------------
def scenario_parallel(rank: int, world: int):
    """Every check of ``test_torch_port_parallel.py`` in one group."""
    from alphazero_gomoku_tpu_torch.games import make_env
    from alphazero_gomoku_tpu_torch.models.model import AZModel
    from alphazero_gomoku_tpu_torch.parallel import (
        gather_trajectories,
        global_buffer_len,
        make_mesh,
        make_sharded_arena,
        make_sharded_gather_epoch,
        make_sharded_selfplay,
        make_sharded_selfplay_continuous,
        make_sharded_train_epoch,
        min_local_buffer_len,
    )
    from alphazero_gomoku_tpu_torch.parallel.mesh import ranks_per_device
    from alphazero_gomoku_tpu_torch.search import MCTSConfig
    from alphazero_gomoku_tpu_torch.selfplay import runner as prun

    mesh = make_mesh()
    out = {"mesh": (mesh.size, mesh.rank, str(mesh.device), mesh.backend)}
    env = make_env("gomoku", SIZE)
    table = LaneTable()
    for name in selfplay_cfgs():
        cfg, steps = port_selfplay_cfg(name)
        eval_fn = table.torch_fn(rank, lanes=name != "noise")
        # "noise" samples its moves from the rank's generator
        with (contextlib.nullcontext() if name == "noise" else
              mock.patch.object(prun, "sample_actions", greedy_actions)):
            if steps is None:
                fn = make_sharded_selfplay(env, cfg, eval_fn, mesh)
            else:
                fn = make_sharded_selfplay_continuous(env, cfg, eval_fn,
                                                      mesh, steps)
            local = fn(None, SELFPLAY_SEED)
        out[f"selfplay_{name}"] = records_numpy(
            gather_trajectories(local, mesh))
        out[f"selfplay_{name}_local"] = records_numpy(local)

    model = AZModel(**NET, device="cpu")
    xs, pis, zs = train_data()
    epoch = make_sharded_train_epoch(model.cfg, model.tx, mesh)
    out["train"] = state_numpy(*epoch(model.params, model.batch_stats,
                                      model.opt_state, xs, pis, zs))
    half = TRAIN_BATCH // world
    sl = slice(rank * half, (rank + 1) * half)
    out["train_local"] = state_numpy(*epoch(
        model.params, model.batch_stats, model.opt_state, xs[:, sl],
        pis[:, sl], zs[:, sl], local=True))
    states, rpis, rzs, idx = ring_data()
    gather = make_sharded_gather_epoch(model.cfg, model.tx, mesh)
    out["gather"] = state_numpy(*gather(
        model.params, model.batch_stats, model.opt_state,
        torch.from_numpy(states), torch.from_numpy(rpis),
        torch.from_numpy(rzs), torch.from_numpy(idx),
        torch.ones(3)))

    arena = make_sharded_arena(env, MCTSConfig(n_simulations=4,
                                               add_noise=False),
                               table.torch_fn(0), mesh)
    out["arena"] = arena(None, None, ARENA_GAMES, ARENA_SEED).numpy()
    local_len = 10 + 7 * rank
    out["buffer_len"] = (global_buffer_len(local_len),
                         min_local_buffer_len(local_len))
    # the ranks counted on one card (the key only: nothing runs on it), and
    # on a card each
    out["ranks_per_device"] = tuple(
        ranks_per_device(dataclasses.replace(
            mesh, device=torch.device("cuda", index)))
        for index in (0, rank))
    return out


LOOP_MODES = {
    "replicated": dict(replay_sharding="replicated"),
    "per_host": dict(replay_sharding="per_host"),
    "continuous": dict(selfplay_mode="continuous", selfplay_steps=10,
                       selfplay_max_moves=8),
    # a batch the two ranks do not divide: the replicated epoch unsharded
    "odd_batch": dict(replay_sharding="replicated", batch_size=15),
}


def scenario_loops(rank: int, world: int):
    """``train_alphazero(mesh="auto")`` at 7x7 on a 1x8 net in each of
    ``LOOP_MODES``; each rank writes into ``<mode>/proc<rank>``, standing
    for what it would have written to a shared file system."""
    from alphazero_gomoku_tpu_torch.selfplay import train_alphazero

    out = {}
    for mode, kw in LOOP_MODES.items():
        kw = dict(dict(batch_size=16), **kw)
        hist = train_alphazero(
            game_name="gomoku", board_size=SIZE, num_iterations=1,
            games_per_iteration=6, n_simulations=8, buffer_size=512,
            epochs_per_iter=1, temp_threshold=4,
            eval_games=4, eval_mcts_simulations=8, n_res_blocks=1,
            channels=8, model_dir=f"{mode}/proc{rank}", seed=3,
            verbose=False, mesh="auto", device="cpu", **kw)
        out[mode] = {k: hist[0][k] for k in ("loss", "win_rate", "moves",
                                             "buffer_size", "winners")}
    return out


SCENARIOS = {"parallel": scenario_parallel, "loops": scenario_loops}


def main(argv):
    scenario, rank, world, port, outdir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from alphazero_gomoku_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        out = SCENARIOS[scenario](rank, world)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, Path(outdir) / f"{scenario}_{rank}.pt")
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

