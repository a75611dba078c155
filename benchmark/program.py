"""The system under test: lockstep self-play of ``alphazero_gomoku_tpu_torch``.

The only module of the benchmark that imports the program.  It builds the
game, the net (:func:`net_config` of the configuration file, in the
inference mode its ``precision`` names: ``models.make_inference``) and
the self-play settings of a cell, and calls ``selfplay.runner.play_games``,
the entry the window drives.  For the traced run, :class:`Probe` hands the
program wrapped objects (the eval function, a ``TreeOps`` of wrapped
kernels and a proxy of the env) that open the ``bench.*`` ranges
``trace.py`` attributes by, and starts and stops the profiler around one
ply of the first call.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the env's methods that compute on the device (the rest are attributes)
ENV_METHODS = ("init_batch", "legal_mask", "step", "step_safe", "encode",
               "terminal_value")


class Probe:
    """The traced run's counters, ranges and profiler.

    The slice starts when the first call's ply ``ply`` begins (after the
    previous ply's ``step_safe``) and stops when that ply's ``step_safe``
    returns; each boundary synchronizes the card first, so that the slice
    holds its own device work and no other."""

    def __init__(self, ply: int):
        if ply < 1:
            raise ValueError("the traced ply must be 1 or later")
        self.ply = ply
        self.steps = 0
        self.armed = True
        self.prof = None
        self.slice_range = None
        self.walks = 0
        self.net_calls = []

    @property
    def on(self) -> bool:
        return self.slice_range is not None

    def _start(self):
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.slice_range = record_function("bench.slice")
        self.slice_range.__enter__()

    def stop(self):
        if self.on:
            torch.cuda.synchronize()
            self.slice_range.__exit__(None, None, None)
            self.slice_range = None
            self.prof.stop()
            self.armed = False

    def ply_done(self):
        if not self.armed:
            return
        self.steps += 1
        if self.steps == self.ply:
            self._start()
        elif self.steps == self.ply + 1:
            self.stop()

    def ranged(self, layer: str, fn, walk: bool = False):
        name = "bench." + layer

        def call(*args, **kwargs):
            if walk and self.on:
                self.walks += 1
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    def eval_fn(self, fn):
        ranged = self.ranged("net", fn)

        def call(net, obs):
            if self.on:
                self.net_calls.append(int(obs.shape[0]))
            return ranged(net, obs)
        return call


class _RangedEnv:
    """The env with its device methods inside ``bench.game`` ranges;
    ``step_safe`` (once a ply in ``play_games``) also marks the ply."""

    def __init__(self, env, probe: Probe):
        self._env = env
        self._probe = probe
        self._wrapped = {}

    def __getattr__(self, name):
        attr = getattr(self._env, name)
        if name not in ENV_METHODS:
            return attr
        if name not in self._wrapped:
            ranged = self._probe.ranged("game", attr)
            if name == "step_safe":
                def stepped(*args, _f=ranged, **kwargs):
                    out = _f(*args, **kwargs)
                    self._probe.ply_done()
                    return out
                self._wrapped[name] = stepped
            else:
                self._wrapped[name] = ranged
        return self._wrapped[name]


def net_config(config: Dict):
    """The program's net configuration of a configuration file: the port's
    ``models.net_config_of(config)`` where the port has one; else its
    residual tower's ``NetConfig``, the one architecture (``resnet``) such
    a port runs, of the shape keys that ``benchmark/nets/resnet.py``
    lists."""
    from alphazero_gomoku_tpu_torch import models

    from benchmark import spec
    if hasattr(models, "net_config_of"):
        return models.net_config_of(config)
    if spec.arch(config) != "resnet":
        raise ValueError(f"architecture {spec.arch(config)!r}: the program "
                         "runs ['resnet']")
    size = config["board_size"]
    return models.NetConfig(board_size=size, action_size=size * size,
                            in_channels=config["in_channels"],
                            **{k: config[k] for k in spec.net("resnet").KEYS})


class Program:
    """A cell's self-play on the card: ``play(generator)`` runs one call."""

    def __init__(self, config: Dict, traffic: Dict, params, stats, calib,
                 device):
        from alphazero_gomoku_tpu_torch.games import make_env
        from alphazero_gomoku_tpu_torch.models import make_inference
        from alphazero_gomoku_tpu_torch.ops.tree_kernels import KERNELS
        from alphazero_gomoku_tpu_torch.search.tree import MCTSConfig
        from alphazero_gomoku_tpu_torch.selfplay.runner import (
            SelfPlayConfig,
            play_games,
        )
        self._play_games = play_games
        self._kernels = KERNELS
        self.device = device
        size = config["board_size"]
        self.env = make_env(config["game"], size,
                            capture_planes=config["in_channels"] == 5)
        self.eval_fn, self.bundle = make_inference(
            config["precision"], net_config(config), params, stats,
            device=device, calib_obs=calib)
        s = traffic["search"]
        mcts = MCTSConfig(
            n_simulations=s["n_simulations"], cpuct=s["cpuct"],
            dirichlet_alpha=s["dirichlet_alpha"],
            dirichlet_epsilon=s["dirichlet_epsilon"],
            dirichlet_moves=s["dirichlet_moves"], add_noise=s["add_noise"],
            max_depth=s["max_depth"], fpu_mode="zero",
            reuse_budget=s["reuse_budget"], search=s["kind"],
            gumbel_max_considered=s["gumbel_max_considered"],
            gumbel_c_visit=s["gumbel_c_visit"],
            gumbel_c_scale=s["gumbel_c_scale"])
        self.plies = traffic["plies_per_call"]
        self.cfg = SelfPlayConfig(
            batch_games=traffic["lanes"], mcts=mcts,
            temp_threshold=traffic["temp_threshold"], max_moves=self.plies,
            opening_random_moves=traffic["opening_random_moves"])
        self._cfg_of = {}

    def _with_plies(self, plies: int):
        if plies not in self._cfg_of:
            import dataclasses
            self._cfg_of[plies] = dataclasses.replace(self.cfg,
                                                      max_moves=plies)
        return self._cfg_of[plies]

    def play(self, generator: torch.Generator, plies: Optional[int] = None,
             probe: Optional[Probe] = None):
        """One call of ``play_games`` from empty boards; returns its
        trajectories (on the card, not synchronized)."""
        cfg = self._with_plies(plies or self.plies)
        if probe is None:
            return self._play_games(self.env, cfg, self.eval_fn, self.bundle,
                                    generator, self.device,
                                    ops=self._kernels)
        k = self._kernels
        ops = type(k)(probe.ranged("tree", k.select_walk, walk=True),
                      probe.ranged("tree", k.backup_paths),
                      probe.ranged("tree", k.gumbel_select_walk, walk=True))
        return self._play_games(_RangedEnv(self.env, probe), cfg,
                                probe.eval_fn(self.eval_fn), self.bundle,
                                generator, self.device, ops=ops)

    def free(self):
        """Drop the net: the reference runs after it."""
        self.eval_fn = self.bundle = None


def records(traj) -> Dict[str, torch.Tensor]:
    """A call's trajectories as the plain dict the reference reads."""
    return {"boards": traj.boards, "players": traj.players,
            "captures": traj.captures, "pis": traj.pis,
            "root_qs": traj.root_qs, "actions": traj.actions,
            "active": traj.active, "winners": traj.winners,
            "moves_played": traj.moves_played}
