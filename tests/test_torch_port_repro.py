"""The port's envelope probes (``alphazero_gomoku_tpu_torch/repro/``) against
the JAX package and the JAX repo's ``repro/`` scripts, on the CPU.

  - Each probe's grid and configs are the JAX script's (the scripts are
    loaded by path: ``repro/`` is not a package).
  - ``probe_kernels`` on the plain ops gives the final tree of the JAX
    ``KERNELS`` loop (``select_walk`` / ``backup_paths`` in interpret mode)
    on the same draws, bit for bit.
  - ``probe_selfplay``'s records are the JAX packed search's, ply by ply:
    at depth cap 2 on 7x7 under both FPU modes (capped walks counted), and
    over whole games on 5x5, where some games fill the board (pi, actions,
    ``active``, winners).  The eval is ``TableEval``, bit-exact in both
    frameworks, and root noise is gated off (the JAX search draws its own).
  - The host replay rejects planted faults, and the ``match`` flag goes
    false when one side's backup perturbs one visit count.

All comparisons are bit for bit.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.ops import tree_kernels as jtk
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    run_mcts_packed as jax_packed,
)
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.repro import (
    bisect_batch512,
    bisect_lockstep,
    envelope as ev,
    parent_longrun,
    parent_probe,
)

from torch_port_util import TableEval, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_repro_{name}", ROOT / "repro" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(name):
    return (ROOT / "repro" / f"{name}.py").read_text()


def _jax_argv(argv):
    """A JAX grid row's argv as the port's: numbers as ints, int8 as the
    port's int8 tower path."""
    return tuple(int(x) if x.isdigit() else ("int8t" if x == "int8" else x)
                 for x in argv)


def _check_batch512():
    jax_grid = _jax_script("bisect_batch512_fault").GRID
    assert all(env == {} for _, _, env in jax_grid)
    assert bisect_batch512.GRID[:len(jax_grid)] == tuple(
        (probe, _jax_argv(argv)) for probe, argv, _ in jax_grid)
    # the README's round-2 rows at 1024 lanes
    assert bisect_batch512.GRID[len(jax_grid):] == (
        ("selfplay", (1024, 400, 24, "f32")), ("kernels", (1024, 400, 408)))
    src = _source("bisect_batch512_fault")
    assert "n_res_blocks=6, channels=128, seed=0" in src
    assert "jax.random.PRNGKey(5)" in src
    assert (bisect_batch512.BLOCKS, bisect_batch512.CHANNELS,
            bisect_batch512.NET_SEED, bisect_batch512.RUN_SEED) == (
                6, 128, 0, 5)
    assert "select_walk(packed, layout, 1.0, 56" in src


def _check_lockstep():
    assert bisect_lockstep.GRID == tuple(
        _jax_script("bisect_lockstep_fault").GRID)
    src = _source("bisect_lockstep_fault")
    assert "n_res_blocks=6, channels=128, seed=0" in src
    assert "jax.random.PRNGKey(5)" in src and "max_depth=56" in src
    assert (bisect_lockstep.NET_SEED, bisect_lockstep.RUN_SEED) == (0, 5)


def _check_parent_probe():
    assert parent_probe.CONFIGS == tuple(
        _jax_script("parent_pallas_probe").CONFIGS)
    src = _source("parent_pallas_probe")
    assert "n_res_blocks=2, channels=32, seed=5" in src
    assert "batch_games=128" in src and "n_simulations=200" in src
    assert "jax.random.PRNGKey(11)" in src
    assert (parent_probe.BLOCKS, parent_probe.CHANNELS,
            parent_probe.NET_SEED, parent_probe.RUN_SEED,
            parent_probe.BATCH, parent_probe.SIMS) == (2, 32, 5, 11, 128, 200)
    for kind, cap, _ in parent_probe.CONFIGS:
        cfg = parent_probe.row_config(kind, cap, 24)
        assert (cfg.mcts.fpu_mode, cfg.mcts.max_depth) == (kind, cap)
    # each row the probe relies on for the capped branch is one of its rows
    rows = {(k, c) for k, c, _ in parent_probe.CONFIGS + parent_probe.EXTRA}
    assert set(parent_probe.MUST_CAP) <= rows


def _check_longrun():
    src = _source("parent_pallas_longrun")
    for needle in ("n_res_blocks=6, channels=128, seed=5",
                   "batch_games=128", "max_moves=225", "n_simulations=200",
                   "max_depth=56", 'fpu_mode="parent"',
                   "jax.random.PRNGKey(1000 + i)", "else 10"):
        assert needle in src, needle
    assert (parent_longrun.BATCH, parent_longrun.MOVES, parent_longrun.SIMS,
            parent_longrun.CAP, parent_longrun.BLOCKS,
            parent_longrun.CHANNELS, parent_longrun.NET_SEED,
            parent_longrun.SEED_BASE, parent_longrun.N_BATCHES) == (
                128, 225, 200, 56, 6, 128, 5, 1000, 10)


@pytest.mark.parametrize("check", [_check_batch512, _check_lockstep,
                                   _check_parent_probe, _check_longrun],
                         ids=["batch512", "lockstep", "parent_probe",
                              "longrun"])
def test_grids_and_configs_are_the_jax_scripts(check):
    check()


def test_selfplay_config_is_the_jax_scripts():
    cfg = ev.selfplay_config(512, 400, 48)
    m = cfg.mcts
    assert (cfg.batch_games, cfg.temp_threshold, cfg.max_moves) == (
        512, 10, 48)
    assert (m.n_simulations, m.cpuct, m.add_noise, m.dirichlet_alpha,
            m.dirichlet_epsilon, m.dirichlet_moves, m.max_depth,
            m.fpu_mode) == (400, 1.0, True, 0.05, 0.15, 10, 56, "zero")
    gumbel = parent_probe.row_config("gumbel", 8, 24).mcts
    assert (gumbel.search, gumbel.n_simulations, gumbel.gumbel_max_considered,
            gumbel.max_depth) == ("gumbel", 64, 16, 8)
    kleaf = parent_probe.row_config("kleaf4", 8, 24).mcts
    assert (kleaf.leaves_per_sim, kleaf.fpu_mode, kleaf.max_depth) == (
        4, "parent", 8)


def _jax_kernels_loop(b, sims, nodes, a, seed):
    """The JAX ``KERNELS`` loop in interpret mode: its final tree and the
    draws it made."""
    layout = jtk.packed_layout(a, nodes)
    key = jax.random.PRNGKey(seed)
    packed = jnp.zeros((b, layout.n_nodes * 8, layout.seg), jnp.float32)
    packed = packed.at[:, 3::8, :].set(-1.0)
    root = jax.nn.softmax(jax.random.normal(key, (b, a)))
    packed = packed.at[:, 2, :a].set(root)

    @jax.jit
    def one(packed, k, slot):
        leaf, action, pn, pa, plen = jtk.select_walk(packed, layout, 1.0, 56,
                                                     interpret=True)
        vals = jax.random.uniform(k, (b,), minval=-1.0, maxval=1.0)
        pri = jax.nn.softmax(jax.random.normal(k, (b, a)))
        packed = jtk.backup_paths(
            packed, pn, pa, plen, vals, (action >= 0).astype(jnp.int32),
            slot, layout, signed_priors=pri, done=jnp.zeros((b,), jnp.float32),
            interpret=True)
        return packed, vals, pri

    rng, values, priors = key, [], []
    for slot in range(1, sims + 1):
        rng, k = jax.random.split(rng)
        packed, vals, pri = one(packed, k, jnp.int32(slot))
        values.append(np.asarray(vals))
        priors.append(np.asarray(pri))
    return (np.asarray(packed),
            (np.asarray(root), np.stack(values), np.stack(priors)))


def test_probe_kernels_equals_the_jax_kernels_loop():
    b, sims, nodes, a = 8, 16, 24, 225
    want, draws = _jax_kernels_loop(b, sims, nodes, a, seed=0)
    run = ev.probe_kernels(b, sims, nodes, draws=draws, device="cpu")
    assert run.line["ok"] and run.line["match"]
    assert run.line["root_visits"] == b * sims
    for name, tree in run.outputs.items():
        np.testing.assert_array_equal(tree.numpy(), want, err_msg=name)


def _jax_search(jenv, kw, eval_fn):
    jcfg = JaxMCTSConfig(backend="pallas", **kw)
    return jax.jit(lambda s, m: jax_packed(
        jenv, jcfg, eval_fn, None, s, m, jax.random.PRNGKey(0),
        interpret=True))


def _replay_with_jax(traj, size, kw, te, temp_threshold):
    """Hold a port run's records against the JAX package ply by ply: the
    JAX packed search on the port's states gives its pi, the JAX step on its
    actions its next boards and ``active`` flags, greedy plies take the
    argmax of JAX's pi, and the games end with JAX's winners."""
    jenv = JaxEnv(size)
    search = _jax_search(jenv, kw, te.jax)
    step = jax.jit(jax.vmap(jenv.step_safe))
    plies = int(traj.moves_played.max())
    batch = traj.moves_played.shape[0]
    states = jenv.init_batch(batch)
    for t in range(plies):
        np.testing.assert_array_equal(np.asarray(states.board),
                                      traj.boards[t].numpy(), f"ply {t}")
        np.testing.assert_array_equal(~np.asarray(states.done),
                                      traj.active[t].numpy(), f"ply {t}")
        pi, _ = search(states, jnp.full((batch,), t, jnp.int32))
        pi = np.asarray(pi)
        np.testing.assert_array_equal(pi, traj.pis[t].numpy(),
                                      err_msg=f"ply {t}")
        live = ~np.asarray(states.done)
        acts = traj.actions[t].numpy()
        if t >= temp_threshold:
            np.testing.assert_array_equal(acts[live],
                                          pi.argmax(axis=1)[live])
        states = step(states, jnp.asarray(acts))
    np.testing.assert_array_equal(np.asarray(states.winner),
                                  traj.winners.numpy())
    np.testing.assert_array_equal(np.asarray(states.move_count),
                                  traj.moves_played.numpy())
    return np.asarray(states.done)


def _gated(cfg, temp=2):
    """A probe's config with root noise gated off (the JAX search draws its
    own) and greedy moves from ply ``temp``."""
    return dataclasses.replace(
        cfg, temp_threshold=temp,
        mcts=dataclasses.replace(cfg.mcts, dirichlet_moves=0))


def _port_run(size, batch, sims, moves, cap, fpu, te, seed):
    env = make_env("gomoku", size)
    cfg = _gated(ev.selfplay_config(batch, sims, moves, max_depth=cap,
                                    fpu_mode=fpu))
    sides = {"pallas": (te.torch, tk.KERNELS), "xla": (te.torch, tk.PLAIN)}
    return cfg, ev.probe_selfplay(env, cfg, sides, None, seed, device="cpu")


def _jax_kw(cfg):
    m = cfg.mcts
    return dict(n_simulations=m.n_simulations, cpuct=m.cpuct, add_noise=True,
                dirichlet_alpha=m.dirichlet_alpha,
                dirichlet_epsilon=m.dirichlet_epsilon, dirichlet_moves=0,
                max_depth=m.max_depth, fpu_mode=m.fpu_mode)


@pytest.mark.parametrize("fpu", ["zero", "parent"])
def test_probe_selfplay_at_cap_2_matches_jax(fpu):
    size, moves = 7, 6
    te = TableEval(size, seed=3)
    cfg, run = _port_run(size, 8, 16, moves, 2, fpu, te, seed=1)
    line = run.line
    assert line["ok"] and line["match"] and line["compared_plies"] == moves
    assert line["capped_walks"] > 0 and line["deepest_path"] == 2
    _replay_with_jax(run.outputs["pallas"], size, _jax_kw(cfg), te,
                     cfg.temp_threshold)


def test_probe_selfplay_whole_games_match_jax():
    """5x5 games to their end: some are won, some fill the board, and the
    lanes whose game ended go on being searched (on a done root) until all
    have."""
    size = 5
    te = TableEval(size, seed=4)
    cfg, run = _port_run(size, 8, 8, size * size, 56, "parent", te, seed=2)
    line = run.line
    assert line["ok"] and line["match"], line
    assert line["won"] > 0 and line["full_board"] > 0
    assert line["running"] == 0 and line["done_root_plies"] > 0
    assert line["done_root_walks"] == line["done_root_plies"] * 8
    done = _replay_with_jax(run.outputs["pallas"], size, _jax_kw(cfg), te,
                            cfg.temp_threshold)
    assert done.all()


@pytest.fixture(scope="module")
def small_run():
    te = TableEval(5, seed=4)
    return _port_run(5, 8, 8, 25, 56, "parent", te, seed=2)[1]


def _plant(traj, fault):
    fields = {k: v.clone() for k, v in traj._asdict().items()}
    lane = 0
    n = int(fields["moves_played"][lane])
    if fault == "winner":
        fields["winners"][lane] = 3 - fields["winners"][lane] \
            if fields["winners"][lane] else 1
    elif fault == "length":
        fields["moves_played"][lane] = n - 1
    elif fault == "board":
        fields["boards"][n // 2, lane, 0, 0] = 3
    else:
        fields["actions"][n // 2, lane] = fields["actions"][0, lane]
    return type(traj)(**fields)


@pytest.mark.parametrize("fault", ["winner", "length", "board", "action"])
def test_host_replay_rejects_a_planted_fault(small_run, fault):
    traj = small_run.outputs["pallas"]
    assert ev.replay_games(traj) == []
    errors = ev.replay_games(_plant(traj, fault))
    assert errors and all(e.startswith("game 0:") for e in errors), errors


class _PerturbedBackup:
    """``backup_paths_plain`` with one visit count moved by one on its
    ``at``-th call (root node, the first lane's first path action)."""

    def __init__(self, at):
        self.at, self.calls = at, 0

    def __call__(self, packed, path_nodes, path_actions, *args, **kwargs):
        out = tk.backup_paths_plain(packed, path_nodes, path_actions, *args,
                                    **kwargs)
        self.calls += 1
        if self.calls == self.at:
            act = max(int(path_actions[0, 0]), 0)
            packed[0, tk.SL_N, act] += 1.0
        return out


@pytest.mark.parametrize("probe", ["selfplay", "kernels"])
def test_match_flag_catches_one_perturbed_visit(probe):
    bad = tk.PLAIN._replace(backup_paths=_PerturbedBackup(at=5))
    if probe == "kernels":
        run = ev.probe_kernels(8, 16, 24,
                               sides={"pallas": tk.KERNELS, "xla": bad},
                               device="cpu")
        assert run.line["match"] is False and not run.line["ok"]
        assert run.line["max_abs_diff"] >= 1.0
        good = ev.probe_kernels(8, 16, 24, device="cpu")
        assert good.line["match"] is True
        return
    te = TableEval(7, seed=3)
    env = make_env("gomoku", 7)
    cfg = _gated(ev.selfplay_config(8, 16, 3))
    sides = {"pallas": (te.torch, tk.KERNELS), "xla": (te.torch, bad)}
    run = ev.probe_selfplay(env, cfg, sides, None, 1, device="cpu")
    assert run.line["match"] is False and not run.line["ok"]
    assert "xla.pis" in run.line["mismatch"]
    sides["xla"] = (te.torch, tk.PLAIN)
    assert ev.probe_selfplay(env, cfg, sides, None, 1,
                             device="cpu").line["match"] is True


def test_compare_over_the_first_plies_of_a_longer_run():
    """A run cut at ``compared_plies`` equals the first plies of the full
    run: the records, and each game's length and winner as far as the cut
    reaches."""
    te = TableEval(5, seed=4)
    env = make_env("gomoku", 5)
    cfg = _gated(ev.selfplay_config(8, 8, 25, fpu_mode="parent"))
    sides = {"pallas": (te.torch, tk.KERNELS), "xla": (te.torch, tk.PLAIN)}
    run = ev.probe_selfplay(env, cfg, sides, None, 2, compared_plies=9,
                            device="cpu")
    assert run.line["match"] and run.line["compared_plies"] == 9
    assert run.outputs["xla"].boards.shape[0] == 9
    with pytest.raises(ValueError):
        ev.compare(run.outputs["pallas"], run.outputs["xla"], 10)


def test_run_one_reports_a_failed_config():
    line = ev.run_one("bisect_lockstep", (4, 4), 120, device="cpu")
    assert line["ok"] is False and line["rc"] == 2
    line = ev.run_one("bisect_lockstep", (4, 4, 2), 300, device="cpu")
    assert line["ok"] and line["match"] and line["probe"] == "lockstep"


def test_parent_probe_rows_cap_walks_on_the_cpu():
    """The rows that must cap do, on a small batch of the probe's own net:
    parent FPU at cap 8, and zero FPU and Gumbel at cap 1."""
    for kind, cap in (("parent", 8), ("zero", 1), ("gumbel", 1)):
        line = parent_probe.probe(kind, cap, 1, batch=2, device="cpu")
        assert line["ok"] and line["match"] and line["capped_walks"] > 0, (
            kind, cap, line)


def test_longrun_prints_each_batch_and_done(capsys):
    lines = parent_longrun.longrun(2, batch=2, sims=2, blocks=1, channels=8,
                                   device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("DONE parent@cap56 longrun: ")
    assert [ln.split(":")[0] for ln in out if ln.startswith("batch")] == [
        "batch 0", "batch 1"]
    assert lines[0]["match"] is True and lines[1]["match"] is None
    assert all(line["ok"] for line in lines)


def test_batch512_int8t_rows_compare_their_first_plies():
    line = bisect_batch512.selfplay(2, 2, 18, "int8t", device="cpu")
    assert line["ok"] and line["match"]
    assert line["compared_plies"] == bisect_batch512.PLAIN_PLIES["int8t"]
    assert line["plies"] == 18
    line = bisect_batch512.selfplay(2, 2, 3, "f32", device="cpu")
    assert line["ok"] and line["compared_plies"] == 3
