"""The port's microbenchmarks and device probes
(``alphazero_gomoku_tpu_torch/tools/``: ``tree_kernel_microbench``,
``search_cost_split``, ``hbm_budget``, ``net_microbench``, ``int8_probe``,
``device_parity``, ``gumbel_determinism_probe``, ``gumbel_flip_probe``) on
the CPU, against the JAX repo's root ``tools/`` where a CPU run of both can
be compared (loaded by path: ``tools/`` is not a package).

What they time needs the card: here they run with the plain versions (a
kernel wrapper given a CPU tensor runs its plain version), which is what
their CPU runs can show: the same inputs and shapes as the JAX tools, the
same keys, and the same answers where both compute exactly.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_gomoku_tpu.selfplay.runner as jrunner
from alphazero_gomoku_tpu.games import make_env as jax_make_env
from alphazero_gomoku_tpu.models import AZModel as JaxModel
from alphazero_gomoku_tpu.ops import tree_kernels as jtk
from alphazero_gomoku_tpu.search import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search import run_mcts as jax_run_mcts
from alphazero_gomoku_tpu.search.tree_pallas import _init_packed
from alphazero_gomoku_tpu.selfplay import SelfPlayConfig as JaxSelfPlay
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_search
from alphazero_gomoku_tpu_torch.tools import (
    device_parity,
    gumbel_determinism_probe,
    gumbel_flip_probe,
    hbm_budget,
    int8_probe,
    search_cost_split,
    tree_kernel_microbench as tkm,
)

from torch_port_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def run_main(main, argv, capsys, **kw):
    assert main(argv, **kw) in (0, None)
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


# ----------------------------------------------------------------------
# tree_kernel_microbench
# ----------------------------------------------------------------------
@pytest.mark.parametrize("depth", [4, 24])
def test_chain_tree_equals_the_jax_tools_tree(depth):
    """Node for node: the port's packed tree is the JAX layout
    (``[B, n_nodes * GROUP, seg]``, a node's rows N, W, P, C, meta)."""
    b, n_nodes = 3, 40
    want = load_jax_tool("tree_kernel_microbench").build_chain_tree(
        b, depth, jtk.packed_layout(225, n_nodes))
    got = tkm.build_chain_tree(b, depth, tk.packed_layout(225, n_nodes))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [4, 24])
def test_chain_walk_and_backup_follow_the_chain(depth):
    """The plain walk takes ``depth`` hops and stops at node ``depth`` on
    its unexpanded action 0 (its path the chain's ``depth + 1`` edges); the
    plain backup of the tool's path adds one visit and the value, sign by
    hop, to each of the ``depth`` edges, and links the last one to the
    slot."""
    b, n_nodes = 3, 40
    layout = tk.packed_layout(tkm.ACTIONS, n_nodes)
    packed = tkm.build_chain_tree(b, depth, layout)
    leaf, action, pnodes, pacts, plen = tk.select_walk(
        packed, layout, 1.0, tkm.DEPTH_LIMIT)
    assert leaf.tolist() == [depth] * b and action.tolist() == [0] * b
    assert plen.tolist() == [depth + 1] * b
    hops = torch.arange(tkm.DEPTH_LIMIT)[:, None].expand(-1, b)
    np.testing.assert_array_equal(
        pnodes.numpy(), torch.where(hops <= depth, hops, -1).numpy())

    before = tk.node_tiles(packed, layout).clone()
    args = tkm.chain_backup_args(b, depth, tkm.DEPTH_LIMIT, layout)
    tiles = tk.node_tiles(tk.backup_paths(packed, *args), layout)
    n, w, c = (tiles[:, :, row, 0] for row in (tk.SL_N, tk.SL_W, tk.SL_C))
    assert (n[:, :depth] == 2).all() and (n[:, depth] == 1).all()
    sign = torch.where((depth - torch.arange(depth)) % 2 == 1, -1.0, 1.0)
    assert torch.equal(w[:, :depth], before[:, :depth, tk.SL_W, 0]
                       + 0.25 * sign)
    assert (c[:, depth - 1] == depth + 1).all()
    assert torch.equal(c[:, :depth - 1], before[:, :depth - 1, tk.SL_C, 0])


def test_microbench_fit_recovers_a_line():
    lo = {"batch": 8, "depth": 4, "select_ms": 0.003 + 4 * 0.0005,
          "backup_ms": 0.002 + 4 * 0.0001}
    hi = {"batch": 8, "depth": 24, "select_ms": 0.003 + 24 * 0.0005,
          "backup_ms": 0.002 + 24 * 0.0001}
    f = tkm.fit(lo, hi)
    assert f["depths"] == [4, 24] and f["batch"] == 8
    for key, want in (("select_hop_ms", 0.0005), ("select_launch_ms", 0.003),
                      ("backup_hop_ms", 0.0001), ("backup_launch_ms", 0.002)):
        assert f[key] == pytest.approx(want, rel=1e-9)


# ----------------------------------------------------------------------
# search_cost_split
# ----------------------------------------------------------------------
def test_search_cost_split_keys_and_null_net_follow_the_jax_tool(
        monkeypatch, capsys):
    """One line a batch with the JAX tool's keys (and the port's
    ``infer``, ``backend`` and ``device``); the null networks agree (priors
    exactly uniform, values within one float32 ulp) and a search on them
    gives the same pi in both packages (15x15: the JAX tool's null net is
    made for its 225 actions)."""
    argv = ["--batches", "2", "--moves", "1", "--sims", "4", "--blocks", "1",
            "--channels", "32"]
    evals = []
    real = jrunner.play_games

    def record(env, cfg, eval_fn, *args, **kw):
        evals.append(eval_fn)
        return real(env, cfg, eval_fn, *args, **kw)

    monkeypatch.setattr(jrunner, "play_games", record)
    [want] = run_main(load_jax_tool("search_cost_split").main,
                      argv + ["--backend", "xla"], capsys)
    [got] = run_main(search_cost_split.main, argv, capsys, device="cpu")
    assert set(got) == set(want) | {"infer", "backend", "device"}
    assert (got["batch"], got["sims"]) == (want["batch"], want["sims"])
    assert (got["infer"], got["backend"], got["device"]) == \
        ("int8t", "pallas", "cpu")
    jax_null = evals[-1]

    size, b = 15, 4
    obs = np.random.default_rng(0).integers(0, 2, (b, size, size, 3))
    obs = obs.astype(np.float32)
    jp, jv = jax_null(None, jnp.asarray(obs))
    tp, tv = search_cost_split.null_eval(None, torch.from_numpy(obs))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(jv), maxulp=1)

    # the same search on each package's null net: 12 simulations
    jenv, env = jax_make_env("gomoku", size), make_env("gomoku", size)
    jcfg = JaxMCTSConfig(n_simulations=12, add_noise=False, backend="xla")
    cfg = MCTSConfig(n_simulations=12, add_noise=False)
    # positions 6 random plies in (the tools' own draws, equal in both)
    jstates = load_jax_tool("device_parity").random_states(jenv, b, 6, 1)
    search = jax.jit(jax_run_mcts, static_argnums=(0, 1, 2))
    jpi = search(jenv, jcfg, jax_null, None, jstates,
                 jnp.zeros((b,), jnp.int32), jax.random.PRNGKey(0))
    pi, _, _, _ = run_search(env, cfg, search_cost_split.null_eval, None,
                             device_parity.random_states(env, b, 6, 1, "cpu"),
                             torch.zeros(b, dtype=torch.int32))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))


# ----------------------------------------------------------------------
# hbm_budget
# ----------------------------------------------------------------------
def _nbytes(tree):
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


def test_hbm_budget_reckoning_equals_the_jax_shapes():
    """Each term of the tool's reckoning equals the bytes of the JAX
    package's arrays at the same shape (read without running them): the
    packed trees and their two int32 sidecars, the node-state stack, the
    trajectory records of ``play_games`` (the port's add the played
    actions, int32 ``[T, B]``), and the weights and statistics twice."""
    batch, sims, moves, size, blocks, ch = 4, 6, 3, 9, 1, 16
    r = hbm_budget.reckon(batch, sims, moves, board_size=size,
                          blocks=blocks, channels=ch)
    jenv = jax_make_env("gomoku", size)
    cap = sims + 2
    layout = jtk.packed_layout(jenv.num_actions, cap)
    packed = jax.eval_shape(lambda: _init_packed(batch, layout))
    assert r["tree_bytes"] == _nbytes(packed) + 2 * batch * cap * 4
    nodes = jax.eval_shape(lambda: jenv.init_batch(batch * cap))
    assert r["node_state_bytes"] == _nbytes(nodes)
    jcfg = JaxSelfPlay(batch_games=batch, temp_threshold=10, max_moves=moves,
                       mcts=JaxMCTSConfig(n_simulations=sims, max_depth=56,
                                          backend="xla"))
    model = JaxModel(board_size=size, n_res_blocks=blocks, channels=ch)

    def null(params, obs):
        a = obs.shape[1] * obs.shape[2]
        return (jnp.full((obs.shape[0], a), 1.0 / a),
                jnp.zeros((obs.shape[0], 1)))

    traj = jax.eval_shape(lambda key: jrunner.play_games(
        jenv, jcfg, null, None, key), jax.random.PRNGKey(0))
    assert r["record_bytes"] == _nbytes(traj) + moves * batch * 4
    assert r["weight_bytes"] == 2 * _nbytes((model.params,
                                             model.batch_stats))


# ----------------------------------------------------------------------
# int8_probe
# ----------------------------------------------------------------------
def test_int8_probe_conv_is_the_exact_int8_conv():
    """The int8 conv of the probe's chain: an exact integer 3x3 SAME conv
    (im2col and ``torch._int_mm``), then ``y / 127`` clipped and cast as
    the JAX probe's requant; against float64 sums in numpy."""
    rng = np.random.default_rng(0)
    b, s, c = 2, 5, 16
    x = rng.integers(-127, 128, (b, s, s, c)).astype(np.int8)
    w = rng.integers(-127, 128, (9 * c, c)).astype(np.int8)
    got = int8_probe.conv(torch.from_numpy(x),
                          torch.from_numpy(w).t().contiguous().t())
    pad = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((b, s, s, c))
    for k in range(9):
        dy, dx = divmod(k, 3)
        acc += pad[:, dy:dy + s, dx:dx + s, :] @ w[k * c:(k + 1) * c]
    want = np.clip((acc.astype(np.float32) * np.float32(1 / 127)), -127,
                   127).astype(np.int8)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# device_parity, gumbel_determinism_probe, gumbel_flip_probe
# ----------------------------------------------------------------------
@pytest.mark.parametrize("plies,seed", [(4, 4), (24, 24)])
def test_random_states_equal_the_jax_tools(plies, seed):
    """The probes' positions: the same numpy draws give the JAX tools'
    boards, players and flags."""
    want = load_jax_tool("device_parity").random_states(
        jax_make_env("gomoku", 9), 6, plies, seed)
    got = device_parity.random_states(make_env("gomoku", 9), 6, plies, seed,
                                      "cpu")
    for name in ("board", "to_move", "move_count", "winner", "done"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_device_parity_grid_runs_equal_on_the_cpu(capsys):
    """The grid's four configs at 9x9 (both sides run the plain versions
    on the CPU): every line equal, exit 0."""
    lines = run_main(device_parity.main,
                     ["--batch", "8", "--sims", "16", "--size", "9"], capsys,
                     device="cpu")
    assert [r.get("config") for r in lines[:-1]] == \
        ["puct", "puct_deep", "kleaf4", "gumbel"]
    assert all(r["pi_exact"] and r["q_max_abs_diff"] == 0.0
               for r in lines[:-1])
    assert lines[-1] == {"device": "cpu", "all_ok": True}


def test_gumbel_determinism_probe_repeats_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(gumbel_determinism_probe, "SIZE", 9)
    monkeypatch.setattr(gumbel_determinism_probe, "BATCH", 8)
    monkeypatch.setattr(gumbel_determinism_probe, "GUMBEL_SIMS", 16)
    [r] = run_main(gumbel_determinism_probe.main, ["3"], capsys,
                   device="cpu")
    assert r["kernels_deterministic"] and r["plain_deterministic"]
    assert r["kernels_equal_plain"] and r["repeats"] == 3
    assert r["cross_backend_pi_max_diff"] == 0.0


def test_gumbel_flip_probe_keys_and_tally_on_the_cpu(tmp_path, capsys):
    """The JAX tool's summary keys; on the CPU both sides are the plain
    versions, so nothing flips; the arena's games add up."""
    ckpt = str(tmp_path / "net.ckpt")
    AZModel(board_size=15, n_res_blocks=1, channels=64, seed=2,
            device="cpu").save(ckpt)
    lines = run_main(gumbel_flip_probe.main,
                     ["--ckpt", ckpt, "--sims", "8", "--m", "4", "--batch",
                      "6", "--plies", "2", "10", "--arena-games", "2"],
                     capsys, device="cpu")
    per_ply, summary, arena = lines[:2], lines[2], lines[3]
    assert [r["plies"] for r in per_ply] == [2, 10]
    fr = summary["flip_rate_summary"]
    assert set(fr) == {"positions", "argmax_flips", "flip_rate",
                       "pi_delta_p50", "pi_delta_p95", "pi_delta_max",
                       "pi_delta_frac_zero", "q_delta_max",
                       "flip_pi_delta_mean"}
    assert fr["positions"] == 12 and fr["argmax_flips"] == 0
    assert fr["pi_delta_frac_zero"] == 1.0
    ar = arena["cross_backend_arena"]
    assert ar["played"] == 2 and ar["pairs"]["n"] == 1
    assert ar["pairs"]["win_both"] + ar["pairs"]["loss_both"] + \
        ar["pairs"]["split"] == 1
