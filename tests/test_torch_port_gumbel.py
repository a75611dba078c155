"""Parity: the port's Gumbel search against the JAX package's.

The JAX package's packed Gumbel search and its ``gumbel_select_walk`` run in
Pallas interpret mode on the CPU, as ``tests/test_gumbel.py`` runs them.  The
root's Gumbel uniforms are the JAX package's own draw
(``jax.random.uniform(key, (B, A), minval=1e-12, maxval=1.0)``, as
``tree_pallas.py`` makes it), injected into the port.  With the bit-exact
``TableEval`` the searched trees and the played actions must be equal
exactly; ``pi_target`` and ``root_q`` sum over actions in another order in
each framework, so they agree within 1e-5, the tolerance at which the JAX
package holds its packed search against its XLA one
(``tests/test_gumbel.py:188-215``).  The port's walk itself reduces in a
fixed order with its own exp and log (``tree_kernels.exp_f32`` /
``log_f32``); its integer outputs must equal the JAX kernel's.
"""

import dataclasses
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.ops import tree_kernels as jtk
from alphazero_gomoku_tpu.search.gumbel import (
    halving_schedule as jax_halving_schedule,
)
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    run_gumbel_packed as jax_gumbel,
    run_gumbel_packed_with_tree as jax_gumbel_with_tree,
)
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_mcts_with_q
from alphazero_gomoku_tpu_torch.search.gumbel import (
    halving_schedule,
    run_gumbel_mcts,
)
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    run_gumbel_packed,
    run_gumbel_packed_with_tree,
)
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    assert_walk_equal,
    one_torch_thread,
    random_jax_states,
    to_torch_state,
)

SIZE = 9
A = SIZE * SIZE
BATCH = 8
TOL = 1e-5


def _kw(sims, m, **extra):
    return dict(n_simulations=sims, search="gumbel", gumbel_max_considered=m,
                add_noise=False, **extra)


def _uniforms(key, b):
    return jax.random.uniform(key, (b, A), jnp.float32, minval=1e-12,
                              maxval=1.0)


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_halving_schedule_matches_jax(m):
    for sims in (2, 3, 8, 16, 24, 50, 64, 128, 200, 400):
        assert halving_schedule(sims, m) == jax_halving_schedule(sims, m)
    assert halving_schedule(64, 16) == (16, [(16, 1), (8, 2), (4, 4), (2, 8)])
    with pytest.raises(ValueError):
        halving_schedule(1, m)


# (plies, sims, m, round-parallel, depth cap): a fresh board, mid-game, a
# depth cap that stops walks, and a late board where searches meet terminal
# nodes and finished games
CASES = [(0, 24, 8, False, 0), (6, 24, 8, True, 0), (14, 16, 16, False, 2),
         (60, 24, 8, True, 0)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c}")
def searched(request):
    plies, sims, m, parallel, max_depth = request.param
    te = TableEval(SIZE, seed=plies)
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    js = random_jax_states(jenv, BATCH, plies, seed=plies)
    kw = _kw(sims, m, gumbel_round_parallel=parallel, max_depth=max_depth)
    key = jax.random.PRNGKey(plies)
    jout = jax.jit(lambda s: jax_gumbel_with_tree(
        jenv, JaxMCTSConfig(backend="pallas", **kw), te.jax, None, key,
        root_states=s, interpret=True))(js)
    u = torch.from_numpy(np.array(_uniforms(key, BATCH)))
    *tout, tree = run_gumbel_packed_with_tree(
        env, MCTSConfig(**kw), te.torch, None, to_torch_state(js), uniforms=u)
    tout.append(tree.packed)
    return dict(cfg=MCTSConfig(**kw), env=env, te=te, states=js, u=u,
                jax=[np.array(x) for x in jout[:3]] + [
                    np.array(jout[3].packed)],
                torch=tout)


def test_gumbel_search_matches_jax(searched):
    pj, qj, aj, jpacked = searched["jax"]
    pt, qt, at, packed = searched["torch"]
    np.testing.assert_array_equal(aj, at.numpy())
    np.testing.assert_array_equal(jpacked, packed.numpy())
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=TOL)
    np.testing.assert_allclose(qt.numpy(), qj, rtol=0, atol=TOL)
    legal = GomokuEnv(SIZE).legal_mask(to_torch_state(searched["states"]))
    live = legal.any(dim=1)
    assert legal[live].gather(1, at[live, None].long()).all()
    np.testing.assert_allclose(pt.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_round_parallel_equals_serial(searched):
    """The port's round-parallel search replays its serial search exactly
    (no endgame duplicates on these boards: the JAX package's
    ``test_gumbel_round_parallel_matches_serial_packed``)."""
    cfg = searched["cfg"]
    flip = dataclasses.replace(
        cfg, gumbel_round_parallel=not cfg.gumbel_round_parallel)
    *other, tree = run_gumbel_packed_with_tree(
        searched["env"], flip, searched["te"].torch, None,
        to_torch_state(searched["states"]), uniforms=searched["u"])
    for x, y in zip(searched["torch"], other + [tree.packed]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fan", [1, 4])
def test_gumbel_select_walk_matches_jax(searched, fan):
    cfg = searched["cfg"]
    jpacked = searched["jax"][3]
    depth = cfg.depth_limit
    rng = np.random.default_rng(fan)
    # any root action, legal or not: the walk takes it as given
    root = rng.integers(0, A, BATCH * fan).astype(np.int32)
    jout = jtk.gumbel_select_walk(
        jnp.asarray(jpacked), jnp.asarray(root),
        jtk.packed_layout(A, cfg.node_capacity), depth, cfg.gumbel_c_visit,
        cfg.gumbel_c_scale, interpret=True, fan=fan)
    layout = tk.packed_layout(A, cfg.node_capacity)
    tout = tk.gumbel_select_walk(torch.from_numpy(jpacked),
                                 torch.from_numpy(root), layout, depth,
                                 cfg.gumbel_c_visit, cfg.gumbel_c_scale, fan)
    assert_walk_equal(jout, tout, depth)
    # the wrapper took the plain version: the tensor is on the CPU
    plain = tk.gumbel_select_walk_plain(
        torch.from_numpy(jpacked), torch.from_numpy(root), layout, depth,
        cfg.gumbel_c_visit, cfg.gumbel_c_scale, fan)
    for x, y in zip(tout, plain):
        assert torch.equal(x, y)


def _endgame_states(jenv):
    """A win-in-one board with six empty points, fewer than m: a blocked four
    for player 1 on row 3, the rest filled with a period-4 pattern that has
    no run of three (the JAX package's ``tests/test_gumbel.py`` case, on
    9x9)."""
    r, c = np.mgrid[0:SIZE, 0:SIZE]
    board = np.where((c + 2 * r) % 4 < 2, 1, 2).astype(np.int8)
    board[3] = [2, 1, 1, 1, 1, 0, 0, 2, 1]
    for corner in [(0, 0), (0, 8), (8, 0), (8, 8)]:
        board[corner] = 0
    return jax.vmap(lambda bd: jenv.from_board(bd, 1))(
        jnp.asarray(board[None].repeat(BATCH, 0)))


@pytest.mark.parametrize("parallel", [False, True])
def test_endgame_with_fewer_legal_moves_than_m_matches_jax(parallel):
    """Fewer legal moves than m: illegal candidates fall back to the
    best-ranked action, and in a round-parallel round the same root action
    is forced twice, as in the JAX package."""
    te = TableEval(SIZE, seed=5)
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    js = _endgame_states(jenv)
    assert not bool(js.done.any())
    assert int(jax.vmap(jenv.legal_mask)(js)[0].sum()) == 6
    kw = _kw(16, 8, gumbel_round_parallel=parallel)
    key = jax.random.PRNGKey(3)
    pj, qj, aj = jax.jit(lambda s: jax_gumbel(
        jenv, JaxMCTSConfig(backend="pallas", **kw), te.jax, None, s, key,
        interpret=True))(js)
    u = torch.from_numpy(np.array(_uniforms(key, BATCH)))
    pt, qt, at = run_gumbel_packed(env, MCTSConfig(**kw), te.torch, None,
                                   to_torch_state(js), uniforms=u)
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=TOL)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=TOL)
    assert (at == 3 * SIZE + 5).all()     # the win in one


def test_play_games_plies_match_jax():
    """Gumbel self-play in the port, ply by ply against the JAX package's
    packed Gumbel search on the port's boards, with the port's root
    uniforms (one ``[B, A]`` draw per move from the generator) put in the
    place of the JAX search's own draw."""
    batch, moves, seed = BATCH, 4, 3
    te = TableEval(SIZE, seed=21)
    env, jenv = make_env("gomoku", SIZE), JaxEnv(SIZE)
    kw = _kw(16, 8, max_depth=56)
    cfg = SelfPlayConfig(batch_games=batch, mcts=MCTSConfig(**kw),
                         max_moves=moves)
    traj = play_games(env, cfg, te.torch, None,
                      torch.Generator().manual_seed(seed), device="cpu")

    jcfg = JaxMCTSConfig(backend="pallas", **kw)

    def jax_search(states, u):
        with mock.patch.object(jax.random, "uniform", lambda *a, **k: u):
            return jax_gumbel(jenv, jcfg, te.jax, None, states,
                              jax.random.PRNGKey(0), interpret=True)

    search = jax.jit(jax_search)
    step = jax.jit(jax.vmap(jenv.step_safe))
    gen = torch.Generator().manual_seed(seed)
    for t in range(moves):
        u = torch.clamp(torch.rand((batch, A), generator=gen), min=1e-12)
        states = jax.vmap(jenv.from_board)(
            jnp.asarray(traj.boards[t].numpy()),
            jnp.asarray(traj.players[t].numpy()),
            jnp.full((batch,), t, jnp.int32))
        pi, root_q, action = search(states, jnp.asarray(u.numpy()))
        np.testing.assert_array_equal(np.asarray(action),
                                      traj.actions[t].numpy(),
                                      err_msg=f"ply {t}")
        np.testing.assert_allclose(traj.pis[t].numpy(), np.asarray(pi),
                                   rtol=0, atol=TOL, err_msg=f"ply {t}")
        np.testing.assert_allclose(traj.root_qs[t].numpy(),
                                   np.asarray(root_q), rtol=0, atol=TOL)
        assert traj.active[t].all()
        nxt = step(states, jnp.asarray(traj.actions[t].numpy()))
        if t + 1 < moves:
            np.testing.assert_array_equal(np.asarray(nxt.board),
                                          traj.boards[t + 1].numpy())
    assert (traj.moves_played.numpy() == moves).all()


def test_run_mcts_with_q_dispatches_gumbel():
    te = TableEval(SIZE, seed=2)
    env = GomokuEnv(SIZE)
    states = env.init_batch(4, device="cpu")
    cfg = MCTSConfig(**_kw(16, 4))
    moves = torch.zeros(4, dtype=torch.int32)
    pi, q = run_mcts_with_q(env, cfg, te.torch, None, states, moves,
                            torch.Generator().manual_seed(4))
    want = run_gumbel_mcts(env, cfg, te.torch, None, states,
                           torch.Generator().manual_seed(4))
    assert torch.equal(pi, want[0]) and torch.equal(q, want[1])
    # the plain tree functions give the same search on the CPU
    plain = run_gumbel_mcts(env, cfg, te.torch, None, states,
                            torch.Generator().manual_seed(4), ops=tk.PLAIN)
    for x, y in zip(want, plain):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw,err", [
    (dict(search="gumbel", leaves_per_sim=2), ValueError),
    (dict(gumbel_round_parallel=True), ValueError),
    (dict(search="nope"), ValueError),
])
def test_gumbel_config_checks(kw, err):
    with pytest.raises(err):
        MCTSConfig(n_simulations=16, **kw)


def test_exp_and_log_f32_are_within_two_ulp():
    """The walk's own exp and log, against float64 numpy."""
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.random(200000) * 110, -rng.random(20000) * 1e-3,
                        [0.0, -87.3, -103.9, -1e9]]).astype(np.float32)
    got = tk.exp_f32(torch.from_numpy(x)).numpy().astype(np.float64)
    want = np.exp(np.maximum(x, -104).astype(np.float64))
    ulp = np.spacing(want.astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= 2 * ulp).all()
    y = np.concatenate([rng.random(200000), np.exp(-rng.random(20000) * 69),
                        [1e-30, 1.0, 0.5, 2.0, 1.41421]]).astype(np.float32)
    got = tk.log_f32(torch.from_numpy(y)).numpy().astype(np.float64)
    want = np.log(y.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= 2 * ulp).all()


def test_gumbel_walk_wrapper_checks_and_counts():
    layout = tk.packed_layout(A, 6)
    packed = tk.init_packed(2, layout, "cpu")
    root = torch.zeros(2, dtype=torch.int32)
    tk.reset_launch_counts()
    tk.gumbel_select_walk(packed, root, layout, 4, 50.0, 1.0)
    assert tk.gumbel_select_walk.launches == 0     # CPU: the plain version
    with pytest.raises(ValueError):
        tk.gumbel_select_walk(packed, root, layout, 4, 50.0, 1.0, fan=2)
    with pytest.raises(TypeError):
        tk.gumbel_select_walk(packed, root.long(), layout, 4, 50.0, 1.0)
    meta = packed.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.gumbel_select_walk(meta, root.to("meta"), layout, 4, 50.0, 1.0)
