"""Parity of the port's self-play slice with the JAX package.

``play_games`` runs a few moves in the port.  At each ply the JAX package's
packed search on the port's states must give the port's pi exactly (with the
bit-exact ``TableEval``), and the JAX engine's ``step`` on the port's chosen
actions must give the port's next boards.  With subtree reuse, playout cap
randomization and the random opening on, the JAX side threads its own carry
through ``packed_advance_root`` with the port's moves and searches each ply
with the full or the cheap config, as the port's recorded pi says (all zero
on a cheap ply).  ``sample_actions`` and ``random_center_actions`` are held
against the JAX ones with the JAX package's own uniforms injected.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    init_packed_carry as jax_init_carry,
    packed_advance_root as jax_advance,
    run_gumbel_packed_with_tree as jax_gumbel,
    run_mcts_packed as jax_packed,
    run_mcts_packed_with_tree as jax_puct,
)
from alphazero_gomoku_tpu.selfplay.runner import (
    center_mask as jax_center_mask,
    random_center_actions as jax_random_center,
    sample_actions as jax_sample,
)
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.search.tree import symmetric_dirichlet
from alphazero_gomoku_tpu_torch.selfplay import (
    SelfPlayConfig,
    center_mask,
    play_games,
    random_center_actions,
    sample_actions,
)

from torch_port_util import TableEval, one_torch_thread  # noqa: F401

SIZE = 9
A = SIZE * SIZE


def test_play_games_plies_match_jax():
    batch, sims, max_moves = 8, 16, 5
    te = TableEval(SIZE, seed=11)
    env, jenv = make_env("gomoku", SIZE), JaxEnv(SIZE)
    # root noise is drawn but gated off (dirichlet_moves=0): the JAX search
    # draws its own noise, so the gate must hold for pi to be comparable
    kw = dict(n_simulations=sims, cpuct=1.0, add_noise=True,
              dirichlet_alpha=0.05, dirichlet_epsilon=0.15, dirichlet_moves=0,
              max_depth=56)
    cfg = SelfPlayConfig(batch_games=batch, mcts=MCTSConfig(**kw),
                         temp_threshold=3, max_moves=max_moves)
    traj = play_games(env, cfg, te.torch, None,
                      torch.Generator().manual_seed(0), device="cpu")

    jcfg = JaxMCTSConfig(backend="pallas", **kw)
    search = jax.jit(lambda s, m: jax_packed(
        jenv, jcfg, te.jax, None, s, m, jax.random.PRNGKey(0),
        interpret=True))
    step = jax.jit(jax.vmap(jenv.step_safe))
    for t in range(max_moves):
        board = traj.boards[t].numpy()
        states = jax.vmap(jenv.from_board)(
            jnp.asarray(board), jnp.asarray(traj.players[t].numpy()),
            jnp.full((batch,), t, jnp.int32))
        pi, _ = search(states, jnp.full((batch,), t, jnp.int32))
        np.testing.assert_array_equal(np.asarray(pi), traj.pis[t].numpy(),
                                      err_msg=f"ply {t}")
        assert traj.active[t].all()
        nxt = step(states, jnp.asarray(traj.actions[t].numpy()))
        if t + 1 < max_moves:
            np.testing.assert_array_equal(np.asarray(nxt.board),
                                          traj.boards[t + 1].numpy())
    assert (traj.moves_played.numpy() == max_moves).all()
    # the temperature schedule reached 0: the last plies are greedy
    greedy = traj.pis[max_moves - 1].argmax(dim=1).int()
    assert torch.equal(traj.actions[max_moves - 1], greedy)


@pytest.mark.parametrize("temp", [1.0, 0.4, 0.0])
def test_sample_actions_matches_jax(temp):
    rng = np.random.default_rng(int(temp * 10))
    b = 256
    pi = rng.random((b, A)) ** 4
    pi[rng.random((b, A)) < 0.3] = 0.0
    pi = (pi / pi.sum(1, keepdims=True)).astype(np.float32)
    legal = rng.random((b, A)) < 0.9
    key = jax.random.PRNGKey(int(temp * 10))
    want = np.asarray(jax_sample(jnp.asarray(pi), jnp.float32(temp),
                                 jnp.asarray(legal), key))
    # jax.random.categorical's Gumbel noise comes from these uniforms
    u = jax.random.uniform(key, (b, A), jnp.float32,
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    got = sample_actions(torch.from_numpy(pi), torch.tensor(temp),
                         torch.from_numpy(legal),
                         uniforms=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(want, got.numpy())


def test_finished_games_stop_the_loop_and_freeze():
    """A batch whose games all end stops before ``max_moves``; records after
    a game's end are inactive, as in the JAX runner."""
    te = TableEval(5, seed=2)
    env = make_env("gomoku", 5)
    cfg = SelfPlayConfig(batch_games=4, mcts=MCTSConfig(n_simulations=4,
                                                        add_noise=False),
                         max_moves=40)
    traj = play_games(env, cfg, te.torch, None,
                      torch.Generator().manual_seed(1), device="cpu")
    played = traj.moves_played.numpy()
    assert played.max() <= 25 and (played > 0).all()
    for lane, n in enumerate(played):
        assert traj.active[:n, lane].all() and not traj.active[n:, lane].any()


def _replay_options(search):
    """The port's ``play_games`` with reuse, PCR and a 2-ply random opening,
    replayed ply by ply by the JAX package's reuse searches."""
    batch, moves, opening, seed = 8, 5, 2, 4
    te = TableEval(SIZE, seed=31)
    env, jenv = make_env("gomoku", SIZE), JaxEnv(SIZE)
    if search == "puct":
        # root noise is drawn but gated off: the JAX search draws its own
        kw = dict(n_simulations=16, cpuct=1.0, add_noise=True,
                  dirichlet_alpha=0.05, dirichlet_epsilon=0.15,
                  dirichlet_moves=0, max_depth=56, reuse_budget=8)
    else:
        kw = dict(n_simulations=16, search="gumbel", gumbel_max_considered=8,
                  add_noise=False, max_depth=56, reuse_budget=8)
    cfg = SelfPlayConfig(batch_games=batch, mcts=MCTSConfig(**kw),
                         temp_threshold=3, max_moves=moves,
                         opening_random_moves=opening, pcr_cheap_sims=6,
                         pcr_full_prob=0.5)
    traj = play_games(env, cfg, te.torch, None,
                      torch.Generator().manual_seed(seed), device="cpu")

    full_cfg = JaxMCTSConfig(backend="pallas", **kw)
    cheap_cfg = JaxMCTSConfig(backend="pallas", **dict(
        kw, n_simulations=6, add_noise=False,
        max_nodes=full_cfg.node_capacity))

    def jax_search(mcfg):
        if search == "puct":
            return jax.jit(lambda s, c, m, u: jax_puct(
                jenv, mcfg, te.jax, None, m, jax.random.PRNGKey(0), carry=c,
                root_states=s, interpret=True)[::2])

        def gumbel(s, c, m, u):
            with mock.patch.object(jax.random, "uniform", lambda *a, **k: u):
                pi, _, _, c = jax_gumbel(jenv, mcfg, te.jax, None,
                                         jax.random.PRNGKey(0), carry=c,
                                         root_states=s, interpret=True)
            return pi, c
        return jax.jit(gumbel)

    searches = {True: jax_search(full_cfg), False: jax_search(cheap_cfg)}
    advance = jax.jit(lambda c, x: jax_advance(jenv, full_cfg, c, x))
    step = jax.jit(jax.vmap(jenv.step_safe))
    states = jenv.init_batch(batch)
    carry = jax_init_carry(jenv, full_cfg, states)
    # the port's generator, drawn in play_games' order: the PCR draw, the
    # search's draws, PUCT's sampling uniforms, the opening's uniforms
    gen = torch.Generator().manual_seed(seed)
    kinds = []
    for t in range(moves):
        full = bool(torch.rand((), generator=gen) < cfg.pcr_full_prob)
        u = jnp.zeros((batch, A), jnp.float32)
        if search == "gumbel":
            u = jnp.asarray(torch.clamp(torch.rand((batch, A), generator=gen),
                                        min=1e-12).numpy())
        elif full:
            symmetric_dirichlet(gen, kw["dirichlet_alpha"], (batch, A))
        if search == "puct":
            torch.rand((batch, A), generator=gen)
        if t < opening:
            u_open = torch.rand((batch, A), generator=gen)
            legal = np.array(jax.vmap(jenv.legal_mask)(states))
            got = random_center_actions(
                torch.from_numpy(legal).float(), center_mask(env, "cpu"),
                uniforms=u_open)
            np.testing.assert_array_equal(got.numpy(),
                                          traj.actions[t].numpy())
        recorded = traj.pis[t].numpy()
        assert full == bool(recorded.any()), f"ply {t}"
        kinds.append(full)
        pi, carry = searches[full](states, carry,
                                   jnp.full((batch,), t, jnp.int32), u)
        if full:
            if search == "puct":
                np.testing.assert_array_equal(np.asarray(pi), recorded,
                                              err_msg=f"ply {t}")
            else:
                np.testing.assert_allclose(recorded, np.asarray(pi), rtol=0,
                                           atol=1e-5, err_msg=f"ply {t}")
        np.testing.assert_array_equal(np.asarray(states.board),
                                      traj.boards[t].numpy())
        assert not traj.active[t].any() if t < opening \
            else traj.active[t].all()
        actions = jnp.asarray(traj.actions[t].numpy())
        states = step(states, actions)
        carry = advance(carry, actions)
    return kinds


@pytest.mark.parametrize("search", ["puct", "gumbel"])
def test_play_games_with_reuse_pcr_and_opening_replays_jax(search):
    kinds = _replay_options(search)
    assert any(kinds) and not all(kinds)          # both kinds of ply


def test_random_center_actions_match_jax():
    rng = np.random.default_rng(5)
    size, b = 15, 64
    env, jenv = make_env("gomoku", size), JaxEnv(size)
    a = size * size
    legal = (rng.random((b, a)) < 0.7).astype(np.float32)
    center = np.asarray(jax_center_mask(jenv))
    legal[:4] *= 1.0 - center          # a full centre: uniform over legal
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_random_center(key, jnp.asarray(legal),
                                        jnp.asarray(center)))
    u = jax.random.uniform(key, (b, a), jnp.float32,
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    got = random_center_actions(torch.from_numpy(legal),
                                center_mask(env, "cpu"),
                                uniforms=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(want, got.numpy())
    assert (legal[np.arange(b), want] > 0).all()
    assert (center[want[4:]] > 0).all() and (center[want[:4]] == 0).all()
    for n in (5, 9, 15):
        np.testing.assert_array_equal(
            np.asarray(jax_center_mask(JaxEnv(n))),
            center_mask(make_env("gomoku", n), "cpu").numpy())
