"""Parity of the port's self-play slice with the JAX package.

``play_games`` runs a few moves in the port.  At each ply the JAX package's
packed search on the port's states must give the port's pi exactly (with the
bit-exact ``TableEval``), and the JAX engine's ``step`` on the port's chosen
actions must give the port's next boards.  ``sample_actions`` is held against
the JAX one with the JAX package's own uniforms injected.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import run_mcts_packed as jax_packed
from alphazero_gomoku_tpu.selfplay.runner import sample_actions as jax_sample
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import (
    SelfPlayConfig,
    play_games,
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


@pytest.mark.parametrize("kw,item", [
    (dict(opening_random_moves=2), "item 11"),
    (dict(pcr_cheap_sims=4), "item 11"),
])
def test_selfplay_features_not_ported_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        SelfPlayConfig(batch_games=2, mcts=MCTSConfig(n_simulations=8), **kw)
