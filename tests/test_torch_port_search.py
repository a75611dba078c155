"""Parity: the port's packed PUCT search against the JAX package's.

With an eval function both frameworks compute bit for bit (``TableEval``),
the visit-count policies must be equal exactly: same PUCT arithmetic in f32,
same lowest-index tie-breaking, same terminal and depth-cap handling.  Root
noise is the JAX package's own draw (``rng, sub = split(rng)`` and
``symmetric_dirichlet(sub, ...)``, as ``tree_pallas.py:189-191`` and
``tree.py:543`` make it), injected into the port.  ``root_q`` sums W over the
root's actions, in another order in each framework, so it agrees to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree import symmetric_dirichlet as jax_dirichlet
from alphazero_gomoku_tpu.search.tree_pallas import run_mcts_packed as jax_packed
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_mcts_with_q
from alphazero_gomoku_tpu_torch.search.tree import symmetric_dirichlet
from alphazero_gomoku_tpu_torch.search.tree_packed import run_mcts_packed

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    one_torch_thread,
    random_jax_states,
    to_torch_state,
)

SIZE = 9
A = SIZE * SIZE
Q_TOL = 1e-6


def _search_both(jenv, env, states, plies, key, cfg_kw, jax_eval, torch_eval,
                 jax_params=None, torch_params=None, jax_search=jax_packed):
    """Search ``states`` in both packages; ``jax_search`` is the JAX
    package's packed search (interpret mode) or its ``run_mcts_with_q``."""
    b = states.done.shape[0]
    moves = np.full((b,), plies, np.int32)
    jcfg = JaxMCTSConfig(backend="pallas", **cfg_kw)
    kw = {"interpret": True} if jax_search is jax_packed else {}
    pj, qj = jax.jit(lambda s: jax_search(
        jenv, jcfg, jax_eval, jax_params, s, jnp.asarray(moves), key,
        **kw))(states)
    noise = None
    if cfg_kw.get("add_noise", True):
        _, sub = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax_dirichlet(
            sub, cfg_kw["dirichlet_alpha"], (b, A))))
    pt, qt = run_mcts_with_q(env, MCTSConfig(**cfg_kw), torch_eval,
                             torch_params, to_torch_state(states),
                             torch.from_numpy(moves), noise=noise)
    return np.asarray(pj), np.asarray(qj), pt.numpy(), qt.numpy()


NOISE = dict(add_noise=True, dirichlet_alpha=0.3, dirichlet_epsilon=0.25,
             dirichlet_moves=10)


# (plies, search settings): root noise on at move 0 and move 5, off past the
# Dirichlet gate, a depth cap, and late positions where searches meet
# terminal nodes and finished games
@pytest.mark.parametrize("plies,extra", [
    (0, dict(NOISE)),
    (5, dict(NOISE, max_depth=56)),
    (12, dict(NOISE)),                     # move 12 >= dirichlet_moves: gated off
    (8, dict(add_noise=False, max_depth=2)),
    (45, dict(add_noise=False)),
])
def test_packed_search_matches_jax_exactly(plies, extra):
    te = TableEval(SIZE, seed=plies)
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    states = random_jax_states(jenv, 16, plies, seed=plies)
    kw = dict(n_simulations=24, cpuct=1.25, **extra)
    pj, qj, pt, qt = _search_both(jenv, env, states, plies,
                                  jax.random.PRNGKey(plies), kw, te.jax,
                                  te.torch)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=Q_TOL)
    assert np.isfinite(pt).all()


def test_search_without_noise_tensor_draws_from_the_generator():
    te = TableEval(SIZE, seed=1)
    env = GomokuEnv(SIZE)
    states = env.init_batch(4, device="cpu")
    moves = torch.zeros(4, dtype=torch.int32)
    cfg = MCTSConfig(n_simulations=8, **NOISE)
    runs = [run_mcts_packed(env, cfg, te.torch, None, states, moves,
                            torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="generator"):
        run_mcts_packed(env, cfg, te.torch, None, states, moves)


@pytest.mark.parametrize("kw,item", [
    (dict(search="gumbel", reuse_budget=8), "item 11"),
    (dict(leaves_per_sim=2), "item 11"),
    (dict(reuse_budget=8), "item 11"),
])
def test_searches_not_ported_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        MCTSConfig(n_simulations=8, **kw)


@pytest.mark.parametrize("alpha", [0.03, 0.3, 1.0])
def test_symmetric_dirichlet_distribution(alpha):
    """The port's sampler against numpy's true Dirichlet, with the
    statistics and bounds of the JAX sampler's test (``tests/test_mcts.py``)."""
    n = 2048
    s = symmetric_dirichlet(torch.Generator().manual_seed(0), alpha,
                            (n, 225)).numpy()
    assert s.shape == (n, 225)
    np.testing.assert_allclose(s.sum(1), 1.0, atol=1e-5)
    assert (s >= 0).all()
    np.testing.assert_allclose(s.mean(0), 1.0 / 225, atol=2e-3)
    ref = np.random.default_rng(0).dirichlet([alpha] * 225, n)
    got_med, ref_med = np.median(s.max(1)), np.median(ref.max(1))
    assert abs(got_med - ref_med) < 0.05 * max(1.0, ref_med / 0.5)
    assert abs(s.max(1).mean() - ref.max(1).mean()) < 0.05
