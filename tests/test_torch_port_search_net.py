"""Parity of the port's PUCT search with the JAX package's: the real network,
and batches below the JAX packed kernels' lane floor.

With the real network the two frameworks' convolutions round differently
(within 1e-5, ``test_torch_port_net.py``); a prior that moves by an ulp can
flip a PUCT near-tie and move a visit.  So there pi may differ by up to two
visits in a lane (2 / n_simulations per entry); measured on these inputs it
is exact.
"""

import numpy as np
import jax

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.models.resnet import NetConfig as JaxNetConfig
from alphazero_gomoku_tpu.models.resnet import init_variables
from alphazero_gomoku_tpu.search.tree import run_mcts_with_q as jax_run_with_q
from alphazero_gomoku_tpu.selfplay.loop import make_eval_fn as jax_make_eval_fn
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.models import NetConfig, bundle_of, make_eval_fn

from test_torch_port_search import A, NOISE, Q_TOL, SIZE, _search_both
from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    one_torch_thread,
    random_jax_states,
)


def test_small_batches_use_the_packed_search_and_match_jax():
    """Batches below 8 run the XLA array tree in the JAX package and the
    packed search here; the results are the same."""
    te = TableEval(SIZE, seed=3)
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    states = random_jax_states(jenv, 3, 4, seed=3)
    kw = dict(n_simulations=24, cpuct=1.0, **NOISE)
    pj, qj, pt, qt = _search_both(jenv, env, states, 4, jax.random.PRNGKey(9),
                                  kw, te.jax, te.torch,
                                  jax_search=jax_run_with_q)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=Q_TOL)


def test_packed_search_with_the_real_net():
    jcfg = JaxNetConfig(board_size=SIZE, action_size=A, n_res_blocks=2,
                        channels=32)
    variables = init_variables(jax.random.PRNGKey(0), jcfg)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    net = bundle_of(NetConfig(board_size=SIZE, action_size=A, n_res_blocks=2,
                              channels=32), params, stats, device="cpu")
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    sims = 32
    states = random_jax_states(jenv, 16, 6, seed=6)
    kw = dict(n_simulations=sims, cpuct=1.0, max_depth=56, **NOISE)
    pj, qj, pt, qt = _search_both(jenv, env, states, 6, jax.random.PRNGKey(1),
                                  kw, jax_make_eval_fn(jcfg), make_eval_fn(),
                                  variables, net)
    visits_moved = np.abs(pj - pt).sum(axis=1) * sims / 2
    assert visits_moved.max() <= 2, visits_moved
    np.testing.assert_allclose(pt, pj, rtol=0, atol=2.0 / sims)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-4)
