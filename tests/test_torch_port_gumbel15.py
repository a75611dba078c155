"""Parity of the port's Gumbel search with the JAX package's at the main
path's shape: 15x15, Gumbel@64 with m=16, on a small real network.

The port's Gumbel walk computes its exp and log with its own IEEE float32
sequences (``ops/tree_kernels.exp_f32`` / ``log_f32``, within 1.5 ulp) so
that kernel and plain version agree; the JAX kernel uses XLA's.  At 9x9 and
16-24 simulations (``test_torch_port_gumbel.py``) the two pick the same
actions; here the trees are deeper and the priors come from a network, so a
near-tie in ``pi' - N / (1 + sum N)`` could go the other way.  Both searches
evaluate the port's float32 ``ResNet`` (the JAX one through
``jax.pure_callback``) and take the JAX package's root uniforms, so they
differ only in their search code: the played actions and the packed trees
must be equal exactly, ``pi_target`` and ``root_q`` within 1e-5 (sums over
actions in another order), as in ``test_torch_port_gumbel.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    run_gumbel_packed_with_tree as jax_gumbel_with_tree,
)
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.models import (
    NetConfig,
    bundle_of,
    init_params,
    make_eval_fn,
)
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    run_gumbel_packed_with_tree,
)

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread,
    random_jax_states,
    to_torch_state,
)

SIZE = 15
A = SIZE * SIZE
TOL = 1e-5


# (plies, batch, seed, round-parallel)
@pytest.mark.parametrize("plies,batch,seed,parallel", [
    (4, 4, 0, False), (12, 2, 1, False), (8, 4, 2, True)])
def test_gumbel64_at_15x15_matches_jax(plies, batch, seed, parallel):
    cfg = NetConfig(board_size=SIZE, action_size=A, n_res_blocks=2,
                    channels=32)
    net = bundle_of(cfg, *init_params(cfg, seed), device="cpu")
    eval_fn = make_eval_fn()

    def port_net(obs):
        probs, value = eval_fn(net, torch.from_numpy(np.array(obs)))
        return probs.numpy(), value.numpy()

    def jax_eval(params, obs):
        del params
        shapes = (jax.ShapeDtypeStruct((obs.shape[0], A), jnp.float32),
                  jax.ShapeDtypeStruct((obs.shape[0], 1), jnp.float32))
        return jax.pure_callback(port_net, shapes, obs)

    kw = dict(n_simulations=64, search="gumbel", gumbel_max_considered=16,
              add_noise=False, max_depth=56, gumbel_round_parallel=parallel)
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    states = random_jax_states(jenv, batch, plies, seed=seed)
    key = jax.random.PRNGKey(seed)
    pj, qj, aj, jtree = jax.jit(lambda s: jax_gumbel_with_tree(
        jenv, JaxMCTSConfig(backend="pallas", **kw), jax_eval, None, key,
        root_states=s, interpret=True))(states)
    # the JAX package's root uniforms (tree_pallas.py), injected
    u = jax.random.uniform(key, (batch, A), jnp.float32, minval=1e-12,
                           maxval=1.0)
    pt, qt, at, tree = run_gumbel_packed_with_tree(
        env, MCTSConfig(**kw), eval_fn, net, to_torch_state(states),
        uniforms=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    np.testing.assert_array_equal(np.asarray(jtree.packed),
                                  tree.packed.numpy())
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=TOL)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=TOL)
