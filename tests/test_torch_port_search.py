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
from alphazero_gomoku_tpu_torch.search import (
    MCTSConfig,
    run_mcts_with_q,
    run_search,
)
from alphazero_gomoku_tpu_torch.search.tree import symmetric_dirichlet

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
    runs = [run_search(env, cfg, te.torch, None, states, moves,
                       torch.Generator().manual_seed(s)).pi
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="generator"):
        run_search(env, cfg, te.torch, None, states, moves)


def _refusal_cases():
    """name -> (the port's call, the JAX package's call): each must raise
    ValueError in both."""
    from alphazero_gomoku_tpu.ops import tree_kernels as jtk
    from alphazero_gomoku_tpu.search import tree_pallas as jtp
    from alphazero_gomoku_tpu.selfplay import runner as jrunner
    from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
    from alphazero_gomoku_tpu_torch.search import tree_packed as tp
    from alphazero_gomoku_tpu_torch.selfplay import runner

    jenv, env = JaxEnv(5), GomokuEnv(5)
    te = TableEval(5)

    def both(**kw):
        return (lambda: MCTSConfig(**kw),
                lambda: JaxMCTSConfig(backend="pallas", **kw))

    def puct(kw, carry):
        def port():
            cfg = MCTSConfig(**kw)
            states = env.init_batch(2, device="cpu")
            tp.run_search(
                env, cfg, te.torch, None, states,
                torch.zeros(2, dtype=torch.int32),
                carry=(tp._fresh_carry(env, cfg, states) if carry else None))

        def jax_side():
            cfg = JaxMCTSConfig(backend="pallas", **kw)
            states = jenv.init_batch(2)
            jtp.run_mcts_packed_with_tree(
                jenv, cfg, te.jax, None, jnp.zeros(2, jnp.int32),
                jax.random.PRNGKey(0), root_states=states,
                carry=(jtp._init_packed(2, jtp.packed_layout(
                    25, cfg.node_capacity)) if carry else None))
        return port, jax_side

    def gumbel_carry():
        kw = dict(n_simulations=8, search="gumbel", gumbel_max_considered=4)
        states = env.init_batch(2, device="cpu")
        cfg = MCTSConfig(**kw)
        return (lambda: tp.run_search(
                    env, cfg, te.torch, None, states,
                    generator=torch.Generator(),
                    carry=tp._fresh_carry(env, cfg, states)),
                lambda: jtp.run_gumbel_packed_with_tree(
                    jenv, JaxMCTSConfig(backend="pallas", **kw), te.jax, None,
                    jax.random.PRNGKey(0), carry=object(),
                    root_states=jenv.init_batch(2)))

    def selfplay(batch, **kw):
        mcts = dict(n_simulations=8, **kw.pop("mcts", {}))
        return (lambda: runner.play_games(
                    env, runner.SelfPlayConfig(batch, MCTSConfig(**mcts),
                                               **kw),
                    te.torch, None, torch.Generator(), device="cpu"),
                lambda: jrunner.play_games(
                    jenv, jrunner.SelfPlayConfig(
                        batch, JaxMCTSConfig(backend="pallas", **mcts), **kw),
                    te.jax, None, jax.random.PRNGKey(0)))

    def advance_without_reuse():
        cfg = dict(n_simulations=8)
        return (lambda: tp.packed_advance_root(
                    env, MCTSConfig(**cfg), None, torch.zeros(2)),
                lambda: jtp.packed_advance_root(
                    jenv, JaxMCTSConfig(**cfg), None, jnp.zeros(2)))

    def unknown_backup_mode():
        lay, jlay = tk.packed_layout(25, 4), jtk.packed_layout(25, 4)
        i32 = dict(dtype=torch.int32)
        return (lambda: tk.backup_paths(
                    tk.init_packed(8, lay, "cpu"), torch.zeros((2, 8), **i32),
                    torch.zeros((2, 8), **i32), torch.ones(8, **i32),
                    torch.zeros(8), torch.ones(8, dtype=torch.bool), 1, lay,
                    torch.zeros((8, 25)), torch.zeros(8, dtype=torch.bool),
                    mode="other"),
                lambda: jtk.backup_paths(
                    jnp.zeros((8, 32, 128)), jnp.zeros((2, 8), jnp.int32),
                    jnp.zeros((2, 8), jnp.int32), jnp.ones(8, jnp.int32),
                    jnp.zeros(8), jnp.ones(8, jnp.int32), jnp.int32(1), jlay,
                    signed_priors=jnp.zeros((8, 25)),
                    done=jnp.zeros(8, bool), interpret=True, mode="other"))

    return {
        "reuse_with_kleaf": puct(dict(n_simulations=8, leaves_per_sim=2,
                                      reuse_budget=4), carry=False),
        "gumbel_with_kleaf": both(n_simulations=8, search="gumbel",
                                  leaves_per_sim=2),
        "sims_not_divisible_by_k": both(n_simulations=10, leaves_per_sim=4),
        "k_below_1": both(n_simulations=8, leaves_per_sim=0),
        "carry_without_reuse": puct(dict(n_simulations=8), carry=True),
        "gumbel_carry_without_reuse": gumbel_carry(),
        "capacity_below_sims_2_reuse": (
            lambda: MCTSConfig(n_simulations=8, reuse_budget=4,
                               max_nodes=12).node_capacity,
            lambda: JaxMCTSConfig(n_simulations=8, reuse_budget=4,
                                  max_nodes=12).node_capacity),
        "selfplay_reuse_below_8_games": selfplay(
            4, mcts=dict(reuse_budget=4)),
        "pcr_with_kleaf": selfplay(2, mcts=dict(leaves_per_sim=2),
                                   pcr_cheap_sims=4),
        "pcr_cheap_sims_not_below_sims": selfplay(2, pcr_cheap_sims=8),
        "advance_root_without_reuse": advance_without_reuse(),
        "unknown_backup_mode": unknown_backup_mode(),
    }


# case -> a phrase both packages' messages hold
REFUSALS = {
    "reuse_with_kleaf": "reuse is not supported with leaves_per_sim",
    "gumbel_with_kleaf": "does not support leaves_per_sim",
    "sims_not_divisible_by_k": "not divisible by leaves_per_sim",
    "k_below_1": "leaves_per_sim=0 < 1",
    "carry_without_reuse": "carry= requires",
    "gumbel_carry_without_reuse": "carry= requires",
    "capacity_below_sims_2_reuse": "n_simulations\\+2\\+reuse_budget",
    "selfplay_reuse_below_8_games": "batch_games >= 8",
    "pcr_with_kleaf": "playout cap randomization is not supported",
    "pcr_cheap_sims_not_below_sims": "must be below",
    "advance_root_without_reuse": "requires cfg.reuse_budget > 0",
    "unknown_backup_mode": "unknown backup mode",
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_shared_with_jax(case):
    """What the JAX package refuses in k-leaf search, reuse, PCR and the
    backup modes, the port refuses too, with a ValueError."""
    port, jax_side = _refusal_cases()[case]
    with pytest.raises(ValueError, match=REFUSALS[case]):
        jax_side()
    with pytest.raises(ValueError, match=REFUSALS[case]):
        port()


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
