"""Parity: the port's cross-move subtree reuse against the JAX package's.

``init_packed_carry``, ``packed_advance_root`` and the PUCT and Gumbel
searches that take a ``carry=`` run in both packages on the same positions,
the JAX package's kernels in Pallas interpret mode, with the bit-exact
``TableEval``.  After every search and every advance each field of the carry
(the packed tree, the node-state stack, the parent links) must be equal on
every lane, finished lanes included, and so must PUCT's pi and Gumbel's
action.  Gumbel's ``pi_target`` and ``root_q`` sum over actions in another
order in each framework, so they agree within 1e-5, as in
``test_torch_port_gumbel.py``; PUCT's ``root_q`` within 1e-6, as in
``test_torch_port_search.py``.  The port's search starts from the JAX
package's carry through ``packed_carry_from_numpy`` where a test needs the
same tree in both.
"""

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
    run_mcts_packed_with_tree as jax_puct,
)
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.search import (
    MCTSConfig,
    init_packed_carry,
    packed_advance_root,
    packed_carry_from_numpy,
    run_search,
)

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    assert_carry_equal,
    carry_to_numpy,
    one_torch_thread,
    random_jax_states,
    to_torch_state,
)

TOL = 1e-5
Q_TOL = 1e-6


def _port_carry(jcarry):
    return packed_carry_from_numpy(*carry_to_numpy(jcarry), device="cpu")


def _puct_kw(sims, budget, **extra):
    return dict(n_simulations=sims, cpuct=1.25, add_noise=False,
                reuse_budget=budget, **extra)


def test_init_packed_carry_matches_jax():
    jenv, env = JaxEnv(7), GomokuEnv(7)
    js = random_jax_states(jenv, 5, 6, seed=2)
    kw = _puct_kw(8, 6)
    want = jax_init_carry(jenv, JaxMCTSConfig(backend="pallas", **kw), js)
    got = init_packed_carry(env, MCTSConfig(**kw), to_torch_state(js))
    assert_carry_equal(want, got)
    assert got.packed.shape == (5, 8 * (8 + 2 + 6), 128)


def test_packed_carry_from_numpy_round_trip():
    jenv = JaxEnv(7)
    js = random_jax_states(jenv, 4, 5, seed=4)
    kw = _puct_kw(12, 5)
    _, _, jcarry = jax.jit(lambda s: jax_puct(
        jenv, JaxMCTSConfig(backend="pallas", **kw), TableEval(7).jax, None,
        jnp.full((4,), 5, jnp.int32), jax.random.PRNGKey(0), root_states=s,
        interpret=True))(js)
    carry = _port_carry(jcarry)
    assert_carry_equal(jcarry, carry)
    assert carry.states.board.shape == (4, 12 + 2 + 5, 7, 7)
    assert carry.packed.device.type == "cpu"
    assert carry.parent.dtype == torch.int32 and (carry.parent >= 0).any()
    # boards given [B, n, H, W] load as they are
    packed, states, parent, pact = carry_to_numpy(carry)
    states[0] = states[0].reshape(carry.states.board.shape)
    assert_carry_equal(jcarry, packed_carry_from_numpy(
        packed, states, parent, pact, device="cpu"))


# (plies, budget): the budget cuts the kept subtree short, or keeps all of
# it; 28 plies in on 7x7 some games are over
@pytest.mark.parametrize("plies,budget", [(4, 3), (4, 40), (28, 8)])
def test_advance_root_matches_jax(plies, budget):
    size, batch, sims = 7, 12, 24
    jenv, env = JaxEnv(size), GomokuEnv(size)
    te = TableEval(size, seed=plies)
    js = random_jax_states(jenv, batch, plies, seed=plies + budget)
    kw = _puct_kw(sims, budget)
    jcfg = JaxMCTSConfig(backend="pallas", **kw)
    _, _, jcarry = jax.jit(lambda s: jax_puct(
        jenv, jcfg, te.jax, None, jnp.full((batch,), plies, jnp.int32),
        jax.random.PRNGKey(plies), carry=jax_init_carry(jenv, jcfg, s),
        root_states=s, interpret=True))(js)
    packed = np.asarray(jcarry.packed)
    children = packed[:, tk.SL_C, :size * size]        # the root's links
    counts = packed[:, tk.SL_N, :size * size]
    legal = np.asarray(jax.vmap(jenv.legal_mask)(js))
    done = np.asarray(js.done)
    # the most visited edge, or (every third lane) a legal edge never
    # expanded: the fresh fallback; finished lanes play 0, as step_safe's
    # callers give them
    actions = counts.argmax(axis=1)
    for lane in range(0, batch, 3):
        unexpanded = np.flatnonzero(legal[lane] & (children[lane] < 0))
        if unexpanded.size:
            actions[lane] = unexpanded[0]
    actions = np.where(done, 0, actions).astype(np.int32)

    want = jax.jit(lambda c, a: jax_advance(jenv, jcfg, c, a))(
        jcarry, jnp.asarray(actions))
    got = packed_advance_root(env, MCTSConfig(**kw), _port_carry(jcarry),
                              torch.from_numpy(actions))
    assert_carry_equal(want, got)
    fresh = children[np.arange(batch), actions] < 0
    assert fresh[~done].any() and (~fresh).any()
    if plies == 28:
        assert done.any()
    kept = (np.asarray(want.parent) >= 0).sum(axis=1) + 1
    if budget == 3:
        assert (kept[~fresh] == budget).all()


def _reuse_moves(search, size, batch, kw, moves, plies, seed, fresh=False):
    """``moves`` searches with reuse in both packages, each followed by
    ``packed_advance_root`` with the played moves; every output and every
    carry is compared.  The first search starts from ``init_packed_carry``'s
    carry, or with ``fresh`` from none (a fresh tree, slots from 1)."""
    jenv, env = JaxEnv(size), GomokuEnv(size)
    a = size * size
    te = TableEval(size, seed=seed)
    jcfg, cfg = JaxMCTSConfig(backend="pallas", **kw), MCTSConfig(**kw)
    js = random_jax_states(jenv, batch, plies, seed=seed)
    jcarry = None if fresh else jax_init_carry(jenv, jcfg, js)
    carry = None if fresh else init_packed_carry(env, cfg, to_torch_state(js))
    step = jax.jit(jax.vmap(jenv.step_safe))
    advance = jax.jit(lambda c, x: jax_advance(jenv, jcfg, c, x))
    if search == "puct":
        jax_search = jax.jit(lambda s, c, key, m: jax_puct(
            jenv, jcfg, te.jax, None, m, key, carry=c, root_states=s,
            interpret=True))
    else:
        jax_search = jax.jit(lambda s, c, key: jax_gumbel(
            jenv, jcfg, te.jax, None, key, carry=c, root_states=s,
            interpret=True))
    for t in range(moves):
        key = jax.random.PRNGKey(seed + t)
        states = to_torch_state(js)
        if search == "puct":
            move_nums = np.full((batch,), plies + t, np.int32)
            pj, qj, jcarry = jax_search(js, jcarry, key,
                                        jnp.asarray(move_nums))
            pt, qt, at, carry = run_search(
                env, cfg, te.torch, None, states, torch.from_numpy(move_nums),
                carry=carry)
            assert at is None
            np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
            np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0,
                                       atol=Q_TOL)
            actions = pt.numpy().argmax(axis=1)
        else:
            pj, qj, aj, jcarry = jax_search(js, jcarry, key)
            u = jax.random.uniform(key, (batch, a), jnp.float32,
                                   minval=1e-12, maxval=1.0)
            pt, qt, at, carry = run_search(
                env, cfg, te.torch, None, states,
                uniforms=torch.from_numpy(np.array(u)), carry=carry)
            np.testing.assert_array_equal(np.asarray(aj), at.numpy())
            np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0,
                                       atol=TOL)
            actions = at.numpy()
        assert_carry_equal(jcarry, carry, f"after search {t}")
        actions = np.where(np.asarray(js.done), 0, actions).astype(np.int32)
        jcarry = advance(jcarry, jnp.asarray(actions))
        carry = packed_advance_root(env, cfg, carry,
                                    torch.from_numpy(actions))
        assert_carry_equal(jcarry, carry, f"after advance {t}")
        js = step(js, jnp.asarray(actions))
    return carry


@pytest.mark.parametrize("search,extra", [
    ("puct", {}),
    ("gumbel", dict(gumbel_round_parallel=False)),
    ("gumbel", dict(gumbel_round_parallel=True)),
    # the first search from no carry
    ("puct", dict(fresh=True)),
    ("gumbel", dict(fresh=True)),
])
def test_reuse_searches_over_three_moves_match_jax(search, extra):
    extra = dict(extra)
    fresh = extra.pop("fresh", False)
    if search == "puct":
        kw = _puct_kw(16, 10, max_depth=56)
    else:
        kw = dict(n_simulations=16, search="gumbel", gumbel_max_considered=8,
                  add_noise=False, reuse_budget=10, max_depth=56, **extra)
    carry = _reuse_moves(search, 9, 8, kw, 3, plies=4, seed=7, fresh=fresh)
    # the carried subtree was not empty: reuse kept nodes
    assert (carry.parent >= 0).any()


def test_gumbel64_reuse_at_15x15_matches_jax():
    """The shipped nets' self-play search: Gumbel@64, m=16, reuse budget
    48, 15x15, two moves."""
    kw = dict(n_simulations=64, search="gumbel", gumbel_max_considered=16,
              add_noise=False, reuse_budget=48, max_depth=56)
    _reuse_moves("gumbel", 15, 4, kw, 2, plies=3, seed=15)


def test_reuse_search_refreshes_the_carried_root():
    """A search given a carry starts from its tree: the carried N, W and
    links stay, the root's priors are new, simulations take slots from
    ``reuse_budget``; the carry it was given is not changed."""
    te = TableEval(7, seed=1)
    env = GomokuEnv(7)
    states = env.init_batch(4, device="cpu")
    cfg = MCTSConfig(**_puct_kw(8, 5))
    moves = torch.zeros(4, dtype=torch.int32)
    _, _, _, carry = run_search(
        env, cfg, te.torch, None, states, moves,
        carry=init_packed_carry(env, cfg, states))
    assert (carry.parent[:, 1:5] == -1).all()            # slots 1..R-1 free
    assert (carry.parent[:, 5] == 0).all()               # the first expansion
    assert ((carry.parent[:, 5:13] >= 0)
            & (carry.parent[:, 5:13] < 13)).all()
    before = [x.clone() for x in (carry.packed, carry.parent)]
    _, _, _, second = run_search(env, cfg, te.torch, None, states, moves,
                                 carry=carry)
    assert torch.equal(carry.packed, before[0])
    assert torch.equal(carry.parent, before[1])
    assert second.packed[:, tk.SL_N, :49].sum() == 4 * 16
