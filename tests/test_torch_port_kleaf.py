"""Parity: the port's k-leaf virtual-loss PUCT against the JAX package's.

``backup_paths`` in modes ``"vl"`` and ``"finalize"`` (the plain version on
the CPU) against the JAX kernel in Pallas interpret mode, and the k-leaf
search (``leaves_per_sim = k``) against the JAX package's packed k-leaf
search, with the bit-exact ``TableEval``.  Trees and pi must be equal
exactly; ``root_q`` sums the root's W row, in another order in each
framework, so it agrees to ``Q_TOL`` (as in ``test_torch_port_search.py``),
and noised root priors agree within a few ulps (``_assert_search_equal``).
The backups take the JAX walk's path rows, as ``test_torch_port_kernels.py``
does: the two walks fill the rows past a lane's path length differently,
and no backup reads them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.ops import tree_kernels as jtk
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree import symmetric_dirichlet as jax_dirichlet
from alphazero_gomoku_tpu.search.tree_pallas import (
    run_mcts_packed_with_tree as jax_search_with_tree,
)
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_search

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    one_torch_thread,
    random_jax_states,
    to_torch_state,
)

Q_TOL = 1e-6


def _search_both(size, batch, plies, k, sims, seed, spare=0, js=None,
                 ops=tk.KERNELS, **extra):
    """The k-leaf search of the same positions in both packages (``js``, or
    ``plies`` random plies in): ``(cfg, (pi, root_q, packed) of JAX, the same
    of the port)``."""
    te = TableEval(size, seed=seed)
    jenv, env = JaxEnv(size), GomokuEnv(size)
    if js is None:
        js = random_jax_states(jenv, batch, plies, seed=seed)
    kw = dict(n_simulations=sims, cpuct=1.25, leaves_per_sim=k,
              max_nodes=sims + 2 + spare, **extra)
    kw.setdefault("add_noise", False)
    moves = np.full((batch,), plies, np.int32)
    key = jax.random.PRNGKey(seed)
    pj, qj, jcarry = jax.jit(lambda s: jax_search_with_tree(
        jenv, JaxMCTSConfig(backend="pallas", **kw), te.jax, None,
        jnp.asarray(moves), key, root_states=s, interpret=True))(js)
    noise = None
    if kw["add_noise"]:
        _, sub = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax_dirichlet(
            sub, kw["dirichlet_alpha"], (batch, size * size))))
    cfg = MCTSConfig(**kw)
    pt, qt, _, carry = run_search(
        env, cfg, te.torch, None, to_torch_state(js), torch.from_numpy(moves),
        noise=noise, ops=ops)
    return cfg, (np.asarray(pj), np.asarray(qj), np.array(jcarry.packed)), \
        (pt.numpy(), qt.numpy(), carry.packed)


def _assert_search_equal(jout, tout, noise=False):
    pj, qj, jpacked = jout
    pt, qt, packed = tout
    packed = packed.numpy().copy()
    if noise:
        # the noised root priors: XLA may contract the noise mix into
        # multiply-adds and sums their row in another order, so the root's P
        # row (rows 0-7 are node 0's tile) agrees within a few ulps (8 at
        # most measured, 5.9e-7 relative), and every other entry exactly
        root_p = (slice(None), tk.SL_P)
        np.testing.assert_allclose(packed[root_p], jpacked[root_p], rtol=2e-6,
                                   atol=0)
        packed[root_p] = jpacked[root_p]
    np.testing.assert_array_equal(jpacked, packed)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=Q_TOL)
    assert np.isfinite(pt).all()


# (k, plies, sims, extra): 7x7 boards fresh, mid-game with root noise and a
# depth cap, and near the end (30 plies in: walks meet terminal nodes that
# an earlier "vl" pass of the same macro step linked)
@pytest.mark.parametrize("k,plies,sims,extra", [
    (2, 0, 16, {}),
    (4, 6, 24, dict(add_noise=True, dirichlet_alpha=0.3,
                    dirichlet_epsilon=0.25, dirichlet_moves=10,
                    max_depth=3)),
    (2, 30, 16, {}),
    (4, 30, 24, {}),
])
def test_kleaf_search_matches_jax_exactly(k, plies, sims, extra):
    _, jout, tout = _search_both(7, 12, plies, k, sims, seed=plies + k,
                                 **extra)
    _assert_search_equal(jout, tout, noise=extra.get("add_noise", False))


def _dense_states(size, batch, seed):
    """Live boards 3-6 points from full: the period-4 pattern of
    ``test_torch_port_gumbel._endgame_states`` (no run of three, so no
    stone wins) with random points cleared.  A full board is a draw, so the
    walks meet terminal nodes within a few plies."""
    r, c = np.mgrid[0:size, 0:size]
    boards = np.repeat(np.where((c + 2 * r) % 4 < 2, 1, 2)[None], batch, 0)
    boards = boards.astype(np.int8)
    rng = np.random.default_rng(seed)
    for b in range(batch):
        boards[b].reshape(-1)[rng.choice(size * size, 3 + b % 4,
                                         replace=False)] = 0
    stones = (boards != 0).reshape(batch, -1).sum(1)
    to_move = np.where(stones % 2 == 0, 1, 2).astype(np.int32)
    return jax.vmap(JaxEnv(size).from_board)(jnp.asarray(boards),
                                             jnp.asarray(to_move))


def test_kleaf_walks_stop_on_terminals_of_their_own_macro_step():
    """Near the end of a game a walk can stop on a terminal node that an
    earlier "vl" pass of the same macro step linked: its slot is an orphan,
    and the virtual loss on its path is cancelled by the finalize."""
    k, batch = 4, 12
    js = _dense_states(7, batch, seed=1)
    stops = []

    def walk(*args):
        out = tk.select_walk(*args)
        base = len(stops) // k * k + 1       # the macro step's first slot
        leaf, action = out[0], out[1]
        stops.append(int(((action < 0) & (leaf >= base)).sum()))
        return out

    ops = tk.TreeOps(walk, tk.backup_paths, tk.gumbel_select_walk)
    _, jout, tout = _search_both(7, batch, 40, k, 24, seed=1, js=js, ops=ops)
    assert not bool(np.asarray(js.done).any())
    assert sum(stops) > 0
    _assert_search_equal(jout, tout)


def test_kleaf_search_15x15_matches_jax_exactly():
    _, jout, tout = _search_both(15, 8, 4, 4, 32, seed=15)
    _assert_search_equal(jout, tout)


@pytest.mark.parametrize("plies", [3, 30])
def test_vl_and_finalize_match_jax(plies):
    """Two "vl" passes, then their two "finalize" passes, on a tree grown by
    a k-leaf search: the second walk may run through the first pass's slot,
    so the first finalize must keep the N, W and C it added."""
    size, batch, sims, k = 7, 12, 16, 2
    cfg, (_, _, jpacked), (_, _, packed) = _search_both(
        size, batch, plies, k, sims, seed=40 + plies, spare=k)
    np.testing.assert_array_equal(jpacked, packed.numpy())
    a = size * size
    jlay = jtk.packed_layout(a, cfg.node_capacity)
    lay = tk.packed_layout(a, cfg.node_capacity)
    depth = cfg.depth_limit
    rng = np.random.default_rng(plies)
    jtree = jnp.asarray(jpacked)
    passes = []
    for j in range(k):
        slot = sims + 1 + j
        sel = jtk.select_walk(jtree, jlay, 1.25, depth, interpret=True)
        _, action, pnodes, pacts, plen = (np.array(x) for x in sel)
        placeholder = np.where(rng.random((batch, a)) < 0.8, 1.0 / a,
                               -1.0).astype(np.float32)
        done = rng.random(batch) < 0.2
        inputs = (pnodes, pacts, plen, (action >= 0).astype(np.int32), slot,
                  done)
        zeros = np.zeros(batch, np.float32)
        jtree = _jax_backup(jtree, jlay, inputs, zeros, placeholder, "vl")
        _port_backup(packed, lay, inputs, zeros, placeholder, "vl")
        np.testing.assert_array_equal(np.asarray(jtree), packed.numpy(),
                                      err_msg=f"vl {j}")
        passes.append(inputs)
    assert np.asarray(jtree)[:, 8 * (sims + 1):].any()
    for j, inputs in enumerate(passes):
        values = rng.uniform(-1, 1, batch).astype(np.float32)
        priors = np.where(rng.random((batch, a)) < 0.8, rng.random((batch, a)),
                          -1.0).astype(np.float32)
        jtree = _jax_backup(jtree, jlay, inputs, values, priors, "finalize")
        _port_backup(packed, lay, inputs, values, priors, "finalize")
        np.testing.assert_array_equal(np.asarray(jtree), packed.numpy(),
                                      err_msg=f"finalize {j}")


def _jax_backup(tree, layout, inputs, values, priors, mode):
    pnodes, pacts, plen, expanding, slot, done = inputs
    return jtk.backup_paths(
        tree, jnp.asarray(pnodes), jnp.asarray(pacts), jnp.asarray(plen),
        jnp.asarray(values), jnp.asarray(expanding), jnp.int32(slot), layout,
        signed_priors=jnp.asarray(priors), done=jnp.asarray(done),
        interpret=True, mode=mode)


def _port_backup(packed, layout, inputs, values, priors, mode):
    pnodes, pacts, plen, expanding, slot, done = inputs
    tk.backup_paths(packed, torch.from_numpy(pnodes), torch.from_numpy(pacts),
                    torch.from_numpy(plen), torch.from_numpy(values),
                    torch.from_numpy(expanding), slot, layout,
                    torch.from_numpy(priors), torch.from_numpy(done),
                    mode=mode)


def test_kleaf_search_runs_the_modes_and_plain_ops_agree():
    """The k-leaf search calls the backup once per leaf in each of "vl" and
    "finalize" and never in "backup"; on the CPU the wrappers and the plain
    functions give the same search."""
    te = TableEval(7, seed=3)
    env = GomokuEnv(7)
    states = to_torch_state(random_jax_states(JaxEnv(7), 6, 5, seed=3))
    cfg = MCTSConfig(n_simulations=12, leaves_per_sim=3, add_noise=False)
    moves = torch.full((6,), 5, dtype=torch.int32)
    modes = []

    def spy(*args, mode="backup"):
        modes.append(mode)
        return tk.backup_paths(*args, mode=mode)

    ops = tk.TreeOps(tk.select_walk, spy, tk.gumbel_select_walk)
    out = run_search(env, cfg, te.torch, None, states, moves, ops=ops)
    assert modes == (["vl"] * 3 + ["finalize"] * 3) * 4
    plain = run_search(env, cfg, te.torch, None, states, moves, ops=tk.PLAIN)
    assert out.action is None and plain.action is None
    for x, y in zip(out[:2] + (out.carry.packed,),
                    plain[:2] + (plain.carry.packed,)):
        assert torch.equal(x, y)
