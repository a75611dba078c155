"""Parity: the plain ``select_walk`` / ``backup_paths`` against the JAX kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as
``tests/test_tree_kernels.py`` runs them.  The packed trees are grown by a
few simulations of both searches (which must leave equal trees), and every
output must be equal exactly.

One difference is in the layout of unused path rows, not in the walk:
the JAX kernel walks its lanes in lockstep over a tile of up to 128 lanes,
writes -1 for lanes that have stopped while others walk on, and leaves the
rows after the tile's last hop at their initial 0.  The port's walk is per
lane and writes -1 in every row at or beyond ``path_len``.  The backup reads
no row at or beyond ``path_len`` in either package.
``torch_port_util.assert_walk_equal`` turns the port's rows into the JAX
fill, so the comparison stays exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.ops import tree_kernels as jtk
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    run_mcts_packed_with_tree as jax_search_with_tree,
)
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.search.tree import MCTSConfig
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    run_mcts_packed_with_tree,
)

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    assert_walk_equal,
    one_torch_thread,
    random_jax_states,
    to_torch_state,
)

SIZE = 9
A = SIZE * SIZE
BATCH = 12
SIMS = 20


# (plies played before the search, depth cap, fpu mode): fresh and mid-game
# trees, a shallow depth cap that stops lanes mid-walk, terminal nodes late
# in the game, and the FPU "parent" score
CASES = [(0, 0, "zero"), (9, 2, "zero"), (40, 0, "zero"), (7, 0, "parent")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c}")
def trees(request):
    plies, max_depth, fpu = request.param
    te = TableEval(SIZE, seed=plies)
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    js = random_jax_states(jenv, BATCH, plies, seed=100 + plies)
    kw = dict(n_simulations=SIMS, cpuct=1.25, add_noise=False,
              max_depth=max_depth, fpu_mode=fpu)
    jcfg = JaxMCTSConfig(backend="pallas", **kw)
    cfg = MCTSConfig(**kw)
    moves = np.full((BATCH,), plies, np.int32)
    _, _, carry = jax.jit(lambda s: jax_search_with_tree(
        jenv, jcfg, te.jax, None, jnp.asarray(moves), jax.random.PRNGKey(0),
        root_states=s, interpret=True))(js)
    _, _, tree = run_mcts_packed_with_tree(
        env, cfg, te.torch, None, to_torch_state(js), torch.from_numpy(moves))
    return cfg, np.asarray(carry.packed), tree.packed


def test_searched_trees_are_equal(trees):
    _, jpacked, packed = trees
    np.testing.assert_array_equal(jpacked, packed.numpy())


def test_select_walk_matches_jax(trees):
    cfg, jpacked, packed = trees
    layout = tk.packed_layout(A, cfg.node_capacity)
    fpu = cfg.fpu_mode == "parent"
    depth = cfg.depth_limit
    jout = jtk.select_walk(jnp.asarray(jpacked), jtk.packed_layout(
        A, cfg.node_capacity), 1.25, depth, interpret=True, fpu_parent=fpu)
    tout = tk.select_walk(packed, layout, 1.25, depth, fpu_parent=fpu)
    assert_walk_equal(jout, tout, depth)
    # the wrapper took the plain version: the tensor is on the CPU
    plain = tk.select_walk_plain(packed, layout, 1.25, depth, fpu)
    for x, y in zip(tout, plain):
        assert torch.equal(x, y)


def test_backup_paths_matches_jax(trees):
    cfg, jpacked, packed = trees
    n = cfg.node_capacity
    depth = cfg.depth_limit
    jlay = jtk.packed_layout(A, n)
    sel = jtk.select_walk(jnp.asarray(jpacked), jlay, 1.25, depth,
                          interpret=True, fpu_parent=cfg.fpu_mode == "parent")
    _, action, pnodes, pacts, plen = (np.array(x) for x in sel)
    rng = np.random.default_rng(7)
    values = rng.uniform(-1, 1, BATCH).astype(np.float32)
    priors = np.where(rng.random((BATCH, A)) < 0.8,
                      rng.random((BATCH, A)), -1.0).astype(np.float32)
    done = rng.random(BATCH) < 0.2
    expanding = (action >= 0).astype(np.int32)
    slot = SIMS + 1
    want = jtk.backup_paths(
        jnp.asarray(jpacked), jnp.asarray(pnodes), jnp.asarray(pacts),
        jnp.asarray(plen), jnp.asarray(values), jnp.asarray(expanding),
        jnp.int32(slot), jlay, signed_priors=jnp.asarray(priors),
        done=jnp.asarray(done), interpret=True)
    got = tk.backup_paths(
        packed.clone(), torch.from_numpy(pnodes), torch.from_numpy(pacts),
        torch.from_numpy(plen), torch.from_numpy(values),
        torch.from_numpy(expanding), slot, tk.packed_layout(A, n),
        torch.from_numpy(priors), torch.from_numpy(done))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert not np.array_equal(np.asarray(want), jpacked)


def _small_inputs(b=2, n_nodes=6, depth=4):
    lay = tk.packed_layout(A, n_nodes)
    packed = tk.init_packed(b, lay, "cpu")
    i32 = dict(dtype=torch.int32)
    return dict(
        packed=packed, path_nodes=torch.zeros((depth, b), **i32),
        path_actions=torch.zeros((depth, b), **i32),
        path_len=torch.ones(b, **i32), values=torch.zeros(b),
        expanding=torch.ones(b, dtype=torch.bool), slot=1, layout=lay,
        signed_priors=torch.zeros((b, A)),
        done=torch.zeros(b, dtype=torch.bool))


@pytest.mark.parametrize("field,bad", [
    ("packed", lambda x: x[:, :-8]),                      # wrong node count
    ("packed", lambda x: x.double()),
    ("path_nodes", lambda x: x.long()),
    ("path_actions", lambda x: x[:, :1]),
    ("values", lambda x: x[:1]),
    ("signed_priors", lambda x: x.t().contiguous().t()),  # not contiguous
    ("path_len", lambda x: x.to("meta")),
])
def test_wrappers_check_their_inputs(field, bad):
    inputs = _small_inputs()
    inputs[field] = bad(inputs[field])
    with pytest.raises((ValueError, TypeError)):
        tk.backup_paths(**inputs)
    if field == "packed":
        with pytest.raises((ValueError, TypeError)):
            tk.select_walk(inputs["packed"], inputs["layout"], 1.0, 4)


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    inputs = _small_inputs()
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in inputs.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tk.select_walk(meta["packed"], meta["layout"], 1.0, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.backup_paths(**meta)


def test_cpu_calls_do_not_count_as_kernel_launches():
    tk.reset_launch_counts()
    inputs = _small_inputs()
    tk.select_walk(inputs["packed"], inputs["layout"], 1.0, 4)
    tk.backup_paths(**inputs)
    assert tk.select_walk.launches == 0 and tk.backup_paths.launches == 0
