"""Parity at the edges: the plain ``gumbel_select_walk`` against the JAX
kernel, on the random trees of ``tests/torch_port_edges.py``.

The trees hold values from 1e-30 to 1e30 (the kernel's fast division must
give way to ``/`` on them), priors of 1e-30, child indices that are -1,
negative, in range or beyond ``n_nodes`` (clamped), terminal nodes, and a
lane whose children all lead back into the tree, so that it cycles into the
depth cap.  The forced root actions are legal, illegal, negative and at or
beyond ``num_actions`` (``edge_roots``).  The JAX kernel runs in Pallas
interpret mode on the CPU, and every output must be equal exactly (with the
JAX walk's fill of unused path rows, ``assert_walk_equal``).  The card tests
hold the CUDA kernel against the plain version on the same inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.ops import tree_kernels as jtk
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk

from torch_port_edges import N_NODES, ROOT_KINDS, edge_roots, edge_tree
from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_walk_equal,
    one_torch_thread,
)

SIZE = 9
A = SIZE * SIZE
BATCH = 12
C_VISIT, C_SCALE = 50.0, 1.0


@pytest.mark.parametrize("fan", [1, 2])
@pytest.mark.parametrize("depth", [8, 40])
def test_gumbel_select_walk_edges_match_jax(depth, fan):
    packed = edge_tree(BATCH, SIZE, 40 + depth + fan)
    roots = edge_roots(packed, SIZE, fan, depth + fan)
    jout = jtk.gumbel_select_walk(
        jnp.asarray(packed), jnp.asarray(roots),
        jtk.packed_layout(A, N_NODES), depth, C_VISIT, C_SCALE,
        interpret=True, fan=fan)
    tout = tk.gumbel_select_walk(
        torch.from_numpy(packed), torch.from_numpy(roots),
        tk.packed_layout(A, N_NODES), depth, C_VISIT, C_SCALE, fan)
    assert_walk_equal(jout, tout, depth)
    # the inputs reach the cases: every kind of root action, a walk past the
    # root hop, a clamped child walked, both stops, and the depth cap
    lanes = BATCH * fan
    assert len(ROOT_KINDS) * fan <= lanes
    assert (roots < 0).any() and (roots >= A).any()
    _, action, pnodes, _, plen = (x.numpy() for x in tout)
    assert (plen >= 2).any()
    assert (pnodes >= N_NODES).any()
    assert (action < 0).any() and (action >= 0).any()
    if depth == 40:
        assert (plen == depth).any()
