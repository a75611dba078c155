"""Parity at the edges: the plain ``select_walk`` and ``backup_paths``
against the JAX kernels, on random trees and paths that take every lane
through a case the kernels must get right (``tests/torch_port_edges.py``):
a slot beyond ``n_nodes`` that clamps onto a node of the path, path actions
that are skipped (< 0 or >= seg), actions in ``[num_actions, seg)``, path
nodes and child indices beyond ``n_nodes`` (clamped), and hops that clamp to
one node, in all three backup modes.

The JAX kernels run in Pallas interpret mode on the CPU, as
``tests/test_torch_port_kernels.py`` runs them, and every output must be
equal exactly: the packed tree after a backup, and the walk's outputs (with
the JAX walk's fill of unused path rows, ``assert_walk_equal``).  The card
tests hold the CUDA kernels against the plain versions on the same inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.ops import tree_kernels as jtk
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk

from torch_port_edges import DEPTH, EDGE_CASES, N_NODES, edge_paths, edge_tree
from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    assert_walk_equal,
    one_torch_thread,
)

SIZE = 9
A = SIZE * SIZE
BATCH = 12


def _backup_inputs(case):
    seed = EDGE_CASES.index(case)
    return edge_tree(BATCH, SIZE, seed), edge_paths(case, BATCH, SIZE,
                                                    seed + 10)


def _case_happened(case, packed, p):
    """The lanes' paths do reach the case (on rows below path_len)."""
    rows = np.arange(DEPTH)[:, None] < p["path_len"]
    nodes, acts = p["path_nodes"][rows], p["path_actions"][rows]
    seg = packed.shape[-1]
    if case == "slot_on_path":
        assert p["slot"] >= N_NODES and (nodes == N_NODES - 1).any()
    elif case == "skipped_actions":
        assert ((acts < 0) | (acts >= seg)).any()
    elif case == "padded_action":
        assert ((acts >= A) & (acts < seg)).any()
    elif case == "clamped_nodes":
        assert (nodes < 0).any() and (nodes >= N_NODES).any()
    else:
        keys = np.stack([np.clip(p["path_nodes"], 0, N_NODES - 1),
                         p["path_actions"]], -1)
        lane_keys = [set() for _ in range(BATCH)]
        repeated = False
        for i in range(DEPTH):
            for b in np.flatnonzero(i < p["path_len"]):
                key = tuple(keys[i, b])
                repeated |= key in lane_keys[b]
                lane_keys[b].add(key)
        assert repeated


@pytest.mark.parametrize("mode", tk.BACKUP_MODES)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_backup_paths_edges_match_jax(case, mode):
    packed, p = _backup_inputs(case)
    _case_happened(case, packed, p)
    jlay = jtk.packed_layout(A, N_NODES)
    want = jtk.backup_paths(
        jnp.asarray(packed), jnp.asarray(p["path_nodes"]),
        jnp.asarray(p["path_actions"]), jnp.asarray(p["path_len"]),
        jnp.asarray(p["values"]), jnp.asarray(p["expanding"].astype(np.int32)),
        jnp.int32(p["slot"]), jlay, signed_priors=jnp.asarray(p["priors"]),
        done=jnp.asarray(p["done"]), interpret=True, mode=mode)
    got = tk.backup_paths(
        torch.from_numpy(packed.copy()), torch.from_numpy(p["path_nodes"]),
        torch.from_numpy(p["path_actions"]), torch.from_numpy(p["path_len"]),
        torch.from_numpy(p["values"]), torch.from_numpy(p["expanding"]),
        p["slot"], tk.packed_layout(A, N_NODES),
        torch.from_numpy(p["priors"]), torch.from_numpy(p["done"]),
        mode=mode)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert not np.array_equal(got.numpy(), packed)


@pytest.mark.parametrize("fpu", [False, True], ids=["zero", "parent"])
@pytest.mark.parametrize("depth", [DEPTH, 40])
def test_select_walk_edges_match_jax(depth, fpu):
    """Child indices beyond ``n_nodes`` and below -1, terminal nodes, and
    cycles that run into the depth cap."""
    packed = edge_tree(BATCH, SIZE, 20 + depth)
    jout = jtk.select_walk(jnp.asarray(packed), jtk.packed_layout(
        A, N_NODES), 1.25, depth, interpret=True, fpu_parent=fpu)
    tout = tk.select_walk(torch.from_numpy(packed), tk.packed_layout(
        A, N_NODES), 1.25, depth, fpu_parent=fpu)
    assert_walk_equal(jout, tout, depth)
    _, action, pnodes, _, plen = (x.numpy() for x in tout)
    assert (pnodes >= N_NODES).any()               # a clamped child walked
    assert (action < 0).any() and (action >= 0).any()
    if depth == 40:
        assert (plen == depth).any()               # a cycle to the depth cap
