"""PUCT search over the packed node-tile tree, driving the two tree kernels.

Counterpart of ``alphazero_gomoku_tpu/search/tree_pallas.py``
(``_init_packed`` and ``run_mcts_packed``), and of its per-simulation body
``one_sim`` (``tree_pallas.py:211-275``).  The JAX version runs the
simulations in a ``lax.scan``; here they are a Python loop, and the tree and
the node-state stack are updated in place.

Per simulation:
  1. ``select_walk``: PUCT walk to an unexpanded edge, a terminal node or the
     depth cap; gives the leaf, the expansion action and the walk's path.
  2. Gather the leaf's game state, ``env.step`` the expansion edge; lanes that
     stopped without expanding keep the leaf's state (an orphan slot that
     nothing links to).  Write that state at ``slot`` of every lane.
  3. Encode and evaluate it; a terminal state takes its terminal value.
  4. ``backup_paths``: write the fresh slot tile (signed priors, done flag),
     back the value up the path and link the slot on the expansion edge.

Not ported yet, and refused by ``MCTSConfig``: subtree reuse (``PackedCarry``)
and k-leaf search (``one_macro``), ROADMAP Queue A item 11; Gumbel search,
item 7.
"""

from __future__ import annotations

from typing import Optional

import torch

from alphazero_gomoku_tpu_torch.games.gomoku import GomokuState, where_state
from alphazero_gomoku_tpu_torch.ops.tree_kernels import (
    KERNELS,
    SL_META,
    SL_N,
    SL_P,
    SL_W,
    TreeOps,
    init_packed,
    packed_layout,
)
from alphazero_gomoku_tpu_torch.search.tree import (
    EvalFn,
    MCTSConfig,
    _signed_priors,
    root_signed_priors,
    terminal_leaf_value,
)


def run_mcts_packed(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
                    root_states: GomokuState, move_numbers: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    ops: TreeOps = KERNELS):
    """Batched PUCT on the packed layout: ``(pi [B, A], root_q [B])``.

    ``noise`` ([B, A]) replaces the Dirichlet draw from ``generator`` (tests
    inject the JAX package's draw).  ``ops`` picks the tree functions: the
    kernel wrappers, or ``tree_kernels.PLAIN`` to run the plain versions on
    any device.
    """
    pi, root_q, _ = run_mcts_packed_with_tree(
        env, cfg, eval_fn, net_params, root_states, move_numbers, generator,
        noise=noise, ops=ops)
    return pi, root_q


def run_mcts_packed_with_tree(env, cfg: MCTSConfig, eval_fn: EvalFn,
                              net_params, root_states: GomokuState,
                              move_numbers: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              noise: Optional[torch.Tensor] = None,
                              ops: TreeOps = KERNELS):
    """:func:`run_mcts_packed` that also returns the searched packed tree."""
    a = env.num_actions
    n = cfg.node_capacity
    layout = packed_layout(a, n)
    batch = root_states.done.shape[0]
    dev = root_states.board.device
    lanes = torch.arange(batch, device=dev)
    fpu_parent = cfg.fpu_mode == "parent"

    signed = root_signed_priors(env, cfg, eval_fn, net_params, root_states,
                                move_numbers, generator, noise)

    # node-state stack [B, N, ...] with the root at node 0
    def stack_field(x):
        z = torch.zeros((batch, n) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=dev)
        z[:, 0] = x
        return z

    states = GomokuState(*(stack_field(x) for x in root_states))
    packed = init_packed(batch, layout, dev)
    packed[:, SL_P, :a] = signed                       # node 0's prior row
    packed[:, SL_META, 0] = root_states.done.to(torch.float32)

    for sim in range(cfg.n_simulations):
        slot = sim + 1
        leaf, action, pnodes, pacts, plen = ops.select_walk(
            packed, layout, cfg.cpuct, cfg.depth_limit, fpu_parent)
        expanding = action >= 0
        leaf_idx = leaf.long()
        parent_state = GomokuState(*(x[lanes, leaf_idx] for x in states))
        child_state = env.step(parent_state, torch.clamp(action, min=0))
        write_state = where_state(expanding, child_state, parent_state)
        for stack, x in zip(states, write_state):     # in place, lane-uniform
            stack[:, slot] = x

        probs, values = eval_fn(net_params, env.encode(write_state))
        probs = probs.reshape(batch, a)
        values = values.reshape(batch)
        leaf_value = torch.where(write_state.done,
                                 terminal_leaf_value(env, cfg, write_state),
                                 values).to(torch.float32)
        legal = env.legal_mask(write_state).to(probs.dtype)
        ops.backup_paths(packed, pnodes, pacts, plen, leaf_value, expanding,
                         slot, layout, _signed_priors(probs, legal),
                         write_state.done)

    # visit-count policy and root value from node 0's tile
    counts = packed[:, SL_N, :a]
    totals = counts.sum(dim=-1, keepdim=True)
    legal01 = (packed[:, SL_P, :a] >= 0.0).to(torch.float32)
    uniform = legal01 / torch.clamp(legal01.sum(dim=-1, keepdim=True), min=1.0)
    pi = torch.where(totals > 0, counts / torch.clamp(totals, min=1e-30),
                     uniform)
    root_q = packed[:, SL_W, :a].sum(dim=-1) / torch.clamp(totals[:, 0],
                                                           min=1.0)
    return pi, root_q, packed
