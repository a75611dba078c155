"""PUCT and Gumbel search over the packed node-tile tree, driving the tree kernels.

Counterpart of ``alphazero_gomoku_tpu/search/tree_pallas.py``
(``_init_packed``, ``run_mcts_packed`` and ``run_gumbel_packed``), and of
their per-simulation bodies ``one_sim`` (``tree_pallas.py:211-275`` and
``:609-690``) and the round-parallel ``one_round`` (``:519-607``).  The JAX
version runs the simulations in a ``lax.scan``; here they are a Python loop,
and the tree and the node-state stack are updated in place.

Per simulation:
  1. The walk: ``select_walk`` (PUCT) or ``gumbel_select_walk`` (Gumbel:
     forced root action, then the deterministic non-root rule) to an
     unexpanded edge, a terminal node or the depth cap; gives the leaf, the
     expansion action and the walk's path.
  2. Gather the leaf's game state, ``env.step`` the expansion edge; lanes that
     stopped without expanding keep the leaf's state (an orphan slot that
     nothing links to).  Write that state at ``slot`` of every lane.
  3. Encode and evaluate it; a terminal state takes its terminal value.
  4. ``backup_paths``: write the fresh slot tile (signed priors, done flag,
     value), back the value up the path and link the slot on the expansion
     edge.

Not ported yet, and refused by ``MCTSConfig``: subtree reuse (``PackedCarry``)
and k-leaf search (``one_macro``), ROADMAP Queue A item 11.
"""

from __future__ import annotations

from typing import Optional

import torch

from alphazero_gomoku_tpu_torch.games.gomoku import GomokuState, where_state
from alphazero_gomoku_tpu_torch.ops.tree_kernels import (
    KERNELS,
    NEG_INF,
    SL_META,
    SL_N,
    SL_P,
    SL_W,
    TreeOps,
    init_packed,
    packed_layout,
)
from alphazero_gomoku_tpu_torch.search.gumbel import (
    _sigma,
    halving_schedule,
    improved_policy,
)
from alphazero_gomoku_tpu_torch.search.tree import (
    EvalFn,
    MCTSConfig,
    _masked_priors,
    _signed_priors,
    root_signed_priors,
    terminal_leaf_value,
)


def _state_stack(root_states: GomokuState, n: int) -> GomokuState:
    """Node-state stack ``[B, n, ...]`` with the root at node 0."""
    batch = root_states.done.shape[0]

    def stack_field(x):
        z = torch.zeros((batch, n) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        z[:, 0] = x
        return z

    return GomokuState(*(stack_field(x) for x in root_states))


def _expand_and_eval(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
                     states: GomokuState, trees: torch.Tensor,
                     leaf: torch.Tensor, action: torch.Tensor):
    """Steps 2-3 of a simulation for walk lanes over trees ``trees [L]``.

    Returns ``(write_state, expanding, leaf_value [L], signed_priors [L, A])``:
    the state each lane's slot gets, and the backup's inputs.
    """
    expanding = action >= 0
    parent_state = GomokuState(*(x[trees, leaf.long()] for x in states))
    child_state = env.step(parent_state, torch.clamp(action, min=0))
    write_state = where_state(expanding, child_state, parent_state)
    probs, values = eval_fn(net_params, env.encode(write_state))
    lanes = leaf.shape[0]
    probs = probs.reshape(lanes, env.num_actions)
    values = values.reshape(lanes)
    leaf_value = torch.where(write_state.done,
                             terminal_leaf_value(env, cfg, write_state),
                             values).to(torch.float32)
    legal = env.legal_mask(write_state).to(probs.dtype)
    return write_state, expanding, leaf_value, _signed_priors(probs, legal)


def _write_slot(states: GomokuState, slot: int, write_state: GomokuState):
    for stack, x in zip(states, write_state):     # in place, lane-uniform
        stack[:, slot] = x


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
    states = _state_stack(root_states, n)
    packed = init_packed(batch, layout, dev)
    packed[:, SL_P, :a] = signed                       # node 0's prior row
    packed[:, SL_META, 0] = root_states.done.to(torch.float32)

    for sim in range(cfg.n_simulations):
        slot = sim + 1
        leaf, action, pnodes, pacts, plen = ops.select_walk(
            packed, layout, cfg.cpuct, cfg.depth_limit, fpu_parent)
        write_state, expanding, leaf_value, priors = _expand_and_eval(
            env, cfg, eval_fn, net_params, states, lanes, leaf, action)
        _write_slot(states, slot, write_state)
        ops.backup_paths(packed, pnodes, pacts, plen, leaf_value, expanding,
                         slot, layout, priors, write_state.done)

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


# ----------------------------------------------------------------------
# Gumbel sequential halving
# ----------------------------------------------------------------------
def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores per row, ties to the lowest index
    (as ``jax.lax.top_k``), int32 ``[B, k]``."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[:, :k].to(torch.int32)


def run_gumbel_packed(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
                      root_states: GomokuState,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[torch.Tensor] = None,
                      ops: TreeOps = KERNELS):
    """Gumbel sequential halving on the packed layout:
    ``(pi_target [B, A], root_q [B], action [B])``.

    ``uniforms`` ([B, A] in [1e-12, 1)) replaces the draw from ``generator``
    (tests inject the JAX package's draw).  ``ops`` picks the tree functions.
    """
    pi, root_q, action, _ = run_gumbel_packed_with_tree(
        env, cfg, eval_fn, net_params, root_states, generator,
        uniforms=uniforms, ops=ops)
    return pi, root_q, action


def run_gumbel_packed_with_tree(env, cfg: MCTSConfig, eval_fn: EvalFn,
                                net_params, root_states: GomokuState,
                                generator: Optional[torch.Generator] = None,
                                uniforms: Optional[torch.Tensor] = None,
                                ops: TreeOps = KERNELS, carry=None):
    """:func:`run_gumbel_packed` that also returns the searched packed tree.

    The root's value estimate rides the meta row's column 1, where the walk
    reads it for the completed Q.  Each phase of the halving schedule runs
    its simulations serially (``one_sim`` of the JAX package), or, with
    ``cfg.gumbel_round_parallel``, in rounds of one walk per surviving root
    action (``fan = m_k`` lanes per tree) and one network call, after which
    the backups are replayed in slot order (``one_round``).  ``carry``
    (subtree reuse) is not ported yet.
    """
    if carry is not None:
        raise NotImplementedError(
            "Gumbel subtree reuse (carry=) is not ported yet (ROADMAP "
            "Queue A item 11)")
    a = env.num_actions
    n = cfg.node_capacity
    layout = packed_layout(a, n)
    batch = root_states.done.shape[0]
    dev = root_states.board.device
    lanes = torch.arange(batch, device=dev)
    m, phases = halving_schedule(cfg.n_simulations, cfg.gumbel_max_considered)

    # root evaluation: priors, value, Gumbel-perturbed logits
    probs, v0 = eval_fn(net_params, env.encode(root_states))
    probs = probs.reshape(batch, a)
    v0 = v0.reshape(batch).to(torch.float32)
    legal = env.legal_mask(root_states)
    priors = _masked_priors(probs, legal.to(probs.dtype))
    signed = torch.where(legal, priors, -1.0)

    states = _state_stack(root_states, n)
    packed = init_packed(batch, layout, dev)
    packed[:, SL_P, :a] = signed
    packed[:, SL_META, 0] = root_states.done.to(torch.float32)
    packed[:, SL_META, 1] = v0

    logits = torch.where(legal, torch.log(torch.clamp(priors, min=1e-30)),
                         NEG_INF)
    if uniforms is None:
        uniforms = torch.clamp(torch.rand((batch, a), generator=generator,
                                          device=dev), min=1e-12)
    g = torch.where(legal, -torch.log(-torch.log(uniforms)), NEG_INF)
    ranked = _top_k(g + logits, m)

    def root_score():
        n_root = packed[:, SL_N, :a]
        q_hat = packed[:, SL_W, :a] / torch.clamp(n_root, min=1.0)
        return torch.where(n_root > 0, g + logits + _sigma(q_hat, n_root, cfg),
                           NEG_INF)

    def forced(cand):
        # candidates that are illegal (fewer legal moves than m) fall back to
        # the best-ranked action
        ok = legal.gather(1, cand.long())
        return torch.where(ok, cand, ranked[:, :1]).to(torch.int32)

    def walk(root_act, fan):
        return ops.gumbel_select_walk(
            packed, root_act.reshape(-1).contiguous(), layout,
            cfg.depth_limit, cfg.gumbel_c_visit, cfg.gumbel_c_scale, fan)

    slot = 1
    for m_k, visits in phases:
        if cfg.gumbel_round_parallel:
            trees = lanes.repeat_interleave(m_k)
            for _ in range(visits):
                leaf, action, pnodes, pacts, plen = walk(
                    forced(ranked[:, :m_k]), m_k)
                write_state, expanding, leaf_value, priors = _expand_and_eval(
                    env, cfg, eval_fn, net_params, states, trees, leaf,
                    action)
                # lane l = tree * m_k + c: column c is one serial simulation
                for c in range(m_k):
                    col = slice(c, None, m_k)
                    _write_slot(states, slot, GomokuState(
                        *(x[col] for x in write_state)))
                    ops.backup_paths(
                        packed, pnodes[:, col].contiguous(),
                        pacts[:, col].contiguous(), plen[col].contiguous(),
                        leaf_value[col].contiguous(),
                        expanding[col].contiguous(), slot, layout,
                        priors[col].contiguous(),
                        write_state.done[col].contiguous())
                    slot += 1
        else:
            for j in range(m_k * visits):
                leaf, action, pnodes, pacts, plen = walk(
                    forced(ranked[:, j % m_k:j % m_k + 1]), 1)
                write_state, expanding, leaf_value, priors = _expand_and_eval(
                    env, cfg, eval_fn, net_params, states, lanes, leaf,
                    action)
                _write_slot(states, slot, write_state)
                ops.backup_paths(packed, pnodes, pacts, plen, leaf_value,
                                 expanding, slot, layout, priors,
                                 write_state.done)
                slot += 1

        # halve: the top of the considered set by g + logits + sigma(q_hat);
        # scoring the full action space with -inf outside the set keeps this
        # a plain top-k
        in_set = torch.zeros((batch, a), dtype=torch.bool, device=dev)
        in_set[lanes[:, None], ranked[:, :m_k].long()] = True
        ranked = _top_k(torch.where(in_set, root_score(), NEG_INF), m)

    action = ranked[:, 0]
    n_root = packed[:, SL_N, :a]
    w_root = packed[:, SL_W, :a]
    pi_target = improved_policy(logits, n_root, w_root, packed[:, SL_P, :a],
                                v0, legal, cfg)
    root_q = w_root.sum(dim=-1) / torch.clamp(n_root.sum(dim=-1), min=1.0)
    return pi_target, root_q, action, packed
