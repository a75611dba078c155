"""PUCT and Gumbel search over the packed node-tile tree, driving the tree kernels.

Counterpart of ``alphazero_gomoku_tpu/search/tree_pallas.py``
(``_init_packed``, ``PackedCarry``, ``run_mcts_packed``,
``run_gumbel_packed``, ``packed_advance_root`` and ``init_packed_carry``),
and of their per-simulation bodies ``one_sim`` (``tree_pallas.py:211-275``
and ``:609-690``), the k-leaf ``one_macro`` (``:277-357``) and the
round-parallel ``one_round`` (``:519-607``).  The JAX version runs the
simulations in a ``lax.scan``; here they are a Python loop, and the tree and
the node-state stack are updated in place.

Every search goes through :func:`run_search`, which runs ``cfg.search``
(``_run_puct`` or ``_run_gumbel``) from a fresh tree or from a carried one;
:func:`run_mcts_with_q` is its ``(pi, root_q)`` from a fresh tree, as the
JAX package's entry point returns.  Both serial loops run each simulation's
steps 2-4 in ``_simulate``.

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

k-leaf PUCT (``cfg.leaves_per_sim = k > 1``), per macro step of k
simulations, slots ``step*k + 1 + j``:
  1. k times (j = 0 .. k-1): steps 1-2, then ``backup_paths`` mode ``"vl"``
     with placeholder priors (uniform over the leaf's legal moves) and value
     0: the virtual loss (N + 1, W - 1 on the path) steers the next walk, and
     the linked slot lets it descend through the new node.
  2. One network call on the k leaves' boards, ``[k*B]`` in j-major order.
  3. k times, in j order: ``backup_paths`` mode ``"finalize"`` with the real
     priors and value, which replaces the virtual loss.

Subtree reuse (``cfg.reuse_budget = R > 0``): a search given a ``carry``
starts from the carried tree (its root's priors, done flag and, for
Gumbel, value are refreshed) and its simulations take slots R, R+1, ...;
each simulation also records its slot's parent and action in the carry's
sidecar arrays, which :func:`packed_advance_root` follows to re-root the
tree at the played move between moves.

Spans (``utils.profiling.trace_annotation``: ``record_function`` ranges
while a profiler records, nothing otherwise): ``az.root`` holds what a search
does before its first simulation (the carry's copy, the root's evaluation,
its noise or Gumbel draw and top-k); each simulation step is ``az.walk``
(step 1), ``az.expand`` (step 2 with the slot's writes), ``az.eval`` (step
3) and ``az.backup`` (step 4), every line of the step in one of them; a
Gumbel search's halving between phases is ``az.halve``; every call of the
eval function is ``az.net``, inside ``az.eval`` or ``az.root``.  A step is a
walk call: one simulation, a k-leaf leaf (whose ``az.backup`` is the virtual
loss's; the macro step adds one ``az.eval`` and one ``az.backup`` of the k
finalize backups), or a round-parallel round of ``m_k`` simulations.
:func:`packed_advance_root` runs in the move loop's ``az.advance_root``.

The searches are generic over the game's state NamedTuple (``GomokuState``,
``PenteState``), as the JAX searches are over its state pytree: every node
holds every field (Pente's ``captures`` too), and each gather, slot write,
concatenation and re-rooting rebuilds the state as ``type(state)(*fields)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuState, where_state
from alphazero_gomoku_tpu_torch.games.pente import PenteState
from alphazero_gomoku_tpu_torch.ops.tree_kernels import (
    KERNELS,
    NEG_INF,
    SL_C,
    SL_META,
    SL_N,
    SL_P,
    SL_W,
    TreeOps,
    init_packed,
    node_tiles,
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
from alphazero_gomoku_tpu_torch.utils.profiling import trace_annotation


class PackedCarry(NamedTuple):
    """A searched tree with what subtree reuse carries across moves.

    ``packed`` is the packed tree, ``states`` the node-state stack (each
    field ``[B, node_capacity, ...]``), and ``parent`` / ``parent_action``
    (i32 ``[B, n_nodes]``, -1 at roots and orphans) each slot's parent node
    and the action leading to it: the tiles hold only child links, and
    :func:`packed_advance_root` walks the parent links.  A PUCT search
    writes them only with ``cfg.reuse_budget > 0``, a Gumbel search always,
    as in the JAX package.
    """

    packed: torch.Tensor
    states: NamedTuple
    parent: torch.Tensor
    parent_action: torch.Tensor


def _state_stack(root_states, n: int):
    """Node-state stack ``[B, n, ...]`` with the root at node 0."""
    batch = root_states.done.shape[0]

    def stack_field(x):
        z = torch.zeros((batch, n) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        z[:, 0] = x
        return z

    return type(root_states)(*(stack_field(x) for x in root_states))


def _fresh_carry(env, cfg: MCTSConfig, root_states) -> PackedCarry:
    layout = packed_layout(env.num_actions, cfg.node_capacity)
    batch = root_states.done.shape[0]
    dev = root_states.board.device
    no_link = torch.full((batch, layout.n_nodes), -1, dtype=torch.int32,
                         device=dev)
    return PackedCarry(init_packed(batch, layout, dev),
                       _state_stack(root_states, cfg.node_capacity),
                       no_link, no_link.clone())


def init_packed_carry(env, cfg: MCTSConfig, root_states) -> PackedCarry:
    """The empty tree of ``root_states`` as a carry (zero stats, children
    -1): the self-play runner's carry from move 0.  A search given it runs
    the search of a fresh tree, with its slots moved up by
    ``reuse_budget - 1``."""
    if cfg.reuse_budget <= 0:
        raise ValueError("init_packed_carry requires cfg.reuse_budget > 0")
    return _fresh_carry(env, cfg, root_states)


def _begin(env, cfg: MCTSConfig, root_states, carry: Optional[PackedCarry]):
    """``(carry, root_states, slot_base)`` a search starts from: a fresh tree
    whose simulations take slots 1, 2, ..., or a copy of ``carry`` whose
    simulations take slots ``reuse_budget``, ... (the root states default to
    the carried roots)."""
    if carry is None:
        if root_states is None:
            raise ValueError("need root_states for the first move")
        return _fresh_carry(env, cfg, root_states), root_states, 1
    if cfg.reuse_budget <= 0:
        raise ValueError("carry= requires cfg.reuse_budget > 0")
    # a copy: the search writes its tree in place, and the caller's carry
    # stays as it was
    packed, states, parent, pact = carry
    carry = PackedCarry(packed.clone(),
                        type(states)(*(x.clone() for x in states)),
                        parent.clone(), pact.clone())
    if root_states is None:
        root_states = type(states)(*(x[:, 0] for x in carry.states))
    return carry, root_states, cfg.reuse_budget


def _expand(env, states, trees: torch.Tensor, leaf: torch.Tensor,
            action: torch.Tensor):
    """Step 2 of a simulation for walk lanes over trees ``trees [L]``:
    ``(write_state, expanding)``, the state each lane's slot gets."""
    expanding = action >= 0
    parent_state = type(states)(*(x[trees, leaf.long()] for x in states))
    child_state = env.step(parent_state, torch.clamp(action, min=0))
    return where_state(expanding, child_state, parent_state), expanding


def _expand_slot(env, carry: PackedCarry, lanes: torch.Tensor, slot: int,
                 leaf: torch.Tensor, action: torch.Tensor, parents: bool):
    """Step 2 of a serial simulation, in ``az.expand``: ``(write_state,
    expanding)``, the state written at ``slot`` of every lane (and, with
    ``parents``, the slot's parent and action in the carry's sidecar)."""
    with trace_annotation("az.expand"):
        write_state, expanding = _expand(env, carry.states, lanes, leaf,
                                         action)
        _write_slot(carry.states, slot, write_state)
        if parents:
            _write_parent(carry, slot, leaf, action, expanding)
    return write_state, expanding


def _evaluate(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params, leaves):
    """Step 3: ``(leaf_value [L], signed_priors [L, A])`` of the leaf
    states, in one network call."""
    obs = env.encode(leaves)
    with trace_annotation("az.net"):
        probs, values = eval_fn(net_params, obs)
    lanes = leaves.done.shape[0]
    probs = probs.reshape(lanes, env.num_actions)
    values = values.reshape(lanes)
    leaf_value = torch.where(leaves.done,
                             terminal_leaf_value(env, cfg, leaves),
                             values).to(torch.float32)
    legal = env.legal_mask(leaves).to(probs.dtype)
    return leaf_value, _signed_priors(probs, legal)


def _write_slot(states, slot: int, write_state):
    for stack, x in zip(states, write_state):     # in place, lane-uniform
        stack[:, slot] = x


def _write_parent(carry: PackedCarry, slot: int, leaf: torch.Tensor,
                  action: torch.Tensor, expanding: torch.Tensor):
    """The sidecar of one simulation: the slot's parent and action."""
    carry.parent[:, slot] = torch.where(expanding, leaf, -1)
    carry.parent_action[:, slot] = action


def _simulate(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
              ops: TreeOps, carry: PackedCarry, layout, lanes: torch.Tensor,
              slot: int, walked, parents: bool):
    """Steps 2-4 of one serial simulation from its walk's outputs
    ``walked``: expand with the slot's writes (the sidecar too, with
    ``parents``), evaluate, back up into ``slot``."""
    leaf, action, pnodes, pacts, plen = walked
    write_state, expanding = _expand_slot(env, carry, lanes, slot, leaf,
                                          action, parents)
    with trace_annotation("az.eval"):
        leaf_value, priors = _evaluate(env, cfg, eval_fn, net_params,
                                       write_state)
    with trace_annotation("az.backup"):
        ops.backup_paths(carry.packed, pnodes, pacts, plen, leaf_value,
                         expanding, slot, layout, priors, write_state.done)


class SearchResult(NamedTuple):
    """What :func:`run_search` returns."""

    # [B, A]: visit counts (PUCT) or the improved-policy target (Gumbel)
    pi: torch.Tensor
    root_q: torch.Tensor             # [B]
    action: Optional[torch.Tensor]   # [B] halving winner (Gumbel); None (PUCT)
    carry: PackedCarry               # the searched tree


def run_search(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
               root_states, move_numbers: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, *,
               carry: Optional[PackedCarry] = None,
               noise: Optional[torch.Tensor] = None,
               uniforms: Optional[torch.Tensor] = None,
               ops: TreeOps = KERNELS) -> SearchResult:
    """The batched search of ``cfg.search`` on the packed layout.

    PUCT (``"puct"``) gives the root's visit-count policy and reads
    ``move_numbers`` (``[B]``, the Dirichlet gate) and ``noise`` (``[B,
    A]``, in place of the Dirichlet draw from ``generator``).  Gumbel
    (``"gumbel"``) gives the improved-policy target and the halving
    winner, and reads ``uniforms`` (``[B, A]`` in ``[1e-12, 1)``, in place
    of its root draw from ``generator``); it ignores ``move_numbers`` and
    ``noise``.  Tests inject the JAX package's draws through ``noise`` and
    ``uniforms``.

    ``carry=None`` searches a fresh tree.  With ``cfg.reuse_budget > 0``,
    ``carry`` is the tree of the previous move after
    :func:`packed_advance_root` (or :func:`init_packed_carry`'s at move 0);
    it is not changed.  ``root_states`` defaults to the carried roots; the
    self-play runner passes its own game states, which equal them on live
    lanes.  The root's priors, done flag, noise (PUCT) and value (Gumbel)
    are computed anew each move; the carried root keeps its N, W and child
    links.  ``ops`` picks the tree functions: the kernel wrappers, or
    ``tree_kernels.PLAIN`` to run the plain versions on any device.
    """
    if cfg.search == "gumbel":
        return _run_gumbel(env, cfg, eval_fn, net_params, root_states,
                           generator, uniforms, ops, carry)
    return _run_puct(env, cfg, eval_fn, net_params, root_states,
                     move_numbers, generator, noise, ops, carry)


def run_mcts_with_q(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
                    root_states, move_numbers: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    ops: TreeOps = KERNELS):
    """:func:`run_search` from a fresh tree, as ``(pi [B, A], root_q
    [B])``: the JAX package's entry point (``search/tree.py`` there).

    Every batch size runs the packed search.  The JAX package sends batches
    below 8 to its XLA array tree because its Pallas kernels need 8 lanes;
    the two are bit-identical there (``tests/test_tree_kernels.py``), and the
    CUDA kernels have no lane floor, so the port needs no second search.
    """
    pi, root_q, _, _ = run_search(env, cfg, eval_fn, net_params, root_states,
                                  move_numbers, generator, noise=noise,
                                  ops=ops)
    return pi, root_q


def _run_puct(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params, root_states,
              move_numbers: torch.Tensor,
              generator: Optional[torch.Generator],
              noise: Optional[torch.Tensor], ops: TreeOps,
              carry: Optional[PackedCarry]) -> SearchResult:
    """PUCT: one walk a simulation, or k-leaf macro steps."""
    if cfg.reuse_budget > 0 and cfg.leaves_per_sim > 1:
        raise ValueError("subtree reuse is not supported with "
                         "leaves_per_sim > 1")
    with trace_annotation("az.root"):
        carry, root_states, slot_base = _begin(env, cfg, root_states, carry)
        packed, states = carry.packed, carry.states
        a = env.num_actions
        layout = packed_layout(a, cfg.node_capacity)
        batch = root_states.done.shape[0]
        dev = root_states.board.device
        lanes = torch.arange(batch, device=dev)
        fpu_parent = cfg.fpu_mode == "parent"

        signed = root_signed_priors(env, cfg, eval_fn, net_params,
                                    root_states, move_numbers, generator,
                                    noise)
        # the root's prior row and done flag; N, W and children carry over
        packed[:, SL_P, :a] = signed
        packed[:, SL_META, 0] = root_states.done.to(torch.float32)

    def walk():
        with trace_annotation("az.walk"):
            return ops.select_walk(packed, layout, cfg.cpuct,
                                   cfg.depth_limit, fpu_parent)

    k = cfg.leaves_per_sim
    if k == 1:
        for sim in range(cfg.n_simulations):
            _simulate(env, cfg, eval_fn, net_params, ops, carry, layout,
                      lanes, sim + slot_base, walk(), cfg.reuse_budget > 0)
    else:
        zeros = torch.zeros(batch, dtype=torch.float32, device=dev)
        for step in range(cfg.n_simulations // k):
            base = step * k + 1
            macro = []
            for j in range(k):
                leaf, action, pnodes, pacts, plen = walk()
                write_state, expanding = _expand_slot(
                    env, carry, lanes, base + j, leaf, action, False)
                with trace_annotation("az.backup"):
                    legal = env.legal_mask(write_state).to(torch.float32)
                    n_legal = torch.clamp(legal.sum(dim=-1, keepdim=True),
                                          min=1.0)
                    placeholder = torch.where(legal > 0, legal / n_legal,
                                              -1.0)
                    ops.backup_paths(packed, pnodes, pacts, plen, zeros,
                                     expanding, base + j, layout,
                                     placeholder, write_state.done,
                                     mode="vl")
                macro.append((pnodes, pacts, plen, expanding, write_state))
            with trace_annotation("az.eval"):
                # the k leaves in one network call, j-major
                leaves = type(states)(*(torch.cat(field) for field in zip(
                    *(m[4] for m in macro))))
                leaf_value, priors = _evaluate(env, cfg, eval_fn, net_params,
                                               leaves)
            with trace_annotation("az.backup"):
                for j, (pnodes, pacts, plen, expanding, write_state) in \
                        enumerate(macro):
                    rows = slice(j * batch, (j + 1) * batch)
                    ops.backup_paths(packed, pnodes, pacts, plen,
                                     leaf_value[rows], expanding, base + j,
                                     layout, priors[rows], write_state.done,
                                     mode="finalize")

    # visit-count policy and root value from node 0's tile
    counts = packed[:, SL_N, :a]
    totals = counts.sum(dim=-1, keepdim=True)
    legal01 = (packed[:, SL_P, :a] >= 0.0).to(torch.float32)
    uniform = legal01 / torch.clamp(legal01.sum(dim=-1, keepdim=True), min=1.0)
    pi = torch.where(totals > 0, counts / torch.clamp(totals, min=1e-30),
                     uniform)
    root_q = packed[:, SL_W, :a].sum(dim=-1) / torch.clamp(totals[:, 0],
                                                           min=1.0)
    return SearchResult(pi, root_q, None, carry)


# ----------------------------------------------------------------------
# Gumbel sequential halving
# ----------------------------------------------------------------------
def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores per row, ties to the lowest index
    (as ``jax.lax.top_k``), int32 ``[B, k]``."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[:, :k].to(torch.int32)


def _run_gumbel(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
                root_states, generator: Optional[torch.Generator],
                uniforms: Optional[torch.Tensor], ops: TreeOps,
                carry: Optional[PackedCarry]) -> SearchResult:
    """Gumbel sequential halving; ``root_q`` is the mean backed-up root
    value.

    The root's value estimate rides the meta row's column 1, where the walk
    reads it for the completed Q.  Each phase of the halving schedule runs
    its simulations serially (``one_sim`` of the JAX package), or, with
    ``cfg.gumbel_round_parallel``, in rounds of one walk per surviving root
    action (``fan = m_k`` lanes per tree) and one network call, after which
    the backups are replayed in slot order (``one_round``).
    """
    with trace_annotation("az.root"):
        carry, root_states, slot = _begin(env, cfg, root_states, carry)
        packed, states = carry.packed, carry.states
        a = env.num_actions
        layout = packed_layout(a, cfg.node_capacity)
        batch = root_states.done.shape[0]
        dev = root_states.board.device
        lanes = torch.arange(batch, device=dev)
        m, phases = halving_schedule(cfg.n_simulations,
                                     cfg.gumbel_max_considered)

        # root evaluation: priors, value, Gumbel-perturbed logits
        obs = env.encode(root_states)
        with trace_annotation("az.net"):
            probs, v0 = eval_fn(net_params, obs)
        probs = probs.reshape(batch, a)
        v0 = v0.reshape(batch).to(torch.float32)
        legal = env.legal_mask(root_states)
        priors = _masked_priors(probs, legal.to(probs.dtype))
        signed = torch.where(legal, priors, -1.0)

        # the root's prior row, done flag and value; N, W and children
        # carry over
        packed[:, SL_P, :a] = signed
        packed[:, SL_META, 0] = root_states.done.to(torch.float32)
        packed[:, SL_META, 1] = v0

        logits = torch.where(legal,
                             torch.log(torch.clamp(priors, min=1e-30)),
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

    def walk(cand, fan):
        with trace_annotation("az.walk"):
            return ops.gumbel_select_walk(
                packed, forced(cand).reshape(-1).contiguous(), layout,
                cfg.depth_limit, cfg.gumbel_c_visit, cfg.gumbel_c_scale, fan)

    for m_k, visits in phases:
        if cfg.gumbel_round_parallel:
            trees = lanes.repeat_interleave(m_k)
            for _ in range(visits):
                leaf, action, pnodes, pacts, plen = walk(ranked[:, :m_k],
                                                         m_k)
                # lane l = tree * m_k + c: column c is one serial
                # simulation, and takes slot slot + c
                cols = [slice(c, None, m_k) for c in range(m_k)]
                with trace_annotation("az.expand"):
                    write_state, expanding = _expand(env, states, trees,
                                                     leaf, action)
                    for c, col in enumerate(cols):
                        _write_slot(states, slot + c, type(states)(
                            *(x[col] for x in write_state)))
                        _write_parent(carry, slot + c, leaf[col],
                                      action[col], expanding[col])
                with trace_annotation("az.eval"):
                    leaf_value, priors = _evaluate(env, cfg, eval_fn,
                                                   net_params, write_state)
                with trace_annotation("az.backup"):
                    for c, col in enumerate(cols):
                        ops.backup_paths(
                            packed, pnodes[:, col].contiguous(),
                            pacts[:, col].contiguous(),
                            plen[col].contiguous(),
                            leaf_value[col].contiguous(),
                            expanding[col].contiguous(), slot + c, layout,
                            priors[col].contiguous(),
                            write_state.done[col].contiguous())
                slot += m_k
        else:
            for j in range(m_k * visits):
                _simulate(env, cfg, eval_fn, net_params, ops, carry, layout,
                          lanes, slot, walk(ranked[:, j % m_k:j % m_k + 1], 1),
                          True)
                slot += 1

        with trace_annotation("az.halve"):
            # the top of the considered set by g + logits + sigma(q_hat);
            # scoring the full action space with -inf outside the set keeps
            # this a plain top-k
            in_set = torch.zeros((batch, a), dtype=torch.bool, device=dev)
            in_set[lanes[:, None], ranked[:, :m_k].long()] = True
            ranked = _top_k(torch.where(in_set, root_score(), NEG_INF), m)

    action = ranked[:, 0]
    n_root = packed[:, SL_N, :a]
    w_root = packed[:, SL_W, :a]
    pi_target = improved_policy(logits, n_root, w_root, packed[:, SL_P, :a],
                                v0, legal, cfg)
    root_q = w_root.sum(dim=-1) / torch.clamp(n_root.sum(dim=-1), min=1.0)
    return SearchResult(pi_target, root_q, action, carry)


# ----------------------------------------------------------------------
# cross-move subtree reuse
# ----------------------------------------------------------------------
def packed_advance_root(env, cfg: MCTSConfig, carry: PackedCarry,
                        actions: torch.Tensor) -> PackedCarry:
    """Re-root each lane's tree at its played action and compact it.

    ``tree_pallas.packed_advance_root`` of the JAX package, batched over the
    lanes.  The played edge's child ``r`` becomes the root.  The nodes
    reached from ``r`` through the parent links, in at most
    ``min(depth_limit, n_nodes)`` sweeps, are ranked by (depth, old index)
    (a stable sort) and
    the first ``reuse_budget`` of them kept, renumbered to ``[0,
    reuse_budget)`` in that order; the child links in their C rows are
    renumbered (links to dropped nodes become -1), and dropped tiles become
    fresh ones (zero, children -1), as the backup's slot compose expects.
    The state stack and the parent links follow the same order.  Where the
    played action was never expanded, the lane starts afresh: the root is
    ``env.step`` of the old root and the action, everything else empty.
    Finished lanes (action 0 from ``step_safe``) go through the same
    arithmetic.  Returns a new carry; ``carry`` is not changed.
    """
    if cfg.reuse_budget <= 0:
        raise ValueError("packed_advance_root requires cfg.reuse_budget > 0")
    layout = packed_layout(env.num_actions, cfg.node_capacity)
    cap, budget = layout.n_nodes, cfg.reuse_budget
    packed, states, parent, pact = carry
    b = packed.shape[0]
    dev = packed.device
    lanes = torch.arange(b, device=dev)
    idx = torch.arange(cap, dtype=torch.int32, device=dev)[None]   # [1, cap]
    actions = actions.to(device=dev, dtype=torch.int64)
    tiles = node_tiles(packed, layout)                 # [B, cap, GROUP, seg]
    r = tiles[lanes, 0, SL_C, actions].to(torch.int32)
    fresh = r < 0

    # reachability from r: a node is reached a sweep after its parent.  JAX
    # runs min(depth_limit, n_nodes) sweeps; a sweep that reaches no new
    # node leaves reach and depth as they are, so the loop stops there
    psafe = torch.clamp(parent, min=0).long()
    has_parent = parent >= 0
    reach = idx == torch.clamp(r, min=0)[:, None]
    depth = torch.where(reach, 0, cap).to(torch.int32)
    for _ in range(min(cfg.depth_limit, cap)):
        preach = reach.gather(1, psafe) & has_parent
        if not bool((preach & ~reach).any()):
            break
        depth = torch.where(reach, depth,
                            torch.where(preach, depth.gather(1, psafe) + 1,
                                        cap))
        reach = reach | preach

    big = 2 * cap * cap
    key = torch.where(reach, depth * cap + idx, big)
    order = torch.argsort(key, dim=1, stable=True)
    take = (key.gather(1, order) < big) & (idx < budget)
    new_of_old = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    new_of_old.scatter_(1, order, torch.where(take, idx, -1))
    # the tiles, states and links that end up empty: dropped ones, and
    # every one of a lane that starts afresh
    gone = ~take | fresh[:, None]                          # [B, cap]

    def remap(ptr):
        flat = ptr.reshape(b, -1)
        new = new_of_old.gather(1, torch.clamp(flat, min=0).long())
        return torch.where(flat >= 0, new, -1).reshape(ptr.shape)

    rows = tiles[lanes[:, None], order]               # [B, cap, GROUP, seg]
    children = remap(rows[:, :, SL_C, :].to(torch.int32)).to(torch.float32)
    rows = torch.where(gone[:, :, None, None], 0.0, rows)
    rows[:, :, SL_C, :] = torch.where(gone[:, :, None], -1.0, children)

    n_stack = states.done.shape[1]
    gone_s = gone[:, :n_stack]

    def gather_states(x):
        x = x[lanes[:, None], order[:, :n_stack]]
        mask = gone_s.view(gone_s.shape + (1,) * (x.dim() - 2))
        return torch.where(mask, torch.zeros_like(x), x)

    state_type = type(states)
    new_states = state_type(*(gather_states(x) for x in states))
    stepped = env.step(state_type(*(x[:, 0] for x in states)), actions)
    root = where_state(fresh, stepped,
                       state_type(*(x[:, 0] for x in new_states)))
    for x, y in zip(new_states, root):
        x[:, 0] = y

    new_parent = torch.where(gone, -1, remap(parent.gather(1, order)))
    new_pact = torch.where(gone, -1, pact.gather(1, order))
    new_parent[:, 0] = -1
    new_pact[:, 0] = -1
    return PackedCarry(rows.reshape(packed.shape), new_states, new_parent,
                       new_pact)


def packed_carry_from_numpy(packed, states, parent, parent_action,
                            device=None) -> PackedCarry:
    """The port's ``PackedCarry`` from numpy arrays of one in the JAX
    package's layout: ``packed`` f32 ``[B, n_nodes * 8, seg]``, ``states``
    the node-state stack's fields in ``GomokuState`` order, or
    ``PenteState``'s (its 7 fields, ``captures`` last) (boards flat,
    ``[B, n, H*W]``, or ``[B, n, H, W]``), ``parent`` and ``parent_action``
    i32 ``[B, n_nodes]``.  Lets a search start from the JAX package's tree
    (as ``params_from_jax`` does for weights); ``device`` as the entry
    points take it (``None``: the card)."""
    dev = resolve_device(device)

    def tensor(x, dtype=None):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    board = np.asarray(states[0])
    if board.ndim == 3:
        size = math.isqrt(board.shape[-1])
        board = board.reshape(board.shape[:2] + (size, size))
    state_type = PenteState if len(states) == len(PenteState._fields) \
        else GomokuState
    stack = state_type(tensor(board, np.int8),
                       *(tensor(x) for x in states[1:]))
    return PackedCarry(tensor(packed, np.float32), stack,
                       tensor(parent, np.int32),
                       tensor(parent_action, np.int32))
