"""Gumbel AlphaZero search: sequential halving at the root.

Counterpart of ``alphazero_gomoku_tpu/search/gumbel.py`` ("Policy
improvement by planning with Gumbel", Danihelka et al., ICLR 2022):

  - **Root**: one Gumbel sample ``g(a)`` per action; the ``m`` actions with
    the highest ``g + logits`` enter sequential halving, which gives each
    survivor an equal share of a phase's simulations and keeps the top half
    by ``g + logits + sigma(q_hat)``, until one action is left: the move to
    play.
  - **Policy target**: ``softmax(logits + sigma(completed Q))`` over legal
    actions, where unvisited actions take the node's mixed value estimate.
  - **Non-root selection** is deterministic:
    ``argmax pi'(a) - N(a) / (1 + sum N)`` (the ``gumbel_select_walk``
    kernel).
  - ``sigma(q) = (c_visit + max N) * c_scale * q``.

No Dirichlet noise: exploration is the root's Gumbel sample.  The JAX
module's XLA search is not ported, by design: the packed search serves every
batch size (``search/tree.py:run_mcts_with_q``), and
:func:`run_gumbel_mcts` runs it
(``search/tree_packed.py:run_gumbel_packed``), which the JAX package holds
equal to its XLA search.  The completed-Q and improved-policy math of that
module is written here for rows of the packed layout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from alphazero_gomoku_tpu_torch.ops.tree_kernels import KERNELS, NEG_INF, TreeOps
from alphazero_gomoku_tpu_torch.search.tree import EvalFn, MCTSConfig


def halving_schedule(n_simulations: int,
                     max_considered: int) -> Tuple[int, List[Tuple[int, int]]]:
    """Static sequential-halving plan for a budget of ``n_simulations``.

    Returns ``(m, [(m_k, visits_per_action), ...])``: ``m`` is
    ``max_considered`` halved until the minimal halving run
    ``m + m/2 + ... + 2`` fits the budget, and each phase gives every
    surviving action ``visits_per_action`` simulations.  Leftover budget goes
    to the last phase; the total never exceeds ``n_simulations``.
    """
    if n_simulations < 2:
        raise ValueError("gumbel search needs n_simulations >= 2")
    m = max(2, max_considered)
    while sum(_halving_ms(m)) > n_simulations and m > 2:
        m //= 2
    ms = _halving_ms(m)
    phases = len(ms)
    per = [max(1, n_simulations // (phases * mk)) for mk in ms]
    used = sum(p * mk for p, mk in zip(per, ms))
    left = n_simulations - used
    if left > 0:
        per[-1] += left // ms[-1]
    return m, list(zip(ms, per))


def _halving_ms(m: int) -> List[int]:
    ms = []
    while m >= 2:
        ms.append(m)
        m //= 2
    return ms


def _sigma(q: torch.Tensor, n_row: torch.Tensor,
           cfg: MCTSConfig) -> torch.Tensor:
    """Monotone Q transform: ``(c_visit + max N) * c_scale * q`` per row."""
    maxvisit = n_row.max(dim=-1, keepdim=True).values
    return (cfg.gumbel_c_visit + maxvisit) * cfg.gumbel_c_scale * q


def completed_q(n: torch.Tensor, w: torch.Tensor, signed_priors: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """Completed Q ``[B, A]`` of packed rows N, W, P and the node value ``[B]``.

    Visited actions take their mean ``W / N``; unvisited ones the node's
    value mixed with the prior-weighted mean Q of the visited actions
    (``qtransform_completed_by_mix_value`` in mctx), or the node's value
    alone where no action is visited.
    """
    q = w / torch.clamp(n, min=1.0)
    p = torch.clamp(signed_priors, min=0.0)
    visited = n > 0.0
    p_vis = torch.where(visited, p, 0.0).sum(dim=-1, keepdim=True)
    w_q = torch.where(visited, p * q, 0.0).sum(dim=-1, keepdim=True) \
        / torch.clamp(p_vis, min=1e-8)
    sum_n = n.sum(dim=-1, keepdim=True)
    v = value[:, None]
    v_mix = (v + sum_n * w_q) / (1.0 + sum_n)
    v_mix = torch.where(p_vis > 1e-8, v_mix, v)
    return torch.where(visited, q, v_mix)


def improved_policy(logits: torch.Tensor, n: torch.Tensor, w: torch.Tensor,
                    signed_priors: torch.Tensor, value: torch.Tensor,
                    legal: torch.Tensor, cfg: MCTSConfig) -> torch.Tensor:
    """``softmax(logits + sigma(completed Q))`` over legal actions ``[B, A]``."""
    scores = logits + _sigma(completed_q(n, w, signed_priors, value), n, cfg)
    return torch.softmax(torch.where(legal, scores, NEG_INF), dim=-1)


def run_gumbel_mcts(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
                    root_states, generator: Optional[torch.Generator] = None,
                    uniforms: Optional[torch.Tensor] = None,
                    ops: TreeOps = KERNELS):
    """Batched Gumbel search: ``(pi_target [B, A], root_q [B], action [B])``.

    ``pi_target`` is the improved policy (the training target), ``action``
    the sequential-halving winner (the move self-play plays, with no
    temperature sampling), ``root_q`` the mean backed-up root value.  The
    root's Gumbel uniforms ``[B, A]`` are ``uniforms`` when given (tests
    inject the JAX package's draw), else a draw from ``generator``.
    ``ops`` picks the tree functions: the kernel wrappers, or
    ``tree_kernels.PLAIN``.
    """
    from alphazero_gomoku_tpu_torch.search.tree_packed import run_gumbel_packed
    return run_gumbel_packed(env, cfg, eval_fn, net_params, root_states,
                             generator, uniforms=uniforms, ops=ops)
