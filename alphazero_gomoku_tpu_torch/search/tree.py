"""Search configuration, root priors and noise.

Counterpart of the parts of ``alphazero_gomoku_tpu/search/tree.py`` that the
packed search uses: ``MCTSConfig``, ``symmetric_dirichlet``,
``_masked_priors``, ``_signed_priors``, ``terminal_leaf_value`` and
``root_signed_priors``.  That module's entry point, ``run_mcts_with_q``, is
``search/tree_packed.py``'s.  Its XLA array-tree search is not ported, by
design: the packed search serves every batch size, the players' batch of 1
included (see ``tree_packed.run_mcts_with_q``).

Search semantics (the JAX module's header lists their sources):
  - PUCT score ``W/(1+N) + cpuct * P * sqrt(sum N)/(1+N)``, illegal actions
    at -1e9, ties to the lowest action index.
  - priors = softmax policy masked to legal moves and NOT renormalized;
    uniform over legal moves if the masked sum vanishes.
  - root-only Dirichlet noise over the full action vector, gated on
    ``move_number < dirichlet_moves``.
  - terminal value 0 for draws and -1 for the side to move otherwise.
  - policy = root visit counts / total, uniform over legal moves when the
    root has no visits.

Randomness comes from a ``torch.Generator``.  Where a test must share random
numbers with the JAX package, the root noise is passed in as a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from alphazero_gomoku_tpu_torch.utils.profiling import trace_annotation

EvalFn = Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
# eval_fn(net, obs [B, H, W, C]) -> (policy_probs [B, A], value [B] or [B, 1])


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """Search settings; field names and defaults as in the JAX ``MCTSConfig``.

    The packed PUCT search reads ``n_simulations``, ``cpuct``, the
    ``dirichlet_*`` and ``add_noise`` fields, ``max_nodes``, ``max_depth``,
    ``fpu_mode``, ``terminal_value_mode``, ``leaves_per_sim`` and
    ``reuse_budget``; the Gumbel search (``search="gumbel"``,
    ``search/gumbel.py``) reads ``n_simulations``, ``max_nodes``,
    ``max_depth``, ``terminal_value_mode``, ``reuse_budget`` and the
    ``gumbel_*`` fields.  The port has only the packed search, so there is
    no ``backend`` field.

    ``leaves_per_sim = k > 1`` runs k-leaf virtual-loss PUCT: each macro
    step walks k leaves in turn (a virtual loss on each path steers the next
    walk away), evaluates them in one network call of ``k * B`` boards and
    then backs them up (``tree_packed._run_puct``).

    ``reuse_budget = R > 0`` turns on cross-move subtree reuse: the caller
    threads the search's ``PackedCarry`` through
    ``tree_packed.packed_advance_root`` between moves, which re-roots each
    tree at the played action and keeps at most R nodes of the subtree in
    slots ``[0, R)``; the next search's simulations then take slots R,
    R+1, ...  Reuse is refused with ``leaves_per_sim > 1``, as in the JAX
    package.

    ``gumbel_round_parallel`` batches each halving round's simulations (one
    per surviving root action) into one walk and one network call.  It
    replays the serial search exactly, except where a position has fewer
    legal moves than the round's candidates: the illegal-candidate fallback
    then forces the same root action twice in one round, and the second
    walk expands a copy of the first's leaf instead of going a ply deeper
    (as in the JAX package, ``search/tree.py:137-152`` there).
    """

    n_simulations: int
    cpuct: float = 1.0
    dirichlet_alpha: float = 0.03
    dirichlet_epsilon: float = 0.03
    dirichlet_moves: int = 10
    add_noise: bool = True
    max_nodes: Optional[int] = None  # default: n_simulations+2+reuse_budget
    max_depth: int = 0  # 0 = unbounded (the node capacity)
    fpu_mode: str = "zero"
    leaves_per_sim: int = 1
    terminal_value_mode: str = "always_loss"
    reuse_budget: int = 0
    search: str = "puct"
    gumbel_max_considered: int = 16   # root actions entering halving
    gumbel_c_visit: float = 50.0      # sigma(q) = (c_visit + maxN)*c_scale*q
    gumbel_c_scale: float = 1.0
    gumbel_round_parallel: bool = False

    def __post_init__(self):
        if self.fpu_mode not in ("zero", "parent"):
            raise ValueError(f"unknown fpu_mode: {self.fpu_mode!r}")
        if self.terminal_value_mode not in ("always_loss", "signed"):
            raise ValueError("unknown terminal_value_mode: "
                             f"{self.terminal_value_mode!r}")
        if self.search not in ("puct", "gumbel"):
            raise ValueError(f"unknown search: {self.search!r}")
        if self.search == "gumbel":
            if self.leaves_per_sim > 1:
                raise ValueError("gumbel search does not support "
                                 "leaves_per_sim > 1")
        elif self.gumbel_round_parallel:
            raise ValueError(
                "gumbel_round_parallel requires search='gumbel'")
        if self.leaves_per_sim < 1:
            raise ValueError(f"leaves_per_sim={self.leaves_per_sim} < 1")
        if (self.leaves_per_sim > 1
                and self.n_simulations % self.leaves_per_sim != 0):
            raise ValueError(
                f"n_simulations={self.n_simulations} not divisible by "
                f"leaves_per_sim={self.leaves_per_sim}")

    @property
    def node_capacity(self) -> int:
        # with reuse, slots [0, reuse_budget) hold the carried subtree and
        # the simulations take the slots from reuse_budget upward; then one
        # slot per simulation, and the JAX kernels' reserved "park" tile,
        # kept so the packed layouts of both packages match
        floor = self.n_simulations + 2 + self.reuse_budget
        cap = self.max_nodes or floor
        if cap < floor:
            raise ValueError(
                f"max_nodes={cap} < n_simulations+2+reuse_budget={floor}")
        return cap

    @property
    def depth_limit(self) -> int:
        return self.max_depth or self.node_capacity


# ----------------------------------------------------------------------
# noise
# ----------------------------------------------------------------------
DIRICHLET_SERIES_TERMS = 8


def symmetric_dirichlet(generator: torch.Generator, alpha: float, shape,
                        device=None) -> torch.Tensor:
    """Symmetric Dirichlet(alpha) over the last axis, without rejection loops.

    The JAX package's series (``search/tree.py:236-264``): with the identity
    ``Gamma(a) = sum_k E_k * prod_{j<=k} U_j^(1/a)`` (E ~ Exp(1),
    U ~ Uniform) truncated at ``DIRICHLET_SERIES_TERMS`` terms, evaluated in
    log space and normalised with a softmax.  Drawn from ``generator``, which
    lives on ``device``.
    """
    dev = generator.device if device is None else torch.device(device)
    size = (DIRICHLET_SERIES_TERMS,) + tuple(shape)
    u = torch.rand(size, generator=generator, device=dev)
    log_u = torch.log(torch.clamp(u, min=1e-30))
    exp = torch.empty(size, device=dev).exponential_(generator=generator)
    # t_k = log(E_k) + (sum_{j<=k} log U_j) / alpha;  log G = logsumexp_k t_k
    t = torch.log(torch.clamp(exp, min=1e-30)) + torch.cumsum(log_u, 0) / alpha
    return torch.softmax(torch.logsumexp(t, dim=0), dim=-1)


# ----------------------------------------------------------------------
# priors and terminal values (batched over the leading axis)
# ----------------------------------------------------------------------
def _masked_priors(probs: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Mask priors ``[B, A]`` to legal moves, NOT renormalised; uniform over
    legal moves where the masked mass vanishes."""
    p = probs * legal
    total = p.sum(dim=-1, keepdim=True)
    n_legal = torch.clamp(legal.sum(dim=-1, keepdim=True), min=1.0)
    return torch.where(total < 1e-8, legal / n_legal, p)


def _signed_priors(probs: torch.Tensor, legal_f32: torch.Tensor) -> torch.Tensor:
    """Masked priors with illegality in the sign (-1.0)."""
    p = _masked_priors(probs, legal_f32)
    return torch.where(legal_f32 > 0, p, -1.0)


def terminal_leaf_value(env, cfg: MCTSConfig, state) -> torch.Tensor:
    """f32 ``[B]`` terminal value per ``cfg.terminal_value_mode``."""
    if cfg.terminal_value_mode == "signed":
        won = torch.where(state.winner == state.to_move, 1.0, -1.0)
        return torch.where(state.winner == 0, 0.0, won).to(torch.float32)
    return env.terminal_value(state)


def root_signed_priors(env, cfg: MCTSConfig, eval_fn: EvalFn, net_params,
                       root_states, move_numbers: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked root priors ``[B, A]`` with the Dirichlet gate applied; illegal
    actions are -1.0.

    With ``cfg.add_noise`` the noise is ``noise`` when given (``[B, A]``),
    else a draw from ``generator``; it is drawn whatever the gate says, so a
    generator's stream does not depend on the move number.
    """
    batch = root_states.done.shape[0]
    a = env.num_actions
    obs = env.encode(root_states)
    with trace_annotation("az.net"):
        root_probs, _ = eval_fn(net_params, obs)
    root_probs = root_probs.reshape(batch, a)
    root_legal = env.legal_mask(root_states).to(root_probs.dtype)
    priors = _masked_priors(root_probs, root_legal)

    if cfg.add_noise:
        if noise is None:
            if generator is None:
                raise ValueError("root noise needs a generator or a noise "
                                 "tensor")
            noise = symmetric_dirichlet(generator, cfg.dirichlet_alpha,
                                        (batch, a), root_probs.device)
        noised = (1.0 - cfg.dirichlet_epsilon) * priors \
            + cfg.dirichlet_epsilon * noise
        noised = noised / noised.sum(dim=-1, keepdim=True)
        gate = (move_numbers < cfg.dirichlet_moves)[:, None]
        priors = torch.where(gate, noised, priors)

    return torch.where(root_legal > 0, priors, -1.0)
