"""PUCT and Gumbel searches on a packed node-tile tree, in plain PyTorch.

Copied, when the benchmark was added, from the plain versions of the
program's searches (``alphazero_gomoku_tpu_torch``: ``ops/tree_kernels.py``'s
``select_walk_plain``, ``gumbel_select_walk_plain``, ``backup_paths_plain``
in its ``"backup"`` mode, and ``search/tree.py``, ``search/gumbel.py`` and
``search/tree_packed.py`` for one leaf a simulation, with and without a
carried tree), and kept here so that a later change to the program cannot
move the yardstick.  Where the program's walks fix an order of float32
operations to match their kernels bit for bit (warp-order sums, exp and log
as IEEE operation sequences), this copy takes plain sums and the library's
exp and log: a few ulps apart.  It runs on any device, on its own games
(``games.py``) and its own net (``net.py``).

Semantics:
  - PUCT score ``W/(1+N) + cpuct * P * sqrt(sum N)/(1+N)`` (zero first-play
    urgency), illegal actions out, ties to the lowest action;
  - root priors masked to legal moves and not renormalised (uniform where
    the mass vanishes), root Dirichlet noise drawn every ply and applied
    while ``move < dirichlet_moves``;
  - a terminal leaf is worth -1 to the side to move after a win, 0 drawn;
  - Gumbel: the ``m`` actions with the highest ``g + logits`` enter
    sequential halving, non-root walks take ``argmax pi' - N/(1+sum N)``,
    the target is ``softmax(logits + sigma(completed Q))``;
  - with ``reuse_budget > 0`` the tree is carried between plies and re-rooted
    at the played move, keeping at most ``reuse_budget`` nodes by (depth,
    index).

The tree of a lane is ``[n_nodes * GROUP, seg]`` float32; node ``k`` owns
rows ``k*GROUP + (N, W, P, C, meta)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from benchmark.reference.games import Game, State, take, where

NEG_INF = -1e9
GROUP = 8
SL_N, SL_W, SL_P, SL_C, SL_META = 0, 1, 2, 3, 4
NO_ACTION = 1 << 30
DIRICHLET_TERMS = 8


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    search: str                 # "puct" or "gumbel"
    n_simulations: int
    cpuct: float = 1.0
    add_noise: bool = True
    dirichlet_alpha: float = 0.05
    dirichlet_epsilon: float = 0.15
    dirichlet_moves: int = 10
    max_depth: int = 64
    reuse_budget: int = 0
    gumbel_max_considered: int = 16
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 1.0

    @property
    def n_nodes(self) -> int:
        return self.n_simulations + 2 + self.reuse_budget

    @property
    def depth_limit(self) -> int:
        return self.max_depth or self.n_nodes


class Layout(NamedTuple):
    num_actions: int
    seg: int
    n_nodes: int


def layout_of(game: Game, cfg: SearchConfig) -> Layout:
    a = game.num_actions
    return Layout(a, (a + 127) // 128 * 128, cfg.n_nodes)


def tiles_of(packed, lay: Layout):
    return packed.view(packed.shape[0], lay.n_nodes, GROUP, lay.seg)


def fresh_tree(batch: int, lay: Layout, device) -> torch.Tensor:
    packed = torch.zeros((batch, lay.n_nodes * GROUP, lay.seg),
                         dtype=torch.float32, device=device)
    packed[:, SL_C::GROUP, :] = -1.0
    return packed


def lowest_argmax(scores):
    iota = torch.arange(scores.shape[1], device=scores.device,
                        dtype=torch.int32)
    mx = scores.max(dim=1, keepdim=True).values
    return torch.where(scores == mx, iota, NO_ACTION).min(dim=1).values


# ----------------------------------------------------------------------
# walks and backup
# ----------------------------------------------------------------------
def _walk(packed, lay: Layout, depth_limit: int, choose):
    b = packed.shape[0]
    a = lay.num_actions
    dev = packed.device
    tiles = tiles_of(packed, lay)
    n_max = lay.n_nodes - 1
    lanes = torch.arange(b, device=dev)
    nodes = torch.zeros(b, dtype=torch.int32, device=dev)
    walking = torch.ones(b, dtype=torch.bool, device=dev)
    leaf = torch.zeros(b, dtype=torch.int32, device=dev)
    action = torch.full((b,), -1, dtype=torch.int32, device=dev)
    plen = torch.zeros(b, dtype=torch.int32, device=dev)
    pnodes = torch.full((depth_limit, b), -1, dtype=torch.int32, device=dev)
    pacts = torch.full((depth_limit, b), -1, dtype=torch.int32, device=dev)
    for h in range(depth_limit):
        if not bool(walking.any()):
            break
        tile = tiles[lanes, nodes.long().clamp(0, n_max)]
        done = tile[:, SL_META, 0] > 0.5
        best = choose(tile, h)
        in_range = (best >= 0) & (best < a)
        child = tile[lanes, SL_C, best.long().clamp(0, a - 1)].to(torch.int32)
        child = torch.where(in_range, child, 0)
        stop_done = walking & done
        rec = walking & ~done
        pnodes[h] = torch.where(rec, nodes, -1)
        pacts[h] = torch.where(rec, best, -1)
        plen = plen + rec.int()
        stop_expand = rec & (child < 0)
        stop_now = stop_done | stop_expand
        action = torch.where(stop_expand, best, action)
        leaf = torch.where(stop_now, nodes, leaf)
        nodes = torch.where(rec & (child >= 0), child, nodes)
        walking = walking & ~stop_now
    leaf = torch.where(walking, nodes, leaf)
    return leaf, action, pnodes, pacts, plen


def puct_walk(packed, lay: Layout, cpuct: float, depth_limit: int):
    a = lay.num_actions
    cpuct_t = torch.tensor(cpuct, dtype=torch.float32, device=packed.device)

    def choose(tile, h):
        n = tile[:, SL_N, :a]
        w = tile[:, SL_W, :a]
        p = tile[:, SL_P, :a]
        sum_n = n.sum(dim=1, keepdim=True)
        q = w / (1.0 + n)
        scores = q + cpuct_t * torch.clamp(p, min=0.0) * torch.sqrt(sum_n) \
            / (1.0 + n)
        return lowest_argmax(torch.where(p >= 0.0, scores, NEG_INF))

    return _walk(packed, lay, depth_limit, choose)


def gumbel_walk(packed, root_actions, lay: Layout, depth_limit: int,
                c_visit: float, c_scale: float):
    a = lay.num_actions

    def choose(tile, h):
        if h == 0:
            return root_actions
        n = tile[:, SL_N, :a]
        w = tile[:, SL_W, :a]
        p_signed = tile[:, SL_P, :a]
        v_node = tile[:, SL_META, 1]
        legal = p_signed >= 0.0
        p = torch.clamp(p_signed, min=0.0)
        sum_n = n.sum(dim=1)
        q = w / torch.clamp(n, min=1.0)
        visited = n > 0.0
        p_vis = torch.where(visited, p, 0.0).sum(dim=1)
        w_q = torch.where(visited, p * q, 0.0).sum(dim=1) \
            / torch.clamp(p_vis, min=1e-8)
        v_mix = (v_node + sum_n * w_q) / (1.0 + sum_n)
        v_mix = torch.where(p_vis > 1e-8, v_mix, v_node)
        comp_q = torch.where(visited, q, v_mix[:, None])
        logits = torch.log(torch.clamp(p, min=1e-30))
        coef = (n.max(dim=1).values + c_visit) * c_scale
        sm_in = torch.where(legal, logits + coef[:, None] * comp_q, NEG_INF)
        sm_max = sm_in.max(dim=1, keepdim=True).values
        e = torch.where(legal, torch.exp(sm_in - sm_max), 0.0)
        pi_prime = e / torch.clamp(e.sum(dim=1), min=1e-30)[:, None]
        scores = torch.where(legal, pi_prime - n / (1.0 + sum_n)[:, None],
                             NEG_INF)
        return lowest_argmax(scores)

    return _walk(packed, lay, depth_limit, choose)


def backup(packed, pnodes, pacts, plen, values, expanding, slot: int,
           lay: Layout, signed_priors, done):
    """Write the fresh slot tile, then N + 1 and W +- value along each
    lane's path (the sign flips at every hop up from the leaf), linking
    the last edge to the slot where the lane expanded.  In place."""
    b = packed.shape[0]
    a = lay.num_actions
    dev = packed.device
    tiles = tiles_of(packed, lay)
    n_max = lay.n_nodes - 1
    lanes = torch.arange(b, device=dev)
    slot_idx = min(max(slot, 0), n_max)
    tile = torch.zeros((b, GROUP, lay.seg), dtype=torch.float32, device=dev)
    tile[:, SL_C, :] = -1.0
    tile[:, SL_P, :] = -1.0
    tile[:, SL_P, :a] = signed_priors
    tile[:, SL_META, 0] = done.to(torch.float32)
    tile[:, SL_META, 1] = values
    tiles[:, slot_idx] = tile
    plen = plen.long()
    hops = min(int(plen.max()), pnodes.shape[0])
    for i in range(hops):
        act = pacts[i].long()
        active = (i < plen) & (act >= 0) & (act < lay.seg)
        node = pnodes[i].long().clamp(0, n_max)
        col = act.clamp(0, lay.seg - 1)
        v = torch.where((plen - i) % 2 == 1, -values, values)
        n_old = tiles[lanes, node, SL_N, col]
        w_old = tiles[lanes, node, SL_W, col]
        tiles[lanes, node, SL_N, col] = torch.where(active, n_old + 1.0,
                                                    n_old)
        tiles[lanes, node, SL_W, col] = torch.where(active, w_old + v, w_old)
        link = active & expanding & (i == plen - 1)
        c_old = tiles[lanes, node, SL_C, col]
        tiles[lanes, node, SL_C, col] = torch.where(link, float(slot), c_old)
    return packed


# ----------------------------------------------------------------------
# the tree a search carries
# ----------------------------------------------------------------------
class Tree(NamedTuple):
    packed: torch.Tensor
    states: State          # each field [B, n_nodes, ...]
    parent: torch.Tensor   # int32 [B, n_nodes]
    parent_action: torch.Tensor


def new_tree(game: Game, cfg: SearchConfig, roots: State) -> Tree:
    lay = layout_of(game, cfg)
    b = roots.done.shape[0]
    dev = roots.board.device

    def stack(x):
        z = torch.zeros((b, cfg.n_nodes) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=dev)
        z[:, 0] = x
        return z

    no_link = torch.full((b, lay.n_nodes), -1, dtype=torch.int32, device=dev)
    return Tree(fresh_tree(b, lay, dev), State(*(stack(x) for x in roots)),
                no_link, no_link.clone())


def _copy(tree: Tree) -> Tree:
    return Tree(tree.packed.clone(), State(*(x.clone() for x in tree.states)),
                tree.parent.clone(), tree.parent_action.clone())


def masked_priors(probs, legal):
    p = probs * legal
    total = p.sum(dim=-1, keepdim=True)
    n_legal = torch.clamp(legal.sum(dim=-1, keepdim=True), min=1.0)
    return torch.where(total < 1e-8, legal / n_legal, p)


def dirichlet(noise_u, noise_e, alpha: float):
    """Symmetric Dirichlet from ``DIRICHLET_TERMS`` uniforms and
    exponentials a point (``[T, B, A]``): ``Gamma(a) = sum_k E_k prod_{j<=k}
    U_j^(1/a)`` in log space, normalised by a softmax."""
    log_u = torch.log(torch.clamp(noise_u, min=1e-30))
    t = torch.log(torch.clamp(noise_e, min=1e-30)) \
        + torch.cumsum(log_u, 0) / alpha
    return torch.softmax(torch.logsumexp(t, dim=0), dim=-1)


def _simulate(game, cfg, lay, eval_fn, tree: Tree, lanes, slot, walk_out):
    leaf, action, pnodes, pacts, plen = walk_out
    expanding = action >= 0
    parent = State(*(x[lanes, leaf.long()] for x in tree.states))
    child = game.step(parent, torch.clamp(action, min=0))
    write = where(expanding, child, parent)
    probs, values = eval_fn(game.encode(write))
    legal = game.legal(write).to(probs.dtype)
    leaf_value = torch.where(write.done, game.terminal_value(write),
                             values.reshape(-1)).to(torch.float32)
    signed = torch.where(legal > 0, masked_priors(probs, legal), -1.0)
    for stack, x in zip(tree.states, write):
        stack[:, slot] = x
    backup(tree.packed, pnodes, pacts, plen, leaf_value, expanding, slot,
           lay, signed, write.done)
    tree.parent[:, slot] = torch.where(expanding, leaf, -1)
    tree.parent_action[:, slot] = action


def puct(game: Game, cfg: SearchConfig, eval_fn, roots: State,
         move_numbers: torch.Tensor, noise: Optional[torch.Tensor],
         carry: Optional[Tree] = None):
    """``(pi [B, A], root_q [B], tree)``; ``noise`` is each root's Dirichlet
    draw ``[B, A]`` (None without root noise), applied where its move
    number ``[B]`` is below ``dirichlet_moves``."""
    lay = layout_of(game, cfg)
    a = game.num_actions
    if carry is None:
        tree, base = new_tree(game, cfg, roots), 1
    else:
        tree, base = _copy(carry), cfg.reuse_budget
    packed = tree.packed
    lanes = torch.arange(roots.done.shape[0], device=packed.device)
    probs, _ = eval_fn(game.encode(roots))
    legal = game.legal(roots).to(probs.dtype)
    priors = masked_priors(probs, legal)
    if noise is not None:
        noised = (1.0 - cfg.dirichlet_epsilon) * priors \
            + cfg.dirichlet_epsilon * noise
        noised = noised / noised.sum(dim=-1, keepdim=True)
        gate = (move_numbers < cfg.dirichlet_moves)[:, None]
        priors = torch.where(gate, noised, priors)
    packed[:, SL_P, :a] = torch.where(legal > 0, priors, -1.0)
    packed[:, SL_META, 0] = roots.done.to(torch.float32)
    for sim in range(cfg.n_simulations):
        _simulate(game, cfg, lay, eval_fn, tree, lanes, sim + base,
                  puct_walk(packed, lay, cfg.cpuct, cfg.depth_limit))
    counts = packed[:, SL_N, :a]
    totals = counts.sum(dim=-1, keepdim=True)
    legal01 = (packed[:, SL_P, :a] >= 0.0).to(torch.float32)
    uniform = legal01 / torch.clamp(legal01.sum(dim=-1, keepdim=True),
                                    min=1.0)
    pi = torch.where(totals > 0, counts / torch.clamp(totals, min=1e-30),
                     uniform)
    root_q = packed[:, SL_W, :a].sum(dim=-1) / torch.clamp(totals[:, 0],
                                                           min=1.0)
    return pi, root_q, tree


def halving_schedule(n: int, max_considered: int):
    def ms_of(m):
        out = []
        while m >= 2:
            out.append(m)
            m //= 2
        return out

    m = max(2, max_considered)
    while sum(ms_of(m)) > n and m > 2:
        m //= 2
    ms = ms_of(m)
    per = [max(1, n // (len(ms) * mk)) for mk in ms]
    left = n - sum(p * mk for p, mk in zip(per, ms))
    if left > 0:
        per[-1] += left // ms[-1]
    return m, list(zip(ms, per))


def _top_k(scores, k):
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[:, :k].to(torch.int32)


def _sigma(q, n, cfg):
    return (cfg.gumbel_c_visit + n.max(dim=-1, keepdim=True).values) \
        * cfg.gumbel_c_scale * q


def gumbel(game: Game, cfg: SearchConfig, eval_fn, roots: State,
           uniforms: torch.Tensor, carry: Optional[Tree] = None):
    """``(pi_target [B, A], root_q [B], action [B], tree)``; ``uniforms``
    is the ply's root draw ``[B, A]``."""
    lay = layout_of(game, cfg)
    a = game.num_actions
    if carry is None:
        tree, slot = new_tree(game, cfg, roots), 1
    else:
        tree, slot = _copy(carry), cfg.reuse_budget
    packed = tree.packed
    b = roots.done.shape[0]
    dev = packed.device
    lanes = torch.arange(b, device=dev)
    m, phases = halving_schedule(cfg.n_simulations, cfg.gumbel_max_considered)
    probs, v0 = eval_fn(game.encode(roots))
    v0 = v0.reshape(b).to(torch.float32)
    legal = game.legal(roots)
    priors = masked_priors(probs, legal.to(probs.dtype))
    packed[:, SL_P, :a] = torch.where(legal, priors, -1.0)
    packed[:, SL_META, 0] = roots.done.to(torch.float32)
    packed[:, SL_META, 1] = v0
    logits = torch.where(legal, torch.log(torch.clamp(priors, min=1e-30)),
                         NEG_INF)
    u = torch.clamp(uniforms, min=1e-12)
    g = torch.where(legal, -torch.log(-torch.log(u)), NEG_INF)
    ranked = _top_k(g + logits, m)

    def root_score():
        n_root = packed[:, SL_N, :a]
        q_hat = packed[:, SL_W, :a] / torch.clamp(n_root, min=1.0)
        return torch.where(n_root > 0, g + logits + _sigma(q_hat, n_root, cfg),
                           NEG_INF)

    for m_k, visits in phases:
        for j in range(m_k * visits):
            cand = ranked[:, j % m_k:j % m_k + 1]
            ok = legal.gather(1, cand.long())
            forced = torch.where(ok, cand, ranked[:, :1]).to(torch.int32)
            _simulate(game, cfg, lay, eval_fn, tree, lanes, slot,
                      gumbel_walk(packed, forced.reshape(-1), lay,
                                  cfg.depth_limit, cfg.gumbel_c_visit,
                                  cfg.gumbel_c_scale))
            slot += 1
        in_set = torch.zeros((b, a), dtype=torch.bool, device=dev)
        in_set[lanes[:, None], ranked[:, :m_k].long()] = True
        ranked = _top_k(torch.where(in_set, root_score(), NEG_INF), m)

    action = ranked[:, 0]
    n_root = packed[:, SL_N, :a]
    w_root = packed[:, SL_W, :a]
    # improved policy: softmax(logits + sigma(completed Q)) over legal moves
    signed = packed[:, SL_P, :a]
    q = w_root / torch.clamp(n_root, min=1.0)
    p = torch.clamp(signed, min=0.0)
    visited = n_root > 0.0
    p_vis = torch.where(visited, p, 0.0).sum(dim=-1, keepdim=True)
    w_q = torch.where(visited, p * q, 0.0).sum(dim=-1, keepdim=True) \
        / torch.clamp(p_vis, min=1e-8)
    sum_n = n_root.sum(dim=-1, keepdim=True)
    v = v0[:, None]
    v_mix = torch.where(p_vis > 1e-8, (v + sum_n * w_q) / (1.0 + sum_n), v)
    comp = torch.where(visited, q, v_mix)
    pi = torch.softmax(torch.where(legal, logits + _sigma(comp, n_root, cfg),
                                   NEG_INF), dim=-1)
    root_q = w_root.sum(dim=-1) / torch.clamp(n_root.sum(dim=-1), min=1.0)
    return pi, root_q, action, tree


def advance_root(game: Game, cfg: SearchConfig, tree: Tree,
                 actions: torch.Tensor) -> Tree:
    """Re-root each lane's tree at its played action: keep the nodes
    reached from the new root through the parent links, ranked by (depth,
    old index), at most ``reuse_budget`` of them, renumbered in that order;
    a lane whose played edge was never expanded starts afresh from the
    stepped root."""
    lay = layout_of(game, cfg)
    cap, budget = lay.n_nodes, cfg.reuse_budget
    packed, states, parent, pact = tree
    b = packed.shape[0]
    dev = packed.device
    lanes = torch.arange(b, device=dev)
    idx = torch.arange(cap, dtype=torch.int32, device=dev)[None]
    actions = actions.to(device=dev, dtype=torch.int64)
    tiles = tiles_of(packed, lay)
    r = tiles[lanes, 0, SL_C, actions].to(torch.int32)
    fresh = r < 0
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
    keep = (key.gather(1, order) < big) & (idx < budget)
    new_of_old = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    new_of_old.scatter_(1, order, torch.where(keep, idx, -1))
    gone = ~keep | fresh[:, None]

    def remap(ptr):
        flat = ptr.reshape(b, -1)
        new = new_of_old.gather(1, torch.clamp(flat, min=0).long())
        return torch.where(flat >= 0, new, -1).reshape(ptr.shape)

    rows = tiles[lanes[:, None], order]
    children = remap(rows[:, :, SL_C, :].to(torch.int32)).to(torch.float32)
    rows = torch.where(gone[:, :, None, None], 0.0, rows)
    rows[:, :, SL_C, :] = torch.where(gone[:, :, None], -1.0, children)

    n_stack = states.done.shape[1]
    gone_s = gone[:, :n_stack]

    def gather(x):
        x = x[lanes[:, None], order[:, :n_stack]]
        mask = gone_s.view(gone_s.shape + (1,) * (x.dim() - 2))
        return torch.where(mask, torch.zeros_like(x), x)

    new_states = State(*(gather(x) for x in states))
    stepped = game.step(take(states, (slice(None), 0)), actions)
    root = where(fresh, stepped, take(new_states, (slice(None), 0)))
    for x, y in zip(new_states, root):
        x[:, 0] = y
    new_parent = torch.where(gone, -1, remap(parent.gather(1, order)))
    new_pact = torch.where(gone, -1, pact.gather(1, order))
    new_parent[:, 0] = -1
    new_pact[:, 0] = -1
    return Tree(rows.reshape(packed.shape), new_states, new_parent, new_pact)
