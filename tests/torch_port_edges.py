"""Edge trees and paths for the tree kernels, made with numpy from a seed.

No JAX here: the CPU tests hold the port's plain versions against the JAX
kernels on these inputs (``tests/test_torch_port_tree_edges.py``), and the
card tests hold the CUDA kernels against the plain versions on the same ones
(``tests/test_torch_port_cuda.py``, which runs where there is no JAX).

The trees are random packed trees, not grown ones: integer visit counts,
values within them (and a few far from 1: 1e-30 to 1e30), priors with
illegal (-1) entries (and a few of 1e-30), child indices that may
be -1, negative, in range or beyond ``n_nodes``, terminal flags, and random
rows 5-7.  The paths (``edge_paths``) take each lane through one of the
cases that a backup must get right:

  - ``slot_on_path``: the slot lies beyond ``n_nodes`` and clamps onto a node
    of the path, so a hop updates the freshly written slot tile;
  - ``skipped_actions``: path actions < 0 or >= seg, which the backup skips;
  - ``padded_action``: actions in ``[num_actions, seg)``, which it updates;
  - ``clamped_nodes``: path nodes < 0 or >= ``n_nodes``, which it clamps;
  - ``repeated_entry``: hops that clamp to one node, some with one action,
    so that one entry is updated by several hops in path order.

The Gumbel walk's forced root actions (``edge_roots``) are legal, illegal
(a prior of -1), negative, or at or beyond ``num_actions``.
"""

import numpy as np

N_NODES = 7
DEPTH = 8
EDGE_CASES = ("slot_on_path", "skipped_actions", "padded_action",
              "clamped_nodes", "repeated_entry")
ROOT_KINDS = ("legal", "illegal", "negative", "beyond")


def _seg(size):
    return -(-size * size // 128) * 128


def edge_tree(batch, size, seed, n_nodes=N_NODES):
    """A random packed tree ``[batch, n_nodes * 8, seg]`` float32."""
    rng = np.random.default_rng(seed)
    a, seg = size * size, _seg(size)
    tiles = rng.normal(0, 1, (batch, n_nodes, 8, seg)).astype(np.float32)
    n = rng.integers(0, 20, (batch, n_nodes, seg)).astype(np.float32)
    tiles[:, :, 0] = n
    tiles[:, :, 1] = (rng.uniform(-1, 1, n.shape) * n).astype(np.float32)
    prior = rng.random((batch, n_nodes, seg)).astype(np.float32)
    prior[rng.random(prior.shape) < 0.15] = -1.0
    prior[..., a:] = -1.0
    tiles[:, :, 2] = prior
    # a few values far from 1, which a fast path of the division may not take
    far = rng.random((batch, n_nodes, seg)) < 0.02
    tiles[:, :, 1][far] = rng.choice([3e25, -1e30, 1e-30, -2e-28], far.sum())
    tiny = (rng.random(prior.shape) < 0.02) & (prior >= 0)
    tiles[:, :, 2][tiny] = 1e-30
    # children: unexpanded, in range, beyond n_nodes, or negative
    child = rng.integers(1, n_nodes, (batch, n_nodes, seg))
    kind = rng.random(child.shape)
    child[kind < 0.45] = -1
    child[(kind >= 0.45) & (kind < 0.55)] = n_nodes + 3
    child[(kind >= 0.55) & (kind < 0.6)] = -4
    tiles[:, :, 3] = child.astype(np.float32)
    meta = np.zeros((batch, n_nodes, seg), np.float32)
    meta[..., 0] = rng.random((batch, n_nodes)) < 0.08
    meta[..., 1] = rng.uniform(-1, 1, (batch, n_nodes))
    tiles[:, :, 4] = meta
    # whatever the scores: lane 0's root leads to a child beyond n_nodes,
    # lane 1's to a negative child, and lane 2 walks to the depth cap
    tiles[:3, 0, 4, 0] = 0.0
    tiles[0, 0, 3] = n_nodes + 3
    tiles[1:2, 0, 3] = -4
    if batch > 2:
        tiles[2, :, 3] = rng.integers(1, n_nodes, (n_nodes, seg))
        tiles[2, :, 4, 0] = 0.0
    # no -0.0 (from W = u * 0): the JAX kernel's tile update adds zeros,
    # which would turn it into +0.0 in tiles it passes through
    return (tiles + np.float32(0)).reshape(batch, n_nodes * 8, seg)


def edge_paths(case, batch, size, seed, n_nodes=N_NODES, depth=DEPTH):
    """A backup's inputs for ``case`` (one of ``EDGE_CASES``): a dict of
    numpy arrays ``path_nodes``, ``path_actions`` ``[depth, batch]`` int32,
    ``path_len``, ``values``, ``expanding``, ``priors`` ``[batch, A]``,
    ``done``, and the int ``slot``."""
    rng = np.random.default_rng(seed)
    a, seg = size * size, _seg(size)
    plen = rng.integers(1, depth + 1, batch)
    plen[0] = depth                              # a path as deep as the rows
    nodes = rng.integers(0, n_nodes - 1, (depth, batch))
    acts = rng.integers(0, a, (depth, batch))
    slot = int(rng.integers(1, n_nodes))
    hop = rng.integers(0, plen)                  # one hop of each lane's path
    lanes = np.arange(batch)
    if case == "slot_on_path":
        slot = n_nodes + 2                       # clamps to n_nodes - 1
        nodes[hop, lanes] = n_nodes - 1
    elif case == "skipped_actions":
        acts[hop, lanes] = rng.choice([-1, -7, seg, seg + 5], batch)
        acts[plen - 1, lanes] = np.where(lanes % 2, -1, seg)
    elif case == "padded_action":
        if a == seg:
            raise ValueError("no padded column at this size")
        acts[hop, lanes] = rng.integers(a, seg, batch)
        acts[plen - 1, lanes] = seg - 1
    elif case == "clamped_nodes":
        nodes[hop, lanes] = rng.choice([-1, -9, n_nodes, n_nodes + 40],
                                       batch)
        nodes[plen - 1, lanes] = np.where(lanes % 2, n_nodes + 1, -2)
    elif case == "repeated_entry":
        # every hop on node n_nodes - 1 (from indices that clamp to it),
        # half of them with one action, the last hop among those
        nodes[:] = rng.choice([n_nodes - 1, n_nodes, n_nodes + 6],
                              (depth, batch))
        same = rng.random((depth, batch)) < 0.5
        acts = np.where(same, 7, acts)
        acts[plen - 1, lanes] = 7
    else:
        raise ValueError(f"unknown case {case!r}")
    rows = np.arange(depth)[:, None]
    # rows at and beyond path_len hold what a walk leaves there, or garbage
    nodes = np.where(rows < plen, nodes, rng.choice([-1, 3], nodes.shape))
    acts = np.where(rows < plen, acts, rng.choice([-1, 5], acts.shape))
    priors = rng.random((batch, a)).astype(np.float32)
    priors[rng.random(priors.shape) < 0.2] = -1.0
    return dict(path_nodes=nodes.astype(np.int32),
                path_actions=acts.astype(np.int32),
                path_len=plen.astype(np.int32),
                values=rng.uniform(-1, 1, batch).astype(np.float32),
                expanding=rng.random(batch) < 0.7,
                priors=priors, done=rng.random(batch) < 0.2, slot=slot)


def edge_roots(packed, size, fan, seed):
    """Forced root actions ``[batch * fan]`` int32 for the Gumbel walk on
    ``packed`` (an :func:`edge_tree`): lane ``l`` takes kind
    ``ROOT_KINDS[l % 4]``, a legal or an illegal action of its tree's root
    (any action if the root has none of that kind), a negative one, or one
    in ``[num_actions, seg + 8)``."""
    rng = np.random.default_rng(seed)
    a, seg = size * size, _seg(size)
    batch = packed.shape[0]
    prior = packed.reshape(batch, -1, 8, seg)[:, 0, 2, :a]
    roots = np.empty(batch * fan, np.int64)
    for lane in range(batch * fan):
        kind = ROOT_KINDS[lane % len(ROOT_KINDS)]
        legal = prior[lane // fan] >= 0
        if kind in ("legal", "illegal"):
            pool = np.flatnonzero(legal if kind == "legal" else ~legal)
            roots[lane] = rng.choice(pool) if pool.size else rng.integers(a)
        elif kind == "negative":
            roots[lane] = rng.choice([-1, -2, -33, -1000])
        else:
            roots[lane] = rng.integers(a, seg + 8)
    return roots.astype(np.int32)
