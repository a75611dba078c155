"""Transposition and cross-move reuse rates in a real AlphaZero search.

Counterpart of the JAX repo's ``tools/tt_rate_probe.py``.  A search that
keys its node statistics by board state, and never clears them within a
game, gets (a) in-tree transposition sharing and (b) cross-move tree reuse
for free; the packed tree keeps neither (it reuses a move's subtree only
with ``reuse_budget``).  Whether that costs strength a simulation depends on
how often the two fire in real Gomoku searches, which this measures:

  - ``tt_rate``: the share of node expansions whose (board, to-move) state
    was already expanded elsewhere in the SAME move's tree;
  - ``reuse_rate``: the share of a move's expansions whose state already
    existed in the PREVIOUS move's tree.

A plain object-tree PUCT search (``W/(1+N)``, illegal moves masked, ties to
the first maximum) on the host engine (``games/host.py``), with the
checkpoint's float32 policy and value at batch 1 on the card, self-plays
one game from two random opening plies, playing each move by visit count.

    python -m alphazero_gomoku_tpu_torch.tools.tt_rate_probe
        [--sims 200] [--moves 24] [--size 15]

One JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games.host import Gomoku
from alphazero_gomoku_tpu_torch.models import AZModel, make_eval_fn


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="checkpoints/best_gomoku.ckpt")
    ap.add_argument("--sims", type=int, default=200)
    ap.add_argument("--moves", type=int, default=24)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--cpuct", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    model = AZModel.from_checkpoint(args.ckpt, device=dev)
    eval_fn, net = make_eval_fn(), model.eval_net()

    def evaluate(game):
        obs = game.get_encoded_state().transpose(1, 2, 0)[None]
        p, v = eval_fn(net, torch.as_tensor(np.asarray(obs, np.float32),
                                            device=dev))
        return p[0].cpu().numpy(), float(v[0, 0])

    def key_of(game):
        return game.board.tobytes() + bytes([game.current_player])

    class Node:
        __slots__ = ("n", "w", "p", "children", "legal")

        def __init__(self, priors, legal):
            a = priors.shape[0]
            self.n = np.zeros(a, np.float32)
            self.w = np.zeros(a, np.float32)
            self.p = priors
            self.legal = legal
            self.children = {}

    rng = np.random.default_rng(args.seed)
    game = Gomoku(args.size)
    # a couple of random opening plies for tree diversity
    for _ in range(2):
        moves = game.get_legal_moves()
        game.do_move(moves[rng.integers(len(moves))])

    tot_exp = 0          # total expansions
    tot_tt = 0           # expansions whose state already in THIS tree
    tot_reuse = 0        # expansions whose state was in the PREVIOUS tree
    prev_keys = set()

    for mv in range(args.moves):
        if game.check_winner() or not game.has_legal_moves():
            break
        legal = game.get_valid_moves().astype(np.float32)
        p, _ = evaluate(game)
        p = p * legal
        p /= max(p.sum(), 1e-9)
        root = Node(p, legal)
        keys = {key_of(game)}

        for _ in range(args.sims):
            g = game.clone()
            node = root
            path = []
            # select
            while True:
                sum_n = node.n.sum()
                q = node.w / (1.0 + node.n)
                u = args.cpuct * node.p * np.sqrt(sum_n) / (1.0 + node.n)
                scores = np.where(node.legal > 0, q + u, -1e9)
                a = int(np.argmax(scores))
                path.append((node, a))
                g.do_move(g.action_to_move(a))
                w = g.check_winner()
                if w or not g.has_legal_moves():
                    v = -1.0 if w else 0.0
                    break
                if a not in node.children:
                    # expansion
                    k = key_of(g)
                    tot_exp += 1
                    if k in keys:
                        tot_tt += 1
                    if k in prev_keys:
                        tot_reuse += 1
                    keys.add(k)
                    lg = g.get_valid_moves().astype(np.float32)
                    pr, v = evaluate(g)
                    pr = pr * lg
                    pr /= max(pr.sum(), 1e-9)
                    node.children[a] = Node(pr, lg)
                    break
                node = node.children[a]
            # backup with per-hop perspective flip
            for (nd, a) in reversed(path):
                v = -v
                nd.n[a] += 1
                nd.w[a] += v
        prev_keys = keys
        counts = root.n
        game.do_move(game.action_to_move(int(np.argmax(counts))))

    print(json.dumps({
        "sims": args.sims, "moves_played": mv + 1, "size": args.size,
        "expansions": tot_exp,
        "tt_rate": round(tot_tt / max(tot_exp, 1), 4),
        "reuse_rate": round(tot_reuse / max(tot_exp, 1), 4),
    }))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
