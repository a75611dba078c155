"""Tactical probe: does a checkpoint see wins-in-one and forced blocks?

Counterpart of the JAX repo's ``tools/tactics_probe.py``: canonical 15x15
positions (open three, open four, split four), or the oracle-validated
suites of ``tools/tactics_suites.py``, and where the raw policy priors and a
short search put their mass.  Tracks tactical sharpness apart from arena
win rates: the policy can be tactically sharp while the value head is
broken, and the other way round.

The JAX tool searches a batch of one on its XLA array tree (its Pallas
kernels need 8 lanes); here the search is the packed PUCT search
(``run_search``: ``select_walk`` and ``backup_paths`` on the card),
which the JAX package holds bit-identical to that tree.  ``--game pente``
reads capture planes when the checkpoint's net does (``in_channels`` 5).

    python -m alphazero_gomoku_tpu_torch.tools.tactics_probe
        --model checkpoints/best_gomoku.ckpt [--sims 64] [--suite full]

A JSON line a position, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_eval_fn
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_search
from alphazero_gomoku_tpu_torch.tools.tactics_suites import suite_for


def positions(size=15):
    """(name, stones, to_move, key_squares): key = correct move set."""
    c = size // 2
    pos = []

    # Opponent (P1) has an open three on the row; P2 to move must block at
    # either open end.
    b = np.zeros((size, size), np.int8)
    b[c, c - 1] = b[c, c] = b[c, c + 1] = 1
    b[c - 1, c] = b[c + 2, c + 2] = 2
    pos.append(("block_open_three", b, 2,
                {(c, c - 2), (c, c + 2)}))

    # P1 has four in a row with one open end; P1 to move wins immediately.
    b = np.zeros((size, size), np.int8)
    b[c, c - 2] = b[c, c - 1] = b[c, c] = b[c, c + 1] = 1
    b[c, c - 3] = 2  # left end blocked
    b[c - 1, c - 1] = b[c - 2, c] = b[c + 1, c + 1] = 2
    pos.append(("win_in_one", b, 1, {(c, c + 2)}))

    # Opponent (P1) has a simple four; P2 must block the single gap.
    b = np.zeros((size, size), np.int8)
    b[c, c - 2] = b[c, c - 1] = b[c, c + 1] = b[c, c + 2] = 1
    b[c - 1, c - 1] = b[c + 1, c + 1] = b[c - 2, c - 2] = 2
    pos.append(("block_split_four", b, 2, {(c, c)}))
    return pos


def probe_positions(game: str, size: int, suite: str):
    """``(name, board, to_move, keys, captures, category)`` of each
    position: the full suite at 15x15, else the three canonical ones."""
    if suite == "full" and size == 15:
        return [(p.name, p.board, p.to_move, set(p.keys), p.captures,
                 p.category) for p in suite_for(game)]
    return [(name, b, tm, keys, (0, 0), "core")
            for name, b, tm, keys in positions(size)]


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--sims", type=int, default=64)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--suite", default="full", choices=["core", "full"],
                    help="core = the 3 canonical positions; full = the "
                         "oracle-validated >=20-position suite "
                         "(tools/tactics_suites.py)")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    net = AZModel.from_checkpoint(args.model, board_size=args.size,
                                  device=dev)
    # the probe positions (row fives, no pending captures) are legal and
    # tactically identical in pente; capture planes follow the checkpoint
    env = make_env(args.game, args.size,
                   capture_planes=net.cfg.in_channels == 5)
    eval_fn, bundle = make_eval_fn(), net.eval_net()
    cfg = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False)
    zeros = torch.zeros((1,), dtype=torch.int32, device=dev)

    ok_prior = ok_search = 0
    results = []
    for name, board, to_move, keys, caps, category in probe_positions(
            args.game, args.size, args.suite):
        b = torch.as_tensor(board, device=dev)[None]
        if args.game == "pente":
            state = env.from_board(b, to_move, captures=caps)
        else:
            state = env.from_board(b, to_move)
        probs, value = eval_fn(bundle, env.encode(state))
        probs = (probs * env.legal_mask(state))[0].cpu().numpy()
        pi = run_search(env, cfg, eval_fn, bundle, state,
                        zeros).pi[0].cpu().numpy()

        def top(vec):
            a = int(np.argmax(vec))
            return (a // args.size, a % args.size)

        key_prior = sum(probs[r * args.size + c] for r, c in keys)
        key_pi = sum(pi[r * args.size + c] for r, c in keys)
        hit_prior = top(probs) in keys
        hit_search = top(pi) in keys
        ok_prior += hit_prior
        ok_search += hit_search
        results.append({
            "position": name, "category": category, "to_move": to_move,
            "value": round(float(value[0, 0]), 3),
            "prior_on_keys": round(float(key_prior), 3),
            "prior_top": top(probs), "prior_hit": bool(hit_prior),
            "search_on_keys": round(float(key_pi), 3),
            "search_top": top(pi), "search_hit": bool(hit_search),
        })
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"model": args.model, "sims": args.sims,
                      "suite": args.suite,
                      "prior_hits": ok_prior, "search_hits": ok_search,
                      "total": len(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
