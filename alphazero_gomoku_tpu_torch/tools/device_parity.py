"""On the card: the searches on the kernels against the same searches on
their plain versions.

Counterpart of the JAX repo's ``tools/device_parity.py``, which held the
Mosaic-compiled packed search against the XLA search on the TPU.  Here the
two backends (``tools/backends.py``) are the kernels (``tk.KERNELS``, and
the int8 tower kernel K5 for the network) and the plain versions
(``tk.PLAIN`` and ``int8_tower_plain``).  A fault of the kernels that the
plain versions do not share (a read before the previous hop's write landed,
a race between a lane's threads, a wrong index) corrupts N or W and shows
as a visit-count (pi) difference.  The grid is the JAX tool's: PUCT with
root noise, a deep PUCT, k-leaf (K2's ``vl`` and ``finalize`` modes) and
Gumbel (K3), on a seeded 2x64 net at 15x15.

The plain side is forced plain (its tree functions and tower passed
explicitly): never a second run of the kernels, the mistake the JAX tool
made before it forced ``backend="xla"``.  pi must be equal bit for bit on
every row (integer visit counts, the same float32 operations in the same
order on both sides, K5 equal to its plain version bit for bit), and
root_q within ``Q_ATOL``.

    python -m alphazero_gomoku_tpu_torch.tools.device_parity   # the grid
    python -m alphazero_gomoku_tpu_torch.tools.device_parity --quick

A JSON line a config, then ``{"device": ..., "all_ok": ...}``; exit 1 unless
all are equal.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_search
from alphazero_gomoku_tpu_torch.tools.backends import backend

INFER = "int8t"
Q_ATOL = 1e-4
GRID = (dict(name="puct", search="puct", add_noise=True, k=1, plies=4),
        dict(name="puct_deep", search="puct", add_noise=False, k=1,
             plies=24),
        dict(name="kleaf4", search="puct", add_noise=False, k=4, plies=8),
        dict(name="gumbel", search="gumbel", add_noise=False, k=1, plies=6))


def random_states(env, batch, plies, seed, device=None):
    """``batch`` games advanced by ``plies`` random legal moves, drawn as
    the JAX tool draws them (numpy's generator, a move a row)."""
    dev = resolve_device(device)
    states = env.init_batch(batch, dev)
    rng = np.random.default_rng(seed)
    for _ in range(plies):
        legal = env.legal_mask(states).cpu().numpy()
        acts = np.array([
            rng.choice(np.flatnonzero(row)) if row.any() else 0
            for row in legal
        ], dtype=np.int64)
        states = env.step_safe(states, torch.as_tensor(acts, device=dev))
    return states


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def search(env, cfg, sides, bundle, states, move_no, seed):
    """``{side: (pi, root_q, seconds)}``: the search of ``cfg`` on each of
    ``sides`` (name -> ``(eval_fn, tree ops)``), each from a generator
    seeded ``seed`` (the same noise and uniforms on every side)."""
    dev = states.board.device
    moves = torch.full((states.done.shape[0],), move_no, dtype=torch.int32,
                       device=dev)
    out = {}
    for name, (eval_fn, ops) in sides.items():
        gen = torch.Generator(device=dev).manual_seed(seed)
        t0 = time.time()
        pi, q, _, _ = run_search(env, cfg, eval_fn, bundle, states, moves,
                                 gen, ops=ops)
        _sync(dev)
        out[name] = (pi.cpu().numpy(), q.cpu().numpy(), time.time() - t0)
    return out


def compare(env, cfg, sides, bundle, states, move_no, seed):
    out = search(env, cfg, sides, bundle, states, move_no, seed)
    (pi_k, q_k, t_k), (pi_p, q_p, t_p) = out["kernels"], out["plain"]
    return {
        "pi_exact": bool((pi_k == pi_p).all()),
        "pi_mismatch_rows": int((pi_k != pi_p).any(axis=-1).sum()),
        "pi_max_abs_diff": float(np.abs(pi_k - pi_p).max()),
        "q_max_abs_diff": float(np.abs(q_k - q_p).max()),
        "t_kernels_s": round(t_k, 2), "t_plain_s": round(t_p, 2),
    }


def make_sides(net_cfg, eval_fn, infer=INFER):
    """The two backends of the probe tools: name -> ``(eval_fn, ops)``."""
    return {"kernels": backend("pallas", infer, net_cfg, eval_fn),
            "plain": backend("xla", infer, net_cfg, eval_fn)}


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sims", type=int, default=96)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--game", default="gomoku")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    env = make_env(args.game, args.size)
    model = AZModel(board_size=args.size, n_res_blocks=2, channels=64,
                    seed=11, device=dev)
    eval_fn, bundle = make_inference(INFER, model.cfg, *model.jax_params(),
                                     device=dev)
    sides = make_sides(model.cfg, eval_fn)

    grid = GRID[:1] if args.quick else GRID
    ok = True
    for g in grid:
        cfg = MCTSConfig(n_simulations=args.sims, cpuct=1.25,
                         add_noise=g["add_noise"], dirichlet_alpha=0.1,
                         dirichlet_epsilon=0.25, dirichlet_moves=10,
                         max_depth=56, leaves_per_sim=g["k"],
                         search=g["search"])
        states = random_states(env, args.batch, g["plies"], g["plies"], dev)
        r = compare(env, cfg, sides, bundle, states, g["plies"],
                    g["plies"] + 1)
        r["config"] = g["name"]
        print(json.dumps(r), flush=True)
        ok = ok and r["pi_exact"] and r["q_max_abs_diff"] < Q_ATOL
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    print(json.dumps({"device": name, "all_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
