"""Lockstep self-play played to the end of its games, on the kernels against
their plain versions.

Counterpart of the JAX repo's ``repro/bisect_lockstep_fault.py``.  Its
kernels crashed the TPU worker on batches of 128 x 400 played to the end of
their games, while the same shapes ran clean over 24 plies; the suspects
were the length of the move loop and what long games put in the trees: done
roots (the move loop searches every lane until every game is done) and
nearly full boards.  The grid is the JAX ``GRID``, ``(batch, sims,
max_moves)``: 128 x 400 at 48, 96, 160 and 225 moves, 96 x 400 and
64 x 800 at 225, each on 15x15 with the seeded 6x128 float32 net, PUCT
with the JAX script's constants and depth cap 56 (``envelope.
probe_selfplay``).

The kernels play every row to its end.  The plain versions are slower (a
plain walk at batch 256 takes 1.7-2.3 ms, ``PERF.md`` §6), so they play
the first ``PLAIN_PLIES`` plies of a row and the records are compared over
those (``compared_plies`` in the line); a whole game against the plain
versions is ``chip_smoke.py`` phase 30d's, at its cut size.  Every game of
the kernels' run is replayed on the host engine, and the counters say how
many games were won, filled the board or ran to the cap, and how many
lane-plies were searched on a done root.

    python -m alphazero_gomoku_tpu_torch.repro.bisect_lockstep    # the grid
    python -m alphazero_gomoku_tpu_torch.repro.bisect_lockstep 128 400 96

A JSON line a config; the grid ends with ``{"all_ok": ...}`` and exits 1
unless all are.
"""

from __future__ import annotations

import argparse
import sys

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.repro import envelope as ev

# (batch, sims, max_moves), the JAX GRID, cheapest information first
GRID = (
    (128, 400, 48),
    (128, 400, 96),
    (128, 400, 160),
    (128, 400, 225),
    (96, 400, 225),
    (64, 800, 225),
)
# plies of a row the plain versions play (and the records are compared
# over): a plain run of 128 x 400 over 96 plies takes about 5 minutes
PLAIN_PLIES = 96
# the JAX script's net (AZModel seed 0, 6x128, float32) and run key
NET_SEED, RUN_SEED = 0, 5
BLOCKS, CHANNELS = 6, 128
TIMEOUT = 3600


def lockstep(batch: int, sims: int, moves: int, device=None) -> dict:
    dev = resolve_device(device)
    env = make_env("gomoku", 15)
    net_cfg, eval_fn, bundle = ev.make_net("f32", BLOCKS, CHANNELS, NET_SEED,
                                           device=dev)
    cfg = ev.selfplay_config(batch, sims, moves)
    run = ev.probe_selfplay(env, cfg, ev.make_sides("f32", net_cfg, eval_fn),
                            bundle, RUN_SEED, net_cfg=net_cfg,
                            compared_plies=PLAIN_PLIES, device=dev)
    return {"probe": "lockstep", **run.line}


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="*", type=int,
                    help="BATCH SIMS MAX_MOVES (default: the grid)")
    ap.add_argument("--device", default=device,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.config:
        if len(args.config) != 3:
            ap.error("a config is BATCH SIMS MAX_MOVES")
        line = lockstep(*args.config, device=args.device)
        ev.print_line(line)
        return 0 if line["ok"] else 1
    ok = True
    for config in GRID:
        line = ev.run_one("bisect_lockstep", config, TIMEOUT, args.device)
        ok = ok and line["ok"]
    ev.print_line({"all_ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
