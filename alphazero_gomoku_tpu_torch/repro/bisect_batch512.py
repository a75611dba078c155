"""The tree kernels and the self-play loop at batches of 384 to 1024, on the
kernels against their plain versions.

Counterpart of the JAX repo's ``repro/bisect_batch512_fault.py``, which
walked the axes of a TPU worker fault at 512 games x 400 simulations
(float32 self-play crashed the worker; int8, 192 simulations, 384 games
and the tree kernels alone ran clean).  The grid is the JAX ``GRID``:

  - ``kernels B SIMS NODES``: ``select_walk`` and ``backup_paths`` alone on
    random priors and values (``envelope.probe_kernels``), 512 x 400 on
    408 node slots;
  - ``selfplay B SIMS MOVES INFER``: ``play_games``, 15x15, the seeded 6x128
    net, PUCT with the JAX script's constants, depth cap 56
    (``envelope.probe_selfplay``): 512 x 192, 384 x 400 and 512 x 400
    float32, 48 moves, and 512 x 400 on the int8 tower (``int8t``, the
    port's int8 path, where the JAX script names ``int8``);

and two more rows at 1024 lanes, the round-2 envelope note of the JAX
``repro/README.md``: self-play at 1024 x 400 float32 (its 24-move bench),
and the kernels alone at 1024 x 400.  Each runs on both backends from one
seed and holds the kernels' records (self-play) or final trees (kernels
alone) bit for bit against the plain versions' (on ``int8t`` over the
first ``PLAIN_PLIES`` plies: the plain int8 tower is slow), checks the memory
preflight (``selfplay/budget.py``) first, and prints the peak beside the
reckoning.  Every game is replayed on the host engine.

The JAX script's ``AZG_LANE_TILE`` axis is not ported: it set the lane tile
of the Mosaic kernels' grid, and the CUDA kernels have none (a block a
lane).  Nor is its 90-second sleep after a crash: a TPU worker took that
long to come back; each config here starts a process of its own, with a
fresh CUDA context.

    python -m alphazero_gomoku_tpu_torch.repro.bisect_batch512    # the grid
    python -m alphazero_gomoku_tpu_torch.repro.bisect_batch512 \
        selfplay 384 400 48 f32
    python -m alphazero_gomoku_tpu_torch.repro.bisect_batch512 \
        kernels 512 400 408

A JSON line a config (``ok``, ``match``, the counters, ``seconds`` a
backend); the grid ends with ``{"all_ok": ...}`` and exits 1 unless all are.
"""

from __future__ import annotations

import argparse
import sys

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.repro import envelope as ev

# (probe, argv): the JAX GRID, int8 as int8t and the lane-tile environment
# dropped, then the README's round-2 rows at 1024 lanes
GRID = (
    ("kernels", (512, 400, 408)),
    ("selfplay", (512, 192, 48, "f32")),
    ("selfplay", (384, 400, 48, "f32")),
    ("selfplay", (512, 400, 48, "f32")),
    ("selfplay", (512, 400, 48, "int8t")),
    ("selfplay", (1024, 400, 24, "f32")),
    ("kernels", (1024, 400, 408)),
)
INFER = ("f32", "int8t")
# plies the plain versions play (and the records are compared over), by
# inference mode: the plain int8 tower takes 36 s a move at 1024 lanes on an
# H100 (18 s at 512), so a 48-move plain run would take a quarter of an hour;
# float32 rows compare every ply
PLAIN_PLIES = {"int8t": 16}
# the JAX script's net (AZModel seed 0, 6x128) and run key (PRNGKey(5))
NET_SEED, RUN_SEED = 0, 5
BLOCKS, CHANNELS = 6, 128
TIMEOUT = 3600


def selfplay(batch: int, sims: int, moves: int, infer: str,
             device=None) -> dict:
    """The JAX ``SELFPLAY`` program on both backends."""
    dev = resolve_device(device)
    env = make_env("gomoku", 15)
    net_cfg, eval_fn, bundle = ev.make_net(infer, BLOCKS, CHANNELS, NET_SEED,
                                           device=dev)
    cfg = ev.selfplay_config(batch, sims, moves)
    run = ev.probe_selfplay(env, cfg, ev.make_sides(infer, net_cfg, eval_fn),
                            bundle, RUN_SEED, net_cfg=net_cfg,
                            compared_plies=PLAIN_PLIES.get(infer),
                            device=dev)
    return {"probe": "selfplay", "infer": infer, **run.line}


def kernels(batch: int, sims: int, nodes: int, device=None) -> dict:
    """The JAX ``KERNELS`` loop on both backends."""
    return ev.probe_kernels(batch, sims, nodes, device=device).line


def run_config(probe: str, argv, device=None) -> dict:
    if probe == "kernels":
        return kernels(*map(int, argv), device=device)
    if probe == "selfplay":
        b, sims, moves = map(int, argv[:3])
        if argv[3] not in INFER:
            raise ValueError(f"infer {argv[3]!r}: expected one of {INFER}")
        return selfplay(b, sims, moves, argv[3], device=device)
    raise ValueError(f"unknown probe {probe!r}: expected kernels or selfplay")


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", nargs="?", choices=("kernels", "selfplay"))
    ap.add_argument("args", nargs="*",
                    help="kernels: B SIMS NODES; selfplay: B SIMS MOVES "
                         "INFER (f32 or int8t)")
    ap.add_argument("--device", default=device,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.probe is not None:
        line = run_config(args.probe, args.args, args.device)
        ev.print_line(line)
        return 0 if line["ok"] else 1
    ok = True
    for probe, config in GRID:
        line = ev.run_one("bisect_batch512", (probe, *config), TIMEOUT,
                          args.device)
        ok = ok and line["ok"]
    ev.print_line({"all_ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
