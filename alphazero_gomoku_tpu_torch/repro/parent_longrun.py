"""Parent FPU at the production shape over many batches of full games, on the
kernels, the first batch against the plain versions.

Counterpart of the JAX repo's ``repro/parent_pallas_longrun.py``.  Parent
FPU on the Mosaic kernels was reported to crash the TPU worker minutes into
long runs; the short probes (``parent_probe``) leave run length itself as
the axis.  This runs ``n_batches`` self-play batches (default 10) in one
process at the JAX script's shape: batch 128, 200 simulations, depth cap 56,
parent FPU, full games (225 moves), the seeded 6x128 float32 net
(``AZModel`` seed 5), batch ``i`` from seed ``1000 + i``, each batch on the
kernels (``envelope.probe_selfplay``).  Batch 0 also runs on the plain
versions and is compared with the kernels' bit for bit; every batch's games
are replayed on the host engine.

    python -m alphazero_gomoku_tpu_torch.repro.parent_longrun [n_batches]

Each batch prints the JAX script's line and its JSON line; the run ends in
the JAX script's ``DONE`` line.  Exit 1 unless every batch is ok.
"""

from __future__ import annotations

import argparse
import sys
import time

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.repro import envelope as ev

N_BATCHES = 10
BATCH, SIMS, CAP, MOVES = 128, 200, 56, 225
NET_SEED, SEED_BASE = 5, 1000
BLOCKS, CHANNELS = 6, 128


def longrun(n_batches: int = N_BATCHES, batch: int = BATCH, sims: int = SIMS,
            blocks: int = BLOCKS, channels: int = CHANNELS, device=None):
    """Run the batches, printing each; return their JSON lines."""
    dev = resolve_device(device)
    env = make_env("gomoku", 15)
    net_cfg, eval_fn, bundle = ev.make_net("f32", blocks, channels, NET_SEED,
                                           device=dev)
    cfg = ev.selfplay_config(batch, sims, MOVES, max_depth=CAP,
                             fpu_mode="parent")
    both = ev.make_sides("f32", net_cfg, eval_fn)
    kernels = {"pallas": both["pallas"]}
    t0 = time.time()
    total, lines = 0, []
    for i in range(n_batches):
        run = ev.probe_selfplay(env, cfg, both if i == 0 else kernels,
                                bundle, SEED_BASE + i, net_cfg=net_cfg,
                                device=dev)
        line = {"probe": "parent_longrun", "index": i, **run.line}
        total += line["lane_moves"]
        print(f"batch {i}: {line['lane_moves']} moves "
              f"({time.time() - t0:.1f}s elapsed, {total} total)",
              flush=True)
        ev.print_line(line)
        lines.append(line)
    print(f"DONE parent@cap{CAP} longrun: {total} moves over {n_batches} "
          f"batches in {time.time() - t0:.1f}s", flush=True)
    return lines


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_batches", nargs="?", type=int, default=N_BATCHES)
    ap.add_argument("--device", default=device,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    lines = longrun(args.n_batches, device=args.device)
    return 0 if all(line["ok"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
