"""Depth-capped lanes under both FPU modes, on the kernels against their plain
versions.

Counterpart of the JAX repo's ``repro/parent_pallas_probe.py``.  Parent FPU
on its Mosaic kernels crashed the TPU worker minutes into long runs; the
round-4 hypothesis was that parent FPU puts the visits on one line, so that
walks reach the depth cap far more often than under zero FPU, and that the
fault was in the capped lanes.  The probe forces capped walks at once with a
cap of 8.  Its ``CONFIGS`` are the JAX script's: FPU ``zero`` or ``parent``
x depth cap 8 or 56, 24 moves, batch 128, 200 simulations, PUCT with the
JAX script's constants on 15x15 with the seeded 2x32 float32 net
(``AZModel`` seed 5; the JAX run key ``PRNGKey(11)`` is seed 11 here).

A capped walk ends with ``action = -1`` and ``path_len = depth``
(``csrc/tree_kernels.cu``'s ``walk``); the search then expands nothing and
``backup_paths`` backs the capped leaf's value up the path without writing a
child link.  Each row runs on both backends (``envelope.probe_selfplay``)
and counts its capped walks.  ``EXTRA`` adds rows for the other kernels
that share the capped branch, Gumbel@64 with m = 16 (``gumbel_select_walk``
and ``backup_paths``) and k-leaf PUCT with k = 4 under parent FPU
(``select_walk``, ``backup_paths`` in modes ``"vl"`` and ``"finalize"``),
both at cap 8; and, since neither zero FPU nor Gumbel's walks get past 2
hops on this net (so that cap 8 caps none of them), zero FPU and Gumbel at
cap 1.  The rows of ``MUST_CAP`` must show capped walks: otherwise they
probed nothing.

    python -m alphazero_gomoku_tpu_torch.repro.parent_probe    # every row
    python -m alphazero_gomoku_tpu_torch.repro.parent_probe parent 8 24

Each row prints a header, its JSON line and ``name CLEAN`` (or
``MISMATCH``, ``UNPROBED`` or ``FAULT(rc=...)``), in a process of its own
as the JAX script runs them; then one JSON object of the verdicts.  Exit 1
unless all are clean.
"""

from __future__ import annotations

import argparse
import json
import sys

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.repro import envelope as ev

# (fpu_mode, depth_cap, moves), the JAX CONFIGS: cap 8 was to force capped
# lanes from the first move; cap 56 is the production setting
CONFIGS = (
    ("zero", 8, 24),
    ("parent", 8, 24),
    ("zero", 56, 24),
    ("parent", 56, 24),
)
# (search, depth_cap, moves): the other kernels of the capped branch at cap
# 8, then zero FPU and Gumbel at the cap their walks reach on this net.
# Under zero FPU (and under Gumbel's non-root rule) the search spreads its
# 200 (64) simulations over the root's 225 children: over 24 moves no walk
# passed 2 hops, so at cap 8 (and at cap 2) none is capped
EXTRA = (
    ("gumbel", 8, 24),
    ("kleaf4", 8, 24),
    ("zero", 1, 24),
    ("gumbel", 1, 24),
)
# the rows whose counters must show capped walks: the capped branch is what
# they are for
MUST_CAP = (("parent", 8), ("kleaf4", 8), ("zero", 1), ("gumbel", 1))
KINDS = ("zero", "parent", "gumbel", "kleaf4")
BATCH, SIMS, GUMBEL_SIMS, KLEAF = 128, 200, 64, 4
# the JAX script's net (AZModel seed 5, 2x32, float32) and run key
NET_SEED, RUN_SEED = 5, 11
BLOCKS, CHANNELS = 2, 32
TIMEOUT = 3600


def row_config(kind: str, cap: int, moves: int, batch: int = BATCH):
    """The ``SelfPlayConfig`` of a row: PUCT under FPU ``kind``, Gumbel@64
    (``"gumbel"``) or k-leaf k=4 under parent FPU (``"kleaf4"``)."""
    if kind == "gumbel":
        return ev.selfplay_config(batch, GUMBEL_SIMS, moves, max_depth=cap,
                                  search="gumbel")
    if kind == "kleaf4":
        return ev.selfplay_config(batch, SIMS, moves, max_depth=cap,
                                  fpu_mode="parent", leaves_per_sim=KLEAF)
    if kind not in ("zero", "parent"):
        raise ValueError(f"unknown row {kind!r}: expected one of {KINDS}")
    return ev.selfplay_config(batch, SIMS, moves, max_depth=cap,
                              fpu_mode=kind)


def probe(kind: str, cap: int, moves: int, batch: int = BATCH,
          device=None) -> dict:
    """One row on both backends; a row of ``MUST_CAP`` must cap walks."""
    dev = resolve_device(device)
    env = make_env("gomoku", 15)
    net_cfg, eval_fn, bundle = ev.make_net("f32", BLOCKS, CHANNELS, NET_SEED,
                                           device=dev)
    cfg = row_config(kind, cap, moves, batch)
    run = ev.probe_selfplay(env, cfg, ev.make_sides("f32", net_cfg, eval_fn),
                            bundle, RUN_SEED, net_cfg=net_cfg,
                            expect=(("capped_walks",)
                                    if (kind, cap) in MUST_CAP else ()),
                            device=dev)
    return {"probe": "parent", "row": f"{kind}@cap{cap}", **run.line}


def verdict(line: dict) -> str:
    if line["ok"]:
        return "CLEAN"
    if line.get("match") is False:
        return "MISMATCH"
    if line.get("axes_reached") is False:
        return "UNPROBED"
    return f"FAULT(rc={line.get('rc', 0)})"


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("row", nargs="*",
                    help=f"KIND CAP MOVES, KIND one of {KINDS} (default: "
                         f"every row)")
    ap.add_argument("--device", default=device,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.row:
        if len(args.row) != 3:
            ap.error("a row is KIND CAP MOVES")
        kind, cap, moves = args.row[0], int(args.row[1]), int(args.row[2])
        line = probe(kind, cap, moves, device=args.device)
        ev.print_line(line)
        return 0 if line["ok"] else 1
    results = {}
    for kind, cap, moves in CONFIGS + EXTRA:
        name = f"{kind}@cap{cap}"
        print(f"--- {name} ({moves} moves, batch {BATCH}) ---", flush=True)
        line = ev.run_one("parent_probe", (kind, cap, moves), TIMEOUT,
                          args.device)
        results[name] = verdict(line)
        print(name, results[name], flush=True)
    print(json.dumps(results), flush=True)
    return 0 if all(v == "CLEAN" for v in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
