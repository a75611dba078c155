"""Pick the strongest snapshot of a training run (TRAINING_GUIDE 7c).

Counterpart of the JAX repo's ``tools/harvest_run.py``: brackets a run's
``snapshot_iter*.ckpt`` (AZTPU1, written by either package) at
``--every`` iterations, plus the last, and plays mirrored-opening arenas
(``selfplay.arena.evaluate_params_detailed``) up a single-elimination ladder
from the latest snapshot down: the champion stays while it wins above 0.5,
or at 0.5 with no fewer decisive pairs won than lost.  ``--baseline`` adds a
last match of the winner against another checkpoint.

    python -m alphazero_gomoku_tpu_torch.tools.harvest_run runs/models_run6
        [--games 32] [--sims 256] [--every 50]
        [--baseline checkpoints/best_gomoku.ckpt]

Prints a JSON line a match, then the winner and its path.  ``--backend`` is
accepted and changes nothing.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_eval_fn
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import evaluate_params_detailed
from alphazero_gomoku_tpu_torch.tools.ab_arena import rounded


def snapshots(model_dir: Path, every: int):
    """Snapshot paths at iteration spacing >= ``every``, plus the last."""
    snaps = {}
    for p in model_dir.glob("snapshot_iter*.ckpt"):
        m = re.search(r"iter(\d+)_", p.name)
        if m:
            snaps[int(m.group(1))] = p
    if not snaps:
        raise SystemExit(f"no snapshots under {model_dir}")
    iters = sorted(snaps)
    picked, last = [], None
    for it in iters:
        if last is None or it - last >= every:
            picked.append(it)
            last = it
    if iters[-1] not in picked:
        picked.append(iters[-1])
    return [(it, snaps[it]) for it in picked]


def duel(env, cfg, a, b, games, seed, device, openings=None):
    """Snapshot ``a`` against ``b``: ``evaluate_params_detailed``'s result."""
    ma = AZModel.from_checkpoint(str(a), board_size=env.size, device=device)
    mb = AZModel.from_checkpoint(str(b), board_size=env.size, device=device)
    return evaluate_params_detailed(
        env, cfg, make_eval_fn(), ma.eval_net(), mb.eval_net(), games, seed,
        device=device, net_cfgs=(ma.cfg, mb.cfg), openings=openings)


def main(argv=None, device=None, openings=None):
    """``device`` None is the card; ``openings`` replaces the random
    openings of every match (tests inject the JAX tool's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--sims", type=int, default=256)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--backend", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cands = snapshots(Path(args.model_dir), args.every)
    probe = AZModel.from_checkpoint(str(cands[-1][1]), board_size=args.size,
                                    device=dev)
    env = make_env(args.game, args.size,
                   capture_planes=probe.cfg.in_channels == 5)
    cfg = MCTSConfig(n_simulations=args.sims, cpuct=1.0, add_noise=False,
                     max_depth=56)

    # the ladder from the latest snapshot down: the champion must beat
    # (> 0.5, or 0.5 with decisive pairs as the tie-break) each earlier pick
    order = list(reversed(cands))
    champ_it, champ = order[0]
    results = []
    for it, path in order[1:]:
        r = duel(env, cfg, champ, path, args.games, args.seed + it, dev,
                 openings)
        decisive = r["pairs"]["win_both"] - r["pairs"]["loss_both"]
        keep = r["win_rate"] > 0.5 or (r["win_rate"] == 0.5 and decisive >= 0)
        rate, ci95 = rounded(r)
        results.append({"a": f"iter{champ_it}", "b": f"iter{it}",
                        "a_win_rate": rate, "ci95": ci95,
                        "pairs": r["pairs"], "kept": "a" if keep else "b"})
        print(json.dumps(results[-1]), flush=True)
        if not keep:
            champ_it, champ = it, path

    out = {"winner": f"iter{champ_it}", "path": str(champ),
           "matches": results}
    if args.baseline:
        r = duel(env, cfg, champ, Path(args.baseline), args.games,
                 args.seed + 7777, dev, openings)
        rate, ci95 = rounded(r)
        out["vs_baseline"] = {"baseline": args.baseline, "win_rate": rate,
                              "ci95": ci95, "pairs": r["pairs"]}
        print(json.dumps({"vs_baseline": out["vs_baseline"]}), flush=True)
    print(json.dumps({"winner": out["winner"], "path": out["path"]}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
