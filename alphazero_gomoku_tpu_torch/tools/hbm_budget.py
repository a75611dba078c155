"""Device memory of the lockstep self-play program: reckoned and measured.

Counterpart of the JAX repo's ``tools/hbm_budget.py``.  That tool read XLA's
ahead-of-time memory analysis of ``play_games`` without running it;
PyTorch has no such analysis.  This one reckons the peak from the shapes
(``selfplay/budget.selfplay_memory``, the memory preflight's reckoning) and
then runs ``play_games`` at that shape for ``--moves`` moves on the card,
under ``torch.cuda.reset_peak_memory_stats``, and prints the peak that
``torch.cuda.max_memory_allocated`` read beside the reckoning.  The net is a
seeded one of ``--blocks`` x ``--channels``, in inference mode ``infer``
(``f32``, ``int8`` on ``torch._int_mm``, or ``int8t``, the int8 tower
kernel); the search is PUCT with ``bench.py``'s constants.

    python -m alphazero_gomoku_tpu_torch.tools.hbm_budget 512 400 f32
    python -m alphazero_gomoku_tpu_torch.tools.hbm_budget 512 400 int8t

One JSON line, bytes in MiB.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games
from alphazero_gomoku_tpu_torch.selfplay.budget import selfplay_memory
from alphazero_gomoku_tpu_torch.tools.card_timing import card

INFER = ("f32", "int8", "int8t")
MIB = 2 ** 20


def selfplay_config(batch: int, sims: int, moves: int) -> SelfPlayConfig:
    return SelfPlayConfig(
        batch_games=batch, temp_threshold=10, max_moves=moves,
        mcts=MCTSConfig(n_simulations=sims, cpuct=1.0, add_noise=True,
                        dirichlet_alpha=0.05, dirichlet_epsilon=0.15,
                        dirichlet_moves=10, max_depth=56))


def reckon(batch: int, sims: int, moves: int = 2, board_size: int = 15,
           blocks: int = 6, channels: int = 128, game: str = "gomoku"):
    """``selfplay_memory``'s terms (bytes) for the tool's program."""
    env = make_env(game, board_size)
    net = AZModel(board_size=board_size, n_res_blocks=blocks,
                  channels=channels, seed=0, device="cpu")
    return selfplay_memory(env, selfplay_config(batch, sims, moves), net.cfg)


def analyze(batch: int, sims: int, infer: str, moves: int = 2,
            board_size: int = 15, blocks: int = 6, channels: int = 128,
            game: str = "gomoku", device=None) -> dict:
    dev = card(device, "hbm_budget")
    env = make_env(game, board_size)
    model = AZModel(board_size=board_size, n_res_blocks=blocks,
                    channels=channels, seed=0, device=dev)
    eval_fn, bundle = make_inference(infer, model.cfg, *model.jax_params(),
                                     device=dev)
    cfg = selfplay_config(batch, sims, moves)
    terms = selfplay_memory(env, cfg, model.cfg)
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    traj = play_games(env, cfg, eval_fn, bundle, gen, dev)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    played = int(torch.clamp(traj.moves_played, max=moves).sum())
    out = {"batch": batch, "sims": sims, "infer": infer, "moves": moves,
           "moves_played": played,
           "measured_peak_mb": round(peak / MIB, 1),
           "resident_before_mb": round(resident / MIB, 1),
           "reckoned_peak_mb": round(terms["peak_bytes"] / MIB, 1),
           "measured_over_reckoned": round(peak / terms["peak_bytes"], 4),
           "device": torch.cuda.get_device_name(dev)}
    out.update({k.replace("_bytes", "_mb"): round(v / MIB, 1)
                for k, v in terms.items() if k != "peak_bytes"})
    return out


def main(argv=None, device=None):
    """``device`` None is the card; it needs one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", type=int)
    ap.add_argument("sims", type=int)
    ap.add_argument("infer", choices=INFER)
    ap.add_argument("--moves", type=int, default=2,
                    help="moves played under the peak counter (the "
                         "records are sized by it; the JAX tool's 48 only "
                         "sized its compiled program)")
    ap.add_argument("--game", default="gomoku")
    args = ap.parse_args(argv)
    print(json.dumps(analyze(**vars(args), device=device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
