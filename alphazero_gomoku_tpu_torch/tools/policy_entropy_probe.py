"""Compare policy sharpness of two checkpoints on shared positions.

Counterpart of the JAX repo's ``tools/policy_entropy_probe.py``.  A net that
plays well under Gumbel search and badly under deep PUCT may have sharpened
its priors: Gumbel's improved-policy target sharpens the net's own policy
every generation, and PUCT's exploration term ``cpuct * P * sqrt(N) /
(1 + n)`` starves where most priors are near zero, while Gumbel's root
sampling re-softens them.  This measures it: mean policy entropy, top-1 and
top-8 prior mass, and the count of actions above 1e-3, for each checkpoint,
over positions drawn from a replay buffer (the distribution the nets see),
the float32 forward on the card.

    python -m alphazero_gomoku_tpu_torch.tools.policy_entropy_probe
        A.ckpt B.ckpt --buffer runs/models_run15/replay_buffer_latest.npz
        [--n 512]

A JSON line a checkpoint, then the entropy delta.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models import AZModel, make_eval_fn


def load_positions(buffer_path: str, n: int, seed: int) -> np.ndarray:
    """Sample n encoded states [n, size, size, C] from a saved buffer.

    Schema of ``selfplay/buffer.save_replay_buffer``: states (uint8 or f32),
    pis, zs, capacity, channel_scales (uint8 decode multipliers).  Rows with
    an all-zero pi are unfilled ring slots and are skipped.
    """
    data = np.load(buffer_path)
    states = data["states"]
    filled = np.flatnonzero(np.abs(data["pis"]).sum(axis=1) > 0)
    rng = np.random.default_rng(seed)
    idx = rng.choice(filled, size=min(n, len(filled)), replace=False)
    batch = states[idx].astype(np.float32)
    if states.dtype == np.uint8 and "channel_scales" in data:
        batch = batch * data["channel_scales"]
    return batch


def probe(ckpt: str, obs: np.ndarray, board_size: int, device=None) -> dict:
    dev = resolve_device(device)
    model = AZModel.from_checkpoint(ckpt, board_size=board_size, device=dev)
    p, v = make_eval_fn()(model.eval_net(), torch.as_tensor(obs, device=dev))
    logp = torch.log(torch.clamp(p, min=1e-12))
    ent = -(p * logp).sum(dim=-1)
    top1 = p.max(dim=-1).values
    top8 = torch.sort(p, dim=-1).values[:, -8:].sum(dim=-1)
    alive = (p > 1e-3).sum(dim=-1).to(torch.float32)
    ent, top1, top8, alive, v = (x.cpu().numpy()
                                 for x in (ent, top1, top8, alive, v))
    return {
        "ckpt": ckpt,
        "positions": int(obs.shape[0]),
        "mean_entropy_nats": round(float(np.mean(ent)), 4),
        "median_entropy_nats": round(float(np.median(ent)), 4),
        "mean_top1_mass": round(float(np.mean(top1)), 4),
        "mean_top8_mass": round(float(np.mean(top8)), 4),
        "mean_actions_above_1e-3": round(float(np.mean(alive)), 2),
        "mean_abs_value": round(float(np.mean(np.abs(v))), 4),
    }


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_a")
    ap.add_argument("ckpt_b")
    ap.add_argument("--buffer", required=True,
                    help="replay_buffer .npz to sample positions from")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    obs = load_positions(args.buffer, args.n, args.seed)
    a = probe(args.ckpt_a, obs, args.size, dev)
    b = probe(args.ckpt_b, obs, args.size, dev)
    print(json.dumps(a))
    print(json.dumps(b))
    print(json.dumps({
        "entropy_delta_nats": round(
            a["mean_entropy_nats"] - b["mean_entropy_nats"], 4),
        "note": "negative delta = A sharper than B",
    }))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
