"""Distill a smaller student net from a strong net's self-play data.

Counterpart of the JAX repo's ``tools/distill_net.py``, the tool that made
the shipped students ``checkpoints/distill_4x96.ckpt`` and
``distill_3x64.ckpt`` (``TRAINING_GUIDE.md``).  It trains a student (e.g.
4x96 or 3x64) SUPERVISED on a replay buffer of the teacher's self-play,
(state, search pi, z) triples, the targets the full loop trains on, so the
student distills the teacher's search policy and not only its raw net; then
an arena of the two (``tools/cross_net_arena.py``) says whether it holds.

The buffer is decoded by ``selfplay/buffer.py``; the batches are the JAX
tool's (the same ``np.random.default_rng(seed)`` draws in the same order);
each step is ``AZModel.train_batch`` on the card, and the student is saved as
an AZTPU1 checkpoint that both packages read.

    python -m alphazero_gomoku_tpu_torch.tools.distill_net
        runs/models_run16/replay_buffer_latest.npz --blocks 4 --channels 96
        --epochs 16 --batch 256 --out checkpoints/distill_4x96.ckpt

A JSON line an epoch (mean train loss, hold-out policy cross-entropy and
value MSE).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models import AZModel
from alphazero_gomoku_tpu_torch.selfplay.buffer import (
    _scales_array,
    decode_states_f32,
    inv_scales_f32,
)


def main(argv=None, device=None, init=None):
    """``device`` None is the card.  ``init``, a ``(params, batch_stats)``
    pair in the JAX pytree layout, replaces the student's initial weights
    (tests pass the JAX model's: this package's seeded init is not
    flax's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("buffer_path")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--channels", type=int, default=96)
    ap.add_argument("--board-size", type=int, default=15)
    ap.add_argument("--game", default="gomoku")
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--holdout", type=int, default=4096,
                    help="samples held out for the eval loss")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    with np.load(args.buffer_path) as data:
        states_u8 = data["states"]          # [N, H, W, C] uint8 (encoded)
        pis = data["pis"].astype(np.float32)
        zs = data["zs"].astype(np.float32)
        scales = (data["channel_scales"] if "channel_scales" in data
                  else None)
    inv_scales = inv_scales_f32(
        _scales_array(scales, states_u8.shape[-1]), states_u8.shape[-1])
    n = states_u8.shape[0]
    print(f"[distill] {n} samples from {args.buffer_path}", flush=True)

    model = AZModel(board_size=args.board_size, n_res_blocks=args.blocks,
                    channels=args.channels, seed=args.seed, lr=args.lr,
                    in_channels=states_u8.shape[-1], device=dev)
    if init is not None:
        model._set_jax(*init)
        model.opt_state = model.tx.init(model.params)
    rng = np.random.default_rng(args.seed)

    def batch_at(idx):
        # model.train_batch/predict expect the reference NCHW convention
        xs = decode_states_f32(states_u8[idx], inv_scales)
        return xs.transpose(0, 3, 1, 2), pis[idx], zs[idx]

    hold_idx = rng.choice(n, size=min(args.holdout, n), replace=False)
    train_idx = np.setdiff1d(np.arange(n), hold_idx)
    hx, hp, hz = batch_at(hold_idx)

    steps_per_epoch = max(1, train_idx.size // args.batch)
    t0 = time.time()
    for epoch in range(args.epochs):
        losses = []
        for _ in range(steps_per_epoch):
            idx = rng.choice(train_idx, size=args.batch, replace=False)
            xs, ps, z = batch_at(idx)
            out = model.train_batch(xs, ps, z)
            losses.append(out["total_loss"])
        probs, values = model.predict(hx)
        eps = 1e-9
        pol_ce = float(-(hp * np.log(probs + eps)).sum(-1).mean())
        val_mse = float(((values.reshape(-1) - hz.reshape(-1)) ** 2).mean())
        print(json.dumps({
            "epoch": epoch, "train_loss": round(float(np.mean(losses)), 4),
            "holdout_policy_ce": round(pol_ce, 4),
            "holdout_value_mse": round(val_mse, 4),
            "elapsed_s": round(time.time() - t0, 1),
        }), flush=True)

    model.save(args.out)
    print(f"[distill] saved {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
