"""int8 calibration sensitivity: the same weights, different calibration sets.

Counterpart of the JAX repo's ``tools/int8_calib_sensitivity.py``.  Two int8
bundles of the same weights differ only in their calibration boards; if the
quantization is fragile to that sample, an arena between them measures the
calibration, not the nets.  This quantizes one checkpoint with several
calibration sets (random-play boards, and two disjoint draws from a replay
buffer) and measures each against the float32 forward on held-out
positions: policy top-1 agreement, policy KL (mean and max) and value MAE.

Each calibration set gets a line for each int8 route: ``int8``, the forward
on ``torch._int_mm`` (``ops/int8_net.int8_apply``, the JAX tool's route),
and ``int8t``, the same bundle through the int8 tower kernel
(``ops/int8_tower.int8_tower_apply``).

    python -m alphazero_gomoku_tpu_torch.tools.int8_calib_sensitivity
        [checkpoints/best_gomoku.ckpt] [--buffer PATH] [--n 256]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models import AZModel
from alphazero_gomoku_tpu_torch.ops.int8_net import (
    int8_apply,
    quantize_int8,
    random_play_calib_obs,
)
from alphazero_gomoku_tpu_torch.ops.int8_tower import (
    int8_tower_apply,
    pack_tower_bundle,
)


def agreement(net, forward, obs):
    """The int8 ``forward(obs) -> (logits, value)`` against the float32
    ``net`` on ``obs``."""
    with torch.no_grad():
        logits_f, value_f = net(obs)
    logits_q, value_q = forward(obs)
    top1_f = torch.argmax(logits_f, dim=-1)
    top1_q = torch.argmax(logits_q, dim=-1)
    lp_f = torch.log_softmax(logits_f, dim=-1)
    lp_q = torch.log_softmax(logits_q, dim=-1)
    kl = (torch.exp(lp_f) * (lp_f - lp_q)).sum(dim=-1)
    return {
        "top1_agree": float((top1_f == top1_q).to(torch.float32).mean()),
        "policy_kl_mean": float(kl.mean()),
        "policy_kl_max": float(kl.max()),
        "value_mae": float((value_f - value_q).abs().mean()),
    }


def main(argv=None, device=None):
    """``device`` None is the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?", default="checkpoints/best_gomoku.ckpt")
    ap.add_argument("--buffer", default=None,
                    help="replay buffer .npz to draw calib/held-out states")
    ap.add_argument("--n", type=int, default=256, help="calib set size")
    ap.add_argument("--held", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    model = AZModel.from_checkpoint(args.ckpt, board_size=15, device=dev)
    cfg = model.cfg
    params, stats = model.jax_params()
    net = model.eval_net()
    rng = np.random.default_rng(args.seed)

    calib_sets = {"random_play": random_play_calib_obs(
        cfg, game="gomoku", n=args.n)}
    held = None
    if args.buffer:
        with np.load(args.buffer) as z:
            states = z["states"] if "states" in z else z[z.files[0]]
            size = len(states)
            idx = rng.choice(size, size=min(size, args.held + 2 * args.n),
                             replace=False)
            pool = states[idx]
        held = pool[: args.held]
        calib_sets["buffer_a"] = pool[args.held: args.held + args.n]
        calib_sets["buffer_b"] = pool[args.held + args.n:]
    if held is None:
        held = random_play_calib_obs(cfg, game="gomoku", n=args.held,
                                     seed=args.seed + 1)

    held = torch.as_tensor(np.ascontiguousarray(held, np.float32),
                           device=dev)
    for name, calib in calib_sets.items():
        bundle = quantize_int8(cfg, params, stats, calib, device=dev)
        packed = pack_tower_bundle(cfg, bundle)
        for route, forward in (
                ("int8", lambda x: int8_apply(cfg, bundle, x)),
                ("int8t", lambda x: int8_tower_apply(cfg, packed, x))):
            stats_q = agreement(net, forward, held)
            print(json.dumps({"calib": name, "ckpt": args.ckpt,
                              "n_calib": int(np.asarray(calib).shape[0]),
                              "n_held": int(held.shape[0]), **stats_q,
                              "route": route}), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
