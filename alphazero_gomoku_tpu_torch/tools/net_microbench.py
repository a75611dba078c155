"""The network forward alone: milliseconds an evaluation in each inference
mode of the port.

Counterpart of the JAX repo's ``tools/net_microbench.py``, whose modes were
XLA's exact and folded forwards, three int8 skip tracks and three tiles of
the Pallas int8 tower.  Here the modes are ``make_inference``'s: ``f32``
(the float32 ``ResNet``, cuDNN, TF32 off), ``bf16`` (the folded forward with
bf16 activations on cuBLAS), ``fused`` (the fused bf16 tower kernel, K4),
``int8`` (im2col and ``torch._int_mm``) and ``int8t`` (the int8 tower
kernel, K5), on a seeded ``--blocks`` x ``--channels`` net at 15x15.

Each mode runs a chain of ``--iters`` evaluations in which each input is
moved by the last output (by 1e-20 of its sum, so the chain is sequential
and the boards do not change), timed by CUDA events around the chain after
a warm-up: the host's launch cost counts where it exceeds the work, as it
does in a search.

    python -m alphazero_gomoku_tpu_torch.tools.net_microbench
        [--batches 64 128] [--iters 200] [--only int8]

A JSON line each (mode, batch), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.models import (
    INFERENCE_MODES,
    AZModel,
    make_inference,
)
from alphazero_gomoku_tpu_torch.tools.card_timing import (
    card,
    card_label,
    events_ms,
)


def chained_ms(eval_fn, bundle, obs0: torch.Tensor, iters: int) -> float:
    """Milliseconds an evaluation over a chain of ``iters`` dependent
    evaluations."""
    obs = [obs0]

    def step():
        probs, value = eval_fn(bundle, obs[0])
        obs[0] = obs[0] + (probs.sum() + value.sum()) * 1e-20

    return events_ms(step, iters)


def main(argv=None, device=None):
    """``device`` None is the card; it needs one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--only", default=None,
                    help="substring filter on mode names")
    args = ap.parse_args(argv)

    dev = card(device, "net_microbench")
    label = card_label()
    model = AZModel(board_size=15, n_res_blocks=args.blocks,
                    channels=args.channels, seed=0, device=dev)
    weights = model.jax_params()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        modes = {m: make_inference(m, model.cfg, *weights, device=dev)
                 for m in INFERENCE_MODES
                 if not args.only or args.only in m}
        for b in args.batches:
            rng = np.random.default_rng(0)
            obs = torch.as_tensor(
                rng.integers(0, 2, (b, 15, 15, 3)).astype(np.float32),
                device=dev)
            for name, (eval_fn, bundle) in modes.items():
                ms = chained_ms(eval_fn, bundle, obs, args.iters)
                print(json.dumps({"mode": name, "batch": b,
                                  "ms_per_eval": round(ms, 4),
                                  "card": label}), flush=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
