"""Does an int8 conv beat float32 and bf16 at the tower's shape?

Counterpart of the JAX repo's ``tools/int8_probe.py``.  It times one
res-block-shaped conv (3x3 SAME, ``--channels`` in and out, 15x15 boards,
``--batch`` boards) through the library: float32 (cuDNN, TF32 off), bf16
(cuDNN, float32 accumulation) and int8 (im2col and ``torch._int_mm``, int32
accumulation, then a requant to int8 as a quantized tower does), each in a
chain of ``--convs`` convs, by CUDA events around ``--reps`` chains after a
warm-up.  Then the whole tower the same way through the port's two tower
kernels, K5 (``int8_tower``) and K4 (``fused_tower``), on a seeded net of
``(convs - 1) / 2`` blocks: the kernels' time a conv beside the library's.

This tool times library calls; it ports no kernel.

    python -m alphazero_gomoku_tpu_torch.tools.int8_probe
        [--batch 256] [--channels 128]

A JSON line a mode, then the ratios, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.ops import fused_net, int8_tower
from alphazero_gomoku_tpu_torch.ops.fused_net import _im2col
from alphazero_gomoku_tpu_torch.ops.int8_net import _int8_matrix
from alphazero_gomoku_tpu_torch.tools.card_timing import (
    card,
    card_label,
    events_ms,
)


def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One conv of the chain: NCHW float32 / bf16 through cuDNN; NHWC int8
    through im2col and ``torch._int_mm`` (``w`` the ``[9C, C]`` int8 matrix,
    column-major), requantized to int8 (``y / 127`` clipped to +-127)."""
    if x.dtype == torch.int8:
        b, h, wd, _ = x.shape
        y = torch._int_mm(_im2col(x, w.shape[0]), w)
        y = torch.clamp(y.to(torch.float32) * (1.0 / 127), -127, 127)
        return y.to(torch.int8).reshape(b, h, wd, -1)
    return F.conv2d(x, w, padding=1)


def chain(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = conv(x, w)
    return x


def report(name: str, ms: float, convs: int, flops_per_conv: float,
           label: str, **extra) -> float:
    dt = ms / 1e3 / convs
    print(json.dumps({"mode": name, "us_per_conv": round(dt * 1e6, 2),
                      "tflops": round(flops_per_conv / dt / 1e12, 1),
                      **extra, "card": label}), flush=True)
    return dt


def main(argv=None, device=None):
    """``device`` None is the card; it needs one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--size", type=int, default=15)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--convs", type=int, default=13)  # 6 blocks x2 + stem
    ap.add_argument("--reps", type=int, default=50,
                    help="timed chains of --convs convs")
    args = ap.parse_args(argv)

    dev = card(device, "int8_probe")
    label = card_label()
    b, s, c, n = args.batch, args.size, args.channels, args.convs
    flops = 2 * 9 * c * c * s * s * b
    rng = np.random.default_rng(0)
    xf = torch.as_tensor(rng.standard_normal((b, c, s, s)), device=dev,
                         dtype=torch.float32)
    wf = torch.as_tensor(rng.standard_normal((c, c, 3, 3)) * 0.05,
                         device=dev, dtype=torch.float32)
    xi = torch.as_tensor(rng.integers(-127, 128, (b, s, s, c)), device=dev,
                         dtype=torch.int8)
    wi = _int8_matrix(torch.as_tensor(rng.integers(-127, 128, (9 * c, c)),
                                      device=dev, dtype=torch.int8))

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            t = {}
            for name, x, w in (("f32", xf, wf),
                               ("bf16", xf.to(torch.bfloat16),
                                wf.to(torch.bfloat16)),
                               ("int8", xi, wi)):
                ms = events_ms(lambda x=x, w=w: chain(x, w, n), args.reps)
                t[name] = report(name, ms, n, flops, label)

            # the whole tower through the port's kernels, a seeded net of
            # (convs - 1) / 2 blocks
            model = AZModel(board_size=s, n_res_blocks=(n - 1) // 2,
                            channels=c, seed=0, device=dev)
            weights = model.jax_params()
            obs = torch.as_tensor(rng.integers(0, 2, (b, s, s, 3)),
                                  device=dev, dtype=torch.float32)
            _, packed = make_inference("int8t", model.cfg, *weights,
                                       device=dev)
            _, folded = make_inference("fused", model.cfg, *weights,
                                       device=dev)
            for name, run in (
                    ("int8t", lambda: int8_tower.int8_tower(packed, obs)),
                    ("fused", lambda: fused_net.fused_tower(folded, obs))):
                ms = events_ms(run, args.reps)
                t[name] = report(name, ms, n, flops, label,
                                 us_per_tower=round(ms * 1e3, 2))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    print(json.dumps({
        "int8_vs_f32": round(t["f32"] / t["int8"], 2),
        "int8_vs_bf16": round(t["bf16"] / t["int8"], 2),
        "int8t_vs_int8": round(t["int8"] / t["int8t"], 2),
        "fused_vs_bf16": round(t["bf16"] / t["fused"], 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
