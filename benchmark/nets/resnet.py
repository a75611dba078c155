"""The architecture ``resnet``, a configuration's default: the
AlphaZero-Gomoku residual tower (``reference/net.py`` says its layers).

Its shape keys, weights made from a seed, its reference, and the operations
and least time the metric readers divide by (``yardstick.py``'s formulas).
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import yardstick
from benchmark.reference import net as rnet

KEYS = ("n_res_blocks", "channels", "value_hidden")


def _tree(config: Dict, take) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` in the checkpoint's layout, each array
    ``take(shape, kind, s)``: ``kind`` ``normal`` (``N(0, 1) * s``),
    ``scale`` (``1 + 0.1 * N(0, 1)``), ``small`` (``0.1 * N(0, 1)``),
    ``var`` (``1 + 0.1 * U[0, 1)``) or ``zero``."""
    def conv(k, ci, co):
        return {"w": take((k, k, ci, co), "normal",
                          float(np.sqrt(2.0 / (k * k * ci))))}

    def bn(ch):
        return ({"scale": take((ch,), "scale"), "bias": take((ch,), "small")},
                {"mean": take((ch,), "small"), "var": take((ch,), "var")})

    def dense(i, o):
        return {"w": take((i, o), "normal", float(1.0 / np.sqrt(i))),
                "b": take((o,), "zero")}

    cin, c = config["in_channels"], config["channels"]
    hw = config["board_size"] ** 2
    params, stats = {}, {}
    params["stem"] = conv(3, cin, c)
    params["stem_bn"], stats["stem_bn"] = bn(c)
    params["blocks"], stats["blocks"] = [], []
    for _ in range(config["n_res_blocks"]):
        p1, s1 = bn(c)
        p2, s2 = bn(c)
        params["blocks"].append({"conv1": conv(3, c, c), "bn1": p1,
                                 "conv2": conv(3, c, c), "bn2": p2})
        stats["blocks"].append({"bn1": s1, "bn2": s2})
    params["policy_conv"] = conv(1, c, 2)
    params["policy_bn"], stats["policy_bn"] = bn(2)
    params["policy_fc"] = dense(2 * hw, hw)
    params["value_conv"] = conv(1, c, 1)
    params["value_bn"], stats["value_bn"] = bn(1)
    params["value_fc1"] = dense(hw, config["value_hidden"])
    params["value_fc2"] = dense(config["value_hidden"], 1)
    return params, stats


# each kind's value: shift + mul * draw (``mul`` None: the leaf's ``s``)
_SHIFT = {"normal": 0.0, "scale": 1.0, "small": 0.0, "zero": 0.0}
_MUL = {"normal": None, "scale": 0.1, "small": 0.1, "zero": 0.0}


def init(config: Dict, seed: int, device="cpu") -> Tuple[Dict, Dict]:
    """``(params, batch_stats)``: float32 numpy arrays in the checkpoint's
    layout, drawn from ``seed`` by a ``torch.Generator`` on ``device`` in
    two calls (the normal draws, then the variances' uniform ones).  Convs
    He-normal, dense layers ``N(0, 1 / fan_in)`` with zero biases; batch
    norm's scale, bias, mean and variance away from the identity, so that
    the heads of a deep tower do not die (seeded 6x128 nets with identity
    batch norm had value 0 and uniform priors)."""
    leaves = []
    _tree(config, lambda shape, kind, s=0.0: leaves.append((shape, kind, s)))
    normal = [(int(np.prod(shape)), kind, s) for shape, kind, s in leaves
              if kind != "var"]
    n_var = sum(int(np.prod(shape)) for shape, kind, _ in leaves
                if kind == "var")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    z = torch.empty(sum(n for n, _, _ in normal), dtype=torch.float32,
                    device=dev)
    z.normal_(generator=gen)
    u = torch.empty(n_var, dtype=torch.float32,
                    device=dev).uniform_(generator=gen)
    counts = torch.tensor([n for n, _, _ in normal], device=dev)
    mul = torch.tensor([s if _MUL[k] is None else _MUL[k]
                        for _, k, s in normal], device=dev)
    shift = torch.tensor([_SHIFT[k] for _, k, _ in normal], device=dev)
    drawn = {"normal": (torch.repeat_interleave(shift, counts)
                        + torch.repeat_interleave(mul, counts) * z
                        ).cpu().numpy(),
             "var": (1.0 + 0.1 * u).cpu().numpy()}
    at = {"normal": 0, "var": 0}

    def take(shape, kind, s=0.0):
        src = "var" if kind == "var" else "normal"
        n = int(np.prod(shape))
        out = drawn[src][at[src]:at[src] + n].reshape(shape)
        at[src] += n
        return out

    return _tree(config, take)


def make(params, stats, calib, device, spec: Dict):
    """The reference's eval function ``obs -> (probs, value)`` at a
    configuration's ``reference_net`` or ``control_net`` ``spec``."""
    return rnet.make(params, stats, calib, device, spec)


def flops_per_eval(config: Dict) -> float:
    """Operations of one board's evaluation."""
    return yardstick.net_flops_per_eval(
        config["board_size"], config["n_res_blocks"], config["channels"],
        config["in_channels"])


def call_least_s(batch: int, config: Dict) -> float:
    """The least time of one network call of ``batch`` boards on the card,
    at the configuration's ``peak``."""
    return yardstick.net_call_least_s(
        batch, config["board_size"], config["n_res_blocks"],
        config["channels"], config["in_channels"], config["peak"],
        config["value_hidden"])
