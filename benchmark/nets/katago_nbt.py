"""The architecture ``katago_nbt``: KataGo's nested-bottleneck residual
net with global pooling (``b18c384nbt``; ``reference/katago_nbt.py`` says
its layers).

Its shape keys, weights made from a seed, its reference, and the operations
and least times the metric readers divide by.  Imports nothing of the
program.

The weights' layout (convs HWIO, linears ``[in, out]`` with ``b`` where
they have a bias, each norm a batch norm: ``scale`` / ``bias`` in the
params, ``mean`` / ``var`` in the batch stats, under the same path); ``T``
trunk, ``M`` mid, ``G`` gpool channels::

    stem/w                    [5, 5, planes, T]
    blocks/<i>/pre_bn         [T]
    blocks/<i>/conv_p/w       [1, 1, T, M]
    blocks/<i>/inner/<j>/bn1  [M]
    blocks/<i>/inner/<j>/conv1/w  [3, 3, M, R]    R = M - G in the first
    blocks/<i>/inner/<j>/conv_g/w [3, 3, M, G]      inner block of a gpool
    blocks/<i>/inner/<j>/bn_g     [G]               block (these three
    blocks/<i>/inner/<j>/linear_g/w [3G, R]         only there), else M
    blocks/<i>/inner/<j>/bn2  [R]
    blocks/<i>/inner/<j>/conv2/w  [3, 3, R, M]
    blocks/<i>/mid_bn         [M]
    blocks/<i>/conv_q/w       [1, 1, M, T]
    trunk_bn                  [T]
    policy/conv_p/w [1, 1, T, p1]   policy/conv_g/w [1, 1, T, g1]
    policy/bn_g [g1]   policy/linear_g/w [3 g1, p1]   policy/bn2 [p1]
    policy/conv_out/w [1, 1, p1, 1]
    value/conv/w [1, 1, T, v1]   value/bn [v1]
    value/fc1/w [3 v1, v2], b [v2]   value/fc2/w [v2, 3], b [3]

Blocks are numbered from 1 in ``gpool_blocks`` (KataGo's ``rconv<n>``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import yardstick
from benchmark.reference import katago_nbt as ref

KEYS = ("n_blocks", "trunk_channels", "mid_channels", "gpool_channels",
        "gpool_blocks", "p1_channels", "g1_channels", "v1_channels",
        "v2_size")
INNER = 2                     # inner blocks of a nested bottleneck block
STEM_K = 5
HEAD_GAIN = 4.0


def _tree(config: Dict, take) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` in the layout above, each array
    ``take(shape, kind, s)``: ``kind`` ``normal`` (``N(0, 1) * s``),
    ``scale`` (``1 + 0.1 * N(0, 1)``), ``small`` (``0.1 * N(0, 1)``),
    ``var`` (``1 + 0.1 * U[0, 1)``) or ``zero``.  Convs He-normal, linears
    ``N(0, 1 / fan_in)``; the last conv of every residual branch, inner
    and outer, at ``branch_gain`` of He's scale (:func:`branch_gain`), and
    the heads' last layers at ``HEAD_GAIN`` of theirs (at 1 the seeded
    net's priors are near uniform: entropy 5.29 of 5.42 nats)."""
    n = config["n_blocks"]
    gain_in, gain_out = branch_gain(n)

    def conv(k, ci, co, gain=1.0):
        return {"w": take((k, k, ci, co), "normal",
                          gain * float(np.sqrt(2.0 / (k * k * ci))))}

    def bn(ch):
        return ({"scale": take((ch,), "scale"), "bias": take((ch,), "small")},
                {"mean": take((ch,), "small"), "var": take((ch,), "var")})

    def dense(i, o, bias=True, gain=1.0):
        d = {"w": take((i, o), "normal", gain * float(1.0 / np.sqrt(i)))}
        if bias:
            d["b"] = take((o,), "zero")
        return d

    cin, t, m = (config["in_channels"], config["trunk_channels"],
                 config["mid_channels"])
    gp = config["gpool_channels"]
    gpool = set(config["gpool_blocks"])
    params, stats = {"stem": conv(STEM_K, cin, t), "blocks": []}, \
        {"blocks": []}
    for i in range(1, n + 1):
        p, s = {}, {}
        p["pre_bn"], s["pre_bn"] = bn(t)
        p["conv_p"] = conv(1, t, m)
        p["inner"], s["inner"] = [], []
        for j in range(INNER):
            pi, si = {}, {}
            r = m - gp if (i in gpool and j == 0) else m
            pi["bn1"], si["bn1"] = bn(m)
            pi["conv1"] = conv(3, m, r)
            if r != m:
                pi["conv_g"] = conv(3, m, gp)
                pi["bn_g"], si["bn_g"] = bn(gp)
                pi["linear_g"] = dense(3 * gp, r, bias=False)
            pi["bn2"], si["bn2"] = bn(r)
            pi["conv2"] = conv(3, r, m, gain_in)
            p["inner"].append(pi)
            s["inner"].append(si)
        p["mid_bn"], s["mid_bn"] = bn(m)
        p["conv_q"] = conv(1, m, t, gain_out)
        params["blocks"].append(p)
        stats["blocks"].append(s)
    params["trunk_bn"], stats["trunk_bn"] = bn(t)
    p1, g1 = config["p1_channels"], config["g1_channels"]
    pol, pst = {"conv_p": conv(1, t, p1), "conv_g": conv(1, t, g1)}, {}
    pol["bn_g"], pst["bn_g"] = bn(g1)
    pol["linear_g"] = dense(3 * g1, p1, bias=False)
    pol["bn2"], pst["bn2"] = bn(p1)
    pol["conv_out"] = conv(1, p1, 1, HEAD_GAIN)
    v1, v2 = config["v1_channels"], config["v2_size"]
    val, vst = {"conv": conv(1, t, v1)}, {}
    val["bn"], vst["bn"] = bn(v1)
    val["fc1"] = dense(3 * v1, v2)
    val["fc2"] = dense(v2, 3, gain=HEAD_GAIN)
    params["policy"], stats["policy"] = pol, pst
    params["value"], stats["value"] = val, vst
    return params, stats


def branch_gain(n_blocks: int) -> Tuple[float, float]:
    """The gains of the last conv of an inner branch and of an outer one.
    KataGo's fixscale init zeroes them, which would leave every branch's
    convs untested; at He's scale the trunk's variance doubles a block.
    Here each inner branch adds a quarter of its block's variance and each
    outer branch ``1 / n_blocks`` of the trunk's, so that the trunk grows
    by about ``e`` over all the blocks and every branch moves it."""
    return 0.5, float(1.0 / np.sqrt(n_blocks))


# each kind's value: shift + mul * draw (``mul`` None: the leaf's ``s``)
_SHIFT = {"normal": 0.0, "scale": 1.0, "small": 0.0, "zero": 0.0}
_MUL = {"normal": None, "scale": 0.1, "small": 0.1, "zero": 0.0}


def init(config: Dict, seed: int, device="cpu") -> Tuple[Dict, Dict]:
    """``(params, batch_stats)``: float32 numpy arrays in the layout above,
    drawn from ``seed`` by a ``torch.Generator`` on ``device`` in two calls
    (the normal draws, then the variances' uniform ones), as
    ``nets/resnet.py`` draws them; batch norm away from the identity, so
    that the heads do not die."""
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
    return ref.make(params, stats, calib, device, spec)


def _layers(config: Dict):
    """``(k, cin, cout)`` of every conv, and ``(fan_in, fan_out)`` of
    every linear, of one evaluation."""
    cin, t, m = (config["in_channels"], config["trunk_channels"],
                 config["mid_channels"])
    gp = config["gpool_channels"]
    convs, linears = [(STEM_K, cin, t)], []
    for i in range(1, config["n_blocks"] + 1):
        convs += [(1, t, m), (1, m, t)]
        for j in range(INNER):
            if i in config["gpool_blocks"] and j == 0:
                convs += [(3, m, m - gp), (3, m, gp), (3, m - gp, m)]
                linears.append((3 * gp, m - gp))
            else:
                convs += [(3, m, m), (3, m, m)]
    p1, g1 = config["p1_channels"], config["g1_channels"]
    v1, v2 = config["v1_channels"], config["v2_size"]
    convs += [(1, t, p1), (1, t, g1), (1, p1, 1), (1, t, v1)]
    linears += [(3 * g1, p1), (3 * v1, v2), (v2, 3)]
    return convs, linears


def flops_per_eval(config: Dict) -> float:
    """Operations of one board's evaluation: 2 a multiply-add of every conv
    (at every point) and linear; 11.70 GFLOP for ``b18c384nbt`` at 15x15
    with 3 planes."""
    hw = config["board_size"] ** 2
    convs, linears = _layers(config)
    return float(sum(2 * hw * k * k * ci * co for k, ci, co in convs)
                 + sum(2 * i * o for i, o in linears))


def weight_count(config: Dict) -> int:
    """Conv and linear weights of the net (the norms and biases left
    out)."""
    convs, linears = _layers(config)
    return (sum(k * k * ci * co for k, ci, co in convs)
            + sum(i * o for i, o in linears))


def call_least_s(batch: int, config: Dict) -> float:
    """The least time of one network call of ``batch`` boards on the card:
    its operations at the configuration's ``peak``, or its bytes at the
    HBM's bandwidth (every weight once, in the peak's type, the boards in
    as float32 planes, the policy and value out as float32), whichever is
    longer."""
    hw = config["board_size"] ** 2
    ops_s = batch * flops_per_eval(config) / yardstick.PEAK_OPS[
        config["peak"]]
    io = 4 * batch * hw * config["in_channels"] + 4 * batch * (hw + 1)
    weights = yardstick.WEIGHT_BYTES[config["peak"]] * weight_count(config)
    return max(ops_s, (weights + io) / yardstick.HBM_BYTES_PER_S)


def gpool_least_s(batch: int, config: Dict) -> float:
    """The least time of one network call's global poolings (one a gpool
    block, the policy head's and the value head's): their bytes at the
    HBM's bandwidth, each activation in the peak's type.  A trunk or
    policy pooling reads its ``C`` pooled channels and its linear's
    ``3C x R`` weights, and reads and writes the ``R`` channels it adds
    to; the value head's reads its ``v1`` channels and writes ``3 v1``
    float32 numbers a board."""
    hw = config["board_size"] ** 2
    e = yardstick.WEIGHT_BYTES[config["peak"]]
    gp, r = config["gpool_channels"], (config["mid_channels"]
                                       - config["gpool_channels"])
    g1, p1, v1 = (config["g1_channels"], config["p1_channels"],
                  config["v1_channels"])

    def adding(c, out):
        return batch * hw * e * (c + 2 * out) + e * 3 * c * out

    total = (len(config["gpool_blocks"]) * adding(gp, r) + adding(g1, p1)
             + batch * (hw * e * v1 + 4 * 3 * v1))
    return total / yardstick.HBM_BYTES_PER_S
