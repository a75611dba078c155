"""The benchmark's fixed arithmetic: the net's operations and bytes, the
card's peaks, and the union of device intervals.

Frozen copies, taken when the benchmark was added:

  - :func:`net_flops_per_eval` is ``net_flops_per_eval`` of
    ``alphazero_gomoku_tpu_torch/bench.py`` (the BASELINE.md roofline
    formula): 2*H*W*9*Cin*Cout a 3x3 SAME conv, two a residual block, the
    heads counted coarsely (under 0.1 % of the whole);
  - :data:`PEAK_OPS` holds the NVIDIA H100 SXM5 datasheet's dense peaks at
    the 700 W limit, as that module's ``PEAK_TFLOPS`` does, and the HBM3
    bandwidth;
  - :func:`busy_ns` is ``_busy_us`` of the repo's ``profile_search.py``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_OPS = {"int8": 1978.9e12, "bf16": 989.4e12, "f32": 66.9e12}
HBM_BYTES_PER_S = 3.35e12
# bytes of one conv weight at each of those peaks' types
WEIGHT_BYTES = {"int8": 1, "bf16": 2, "f32": 4}


def conv_flops(board_size: int, n_res_blocks: int, channels: int,
               cin: int) -> float:
    """Operations of the stem and the residual tower (the 3x3 convs)."""
    hw = board_size * board_size
    stem = 2 * hw * 9 * cin * channels
    tower = n_res_blocks * 2 * (2 * hw * 9 * channels * channels)
    return float(stem + tower)


def head_flops(board_size: int, channels: int) -> float:
    hw = board_size * board_size
    return float(2 * hw * channels * 3 + 2 * (2 * hw) * (hw + 1)
                 + 2 * hw * 64)


def net_flops_per_eval(board_size: int, n_res_blocks: int, channels: int,
                       cin: int = 3) -> float:
    """Operations of one board's evaluation: 798,222,600 for 6x128 at
    15x15 with 3 planes."""
    return (conv_flops(board_size, n_res_blocks, channels, cin)
            + head_flops(board_size, channels))


def net_call_bytes(batch: int, board_size: int, n_res_blocks: int,
                   channels: int, cin: int, value_hidden: int = 64,
                   weight_bytes: int = 1) -> float:
    """Bytes a network call must move at the least: the boards in (float32
    planes), the conv weights (``weight_bytes`` each: 1 int8) and their
    float32 scales and biases, the float32 heads, and the policy and value
    out, each once."""
    hw = board_size * board_size
    a = hw
    convs = 1 + 2 * n_res_blocks
    conv_w = 9 * cin * channels + 2 * n_res_blocks * 9 * channels * channels
    conv_vec = 4 * convs * channels * 3          # scale, bias, 1 / act scale
    heads = 4 * (channels * 3 + 3 + 2 * hw * a + a + hw * value_hidden
                 + value_hidden + value_hidden + 1)
    io = 4 * batch * hw * cin + 4 * batch * (a + 1)
    return float(weight_bytes * conv_w + conv_vec + heads + io)


def net_call_least_s(batch: int, board_size: int, n_res_blocks: int,
                     channels: int, cin: int, precision: str,
                     value_hidden: int = 64) -> float:
    """The least time of one network call of ``batch`` boards on the card:
    the convs at the peak ``precision`` names (a key of :data:`PEAK_OPS`,
    a configuration's ``peak``) and the heads at float32's, or the bytes at
    the HBM's bandwidth, whichever is longer."""
    ops_s = (batch * conv_flops(board_size, n_res_blocks, channels, cin)
             / PEAK_OPS[precision]
             + batch * head_flops(board_size, channels) / PEAK_OPS["f32"])
    bytes_s = net_call_bytes(batch, board_size, n_res_blocks, channels,
                             cin, value_hidden, WEIGHT_BYTES[precision]
                             ) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)


def busy_ns(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of intervals ``(start, end)``."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps(spans: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> Iterable[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    at = lo
    out = []
    for s, e in sorted(spans):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]

