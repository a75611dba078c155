"""AlphaZero residual policy/value network as a PyTorch module (eval mode).

Counterpart of ``alphazero_gomoku_tpu/models/resnet.py:40-226``: 3x3 conv
stem -> BN/ReLU -> N residual blocks (conv-BN-ReLU-conv-BN + skip, ReLU) ->
policy head (1x1 conv to 2 channels, BN, ReLU, FC to action logits) and
value head (1x1 conv to 1 channel, BN, ReLU, FC->hidden, ReLU, FC->1, tanh).

The module computes in NCHW, PyTorch's layout, and takes NHWC observations
at its public ``forward`` as the JAX ``apply`` does.  BatchNorm runs with
running statistics only: training mode waits for the training slice
(ROADMAP Queue A item 8), so ``forward`` refuses a module in train mode.

Weights are made as numpy arrays in the JAX package's pytree layout
(:func:`init_params`) and converted with :func:`params_from_jax`, so one set
of numbers can feed both frameworks; ``models/model.py:bundle_of`` builds the
module from them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


BN_EPS = 1e-5
BN_MOMENTUM = 0.1

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NetConfig:
    board_size: int = 15
    action_size: int = 15 * 15
    in_channels: int = 3
    n_res_blocks: int = 3
    channels: int = 64
    value_hidden: int = 64

    @staticmethod
    def full(board_size: int = 15, **kw) -> "NetConfig":
        return NetConfig(board_size=board_size, action_size=board_size ** 2,
                         n_res_blocks=6, channels=128, **kw)


# ----------------------------------------------------------------------
# weights in the JAX layout (numpy)
# ----------------------------------------------------------------------
def init_params(cfg: NetConfig, seed: int) -> Tuple[Params, Params]:
    """``(params, batch_stats)`` as numpy arrays in the JAX pytree layout.

    Same distributions as the JAX ``init_variables``: Kaiming-normal HWIO
    convs (gain sqrt(2), fan_in), Kaiming-uniform ``[in, out]`` linears
    (bound sqrt(6/fan_in)), zero biases, BN scale 1 / bias 0, running mean 0
    / var 1.  The numbers come from numpy's generator, not from JAX's.
    """
    rng = np.random.default_rng(seed)
    c = cfg.channels
    hw = cfg.board_size * cfg.board_size

    def conv(kh, kw, cin, cout):
        std = (2.0 / (kh * kw * cin)) ** 0.5
        return (rng.standard_normal((kh, kw, cin, cout)) * std).astype(
            np.float32)

    def linear(cin, cout):
        bound = (6.0 / cin) ** 0.5
        return {"w": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
                "b": np.zeros((cout,), np.float32)}

    def bn(ch):
        return {"scale": np.ones((ch,), np.float32),
                "bias": np.zeros((ch,), np.float32)}

    def stats(ch):
        return {"mean": np.zeros((ch,), np.float32),
                "var": np.ones((ch,), np.float32)}

    params = {
        "stem": {"w": conv(3, 3, cfg.in_channels, c)},
        "stem_bn": bn(c),
        "blocks": [
            {"conv1": {"w": conv(3, 3, c, c)}, "bn1": bn(c),
             "conv2": {"w": conv(3, 3, c, c)}, "bn2": bn(c)}
            for _ in range(cfg.n_res_blocks)
        ],
        "policy_conv": {"w": conv(1, 1, c, 2)},
        "policy_bn": bn(2),
        "policy_fc": linear(2 * hw, cfg.action_size),
        "value_conv": {"w": conv(1, 1, c, 1)},
        "value_bn": bn(1),
        "value_fc1": linear(hw, cfg.value_hidden),
        "value_fc2": linear(cfg.value_hidden, 1),
    }
    batch_stats = {
        "stem_bn": stats(c),
        "blocks": [{"bn1": stats(c), "bn2": stats(c)}
                   for _ in range(cfg.n_res_blocks)],
        "policy_bn": stats(2),
        "value_bn": stats(1),
    }
    return params, batch_stats


def hwc_rows_to_chw(w: np.ndarray, c: int, h: int, wd: int) -> np.ndarray:
    """Reorder the rows of an ``[H*W*C, out]`` FC weight to CHW flatten order.

    The JAX net flattens NHWC activations (index ``(hi*W + wi)*C + ci``); this
    module flattens NCHW ones (index ``ci*H*W + hi*W + wi``).
    """
    return np.ascontiguousarray(
        w.reshape(h, wd, c, -1).transpose(2, 0, 1, 3).reshape(c * h * wd, -1))


def params_from_jax(params: Params,
                    batch_stats: Params) -> Dict[str, torch.Tensor]:
    """Turn the JAX pytree (numpy arrays) into :class:`ResNet`'s ``state_dict``.

    Conv weights go HWIO -> OIHW, linear weights ``[in, out]`` -> ``[out, in]``,
    and the ``policy_fc`` rows are permuted from HWC to CHW flatten order.  The
    value head has one channel, so its flatten order is the same in both.
    """
    sd: Dict[str, torch.Tensor] = {}
    # value_fc1 takes the flattened 1-channel board: H*W rows, H == W
    hw = np.asarray(params["value_fc1"]["w"]).shape[0]
    board_size = math.isqrt(hw)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))

    def conv(name, p):
        sd[f"{name}.weight"] = t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))

    def bn(name, p, s):
        sd[f"{name}.weight"] = t(p["scale"])
        sd[f"{name}.bias"] = t(p["bias"])
        sd[f"{name}.running_mean"] = t(s["mean"])
        sd[f"{name}.running_var"] = t(s["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def linear(name, p, w=None):
        w = np.asarray(p["w"]) if w is None else w
        sd[f"{name}.weight"] = t(w.T)
        sd[f"{name}.bias"] = t(p["b"])

    conv("stem", params["stem"])
    bn("stem_bn", params["stem_bn"], batch_stats["stem_bn"])
    for i, blk in enumerate(params["blocks"]):
        bs = batch_stats["blocks"][i]
        conv(f"blocks.{i}.conv1", blk["conv1"])
        bn(f"blocks.{i}.bn1", blk["bn1"], bs["bn1"])
        conv(f"blocks.{i}.conv2", blk["conv2"])
        bn(f"blocks.{i}.bn2", blk["bn2"], bs["bn2"])
    conv("policy_conv", params["policy_conv"])
    bn("policy_bn", params["policy_bn"], batch_stats["policy_bn"])
    linear("policy_fc", params["policy_fc"],
           hwc_rows_to_chw(np.asarray(params["policy_fc"]["w"]), 2,
                           board_size, board_size))
    conv("value_conv", params["value_conv"])
    bn("value_bn", params["value_bn"], batch_stats["value_bn"])
    linear("value_fc1", params["value_fc1"])
    linear("value_fc2", params["value_fc2"])
    return sd


# ----------------------------------------------------------------------
# module
# ----------------------------------------------------------------------
def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class ResBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn1 = _bn(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn2 = _bn(ch)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + x)


class ResNet(nn.Module):
    """The policy/value net.

    ``forward(obs NHWC [B, H, W, C]) -> (logits [B, A], value [B, 1])``.
    """

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        hw = cfg.board_size * cfg.board_size
        self.stem = nn.Conv2d(cfg.in_channels, c, 3, padding=1, bias=False)
        self.stem_bn = _bn(c)
        self.blocks = nn.ModuleList(ResBlock(c)
                                    for _ in range(cfg.n_res_blocks))
        self.policy_conv = nn.Conv2d(c, 2, 1, bias=False)
        self.policy_bn = _bn(2)
        self.policy_fc = nn.Linear(2 * hw, cfg.action_size)
        self.value_conv = nn.Conv2d(c, 1, 1, bias=False)
        self.value_bn = _bn(1)
        self.value_fc1 = nn.Linear(hw, cfg.value_hidden)
        self.value_fc2 = nn.Linear(cfg.value_hidden, 1)

    def forward(self, obs: torch.Tensor):
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm waits for the training slice "
                "(ROADMAP Queue A item 8); call .eval()")
        x = obs.permute(0, 3, 1, 2)                      # NHWC -> NCHW
        h = F.relu(self.stem_bn(self.stem(x)))
        for blk in self.blocks:
            h = blk(h)
        p = F.relu(self.policy_bn(self.policy_conv(h))).flatten(1)
        logits = self.policy_fc(p)
        v = F.relu(self.value_bn(self.value_conv(h))).flatten(1)
        v = torch.tanh(self.value_fc2(F.relu(self.value_fc1(v))))
        return logits, v

