"""AlphaZero residual policy/value network as a PyTorch module.

Counterpart of ``alphazero_gomoku_tpu/models/resnet.py:40-226``: 3x3 conv
stem -> BN/ReLU -> N residual blocks (conv-BN-ReLU-conv-BN + skip, ReLU) ->
policy head (1x1 conv to 2 channels, BN, ReLU, FC to action logits) and
value head (1x1 conv to 1 channel, BN, ReLU, FC->hidden, ReLU, FC->1, tanh).

The module computes in NCHW, PyTorch's layout, and takes NHWC observations
at its public ``forward`` as the JAX ``apply`` does.  BatchNorm follows the
JAX ``_batch_norm`` (``models/resnet.py:142-159`` there), which is
``nn.BatchNorm2d``'s own rule: eps 1e-5; in train mode (``net.train()``) it
normalises with the batch mean and the *biased* variance and moves the
running statistics with momentum 0.1 toward the batch mean and the
*unbiased* variance (times n / (n - 1)); in eval mode it normalises with the
running statistics.

``NetConfig.compute_dtype`` (float32 or bfloat16) is the JAX ``_conv``'s
(``:131-139``): every convolution and linear layer rounds its input and
weight to that type and computes in float32 (the products of two bfloat16
values are exact in float32), so its output is float32.

Weights are made as numpy arrays in the JAX package's pytree layout
(:func:`init_params`) and converted with :func:`params_from_jax`, so one set
of numbers can feed both frameworks; ``models/model.py:bundle_of`` builds the
module from them.  :func:`params_to_jax` is the inverse, for checkpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

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
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {self.compute_dtype} is not "
                             f"torch.float32 or torch.bfloat16")

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


def chw_rows_to_hwc(w: np.ndarray, c: int, h: int, wd: int) -> np.ndarray:
    """The inverse of :func:`hwc_rows_to_chw`."""
    return np.ascontiguousarray(
        w.reshape(c, h, wd, -1).transpose(1, 2, 0, 3).reshape(h * wd * c, -1))


def param_paths(n_res_blocks: int) -> List[Tuple[str, tuple, str]]:
    """``(state_dict name, JAX params path, kind)`` of every trainable
    tensor, in :class:`ResNet`'s parameter order.  ``kind`` says how the
    layouts differ: ``conv`` (HWIO / OIHW), ``linear`` (``[in, out]`` /
    ``[out, in]``), ``policy_fc`` (a linear whose rows are also permuted
    from HWC to CHW flatten order) or ``vec``."""
    out = [("stem.weight", ("stem", "w"), "conv")]

    def bn(name, path):
        out.append((f"{name}.weight", path + ("scale",), "vec"))
        out.append((f"{name}.bias", path + ("bias",), "vec"))

    bn("stem_bn", ("stem_bn",))
    for i in range(n_res_blocks):
        for k in (1, 2):
            out.append((f"blocks.{i}.conv{k}.weight",
                        ("blocks", i, f"conv{k}", "w"), "conv"))
            bn(f"blocks.{i}.bn{k}", ("blocks", i, f"bn{k}"))
    out.append(("policy_conv.weight", ("policy_conv", "w"), "conv"))
    bn("policy_bn", ("policy_bn",))
    out.append(("policy_fc.weight", ("policy_fc", "w"), "policy_fc"))
    out.append(("policy_fc.bias", ("policy_fc", "b"), "vec"))
    out.append(("value_conv.weight", ("value_conv", "w"), "conv"))
    bn("value_bn", ("value_bn",))
    for fc in ("value_fc1", "value_fc2"):
        out.append((f"{fc}.weight", (fc, "w"), "linear"))
        out.append((f"{fc}.bias", (fc, "b"), "vec"))
    return out


def bn_paths(n_res_blocks: int) -> List[Tuple[str, tuple]]:
    """``(BatchNorm module name, JAX batch_stats path)`` of every BN."""
    return ([("stem_bn", ("stem_bn",))]
            + [(f"blocks.{i}.bn{k}", ("blocks", i, f"bn{k}"))
               for i in range(n_res_blocks) for k in (1, 2)]
            + [("policy_bn", ("policy_bn",)), ("value_bn", ("value_bn",))])


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: tuple, value):
    """Set ``tree[path]``, making the dicts (and the ``blocks`` list) on the
    way."""
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(nxt, int):
            lst = tree.setdefault(key, [])
            lst.extend({} for _ in range(nxt + 1 - len(lst)))
            tree = lst
        else:
            tree = tree[key] if isinstance(tree, list) else \
                tree.setdefault(key, {})
    tree[path[-1]] = value


def n_blocks_of(tree_or_names) -> int:
    if isinstance(tree_or_names, dict) and "blocks" in tree_or_names:
        return len(tree_or_names["blocks"])
    return len({k.split(".")[1] for k in tree_or_names
                if k.startswith("blocks.")})


def _to_torch_layout(x, kind: str, board_size: int) -> torch.Tensor:
    x = np.asarray(x, dtype=np.float32)
    if kind == "conv":
        x = np.transpose(x, (3, 2, 0, 1))
    elif kind == "policy_fc":
        x = hwc_rows_to_chw(x, 2, board_size, board_size).T
    elif kind == "linear":
        x = x.T
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _to_jax_layout(t: torch.Tensor, kind: str, board_size: int) -> np.ndarray:
    x = t.detach().to("cpu", torch.float32).numpy()
    if kind == "conv":
        x = np.transpose(x, (2, 3, 1, 0))
    elif kind == "policy_fc":
        x = chw_rows_to_hwc(x.T, 2, board_size, board_size)
    elif kind == "linear":
        x = x.T
    return np.ascontiguousarray(x, dtype=np.float32)


def param_tree_to_torch(tree: Params) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX ``params`` (the params themselves, or
    Adam's ``mu`` or ``nu``) as :class:`ResNet` parameter tensors by
    ``state_dict`` name (CPU float32)."""
    board_size = math.isqrt(np.asarray(tree["value_fc1"]["w"]).shape[0])
    return {name: _to_torch_layout(_get(tree, path), kind, board_size)
            for name, path, kind in param_paths(n_blocks_of(tree))}


def param_tree_to_jax(named: Dict[str, torch.Tensor]) -> Params:
    """The inverse of :func:`param_tree_to_torch`: numpy float32 arrays in
    the JAX ``params`` layout."""
    board_size = math.isqrt(named["value_fc1.weight"].shape[1])
    tree: Params = {}
    for name, path, kind in param_paths(n_blocks_of(named)):
        _put(tree, path, _to_jax_layout(named[name], kind, board_size))
    return tree


def params_from_jax(params: Params,
                    batch_stats: Params) -> Dict[str, torch.Tensor]:
    """Turn the JAX pytree (numpy arrays) into :class:`ResNet`'s ``state_dict``.

    Conv weights go HWIO -> OIHW, linear weights ``[in, out]`` -> ``[out, in]``,
    and the ``policy_fc`` rows are permuted from HWC to CHW flatten order.  The
    value head has one channel, so its flatten order is the same in both.
    """
    sd = param_tree_to_torch(params)
    for name, path in bn_paths(len(params["blocks"])):
        s = _get(batch_stats, path)
        sd[f"{name}.running_mean"] = _to_torch_layout(s["mean"], "vec", 0)
        sd[f"{name}.running_var"] = _to_torch_layout(s["var"], "vec", 0)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd


def params_to_jax(sd: Dict[str, torch.Tensor]) -> Tuple[Params, Params]:
    """The inverse of :func:`params_from_jax`: ``(params, batch_stats)`` as
    numpy float32 arrays in the JAX pytree layout, from a :class:`ResNet`
    ``state_dict`` (on any device).  ``num_batches_tracked`` has no JAX
    counterpart and is dropped."""
    params = param_tree_to_jax(sd)
    stats: Params = {}
    for name, path in bn_paths(len(params["blocks"])):
        _put(stats, path, {
            "mean": _to_jax_layout(sd[f"{name}.running_mean"], "vec", 0),
            "var": _to_jax_layout(sd[f"{name}.running_var"], "vec", 0)})
    return params, stats


# ----------------------------------------------------------------------
# module
# ----------------------------------------------------------------------
def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in float32 (a no-op for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _conv(layer: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.conv2d(_round(x, dtype), _round(layer.weight, dtype),
                    padding=layer.padding)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(_round(x, dtype), _round(layer.weight, dtype), layer.bias)


class ResBlock(nn.Module):
    def __init__(self, ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn1 = _bn(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn2 = _bn(ch)

    def forward(self, x):
        y = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        y = self.bn2(_conv(self.conv2, y, self.dtype))
        return F.relu(y + x)


class ResNet(nn.Module):
    """The policy/value net.

    ``forward(obs NHWC [B, H, W, C]) -> (logits [B, A], value [B, 1])``, in
    train or eval mode (``net.train()`` / ``net.eval()``).
    """

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        hw = cfg.board_size * cfg.board_size
        self.stem = nn.Conv2d(cfg.in_channels, c, 3, padding=1, bias=False)
        self.stem_bn = _bn(c)
        self.blocks = nn.ModuleList(ResBlock(c, cfg.compute_dtype)
                                    for _ in range(cfg.n_res_blocks))
        self.policy_conv = nn.Conv2d(c, 2, 1, bias=False)
        self.policy_bn = _bn(2)
        self.policy_fc = nn.Linear(2 * hw, cfg.action_size)
        self.value_conv = nn.Conv2d(c, 1, 1, bias=False)
        self.value_bn = _bn(1)
        self.value_fc1 = nn.Linear(hw, cfg.value_hidden)
        self.value_fc2 = nn.Linear(cfg.value_hidden, 1)

    def forward(self, obs: torch.Tensor):
        dt = self.cfg.compute_dtype
        x = obs.permute(0, 3, 1, 2)                      # NHWC -> NCHW
        h = F.relu(self.stem_bn(_conv(self.stem, x, dt)))
        for blk in self.blocks:
            h = blk(h)
        p = F.relu(self.policy_bn(_conv(self.policy_conv, h, dt))).flatten(1)
        logits = _linear(self.policy_fc, p, dt)
        v = F.relu(self.value_bn(_conv(self.value_conv, h, dt))).flatten(1)
        v = torch.tanh(_linear(self.value_fc2,
                               F.relu(_linear(self.value_fc1, v, dt)), dt))
        return logits, v
