"""The network as the search sees it: an eval function over a bundle.

Counterpart of ``alphazero_gomoku_tpu/selfplay/loop.py:60-73``
(``make_eval_fn`` / ``bundle_of``), with only what the eval path needs.  In
the JAX package the bundle is the ``{'params', 'batch_stats'}`` pytree; here
it is the eval-mode :class:`ResNet` that holds them.
"""

from __future__ import annotations

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models.resnet import (
    NetConfig,
    Params,
    ResNet,
    params_from_jax,
)


def make_eval_fn():
    """Network forward for MCTS.

    ``eval_fn(net, obs NHWC) -> (softmax probs [B, A], value [B, 1])``.
    """

    def eval_fn(net: ResNet, obs: torch.Tensor):
        with torch.no_grad():
            logits, value = net(obs)
            return torch.softmax(logits, dim=-1), value

    return eval_fn


def bundle_of(cfg: NetConfig, params: Params, batch_stats: Params,
              device=None) -> ResNet:
    """The bundle ``eval_fn`` takes: an eval-mode :class:`ResNet` on ``device``
    holding weights given in the JAX pytree layout."""
    dev = resolve_device(device)
    net = ResNet(cfg)
    net.load_state_dict(params_from_jax(params, batch_stats))
    return net.to(dev).eval()
