"""The network as the search sees it: an eval function over a bundle.

Counterpart of ``alphazero_gomoku_tpu/selfplay/loop.py:60-73``
(``make_eval_fn`` / ``bundle_of``), with only what the eval path needs.  In
the JAX package the bundle is the ``{'params', 'batch_stats'}`` pytree; here
it is the eval-mode :class:`ResNet` that holds them.

:func:`make_inference` is the counterpart of the inference switch of
``selfplay/loop.py:440-516`` and ``bench.py:112-160``: one name picks the
forward and builds the bundle it takes.
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


def fit_batch_stats(cfg: NetConfig, params: Params, batch_stats: Params,
                    obs, device=None) -> Params:
    """``batch_stats`` with each BN's running mean and variance set to the
    batch statistics of its input on ``obs`` (NHWC float32 boards), layer by
    layer, as a trained net's are its data's; a new pytree.

    With the initial stats (mean 0, var 1) a random net's activations grow
    block by block, its heads are dead or saturated (the 15x15 6x128 net's
    policy logits are 0 on most boards, its value 0 or +-1), and its folded
    biases are all zero: a check of logits, values or biases holds little.
    """
    net = bundle_of(cfg, params, batch_stats, device=device)
    x = torch.as_tensor(obs, device=next(net.parameters()).device)
    fitted = {}

    def fit(bn, x, key, into):
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
        into[key] = {"mean": mean.cpu().numpy(), "var": var.cpu().numpy()}
        return bn(x)

    with torch.no_grad():
        h = torch.relu(fit(net.stem_bn, net.stem(x.permute(0, 3, 1, 2)),
                           "stem_bn", fitted))
        fitted["blocks"] = []
        for blk in net.blocks:
            st = {}
            m = torch.relu(fit(blk.bn1, blk.conv1(h), "bn1", st))
            h = torch.relu(fit(blk.bn2, blk.conv2(m), "bn2", st) + h)
            fitted["blocks"].append(st)
        fit(net.policy_bn, net.policy_conv(h), "policy_bn", fitted)
        fit(net.value_bn, net.value_conv(h), "value_bn", fitted)
    return fitted


INFERENCE_MODES = ("f32", "bf16", "fused", "int8", "int8t")


def make_inference(inference: str, cfg: NetConfig, params: Params,
                   batch_stats: Params, device=None, int8_skip: str = "f32"):
    """``(eval_fn, bundle)`` for an inference mode, the weights given in the
    JAX pytree layout, the bundle on ``device`` (None: the card).

      - ``"f32"``: the float32 :class:`ResNet`;
      - ``"bf16"``: the folded forward with bf16 activations
        (``ops/fused_net.folded_xla_apply``);
      - ``"fused"``: the fused bf16 tower kernel (``fused_net.fused_predict``);
      - ``"int8"``: the int8 forward on ``torch._int_mm``
        (``ops/int8_net.int8_apply``), skip track ``int8_skip``;
      - ``"int8t"``: the same quantized bundle through the int8 tower kernel
        (``ops/int8_tower.int8_tower_apply``; float32 skip track only).

    int8 bundles are calibrated on ``random_calib_obs`` boards, as
    ``bench.py`` calibrates them.  ``play_games`` and ``run_mcts_packed``
    take the pair as it is.
    """
    # imported here: the ops modules import models.resnet
    from alphazero_gomoku_tpu_torch.ops import fused_net, int8_net, int8_tower

    if inference not in INFERENCE_MODES:
        raise ValueError(f"unknown inference mode {inference!r}: expected one "
                         f"of {INFERENCE_MODES}")
    if inference == "f32":
        return make_eval_fn(), bundle_of(cfg, params, batch_stats, device)
    if inference == "bf16":
        return (fused_net.make_bf16_eval_fn(cfg),
                fused_net.fold_bn_xla(cfg, params, batch_stats, device=device))
    if inference == "fused":
        return (fused_net.make_fused_eval_fn(cfg),
                fused_net.fold_bn(cfg, params, batch_stats, device=device))
    q = int8_net.quantize_int8(
        cfg, params, batch_stats,
        int8_net.random_calib_obs(cfg, cin=cfg.in_channels),
        residual=int8_skip, device=device)
    if inference == "int8":
        return int8_net.make_int8_eval_fn(cfg), q
    return (int8_tower.make_int8_tower_eval_fn(cfg),
            int8_tower.pack_tower_bundle(cfg, q))
