"""The network as the search sees it, and as the trainer changes it.

The eval side is the counterpart of ``alphazero_gomoku_tpu/selfplay/
loop.py:60-73`` (``make_eval_fn`` / ``bundle_of``).  In the JAX package the
bundle is the ``{'params', 'batch_stats'}`` pytree; here it is the eval-mode
:class:`ResNet` that holds them.  :func:`make_inference` is the counterpart
of the inference switch of ``selfplay/loop.py:440-516`` and
``bench.py:112-160``: one name picks the forward and builds the bundle it
takes.

The training side is the counterpart of ``alphazero_gomoku_tpu/models/
model.py``: the optimizer (:class:`Optimizer`, optax's chain written out),
:func:`train_step` (autograd through the train-mode :class:`ResNet`; no
Pallas kernel of the JAX package has a backward, so the step needs no
kernel of its own), the epochs of the training loop, and :class:`AZModel`,
the host surface with AZTPU1 checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models import checkpoint as ckpt
from alphazero_gomoku_tpu_torch.models.losses import alphazero_loss
from alphazero_gomoku_tpu_torch.models.resnet import (
    NetConfig,
    Params,
    ResNet,
    init_params,
    n_blocks_of,
    param_paths,
    param_tree_to_jax,
    param_tree_to_torch,
    params_from_jax,
    params_to_jax,
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
                   batch_stats: Params, device=None, int8_skip: str = "f32",
                   calib_obs=None):
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

    int8 bundles are calibrated on ``calib_obs`` (NHWC boards; the training
    loop's replay samples), by default on ``random_calib_obs`` boards, as
    ``bench.py`` calibrates them.  ``play_games`` and ``run_mcts_packed``
    take the pair as it is; the training loop makes the eval function once
    and a bundle at each weight update.
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
    if calib_obs is None:
        calib_obs = int8_net.random_calib_obs(cfg, cin=cfg.in_channels)
    q = int8_net.quantize_int8(cfg, params, batch_stats, calib_obs,
                               residual=int8_skip, device=device)
    if inference == "int8":
        return int8_net.make_int8_eval_fn(cfg), q
    return (int8_tower.make_int8_tower_eval_fn(cfg),
            int8_tower.pack_tower_bundle(cfg, q))


# ----------------------------------------------------------------------
# the optimizer: optax's chain as plain functions on tensors
# ----------------------------------------------------------------------
DEFAULT_LR = 1e-3
DEFAULT_WEIGHT_DECAY = 1e-4
GRAD_CLIP_NORM = 3.0


class AdamState(NamedTuple):
    """Adam's state: ``count`` (int32, 0-d) and the moments ``mu`` and ``nu``,
    each a dict of tensors by parameter name, shaped as the parameters."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Counterpart of ``make_optimizer`` (``models/model.py:36-44`` in the
    JAX package), optax's chain in its order and with its formulas:

      1. ``clip_by_global_norm(3.0)``: ``g * 3 / ||g||`` where the global
         norm ``||g|| >= 3``, with no epsilon;
      2. ``add_decayed_weights(wd)``: ``g + wd * p``;
      3. ``scale_by_adam(0.9, 0.999, eps=1e-8, eps_root=0)``: ``mu``, ``nu``
         moved toward ``g`` and ``g**2``, bias-corrected by
         ``1 - b**count``, and ``mu_hat / (sqrt(nu_hat) + eps)``;
      4. ``scale(-lr)``.

    ``torch.optim.Adam`` and ``clip_grad_norm_`` differ from it (weight decay
    after the clip, the clip's ``+1e-6``), so they are not used.
    """

    lr: float = DEFAULT_LR
    weight_decay: float = DEFAULT_WEIGHT_DECAY
    clip_norm: ClassVar[float] = GRAD_CLIP_NORM
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        any_param = next(iter(params.values()))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=any_param.device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor]):
        """``(updates, new_state)``; nothing is written in place."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clipped = g_norm < self.clip_norm
        count = state.count + 1
        c = count.to(g_norm.dtype)
        bc1 = 1 - self.b1 ** c
        bc2 = 1 - self.b2 ** c
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = torch.where(clipped, g, g / g_norm * self.clip_norm)
            g = g + self.weight_decay * params[k]
            mu[k] = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state.nu[k]
            step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            updates[k] = -self.lr * step
        return updates, AdamState(count, mu, nu)


def apply_updates(params, updates):
    return {k: p + updates[k] for k, p in params.items()}


_TEMPLATES: Dict[NetConfig, ResNet] = {}


def _template(cfg: NetConfig) -> ResNet:
    """A train-mode :class:`ResNet` on the meta device for each config: the
    module ``functional_call`` runs with the tensors it is given."""
    if cfg not in _TEMPLATES:
        _TEMPLATES[cfg] = ResNet(cfg).to("meta").train()
    return _TEMPLATES[cfg]


def split_state(sd: Dict[str, torch.Tensor]):
    """``(params, batch_stats)`` of a :class:`ResNet` ``state_dict``: the
    trainable tensors and the BN buffers."""
    names = {name for name, _, _ in param_paths(n_blocks_of(sd))}
    return ({k: v for k, v in sd.items() if k in names},
            {k: v for k, v in sd.items() if k not in names})


def loss_grads(cfg: NetConfig, params, batch_stats, x: torch.Tensor,
               target_pi: torch.Tensor, target_z: torch.Tensor,
               value_loss_weight: float = 1.0,
               template: Optional[ResNet] = None):
    """``(grads, new_batch_stats, metrics)``: autograd of the loss through
    the train-mode forward (batch statistics; the running ones moved, in new
    tensors) at ``params``.  Dicts by :class:`ResNet` ``state_dict`` name
    (:func:`split_state`); ``x`` NHWC observations, ``target_pi [B, A]``,
    ``target_z [B, 1]``; ``metrics`` holds the 0-d ``policy_loss``,
    ``value_loss`` and ``total_loss``.  Works in any floating type the
    params have (float64 for a reference).  ``template`` is the train-mode
    module the tensors run through (the data-parallel step's, whose batch
    norms are global: ``parallel/mesh.global_bn_template``); by default a
    :class:`ResNet` of ``cfg``."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    stats = {k: v.clone() for k, v in batch_stats.items()}
    # train-mode BN moves the running statistics of ``stats`` in place
    net = _template(cfg) if template is None else template
    logits, value = torch.func.functional_call(net, {**p, **stats}, (x,))
    loss, metrics = alphazero_loss(logits, value, target_pi, target_z,
                                   value_loss_weight)
    grads = torch.autograd.grad(loss, list(p.values()))
    return (dict(zip(p.keys(), grads)), stats,
            {k: v.detach() for k, v in metrics.items()})


def train_step(cfg: NetConfig, tx: Optimizer, params, batch_stats,
               opt_state: AdamState, x: torch.Tensor, target_pi: torch.Tensor,
               target_z: torch.Tensor, value_loss_weight: float = 1.0):
    """One optimizer step on one batch; counterpart of ``train_step_fn``
    (``models/model.py:54-70`` in the JAX package): :func:`loss_grads`, then
    the optimizer.  Returns ``(new_params, new_batch_stats, new_opt_state,
    metrics)``, new tensors throughout."""
    grads, stats, metrics = loss_grads(cfg, params, batch_stats, x,
                                       target_pi, target_z, value_loss_weight)
    updates, new_opt = tx.update(grads, opt_state, params)
    return apply_updates(params, updates), stats, new_opt, metrics


def train_epoch(cfg: NetConfig, tx: Optimizer, params, batch_stats,
                opt_state, xs, pis, zs, value_loss_weight: float = 1.0,
                step=None):
    """Steps over pre-sampled batches ``[n_batches, b, ...]``; the last
    step's metrics.  Counterpart of ``train_epoch_fn``
    (``selfplay/loop.py:76-95`` in the JAX package).  ``step`` replaces
    :func:`train_step` (the data-parallel epochs' step, same arguments)."""
    step = step or train_step
    metrics = None
    for x, pi, z in zip(xs, pis, zs):
        params, batch_stats, opt_state, metrics = step(
            cfg, tx, params, batch_stats, opt_state, x, pi, z,
            value_loss_weight)
    return params, batch_stats, opt_state, metrics


def train_epoch_gather(cfg: NetConfig, tx: Optimizer, params, batch_stats,
                       opt_state, dev_states, dev_pis, dev_zs, idx,
                       inv_scales, value_loss_weight: float = 1.0,
                       step=None):
    """An epoch over a device-resident ring (``DeviceBufferMirror``),
    gathering each step's batch by the ``[n_batches, batch]`` index tensor
    and decoding uint8 states by one multiply by ``inv_scales``;
    counterpart of ``train_epoch_gather_fn`` (``selfplay/loop.py:98-127``).
    ``step`` as in :func:`train_epoch`."""
    step = step or train_step
    metrics = None
    for ib in idx:
        x = dev_states[ib]
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) * inv_scales
        params, batch_stats, opt_state, metrics = step(
            cfg, tx, params, batch_stats, opt_state, x, dev_pis[ib],
            dev_zs[ib].reshape(-1, 1), value_loss_weight)
    return params, batch_stats, opt_state, metrics


# ----------------------------------------------------------------------
# the host surface
# ----------------------------------------------------------------------
def _lists(tree):
    """flax's state-dict form back to the params layout: a dict keyed
    ``"0"``, ``"1"``, ... (the ``blocks`` list) becomes a list."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


class AZModel:
    """The net, its optimizer state and the host API; counterpart of the JAX
    package's ``AZModel`` (``models/model.py:73-206``).

    ``params`` and ``batch_stats`` are dicts of tensors on ``device`` by
    :class:`ResNet` ``state_dict`` name, ``opt_state`` an
    :class:`AdamState`; :func:`train_step` replaces them (new dicts) rather
    than writing into them.  The initial weights are :func:`init_params`'s
    (numpy's generator, not JAX's).  Checkpoints are AZTPU1 files that the
    JAX package reads and writes (``models/checkpoint.py``), the weights,
    statistics and Adam's moments in its pytree layout.
    """

    def __init__(self, board_size: int = 15, action_size: Optional[int] = None,
                 n_res_blocks: int = 3, channels: int = 64,
                 lr: float = DEFAULT_LR,
                 weight_decay: float = DEFAULT_WEIGHT_DECAY, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, device=None):
        self.device = resolve_device(device)
        self.board_size = board_size
        self.action_size = action_size or board_size * board_size
        self.cfg = NetConfig(board_size=board_size,
                             action_size=self.action_size,
                             n_res_blocks=n_res_blocks, channels=channels,
                             compute_dtype=compute_dtype,
                             in_channels=in_channels)
        self.lr = lr
        self.weight_decay = weight_decay
        self.tx = Optimizer(lr=lr, weight_decay=weight_decay)
        self._set_jax(*init_params(self.cfg, seed))
        self.opt_state = self.tx.init(self.params)

    # -- layouts ---------------------------------------------------------
    def _set_jax(self, params: Params, batch_stats: Params):
        sd = params_from_jax(params, batch_stats)
        self.params, self.batch_stats = split_state(
            {k: v.to(self.device) for k, v in sd.items()})

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {**self.params, **self.batch_stats}

    def jax_params(self) -> Tuple[Params, Params]:
        """``(params, batch_stats)`` as numpy arrays in the JAX layout, as
        ``make_inference`` and the folding and quantizing functions take
        them."""
        return params_to_jax(self.state_dict())

    def eval_net(self) -> ResNet:
        """An eval-mode :class:`ResNet` holding a copy of the weights: the
        float32 search bundle (``make_eval_fn``)."""
        net = ResNet(self.cfg)
        net.load_state_dict(self.state_dict())
        return net.to(self.device).eval()

    # -- prediction ------------------------------------------------------
    def predict(self, encoded_states: np.ndarray):
        """``encoded_states`` float32 ``[B, C, H, W]`` (the reference's NCHW)
        -> numpy ``(probs [B, A], values [B, 1])``."""
        x = torch.as_tensor(np.asarray(encoded_states, np.float32),
                            device=self.device).permute(0, 2, 3, 1)
        probs, values = make_eval_fn()(self.eval_net(), x)
        return probs.cpu().numpy(), values.cpu().numpy()

    def predict_batch(self, states_list: List[np.ndarray]):
        return self.predict(self.make_batch_from_states(states_list))

    # -- training --------------------------------------------------------
    def train_batch(self, states: np.ndarray, target_pis: np.ndarray,
                    target_vs: np.ndarray, epochs: int = 1
                    ) -> Dict[str, float]:
        """``epochs`` steps on one NCHW batch; the mean of their losses."""
        x = torch.as_tensor(np.asarray(states, np.float32),
                            device=self.device).permute(0, 2, 3, 1)
        pis = torch.as_tensor(np.asarray(target_pis, np.float32),
                              device=self.device)
        zs = torch.as_tensor(np.asarray(target_vs, np.float32),
                             device=self.device).reshape(-1, 1)
        totals = {"policy_loss": 0.0, "value_loss": 0.0, "total_loss": 0.0}
        for _ in range(epochs):
            (self.params, self.batch_stats, self.opt_state,
             metrics) = train_step(self.cfg, self.tx, self.params,
                                   self.batch_stats, self.opt_state, x, pis,
                                   zs)
            for k in totals:
                totals[k] += float(metrics[k])
        return {k: v / float(epochs) for k, v in totals.items()}

    # -- persistence -----------------------------------------------------
    def metadata(self) -> Dict[str, int]:
        return {"board_size": self.board_size,
                "action_size": self.action_size,
                "n_res_blocks": self.cfg.n_res_blocks,
                "channels": self.cfg.channels,
                "in_channels": self.cfg.in_channels}

    def save(self, path: str) -> None:
        """An AZTPU1 checkpoint of the weights, statistics and optimizer
        state, in the JAX package's tree (its ``opt_state`` is optax's
        chain: two empty states, Adam's, one empty state)."""
        params, stats = self.jax_params()
        adam = {"count": np.asarray(self.opt_state.count.cpu().numpy(),
                                    np.int32),
                "mu": param_tree_to_jax(self.opt_state.mu),
                "nu": param_tree_to_jax(self.opt_state.nu)}
        ckpt.save_checkpoint(path, {"params": params, "batch_stats": stats,
                                    "opt_state": ({}, {}, adam, {})},
                             self.metadata())

    def load(self, path: str, map_location=None) -> None:
        del map_location
        meta = ckpt.peek_metadata(path)
        for field, mine in (("board_size", self.board_size),
                            ("n_res_blocks", self.cfg.n_res_blocks),
                            ("channels", self.cfg.channels),
                            ("in_channels", self.cfg.in_channels)):
            theirs = meta.get(field)
            if theirs is not None and theirs != mine:
                raise ValueError(
                    f"checkpoint {field}={theirs} != model {field}={mine} "
                    f"(construct AZModel with the checkpoint's architecture, "
                    f"or use AZModel.from_checkpoint)")
        state, _ = ckpt.load_checkpoint(path)
        self._set_jax(_lists(state["params"]), _lists(state["batch_stats"]))
        adam = state["opt_state"]["2"]

        def moments(tree):
            return {k: v.to(self.device)
                    for k, v in param_tree_to_torch(_lists(tree)).items()}

        self.opt_state = AdamState(
            count=torch.as_tensor(np.asarray(adam["count"]),
                                  dtype=torch.int32, device=self.device),
            mu=moments(adam["mu"]), nu=moments(adam["nu"]))

    @classmethod
    def from_checkpoint(cls, path: str, **overrides) -> "AZModel":
        """A model sized from the checkpoint's own metadata, then loaded.

        Reference torch snapshots (``.pt``/``.pth``) are detected and
        imported one-way (``models/torch_import.py``), sized from their
        tensors; of ``overrides`` they take only ``device``, as the JAX
        package's take none."""
        from alphazero_gomoku_tpu_torch.models.torch_import import (
            _is_torch_file,
            import_torch_checkpoint,
        )
        if _is_torch_file(path):
            return import_torch_checkpoint(path,
                                           device=overrides.get("device"))
        meta = ckpt.peek_metadata(path)
        kwargs = dict(board_size=meta.get("board_size", 15),
                      n_res_blocks=meta.get("n_res_blocks", 3),
                      channels=meta.get("channels", 64),
                      in_channels=meta.get("in_channels", 3))
        kwargs.update(overrides)
        model = cls(**kwargs)
        model.load(path)
        return model

    def copy_weights_from(self, other: "AZModel",
                          include_optimizer: bool = True) -> None:
        self.params = {k: v.clone() for k, v in other.params.items()}
        self.batch_stats = {k: v.clone()
                            for k, v in other.batch_stats.items()}
        if include_optimizer:
            self.opt_state = AdamState(
                other.opt_state.count.clone(),
                {k: v.clone() for k, v in other.opt_state.mu.items()},
                {k: v.clone() for k, v in other.opt_state.nu.items()})

    @staticmethod
    def make_batch_from_states(list_of_encoded_states: List[np.ndarray]
                               ) -> np.ndarray:
        return np.stack(list_of_encoded_states, axis=0).astype(np.float32)
