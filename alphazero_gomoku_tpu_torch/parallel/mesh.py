"""Data parallelism over ranks: sharded self-play, arena and training.

Counterpart of ``alphazero_gomoku_tpu/parallel/mesh.py``.  The JAX package
runs one controller over a 1-D ``('data',)`` mesh of chips; the port runs
one process per card (``parallel/distributed.py``), and a
:class:`DataMesh` is this rank's view of the process group: its size, its
rank, its device and the group.  A process does not drive several cards:
the kernel wrappers launch on the current device's stream, the search's
Python move loop would serialise the cards' work on one host thread, and
``torch.distributed``'s collectives are built for a rank a card.

  - **self-play and the arena** shard the game batch: each rank plays
    ``batch_games / size`` games (or lanes) with its own generator, the
    counterpart of ``jax.random.fold_in(rng, shard_idx)`` (:func:`fold_in`;
    rank 0 keeps the seed, so a world of one is the unsharded run bit for
    bit), and no rank talks to another during a search;
  - :func:`gather_trajectories` all-gathers the shards along the game axis,
    so that every rank holds the unsharded ``Trajectories`` (or
    ``ContinuousRecords``) and ``collect_examples`` runs unchanged.  A rank
    stops its move loop when all of *its* games are done, as the JAX
    ``shard_map`` of its ``while_loop`` exits per shard, so its later rows
    are zeros where an unsharded batch writes inactive rows; the samples
    collected are the same;
  - **training** shards the per-step batch: each rank trains on its slice
    with batch norm over the *global* batch (:class:`GlobalBatchNorm2d`,
    JAX's reductions over a sharded axis being global under GSPMD) and
    averages the gradients over the ranks *before* ``Optimizer.update``,
    whose global-norm clip then sees the global batch's gradient; the loss
    terms are averaged too, so that every rank's history agrees.

Collectives go through the group's backend: NCCL on the cards, gloo on the
CPU (the tests) and for ranks that share a card (NCCL refuses two ranks on
one device), where gloo takes the CUDA tensors itself and moves them
through host memory (torch 2.11: ``all_reduce``, ``all_gather`` and
``all_gather_into_tensor``, bool and int64 included).

Why only data parallelism: the net is a small CNN over a fixed board whose
weights fit one card many times over; the scaling axes are the batch of
games and of training samples (``mesh.py:16-22`` there).
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models.model import (
    apply_updates,
    loss_grads,
    train_epoch,
    train_epoch_gather,
)
from alphazero_gomoku_tpu_torch.models.resnet import NetConfig, ResNet
from alphazero_gomoku_tpu_torch.parallel.distributed import (
    is_initialized,
    rank_device,
)
from alphazero_gomoku_tpu_torch.selfplay.arena import arena_half
from alphazero_gomoku_tpu_torch.selfplay.runner import (
    SelfPlayConfig,
    play_games,
    play_games_continuous,
)

# the kernels of the sharded paths, built by rank 0 before the others load
# them (ops/_build.py)
_PATH_KERNELS = ("tree_kernels", "fused_net", "int8_tower")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A rank's view of the data-parallel group.

    ``group`` is None for a mesh of one process without a group, whose
    collectives are the identity; ``backend`` is the group's
    (``"nccl"``, ``"gloo"``) or ``"none"``.
    """

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    backend: str = "none"

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.size}, backend {self.backend}, "
                f"device {self.device}")


def make_mesh(n_devices: Optional[int] = None, device=None) -> DataMesh:
    """This rank's mesh over the process group (every rank; one member
    without a group).

    ``n_devices`` other than the world size is refused: a rank drives one
    card, so the mesh is the whole group.  ``device`` None is the device
    ``initialize_distributed`` chose, else the current card (NCCL) or the
    CPU (gloo).  On the cards, rank 0 builds the kernels of the sharded
    paths and the others wait at a barrier, so that the ranks do not all
    run the same ``nvcc``.
    """
    if not is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh(n_devices={n_devices}) without a process group: "
                f"the port runs one process per card, so call "
                f"initialize_distributed on every rank first (or launch "
                f"with torchrun)")
        return DataMesh(1, 0, resolve_device(device or rank_device()))
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, size):
        raise ValueError(
            f"make_mesh(n_devices={n_devices}) over a group of {size} "
            f"ranks: each rank drives one card, so the mesh is the whole "
            f"group (launch {n_devices} ranks instead)")
    backend = str(dist.get_backend())
    if device is None:
        device = rank_device() or (
            torch.device("cuda", torch.cuda.current_device())
            if backend == "nccl" else torch.device("cpu"))
    mesh = DataMesh(size, rank, resolve_device(device), dist.group.WORLD,
                    backend)
    if mesh.device.type == "cuda":
        from alphazero_gomoku_tpu_torch.ops import _build

        if rank == 0:
            _build.build_all(_PATH_KERNELS)
        dist.barrier(group=mesh.group)
        _build.build_all(_PATH_KERNELS)
    return mesh


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def all_reduce(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``t`` summed over the ranks, a new tensor."""
    out = t.clone()
    if mesh.group is not None:
        dist.all_reduce(out, group=mesh.group)
    return out


def all_gather(t: torch.Tensor, mesh: DataMesh, axis: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``axis``, in rank order (every
    rank's ``t`` of one shape)."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=axis)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def broadcast_from_primary(tree, mesh: DataMesh):
    """Rank 0's values of every tensor in ``tree`` (dicts, tuples and
    tensors), written in place on every rank; ``tree`` returned.  Ranks that
    each computed the same replicated step (the unsharded epoch) agree bit
    for bit afterwards, whatever the order of a card's atomics."""
    if mesh.group is not None:
        for t in _leaves(tree):
            dist.broadcast(t, src=0, group=mesh.group)
    return tree


def ranks_per_device(mesh: DataMesh) -> int:
    """How many of the group's ranks run on this rank's card (1 on the CPU
    and without a group): ranks that share a card share its memory."""
    if mesh.group is None or mesh.device.type != "cuda":
        return 1
    me = (socket.gethostname(), mesh.device.index)
    everyone = [None] * mesh.size
    dist.all_gather_object(everyone, me, group=mesh.group)
    return everyone.count(me)


def fold_in(seed: int, index: int) -> int:
    """A seed for stream ``index`` of ``seed``: the counterpart of
    ``jax.random.fold_in``.  Index 0 keeps ``seed``, so that rank 0 draws
    what the unsharded loop draws; the others hash ``(seed, index)``."""
    if index == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed) % 2 ** 64, int(index)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def local_cfg(cfg: SelfPlayConfig, mesh: DataMesh) -> SelfPlayConfig:
    if cfg.batch_games % mesh.size:
        raise ValueError(f"batch_games={cfg.batch_games} not divisible by "
                         f"mesh size {mesh.size}")
    return dataclasses.replace(cfg, batch_games=cfg.batch_games // mesh.size)


def _generator(mesh: DataMesh, seed: int) -> torch.Generator:
    return torch.Generator(device=mesh.device).manual_seed(
        fold_in(seed, mesh.rank))


# ----------------------------------------------------------------------
# self-play and the arena
# ----------------------------------------------------------------------
def make_sharded_selfplay(env, cfg: SelfPlayConfig, eval_fn,
                          mesh: DataMesh):
    """Data-parallel lockstep self-play: each rank plays
    ``batch_games / size`` games.

    Returns ``fn(net_params, seed) -> Trajectories``, this rank's shard, its
    draws from a generator seeded ``fold_in(seed, rank)``
    (:func:`gather_trajectories` assembles the batch).
    """
    shard_cfg = local_cfg(cfg, mesh)

    def fn(net_params, seed: int):
        return play_games(env, shard_cfg, eval_fn, net_params,
                          _generator(mesh, seed), mesh.device)

    return fn


def make_sharded_selfplay_continuous(env, cfg: SelfPlayConfig, eval_fn,
                                     mesh: DataMesh, total_steps: int):
    """Data-parallel continuous (auto-reset) self-play: each rank advances
    ``batch_games / size`` lanes for ``total_steps`` plies.  Returns
    ``fn(net_params, seed) -> ContinuousRecords``, this rank's lanes."""
    shard_cfg = local_cfg(cfg, mesh)

    def fn(net_params, seed: int):
        return play_games_continuous(env, shard_cfg, eval_fn, net_params,
                                     _generator(mesh, seed), total_steps,
                                     mesh.device)

    return fn


def make_sharded_arena(env, cfg, eval_fn, mesh: DataMesh):
    """Data-parallel arena: the games split over the ranks, both nets on
    every rank.

    Returns ``fn(params_p1, params_p2, n_games, seed) -> winners``: each
    rank plays ``ceil(n_games / size)`` games of ``arena_half`` with seed
    ``fold_in(seed, rank)``, and every rank gets all ranks' winners, so
    ``n_games`` is rounded up to a multiple of the mesh size (callers read
    the count played from the result's length).
    """

    def fn(params_p1, params_p2, n_games: int, seed: int):
        local = -(-n_games // mesh.size)
        winners = arena_half(env, cfg, eval_fn, params_p1, params_p2, local,
                             fold_in(seed, mesh.rank), mesh.device)
        return all_gather(winners, mesh, axis=0)

    return fn


def gather_trajectories(traj, mesh: DataMesh):
    """Every rank's shard of a ``Trajectories`` or ``ContinuousRecords``
    gathered along the game axis, on every rank: axis 0 of the per-game
    ``[B]`` records (``winners``, ``moves_played``), axis 1 of the ``[T, B,
    ...]`` ones.  Equal to the unsharded records wherever a record is
    active."""
    return type(traj)(*(
        None if x is None else all_gather(x, mesh, 0 if x.dim() == 1 else 1)
        for x in traj))


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks whose backward is the SUM of the gradients: the
    gradient of a rank's loss reaches every rank's inputs to the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh), None


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are the global
    batch's, over the mesh's ranks (eval mode is unchanged).

    The JAX ``_batch_norm`` (``models/resnet.py:142-159`` there) over a
    sharded batch: the mean, then the centred biased variance
    ``sum((x - mean)**2) / n`` (two all-reduces, each of the per-channel
    sums; the element count rides the first), normalising by ``(x - mean)
    * rsqrt(var + eps) * scale + bias``, and the running variance moved
    toward ``var * n / (n - 1)`` with ``n`` the global count.  Both sums
    are differentiable all-reduces, so the backward reduces too: the sum of
    the ranks' parameter gradients is the gradient of the sum of their
    losses.
    """

    def __init__(self, num_features: int, mesh: DataMesh, eps: float,
                 momentum: float):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.mesh = mesh

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        local = torch.cat([x.sum(dim=(0, 2, 3)),
                           x.new_full((1,), x.numel() // c)])
        total = _AllReduceSum.apply(local, self.mesh)
        n = total[c]
        mean = total[:c] / n
        d = x - mean[None, :, None, None]
        var = _AllReduceSum.apply((d * d).sum(dim=(0, 2, 3)), self.mesh) / n
        y = (d * torch.rsqrt(var + self.eps)[None, :, None, None]
             * self.weight[None, :, None, None]
             + self.bias[None, :, None, None])
        with torch.no_grad():
            m = self.momentum
            count = float(n)
            unbiased = var * (count / max(count - 1.0, 1.0))
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var
                                   + m * unbiased)
            self.num_batches_tracked.add_(1)
        return y


def global_bn_template(cfg: NetConfig, mesh: DataMesh) -> ResNet:
    """A train-mode :class:`ResNet` on the meta device whose batch norms are
    :class:`GlobalBatchNorm2d` over ``mesh``, for ``loss_grads(...,
    template=)`` (the same ``state_dict`` names)."""
    net = ResNet(cfg)
    for name, module in list(net.named_modules()):
        if isinstance(module, nn.BatchNorm2d):
            parent, _, attr = name.rpartition(".")
            owner = net.get_submodule(parent) if parent else net
            setattr(owner, attr, GlobalBatchNorm2d(
                module.num_features, mesh, module.eps, module.momentum))
    return net.to("meta").train()


def _mean_over_ranks(tensors: Dict[str, torch.Tensor], mesh: DataMesh):
    """Each tensor averaged over the ranks, by one all-reduce of their
    concatenation."""
    if mesh.group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors.values()])
    flat = all_reduce(flat, mesh) / mesh.size
    out, at = {}, 0
    for k, t in tensors.items():
        out[k] = flat[at:at + t.numel()].view_as(t)
        at += t.numel()
    return out


def _sharded_step(mesh: DataMesh, template: ResNet):
    """A ``train_step`` over the mesh: global batch norm, then the gradients
    and the loss terms averaged over the ranks, then the optimizer."""

    def step(cfg, tx, params, batch_stats, opt_state, x, target_pi,
             target_z, value_loss_weight=1.0):
        grads, stats, metrics = loss_grads(cfg, params, batch_stats, x,
                                           target_pi, target_z,
                                           value_loss_weight,
                                           template=template)
        grads = _mean_over_ranks(grads, mesh)
        metrics = _mean_over_ranks(metrics, mesh)
        updates, new_opt = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), stats, new_opt, metrics

    return step


def _shard_rows(a, mesh: DataMesh, axis: int = 1) -> torch.Tensor:
    """This rank's slice of ``a`` along ``axis`` (the per-step batch), on
    its device; the axis must divide evenly."""
    a = torch.as_tensor(a, device=mesh.device)
    n = a.shape[axis]
    if n % mesh.size:
        raise ValueError(f"batch of {n} not divisible by mesh size "
                         f"{mesh.size}")
    per = n // mesh.size
    return a.narrow(axis, mesh.rank * per, per)


def make_sharded_train_epoch(net_cfg: NetConfig, tx, mesh: DataMesh,
                             value_loss_weight: float = 1.0):
    """Gradient-data-parallel epoch over pre-sampled batches.

    Returns ``fn(params, batch_stats, opt_state, xs, pis, zs, local=False)``
    with ``[n_batches, batch, ...]`` minibatches, the same on every rank;
    each rank trains on its slice of each step's batch (axis 1).  With
    ``local=True`` the arrays are already this rank's slices
    (:func:`form_global_batches`).  Parameters and optimizer state are
    replicated: every rank ends with the same ones.
    """
    step = _sharded_step(mesh, global_bn_template(net_cfg, mesh))

    def epoch_fn(params, batch_stats, opt_state, xs, pis, zs, local=False):
        if local:
            xs, pis, zs = (torch.as_tensor(a, device=mesh.device)
                           for a in (xs, pis, zs))
        else:
            xs, pis, zs = (_shard_rows(a, mesh) for a in (xs, pis, zs))
        return train_epoch(net_cfg, tx, params, batch_stats, opt_state, xs,
                           pis, zs, value_loss_weight, step=step)

    return epoch_fn


def make_sharded_gather_epoch(net_cfg: NetConfig, tx, mesh: DataMesh,
                              value_loss_weight: float = 1.0):
    """Gradient-data-parallel epoch over a device-resident ring.

    The mesh form of ``train_epoch_gather``: every rank mirrors the same
    ring on its own card (``DeviceBufferMirror``) and gathers its slice of
    each step's ``[n_batches, batch]`` index rows.  Returns ``fn(params,
    batch_stats, opt_state, states, pis, zs, idx, inv_scales)``.
    """
    step = _sharded_step(mesh, global_bn_template(net_cfg, mesh))

    def epoch_fn(params, batch_stats, opt_state, dev_states, dev_pis, dev_zs,
                 idx, inv_scales):
        return train_epoch_gather(net_cfg, tx, params, batch_stats,
                                  opt_state, dev_states, dev_pis, dev_zs,
                                  _shard_rows(idx, mesh), inv_scales,
                                  value_loss_weight, step=step)

    return epoch_fn


# ----------------------------------------------------------------------
# per-host sharded replay
# ----------------------------------------------------------------------
def local_trajectory_shards(traj):
    """This rank's games of a sharded self-play result: the result itself.

    In the JAX package a sharded array spans hosts and this extracts the
    process's addressable shards; here each rank's self-play result is
    already its own shard (``replay_sharding="per_host"``: each rank keeps
    only its games, with no trajectory all-gather).
    """
    return traj


class GlobalBatches(NamedTuple):
    """This rank's slices of a global ``[n_batches, batch, ...]`` batch."""

    xs: torch.Tensor
    pis: torch.Tensor
    zs: torch.Tensor


def form_global_batches(mesh: DataMesh, xs, pis, zs) -> GlobalBatches:
    """The per-host replay path's train input: each rank's locally sampled
    ``[n_batches, batch / size, ...]`` arrays are its slices of the global
    batch, on its device, for ``make_sharded_train_epoch``'s
    ``local=True`` (the JAX package assembles a global array sharded on the
    batch axis; a rank here holds only its slice, so nothing moves)."""
    return GlobalBatches(*(torch.as_tensor(np.asarray(a), device=mesh.device)
                           for a in (xs, pis, zs)))


def _reduce_len(local_len: int, op) -> int:
    if not is_initialized() or dist.get_world_size() == 1:
        return local_len
    dev = (torch.device("cuda", torch.cuda.current_device())
           if str(dist.get_backend()) == "nccl" else torch.device("cpu"))
    t = torch.tensor([local_len], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=op)
    return int(t.item())


def global_buffer_len(local_len: int) -> int:
    """Sum of every rank's local replay-buffer length, the same on every
    rank: the train gate and steps per epoch issue collectives, and ranks
    that disagreed on them would deadlock the sharded epoch."""
    return _reduce_len(local_len, dist.ReduceOp.SUM)


def min_local_buffer_len(local_len: int) -> int:
    """Minimum of every rank's local replay-buffer length: a rank whose
    shard is empty cannot draw its share of the global batch, and the gate
    must agree on every rank."""
    return _reduce_len(local_len, dist.ReduceOp.MIN)
