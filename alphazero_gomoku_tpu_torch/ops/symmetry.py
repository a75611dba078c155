"""Dihedral (8-fold) symmetry augmentation for square-board samples.

Counterpart of ``alphazero_gomoku_tpu/ops/symmetry.py:16-80``: for k in 0..3
rotations, emit ``(rot_k(state), rot_k(pi))`` and the horizontal flip of
each.  The numpy forms serve the host collection path
(``selfplay/runner.collect_examples``); :func:`expand_symmetries_torch` is the
form for tensors on the card (the JAX ``expand_symmetries_jax``).  States are
``[..., H, W, C]`` (NHWC), policies flat ``[H*W]``.
"""

from __future__ import annotations

import numpy as np
import torch


def expand_symmetries_np(state_hwc: np.ndarray, pi: np.ndarray):
    """The 8 dihedral variants of one sample: a list of ``(state [H, W, C],
    pi [H*W])`` pairs."""
    size = state_hwc.shape[0]
    pi_board = pi.reshape(size, size)
    out = []
    for k in range(4):
        s_rot = np.rot90(state_hwc, k, axes=(0, 1))
        p_rot = np.rot90(pi_board, k)
        out.append((np.ascontiguousarray(s_rot),
                    np.ascontiguousarray(p_rot.reshape(-1))))
        s_flip = np.flip(s_rot, axis=1)
        p_flip = np.flip(p_rot, axis=1)
        out.append((np.ascontiguousarray(s_flip),
                    np.ascontiguousarray(p_flip.reshape(-1))))
    return out


def expand_symmetries_batch_np(states: np.ndarray, pis: np.ndarray):
    """Vectorised 8-fold expansion: ``states [N, H, W, C]``, ``pis [N, H*W]``
    -> ``[8N, ...]``, variant-major."""
    size = states.shape[1]
    pib = pis.reshape(-1, size, size)
    ss, pp = [], []
    for k in range(4):
        s_rot = np.rot90(states, k, axes=(1, 2))
        p_rot = np.rot90(pib, k, axes=(1, 2))
        ss.append(s_rot)
        pp.append(p_rot)
        ss.append(np.flip(s_rot, axis=2))
        pp.append(np.flip(p_rot, axis=2))
    states8 = np.ascontiguousarray(np.concatenate(ss, axis=0))
    pis8 = np.ascontiguousarray(
        np.concatenate(pp, axis=0).reshape(-1, size * size))
    return states8, pis8


def expand_symmetries_torch(states: torch.Tensor, pis: torch.Tensor):
    """The same expansion on tensors (any device): ``[N, H, W, C]``,
    ``[N, A]`` -> ``[8N, ...]``, variant-major."""
    size = states.shape[1]
    pib = pis.reshape(-1, size, size)
    ss, pp = [], []
    for k in range(4):
        s_rot = torch.rot90(states, k, dims=(1, 2))
        p_rot = torch.rot90(pib, k, dims=(1, 2))
        ss += [s_rot, torch.flip(s_rot, dims=(2,))]
        pp += [p_rot, torch.flip(p_rot, dims=(2,))]
    return (torch.cat(ss, dim=0),
            torch.cat(pp, dim=0).reshape(-1, size * size))
