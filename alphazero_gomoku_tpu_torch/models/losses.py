"""Training losses.

Counterpart of ``alphazero_gomoku_tpu/models/losses.py:18-39``:
  - policy: ``KL(target || softmax(logits))``, batch-mean, with the
    ``0 * log 0 := 0`` convention;
  - value: MSE between the tanh value ``[B, 1]`` and the outcome z;
  - total = policy + ``value_loss_weight`` * value.
"""

from __future__ import annotations

import torch


def policy_kl(logits: torch.Tensor, target_pi: torch.Tensor) -> torch.Tensor:
    """KL(target || softmax(logits)), batch-mean; target may contain zeros."""
    logp = torch.log_softmax(logits, dim=-1)
    safe_t = torch.where(target_pi > 0, target_pi, 1.0)
    tlogt = torch.where(target_pi > 0, target_pi * torch.log(safe_t), 0.0)
    return torch.mean(torch.sum(tlogt - target_pi * logp, dim=-1))


def value_mse(value: torch.Tensor, target_z: torch.Tensor) -> torch.Tensor:
    return torch.mean((value - target_z) ** 2)


def alphazero_loss(logits, value, target_pi, target_z,
                   value_loss_weight: float = 1.0):
    """``(total, {"policy_loss", "value_loss", "total_loss"})``."""
    pl = policy_kl(logits, target_pi)
    vl = value_mse(value, target_z)
    total = pl + value_loss_weight * vl
    return total, {"policy_loss": pl, "value_loss": vl, "total_loss": total}
