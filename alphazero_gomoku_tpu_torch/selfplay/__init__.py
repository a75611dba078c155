"""Lockstep batched self-play (PUCT or Gumbel)."""

from alphazero_gomoku_tpu_torch.selfplay.runner import (  # noqa: F401
    SelfPlayConfig,
    Trajectories,
    center_mask,
    play_games,
    random_center_actions,
    sample_actions,
)
