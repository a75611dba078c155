"""Lockstep batched self-play (PUCT or Gumbel)."""

from alphazero_gomoku_tpu_torch.selfplay.runner import (  # noqa: F401
    SelfPlayConfig,
    Trajectories,
    play_games,
    sample_actions,
)
