"""Lockstep batched self-play (PUCT or Gumbel), the replay buffer, the arena
and the training loop."""

from alphazero_gomoku_tpu_torch.selfplay.arena import (  # noqa: F401
    evaluate_params,
    evaluate_params_detailed,
    wilson_ci,
)
from alphazero_gomoku_tpu_torch.selfplay.loop import (  # noqa: F401
    gate_decision,
    train_alphazero,
)
from alphazero_gomoku_tpu_torch.selfplay.runner import (  # noqa: F401
    SelfPlayConfig,
    Trajectories,
    center_mask,
    collect_examples,
    play_games,
    random_center_actions,
    sample_actions,
)
