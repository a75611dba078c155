"""Batched self-play (PUCT or Gumbel; lockstep or continuous), the replay
buffer, the arena and the training loop."""

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
    ContinuousRecords,
    SelfPlayConfig,
    Trajectories,
    center_mask,
    collect_examples,
    collect_examples_continuous,
    play_games,
    play_games_continuous,
    random_center_actions,
    sample_actions,
)
