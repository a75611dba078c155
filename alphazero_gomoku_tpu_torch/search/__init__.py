"""PUCT search on the packed node-tile tree."""

from alphazero_gomoku_tpu_torch.search.tree import (  # noqa: F401
    MCTSConfig,
    run_mcts_with_q,
)
