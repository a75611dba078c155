"""PUCT and Gumbel search on the packed node-tile tree."""

from alphazero_gomoku_tpu_torch.search.gumbel import (  # noqa: F401
    halving_schedule,
    run_gumbel_mcts,
)
from alphazero_gomoku_tpu_torch.search.tree import (  # noqa: F401
    MCTSConfig,
    run_mcts_with_q,
)
from alphazero_gomoku_tpu_torch.search.tree_packed import (  # noqa: F401
    PackedCarry,
    init_packed_carry,
    packed_advance_root,
    packed_carry_from_numpy,
)
