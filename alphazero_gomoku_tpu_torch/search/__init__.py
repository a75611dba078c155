"""PUCT and Gumbel search on the packed node-tile tree."""

from alphazero_gomoku_tpu_torch.search.gumbel import (  # noqa: F401
    halving_schedule,
)
from alphazero_gomoku_tpu_torch.search.tree import MCTSConfig  # noqa: F401
from alphazero_gomoku_tpu_torch.search.tree_packed import (  # noqa: F401
    PackedCarry,
    SearchResult,
    init_packed_carry,
    packed_advance_root,
    packed_carry_from_numpy,
    run_mcts_with_q,
    run_search,
)
