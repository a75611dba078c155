"""Default AlphaZero player (reference ``players/player.py``: 3000 sims).

Counterpart of ``alphazero_gomoku_tpu/players/player.py``."""

from alphazero_gomoku_tpu_torch.players.alpha_base import AlphaZeroPlayer


class Player(AlphaZeroPlayer):
    def __init__(self, rules="gomoku", board_size=15, n_simulations=3000,
                 c_puct=1.0, model_path="models/best_latest.ckpt", **kw):
        super().__init__(rules, board_size, n_simulations, c_puct,
                         model_path, **kw)
