"""AlphaZero player, 3000-simulation variant (reference ``player_alpha.py``).

Counterpart of ``alphazero_gomoku_tpu/players/player_alpha.py``."""

from alphazero_gomoku_tpu_torch.players.alpha_base import AlphaZeroPlayer


class Player(AlphaZeroPlayer):
    def __init__(self, rules="gomoku", board_size=15, n_simulations=3000,
                 c_puct=1.0, model_path="models/best_latest.ckpt", **kw):
        super().__init__(rules, board_size, n_simulations, c_puct,
                         model_path, **kw)
