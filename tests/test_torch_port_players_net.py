"""Parity: the port's AlphaZero player against the JAX package's, on real
nets: a small net saved once as an AZTPU1 file and loaded by both players
(9x9), and the shipped ``best_gomoku.ckpt`` and ``best_pente.ckpt`` (15x15,
6x128, 16 simulations).

cuDNN and XLA round the float32 forward differently within 1e-5
(``test_torch_port_search_net.py``), which can move a visit: each search's
pi may differ by at most 2 visits (half the L1 distance of the visit
counts), and the move must be equal wherever JAX's top two visit counts
differ by more than 2 (``torch_port_play.within_two_visits``).  The Gumbel
player takes the JAX player's root uniforms; its move must be equal.
"""

from pathlib import Path

import pytest

from alphazero_gomoku_tpu_torch.models import AZModel

from torch_port_play import (
    Pair,
    play_gumbel_sequence,
    play_real_net_sequence,
    players,
)
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 9


def _real_net(tmp_path, game, seed):
    path = str(tmp_path / f"{game}_{seed}.ckpt")
    AZModel(board_size=SIZE, n_res_blocks=2, channels=16, seed=seed,
            in_channels=5 if game == "pente" else 3, device="cpu").save(path)
    return path


@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_puct_player_with_a_real_net_within_two_visits(game, tmp_path):
    path = _real_net(tmp_path, game, seed=2)
    pair = Pair(*players(game, 32, model_path=path))
    play_real_net_sequence(pair, game, 32, SIZE)
    assert [k for k, _, _ in pair.tlog][:2] == ["_search_fresh",
                                                 "_search_resume"]




@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_shipped_nets_within_two_visits_at_15x15(game):
    path = str(ROOT / "checkpoints" / f"best_{game}.ckpt")
    pair = Pair(*players(game, 16, model_path=path, size=15))
    assert pair.tp.net.cfg.channels == 128
    assert pair.tp.env.obs_channels == pair.jp.env.obs_channels
    play_real_net_sequence(pair, game, 16, 15, plies=3)
    assert [k for k, _, _ in pair.tlog][:2] == ["_search_fresh",
                                                 "_search_resume"]


@pytest.mark.parametrize("parallel", [True, False])
def test_gumbel_player_with_a_real_net_moves_as_jax(parallel, tmp_path):
    path = _real_net(tmp_path, "gomoku", 4)
    jp, tp = players("gomoku", 16, model_path=path, search="gumbel",
                     gumbel_parallel=parallel)
    play_gumbel_sequence(jp, tp, parallel)
