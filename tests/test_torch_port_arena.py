"""The port's arena (``selfplay/arena.py``) and gate
(``selfplay/loop.gate_decision``), as ``tests/test_train_loop.py:22-119``
holds the JAX package's: seats and scoring, seat fairness, the Wilson
interval, mirrored openings and their pair tally, determinism; and the
Wilson interval and gate against the JAX functions themselves.

The arena's games draw from a torch generator, not from JAX's keys, so
whole games are compared by their properties, not move by move (the search
under them is held against JAX in ``tests/test_torch_port_search.py`` and
the files after it).
"""

import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu.selfplay import arena as jarena
from alphazero_gomoku_tpu.selfplay import loop as jloop
from alphazero_gomoku_tpu_torch.games import GomokuEnv
from alphazero_gomoku_tpu_torch.models import make_eval_fn
from alphazero_gomoku_tpu_torch.models.model import AZModel
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import (
    evaluate_params,
    evaluate_params_detailed,
    gate_decision,
    wilson_ci,
)
from alphazero_gomoku_tpu_torch.selfplay.arena import arena_half

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SIZE = 7


def _net(seed):
    return AZModel(board_size=SIZE, n_res_blocks=1, channels=8, seed=seed,
                   device="cpu").eval_net()


def test_arena_seats_and_scoring():
    env = GomokuEnv(SIZE)
    cfg = MCTSConfig(n_simulations=8, cpuct=1.0, add_noise=False)
    wins, rate, draws = evaluate_params(env, cfg, make_eval_fn(), _net(1),
                                        _net(2), 4, 0, device="cpu")
    assert 0 <= wins <= 4 and 0 <= draws <= 4 - wins
    assert rate == wins / 4.0
    wins2, _, draws2 = evaluate_params(env, cfg, make_eval_fn(), _net(1),
                                       _net(1), 4, 1, device="cpu")
    assert wins2 + draws2 <= 4


def test_arena_self_match_is_seat_fair():
    env = GomokuEnv(SIZE)
    net = _net(3)
    cfg = MCTSConfig(n_simulations=16, cpuct=1.0, add_noise=False)
    wins, _, draws = evaluate_params(env, cfg, make_eval_fn(), net, net, 32,
                                     7, device="cpu")
    decided = 32 - draws
    assert decided >= 8
    assert 0.25 <= wins / max(decided, 1) <= 0.75


@pytest.mark.parametrize("wins,n", [(0, 0), (8, 16), (0, 16), (16, 16),
                                    (3, 7), (40, 64)])
def test_wilson_ci_equals_jaxs(wins, n):
    assert wilson_ci(wins, n) == jarena.wilson_ci(wins, n)


def test_wilson_ci_math():
    lo, hi = wilson_ci(8, 16)
    assert abs(lo - 0.28) < 0.005 and abs(hi - 0.72) < 0.005
    lo0, hi0 = wilson_ci(0, 16)
    lo1, hi1 = wilson_ci(16, 16)
    assert lo0 == 0.0 and hi0 < 0.35 and lo1 > 0.65 and hi1 == 1.0


@pytest.mark.parametrize("stat", ["ci_low", "win_rate"])
@pytest.mark.parametrize("rate,ci", [(0.7, (0.56, 0.82)), (0.6, (0.4, 0.78)),
                                     (0.3, (0.1, 0.52)), (0.55, (0.55, 0.7))])
@pytest.mark.parametrize("run", [True, False])
def test_gate_decision_equals_jaxs(stat, rate, ci, run):
    assert gate_decision(stat, rate, ci, 0.55, run) == \
        jloop.gate_decision(stat, rate, ci, 0.55, run)
    with pytest.raises(ValueError):
        gate_decision("mean", rate, ci, 0.55)


def test_arena_mirrored_openings_and_pair_stats():
    env = GomokuEnv(SIZE)
    net = _net(4)
    cfg = MCTSConfig(n_simulations=4, cpuct=1.0, add_noise=False)
    calls = []

    def fake_half(p1, p2, n, seed):
        calls.append(seed)
        return torch.where(torch.arange(n) % 2 == 0, 1, 2).to(torch.int32)

    r = evaluate_params_detailed(env, cfg, make_eval_fn(), net, net, 8, 11,
                                 arena_half_fn=fake_half, device="cpu")
    assert calls == [11, 11]                 # mirrored openings
    assert r["wins"] == 4 and r["played"] == 8 and r["win_rate"] == 0.5
    assert r["pairs"] == {"win_both": 0, "split": 4, "loss_both": 0, "n": 4}
    lo, hi = r["ci95"]
    assert lo < 0.5 < hi


def test_arena_real_pairing_is_deterministic():
    env = GomokuEnv(SIZE)
    net = _net(5)
    cfg = MCTSConfig(n_simulations=8, cpuct=1.0, add_noise=False)
    w_a = arena_half(env, cfg, make_eval_fn(), net, net, 6, 13, "cpu")
    w_b = arena_half(env, cfg, make_eval_fn(), net, net, 6, 13, "cpu")
    assert torch.equal(w_a, w_b)
    assert w_a.dtype == torch.int32 and set(w_a.tolist()) <= {0, 1, 2}


@pytest.mark.parametrize("size", [7, 9, 15])
def test_arena_openings_are_in_the_centre(size):
    """Every game opens with one stone of player 1 in the centre 9x9, or
    anywhere on a smaller board (the JAX arena draws off a board below 9x9:
    ROADMAP Queue C, P5); a Gumbel arena plays too."""
    env = GomokuEnv(size)
    net = AZModel(board_size=size, n_res_blocks=1, channels=8,
                  device="cpu").eval_net()
    cfg = MCTSConfig(n_simulations=4, add_noise=False, search="gumbel",
                     gumbel_max_considered=4)
    seen = []

    def step(states, action):
        seen.append(action.clone())
        return GomokuEnv.step(env, states, action)

    object.__setattr__(env, "step", step)       # the opening is one step()
    w = arena_half(env, cfg, make_eval_fn(), net, net, 16, 0, "cpu")
    assert w.shape == (16,)
    r, c = seen[0] // size, seen[0] % size
    lo, hi = max(0, size // 2 - 4), min(size, size // 2 + 5)
    assert bool(((r >= lo) & (r < hi) & (c >= lo) & (c < hi)).all())


def test_arena_refuses_nets_reading_different_planes():
    env = GomokuEnv(SIZE)
    a = AZModel(board_size=SIZE, n_res_blocks=1, channels=8, device="cpu")
    b = AZModel(board_size=SIZE, n_res_blocks=1, channels=8, in_channels=5,
                device="cpu")
    cfg = MCTSConfig(n_simulations=4, add_noise=False)
    with pytest.raises(ValueError, match="in_channels 3 and 5"):
        evaluate_params_detailed(env, cfg, make_eval_fn(), None, None, 2, 0,
                                 device="cpu", net_cfgs=(a.cfg, b.cfg))
    np.testing.assert_equal(wilson_ci(1, 2), jarena.wilson_ci(1, 2))
