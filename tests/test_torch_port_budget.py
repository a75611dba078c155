"""The port's device-memory preflight (``selfplay/budget.py``), the
counterparts of ``tests/test_budget.py``'s four tests, and its reckoning
held against the tensors self-play allocates.

The JAX checks read XLA's memory analysis of a compiled program; the
port's reckons the peak from the config's shapes (there is no ahead-of-time
analysis in PyTorch), so the tests give the limit explicitly (or patch the
card's) where the CPU has none.
"""

from unittest import mock

import pytest
import torch

from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models.resnet import NetConfig
from alphazero_gomoku_tpu_torch.search import MCTSConfig, init_packed_carry
from alphazero_gomoku_tpu_torch.selfplay import (
    SelfPlayConfig,
    play_games,
    play_games_continuous,
    train_alphazero,
)
from alphazero_gomoku_tpu_torch.selfplay import budget

from torch_port_util import TableEval, one_torch_thread  # noqa: F401

GIB = 1024 ** 3
SIZE = 7


def _config(batch=8, sims=6, **kw):
    env = make_env("gomoku", SIZE)
    cfg = SelfPlayConfig(batch_games=batch, max_moves=6,
                         mcts=MCTSConfig(n_simulations=sims, add_noise=False,
                                         **kw))
    net = NetConfig(board_size=SIZE, action_size=SIZE * SIZE,
                    n_res_blocks=1, channels=8)
    return env, cfg, net


def test_preflight_passes_in_budget():
    env, cfg, net = _config()
    acct = budget.preflight_memory_check(
        budget.selfplay_memory(env, cfg, net), label="test",
        limit_bytes=16 * GIB)
    assert 0 < acct["peak_bytes"] <= acct["limit_bytes"]
    assert acct["margin"] == 0.92


def test_preflight_raises_over_budget():
    env, cfg, net = _config(batch=4096, sims=400)
    reck = budget.selfplay_memory(env, cfg, net)
    assert reck["peak_bytes"] > GIB
    with pytest.raises(budget.MemoryBudgetError,
                       match="peak device memory.*tree"):
        budget.preflight_memory_check(reck, label="big", limit_bytes=GIB)
    with pytest.raises(budget.MemoryBudgetError, match="tiny-margin"):
        budget.preflight_memory_check(budget.selfplay_memory(*_config()),
                                      margin=1e-9, label="tiny-margin",
                                      limit_bytes=16 * GIB)


def test_with_preflight_wrapper_checks_then_calls():
    reck = budget.selfplay_memory(*_config())
    calls = []
    fn = calls.append
    with mock.patch.object(budget, "device_hbm_bytes",
                           return_value=reck["peak_bytes"] // 2):
        wrapped = budget.with_preflight(fn, reck, label="wrapped")
        with pytest.raises(budget.MemoryBudgetError, match="wrapped"):
            wrapped(1)
        assert calls == []          # raised before the call ran
    with mock.patch.object(budget, "device_hbm_bytes",
                           return_value=16 * GIB) as limit:
        ok = budget.with_preflight(fn, reck, label="wrapped-ok")
        ok(1)
        ok(2)
        assert calls == [1, 2] and limit.call_count == 1  # checked once


def test_device_hbm_bytes_positive():
    """On the CPU there is no limit: no check, as the JAX one degrades
    where its backend cannot report (the card's total memory is
    ``chip_smoke.py`` phase 26d's)."""
    assert budget.device_hbm_bytes("cpu") is None
    assert budget.preflight_memory_check(
        budget.selfplay_memory(*_config()), device="cpu") is None


@pytest.mark.parametrize("kind", ["lockstep", "continuous"])
def test_reckoning_counts_what_self_play_allocates(kind):
    """The tree, node-state and record terms are the bytes of the tensors
    the port allocates for them; with reuse, re-rooting holds two more
    trees."""
    env, cfg, net = _config(reuse_budget=4)
    te = TableEval(SIZE, seed=1)
    gen = torch.Generator().manual_seed(0)
    if kind == "lockstep":
        rec = play_games(env, cfg, te.torch, None, gen, "cpu")
        reck = budget.selfplay_memory(env, cfg, net)
    else:
        rec = play_games_continuous(env, cfg, te.torch, None, gen, 5, "cpu")
        reck = budget.selfplay_memory(env, cfg, net, total_steps=5)
    assert reck["record_bytes"] == sum(
        x.numel() * x.element_size() for x in rec if x is not None)
    carry = init_packed_carry(env, cfg.mcts, env.init_batch(8, "cpu"))
    nbytes = lambda x: x.numel() * x.element_size()  # noqa: E731
    assert reck["tree_bytes"] == sum(map(nbytes, (carry.packed, carry.parent,
                                                  carry.parent_action)))
    assert reck["reroot_bytes"] == 2 * nbytes(carry.packed)
    assert reck["node_state_bytes"] == sum(map(nbytes, carry.states))
    assert reck["peak_bytes"] == sum(v for k, v in reck.items()
                                     if k != "peak_bytes")


def test_train_loop_checks_before_self_play(tmp_path):
    """``train_alphazero`` runs the check before its first self-play call,
    where the JAX loop wraps its self-play program."""
    with mock.patch.object(budget, "device_hbm_bytes", return_value=1024), \
            mock.patch("alphazero_gomoku_tpu_torch.parallel.mesh."
                       "play_games") as play:
        with pytest.raises(budget.MemoryBudgetError, match="lockstep"):
            train_alphazero(board_size=SIZE, num_iterations=1,
                            games_per_iteration=2, n_simulations=4,
                            n_res_blocks=1, channels=8, verbose=False,
                            model_dir=str(tmp_path), device="cpu")
        play.assert_not_called()
