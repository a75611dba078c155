"""Parity: the port's batched Gomoku engine against the JAX engine.

Random legal games (numpy-driven, seeded) run through both engines ply by
ply; every state field, the legal mask, the encoding and the terminal value
must be equal exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.ops.lines import run_length_through as jax_run_length
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.ops.lines import run_length_through, wins_at

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SIZE = 9


def _assert_states_equal(jst, tst):
    for name, jx, tx in zip(jst._fields, jst, tst):
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_games_match_jax(seed):
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    batch = 16
    rng = np.random.default_rng(seed)
    jst = jenv.init_batch(batch)
    tst = env.init_batch(batch, device="cpu")
    j_step = jax.jit(jax.vmap(jenv.step_safe))
    j_legal = jax.jit(jax.vmap(jenv.legal_mask))
    j_encode = jax.jit(jax.vmap(jenv.encode))
    j_term = jax.jit(jax.vmap(jenv.terminal_value))
    saw_win = False
    for _ in range(SIZE * SIZE):
        _assert_states_equal(jst, tst)
        legal = np.asarray(j_legal(jst))
        np.testing.assert_array_equal(legal, env.legal_mask(tst).numpy())
        np.testing.assert_array_equal(np.asarray(j_encode(jst)),
                                      env.encode(tst).numpy())
        np.testing.assert_array_equal(np.asarray(j_term(jst)),
                                      env.terminal_value(tst).numpy())
        if legal.any(axis=1).sum() == 0:
            break
        acts = np.array([rng.choice(np.flatnonzero(row)) if row.any() else 0
                         for row in legal], dtype=np.int32)
        jst = j_step(jst, jnp.asarray(acts))
        tst = env.step_safe(tst, torch.from_numpy(acts))
        saw_win |= bool((tst.winner != 0).any())
    _assert_states_equal(jst, tst)
    assert saw_win and bool(tst.done.all())


def test_step_matches_jax_on_done_lanes_and_draws():
    """``step`` (not ``step_safe``) on arbitrary actions, and a full-board
    draw: the full board ends the game with winner 0."""
    jenv, env = JaxEnv(3), GomokuEnv(3)   # 3x3: no five fits, so draws only
    jst = jenv.init_batch(2)
    tst = env.init_batch(2, device="cpu")
    j_step = jax.jit(jax.vmap(jenv.step))
    for a in range(9):
        acts = np.array([a, 8 - a], np.int32)
        jst = j_step(jst, jnp.asarray(acts))
        tst = env.step(tst, torch.from_numpy(acts))
        _assert_states_equal(jst, tst)
    assert bool(tst.done.all()) and int(tst.winner.abs().sum()) == 0


def test_run_length_and_wins_at_match_jax():
    rng = np.random.default_rng(3)
    b = 256
    boards = rng.choice([0, 1, 2], size=(b, SIZE, SIZE),
                        p=[0.3, 0.35, 0.35]).astype(np.int8)
    r = rng.integers(0, SIZE, b).astype(np.int32)
    c = rng.integers(0, SIZE, b).astype(np.int32)
    player = rng.integers(1, 3, b).astype(np.int8)
    want = np.asarray(jax.vmap(jax_run_length)(
        jnp.asarray(boards), jnp.asarray(r), jnp.asarray(c),
        jnp.asarray(player)))
    args = (torch.from_numpy(boards), torch.from_numpy(r),
            torch.from_numpy(c), torch.from_numpy(player))
    got = run_length_through(*args)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want >= 5, wins_at(*args).numpy())
    assert (want >= 5).any() and (want < 5).any()


def test_make_env():
    env = make_env("Gomoku", 9)
    assert isinstance(env, GomokuEnv) and env.num_actions == 81
    pente = make_env("Pente", 9, capture_planes=True)
    assert (pente.name, pente.num_actions, pente.obs_channels) == \
        ("pente", 81, 5)
    assert make_env("pente", 9).obs_channels == 3
    # Gomoku ignores the flag
    assert make_env("gomoku", 9, capture_planes=True).obs_channels == 3
    with pytest.raises(ValueError):
        make_env("chess")


def test_init_batch_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GomokuEnv(SIZE).init_batch(2)
    assert GomokuEnv(SIZE).init_batch(2, device="cpu").board.device.type == "cpu"
