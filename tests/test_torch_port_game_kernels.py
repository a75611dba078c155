"""The game kernels' wrappers on the CPU (``ops/game_kernels.py``).

A CPU tensor takes the env's plain methods and launches nothing; a tensor on
a device that is neither the CPU nor CUDA raises rather than falling back;
the module imports, and the CPU path runs, where there is no ``nvcc``.  The
kernels themselves are held against the plain methods on the card
(``tests/test_torch_port_cuda.py``).
"""

import importlib

import pytest
import torch

from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops import game_kernels as gk
from alphazero_gomoku_tpu_torch.parallel import mesh

GAMES = [("gomoku", False), ("pente", False), ("pente", True)]
GAME_IDS = ["gomoku", "pente3", "pente5"]
METHODS = ("step", "step_safe", "encode", "legal_mask", "terminal_value")


def _play(env, batch, plies, seed):
    """Random legal plies from empty boards on the CPU, and the next
    plies' actions."""
    g = torch.Generator().manual_seed(seed)
    states = env.init_batch(batch, "cpu")
    for _ in range(plies):
        legal = env.legal_mask_plain(states)
        u = torch.rand(legal.shape, generator=g)
        states = env.step_safe_plain(
            states, torch.argmax(torch.where(legal, u, -1.0), dim=1))
    legal = env.legal_mask_plain(states)
    u = torch.rand(legal.shape, generator=g)
    return states, torch.argmax(torch.where(legal, u, -1.0), dim=1)


def _equal(got, want):
    if isinstance(want, tuple):
        return type(got) is type(want) and all(
            _equal(g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("game,planes5", GAMES, ids=GAME_IDS)
def test_cpu_calls_take_the_plain_methods_and_launch_nothing(game, planes5):
    env = make_env(game, 9, capture_planes=planes5)
    gk.reset_launch_counts()
    for plies in (0, 12, 40):
        states, action = _play(env, 16, plies, plies)
        for name in METHODS:
            args = (action,) if name.startswith("step") else ()
            got = getattr(env, name)(states, *args)
            want = getattr(env, name + "_plain")(states, *args)
            assert _equal(got, want), name
    assert gk.launch_counts() == dict.fromkeys(
        ("game_step", "game_encode", "game_legal_mask",
         "game_terminal_value"), 0)
    assert "game_step" not in _build._LOADED


@pytest.mark.parametrize("name", METHODS)
@pytest.mark.parametrize("game,planes5", GAMES, ids=GAME_IDS)
def test_meta_tensors_raise_rather_than_fall_back(game, planes5, name):
    env = make_env(game, 9, capture_planes=planes5)
    states, action = _play(env, 4, 3, 0)
    meta = type(states)(*(x.to("meta") for x in states))
    args = (action.to("meta"),) if name.startswith("step") else ()
    with pytest.raises(ValueError, match="unsupported device meta"):
        getattr(env, name)(meta, *args)
    assert sum(gk.launch_counts().values()) == 0
    assert "game_step" not in _build._LOADED


def test_module_imports_and_cpu_path_runs_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    importlib.reload(gk)
    env = make_env("pente", 7, capture_planes=True)
    states, action = _play(env, 4, 6, 1)
    assert env.step(states, action).board.shape == (4, 7, 7)
    assert env.encode(states).shape == (4, 7, 7, 5)
    assert "game_step" not in _build._LOADED


def test_game_step_builds_with_the_others_and_without_fast_math():
    """The source is one file with no quoted headers; no flag relaxes its
    one float division (the capture planes' k / pairs_to_win); every rank
    of a mesh builds it before the first move."""
    assert _build.sources("game_step") == [_build.CSRC_DIR / "game_step.cu"]
    flags = " ".join(_build._flags("game_step"))
    for relaxed in ("fast_math", "fast-math", "prec-div=false",
                    "ftz=true"):
        assert relaxed not in flags
    assert "game_step" in mesh._PATH_KERNELS
    assert 22 * 22 <= gk.MAX_CELLS < 23 * 23


def test_capture_planes_on_the_cpu_are_the_quotients():
    """``encode_plain``'s tensor divisor gives the CPU the same planes as
    dividing by the Python number did: k / 5 rounded once, for k = 0..12."""
    env = make_env("pente", 7, capture_planes=True)
    k = torch.arange(13, dtype=torch.int32)
    states = env.init_batch(13, "cpu")._replace(
        captures=torch.stack([k, 12 - k], dim=1))
    obs = env.encode_plain(states)
    assert torch.equal(obs[:, 0, 0, 3], k.float() / 5.0)
    assert torch.equal(obs[:, 0, 0, 4], (12 - k).float() / 5.0)
