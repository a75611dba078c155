"""Parity: the port's pure-MCTS baseline and its C scans against the JAX
package's.

The port keeps its own copy of ``search/pure_mcts.py`` and ``native/``
(host NumPy and C; it may import nothing of the JAX package).  On random
boards the scans (``threat_scores``, ``capture_potential``,
``capture_count_all``, ``winning_cells``) must equal the JAX package's
exactly, on the native path and on the NumPy path (``AZG_NO_NATIVE=1``,
which both packages read at each call); the port's native path must equal
its own NumPy path (as ``tests/test_native.py`` holds the JAX package's);
and ``MCTSGomoku`` / ``MCTSPente`` given the same seeded ``random.Random``
must pick the same moves as the JAX package's.
"""

import random

import numpy as np
import pytest

from alphazero_gomoku_tpu.native import load_puremcts as jax_load_puremcts
from alphazero_gomoku_tpu.search import pure_mcts as jpm
from alphazero_gomoku_tpu_torch.games.host import Gomoku, Pente
from alphazero_gomoku_tpu_torch.native import load_puremcts
from alphazero_gomoku_tpu_torch.players import load_player
from alphazero_gomoku_tpu_torch.search import pure_mcts as pm


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Runs a test on the native scans, then on the NumPy ones."""
    if request.param == "numpy":
        monkeypatch.setenv("AZG_NO_NATIVE", "1")
        assert load_puremcts() is None and jax_load_puremcts() is None
    else:
        monkeypatch.delenv("AZG_NO_NATIVE", raising=False)
        assert load_puremcts() is not None, "the C scans did not build"
    return request.param


def random_boards(sizes=(9, 15), trials=6, seed=0):
    rng = np.random.default_rng(seed)
    for size in sizes:
        for t in range(trials):
            density = rng.uniform(0.05, 0.6)
            board = rng.choice(
                np.int8([0, 1, 2]), size=(size, size),
                p=[1 - density, density / 2, density / 2]).astype(np.int8)
            yield size, t, board


class _State:
    """A board (and, for Pente, captured pairs): the scans' protocol."""

    def __init__(self, board, captures=None):
        self.board = board
        self.size = board.shape[0]
        if captures is not None:
            self.captures = captures


def test_the_native_scans_build_into_the_port_package():
    lib = load_puremcts()
    assert lib is not None
    assert "alphazero_gomoku_tpu_torch/build/libpuremcts-" in lib._name


@pytest.mark.parametrize("table", ["gomoku", "pente"])
def test_threat_scores_equal_jax(path, table):
    for size, t, board in random_boards():
        for player in (1, 2):
            got = pm.threat_scores(board, player, table)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(
                got, jpm.threat_scores(board, player, table),
                err_msg=f"{path} size={size} trial={t} P{player}")


def test_capture_scans_equal_jax(path):
    for size, t, board in random_boards(seed=1):
        for player in (1, 2):
            for fn in ("capture_potential", "capture_count_all"):
                np.testing.assert_array_equal(
                    getattr(pm, fn)(board, player),
                    getattr(jpm, fn)(board, player),
                    err_msg=f"{fn} {path} size={size} trial={t} P{player}")


@pytest.mark.parametrize("caps", [None, 0, 3, 4, 5])
def test_winning_cells_equal_jax(path, caps):
    for size, t, board in random_boards(trials=4, seed=2 + (caps or 0)):
        for player in (1, 2):
            captures = None if caps is None else {1: caps, 2: caps}
            got = pm.winning_cells(_State(board, captures), player)
            assert got.dtype == bool
            np.testing.assert_array_equal(
                got, jpm.winning_cells(_State(board, captures), player),
                err_msg=f"{path} caps={caps} size={size} trial={t} "
                        f"P{player}")


def test_native_scans_equal_the_numpy_path():
    assert load_puremcts() is not None
    for size, t, board in random_boards(seed=3):
        for player in (1, 2):
            for table in ("gomoku", "pente"):
                np.testing.assert_array_equal(
                    pm.threat_scores(board, player, table),
                    pm._threat_scores_np(board, player, table))
            np.testing.assert_array_equal(
                pm.capture_potential(board, player),
                pm._capture_potential_np(board, player))
            np.testing.assert_array_equal(
                pm.capture_count_all(board, player),
                pm._capture_count_all_np(board, player))


def test_policy_native_equals_numpy(monkeypatch):
    for game_cls, table in ((Gomoku, "gomoku"), (Pente, "pente")):
        g = game_cls(9)
        rng = np.random.default_rng(7)
        for _ in range(12):
            legal = np.nonzero(g.get_valid_moves())[0]
            g.do_move(divmod(int(rng.choice(legal)), 9))
            if g.is_game_over():
                break
        bot = pm.PureMCTS(n_playout=1, table=table)
        moves_nat, probs_nat = bot._policy(g)
        with monkeypatch.context() as m:
            m.setattr(pm, "load_puremcts", lambda: None)
            moves_np, probs_np = bot._policy(g)
        assert moves_nat == moves_np
        np.testing.assert_allclose(probs_nat, probs_np, rtol=1e-6)


def _random_game(game_cls, size, plies, seed):
    g = game_cls(size)
    rng = np.random.default_rng(seed)
    for _ in range(plies):
        legal = np.nonzero(g.get_valid_moves())[0]
        g.do_move(divmod(int(rng.choice(legal)), size))
        if g.is_game_over():
            break
    return g


@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_get_move_equals_jax_under_the_same_seed(path, game):
    from alphazero_gomoku_tpu.games import host as jhost

    for seed in range(4):
        g = _random_game(Pente if game == "pente" else Gomoku, 9,
                         6 + 3 * seed, seed)
        if g.is_game_over():
            continue
        jg = getattr(jhost, type(g).__name__)(9)
        jg.board, jg.current_player = g.board.copy(), g.current_player
        jg.last_move = g.last_move
        if game == "pente":
            jg.captures = dict(g.captures)
        cls, jcls = ((pm.MCTSPente, jpm.MCTSPente) if game == "pente"
                     else (pm.MCTSGomoku, jpm.MCTSGomoku))
        got = cls(n_playout=30, rng=random.Random(seed)).get_move(g)
        want = jcls(n_playout=30, rng=random.Random(seed)).get_move(jg)
        assert got == want, (game, seed)


def test_pure_mcts_takes_win_and_blocks():
    g = Gomoku(9)
    for k in range(4):
        g.do_move((4, k))
        g.do_move((8, k if k < 3 else 5))
    assert pm.MCTSGomoku(n_playout=25).get_move(g) == (4, 4)
    g2 = Gomoku(9)
    g2.do_move((0, 0))
    for k in range(3):
        g2.do_move((4, 2 + k))
        g2.do_move((1, k))
    g2.do_move((4, 5))  # P2 four at (4,2..5); P1 must block
    assert pm.MCTSGomoku(n_playout=25).get_move(g2) in [(4, 1), (4, 6)]


def test_pure_mcts_never_expands_a_finished_game():
    g = Gomoku(9)
    for k in range(4):
        g.do_move((4, k))
        g.do_move((8, k if k < 3 else 5))
    g.do_move((4, 4))  # P1 wins
    assert g.is_game_over()
    root = pm._PureNode(state=g.clone())
    pm.MCTSGomoku(n_playout=5)._playout(root)
    assert root.children == {}


def test_winning_cells_matches_the_clone_scan():
    rng = np.random.default_rng(3)
    for game_cls in (Gomoku, Pente):
        for trial in range(6):
            g = _random_game(game_cls, 9, int(rng.integers(4, 30)), trial)
            if g.is_game_over():
                continue
            for player in (1, 2):
                want = np.zeros((9, 9), bool)
                for mv in g.get_legal_moves():
                    probe = g.clone()
                    probe.current_player = player
                    probe.do_move(mv)
                    if probe.check_winner() == player:
                        want[mv] = True
                np.testing.assert_array_equal(
                    pm.winning_cells(g, player), want,
                    err_msg=f"{game_cls.__name__} trial {trial} P{player}")


def test_player_mcts_plugin_honours_captures():
    player = load_player("player_mcts", "gomoku", 9)
    g = Gomoku(9)
    g.do_move((4, 4))
    mv = player.play(g.clone(), 1, g.last_move)
    assert mv is not None and g.board[mv] == 0
    assert player.play(g.board.tolist(), 1, (4, 4)) is not None
    p = Pente(9)
    for m in [(4, 5), (4, 4), (4, 6), (4, 7)]:
        p.do_move(m)  # P2's (4,7) captures (4,5),(4,6)
    assert p.captures[2] == 1 and p.current_player == 1
    pente = load_player("player_mcts", "pente", 9)
    mv = pente.play(p.clone(), 5, p.last_move)
    assert mv is not None and p.board[mv] == 0
