"""Parity: the port's AlphaZero player against the JAX package's.

Both players are handed the same positions (boards, and captured pairs in
Pente) and asked for a move.  The JAX player searches a batch of one on its
XLA array tree, the port's on the packed search (the JAX package holds the
two bit-identical, reuse included).  Each search's pi is recorded by
wrapping the players' search methods.

  - With ``TableEval`` in both (bit-exact priors and values), pi must be
    equal bit for bit, and so must the move, across a fresh search, resumes
    through the opponent's reply, an ambiguous board diff that starts
    afresh, a guard block onto an edge the carried tree never expanded (so
    ``packed_advance_root`` starts afresh), a guard win, a Pente reply that
    captures the player's pair, and a finished game (``None``).
  - With a real net (one AZTPU1 file loaded by both players), cuDNN and XLA
    round the float32 forward differently within 1e-5, which can move a
    visit: pi may differ by at most 2 visits per search (half the L1
    distance of the visit counts), and the move must be equal wherever
    JAX's top two visit counts differ by more than 2.
  - The Gumbel player's root uniforms are the JAX player's draw
    (``jax.random.uniform(PRNGKey(turn_number), ...)``), injected; the move
    must be equal, and pi (the improved policy, summed in another order in
    each framework) within 1e-5, as in ``test_torch_port_gumbel.py``.
"""

import subprocess
import sys
from pathlib import Path
import numpy as np
import pytest
import torch

import alphazero_gomoku_tpu.players.alpha_base as jab
import alphazero_gomoku_tpu_torch.players.alpha_base as tab
from alphazero_gomoku_tpu.games.host import Pente as JaxHostPente
from alphazero_gomoku_tpu_torch.games.host import Pente
from alphazero_gomoku_tpu_torch.models import AZModel
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.players import load_player

from torch_port_play import Pair, Pos, play_gumbel_sequence, players
from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    one_torch_thread,
)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 9
A = SIZE * SIZE


def _exact(pair, pos, turn, want_kinds):
    mj, mt, kinds, pis = pair.play(pos, turn)
    assert kinds == want_kinds
    for j, t in pis:
        np.testing.assert_array_equal(t, j)
    assert mt == mj
    return mt


def _empty_row(board, rows, cols):
    for r in rows:
        if all(board[r, c] == 0 for c in cols):
            return r
    raise AssertionError("no empty row")


def _root_child(player, carry, action):
    """The carried root's child link on ``action`` (-1: unexpanded)."""
    layout = tk.packed_layout(A, player.cfg.node_capacity)
    return int(tk.node_tiles(carry.packed, layout)[0, 0, tk.SL_C, action])


@pytest.mark.parametrize("sims", [8, 16])
def test_puct_player_equals_jax_through_reuse_and_guards(sims):
    table = TableEval(SIZE, seed=3)
    pair = Pair(*players("gomoku", sims, table))
    b = np.zeros((SIZE, SIZE), np.int8)
    b[4, 4] = 1
    b[_exact(pair, Pos(b), 1, ["_search_fresh"])] = 2
    # scattered: no four P1 stones on one line
    replies = [(3, 6), (5, 2), (6, 7), (2, 5), (7, 4), (1, 3), (6, 1)]
    turn = 3
    for _ in range(2):          # resumes through a single reply
        b[next(m for m in replies if b[m] == 0)] = 1
        b[_exact(pair, Pos(b), turn, ["_search_resume"])] = 2
        turn += 2
    # an ambiguous diff (six P1 stones at once, threes on two edge rows):
    # a fresh search
    rows = []
    for _ in range(2):
        r = _empty_row(b, [0, 8, 1, 7], range(5))
        b[r, :3] = 1
        rows.append(r)
    b[next(m for m in replies if b[m] == 0)] = 1
    b[_exact(pair, Pos(b), turn, ["_search_fresh"])] = 2
    turn += 2
    # P1 makes a four with one reply: the carried tree resumes, and the
    # guard blocks at the row's open end without a search
    r = next(r for r in rows if b[r, 3] == 0 and b[r, 4] == 0)
    b[r, 3] = 1
    n_adv = len(pair.advances)
    assert _exact(pair, Pos(b), turn, []) == (r, 4)
    b[r, 4] = 2
    turn += 2
    # the reply and the guard's move were both advanced; the guard's edge
    # was never expanded in the 1-visit-per-sim tree of a fresh root...
    (_, reply), (carry, guard) = pair.advances[n_adv:]
    assert guard == r * SIZE + 4
    if _root_child(pair.tp, carry, guard) < 0:
        # an unexpanded edge: the carried root is the stepped position,
        # with no statistics
        assert float(pair.tp._carry.packed[0, tk.SL_N, :A].sum()) == 0
    # the next reply resumes from that root (again a fresh lane inside
    # packed_advance_root when the edge is unexpanded)
    b[next(m for m in replies if b[m] == 0)] = 1
    _exact(pair, Pos(b), turn, ["_search_resume"])


def test_puct_player_without_reuse_equals_jax():
    pair = Pair(*players("gomoku", 16, TableEval(SIZE, seed=8),
                         tree_reuse=False))
    assert pair.tp.cfg.reuse_budget == 0 and pair.tp._carry is None
    b = np.zeros((SIZE, SIZE), np.int8)
    for turn, reply in ((1, (4, 4)), (3, (3, 6)), (5, (5, 2))):
        b[reply if b[reply] == 0 else (8, turn)] = 1
        b[_exact(pair, Pos(b), turn, ["_search"])] = 2


def test_guard_block_onto_an_unexpanded_edge_starts_afresh():
    """The same sequence at 4 simulations, where the guard's cell is
    certainly off the carried root's few expanded edges."""
    table = TableEval(SIZE, seed=5)
    pair = Pair(*players("gomoku", 4, table))
    b = np.zeros((SIZE, SIZE), np.int8)
    b[0, :3] = 1
    b[4, 4] = 1
    b[_exact(pair, Pos(b), 1, ["_search_fresh"])] = 2
    assert b[0, 3] == 0 and b[0, 4] == 0
    b[0, 3] = 1
    n_adv = len(pair.advances)
    assert _exact(pair, Pos(b), 3, []) == (0, 4)
    (carry, guard) = pair.advances[n_adv + 1]
    assert guard == 4 and _root_child(pair.tp, carry, guard) < 0
    assert float(pair.tp._carry.packed[0, tk.SL_N, :A].sum()) == 0
    b[0, 4] = 2
    b[8, 8] = 1
    _exact(pair, Pos(b), 5, ["_search_resume"])


def test_guard_win_and_finished_game():
    table = TableEval(SIZE, seed=4)
    pair = Pair(*players("gomoku", 8, table))
    b = np.zeros((SIZE, SIZE), np.int8)
    b[2, 1:5] = 2          # the player (P2, to move) wins at (2, 0) or (2, 5)
    b[6, 0:4] = 1          # P1's four, which a block would answer
    b[8, 8] = 1
    move = _exact(pair, Pos(b), 9, [])
    assert move == (2, 0)
    b[move] = 2
    assert pair.jp.play(Pos(b), 10, None) is None
    assert pair.tp.play(Pos(b), 10, None) is None


def _pente_after(board, captures, to_move, move):
    """The host engine's position after ``move`` (captures applied)."""
    g = Pente(SIZE)
    g.board = board.copy()
    g.captures = {1: captures[0], 2: captures[1]}
    g.current_player = to_move
    assert g.do_move(move)
    return g


@pytest.mark.parametrize("in_channels", [3, 5])
def test_puct_player_equals_jax_through_a_pente_capture(in_channels,
                                                        tmp_path):
    path = None
    if in_channels == 5:
        path = str(tmp_path / "pente5.ckpt")
        AZModel(board_size=SIZE, n_res_blocks=1, channels=8, in_channels=5,
                device="cpu").save(path)
    table = TableEval(SIZE, seed=6)
    pair = Pair(*players("pente", 16, table, model_path=path))
    assert pair.tp.env.obs_channels == pair.jp.env.obs_channels \
        == in_channels
    b = np.zeros((SIZE, SIZE), np.int8)
    for m in [(4, 4), (2, 2), (6, 6), (0, 8), (8, 0)]:
        b[m] = 1
    for m in [(4, 5), (4, 6), (2, 3), (2, 4)]:   # two capturable pairs
        b[m] = 2
    mv = _exact(pair, Pos(b, (0, 0)), 9, ["_search_fresh"])
    b[mv] = 2
    cell = next(c for c, pair_cells in (((4, 7), [(4, 5), (4, 6)]),
                                        ((2, 5), [(2, 3), (2, 4)]))
                if b[c] == 0)
    g = _pente_after(b, (0, 0), 1, cell)
    assert g.captures == {1: 1, 2: 0}
    mv = _exact(pair, Pos(g.board, (1, 0)), 11, ["_search_resume"])
    # the resumed root is the position handed in, captured pair included
    carry = pair.tlog[-1][2][0]
    np.testing.assert_array_equal(carry.states.board[0, 0].numpy(), g.board)
    assert carry.states.captures[0, 0].tolist() == [1, 0]
    # and one more ply each way
    g = _pente_after(g.board, (1, 0), 2, mv)
    g.do_move(next(m for m in [(8, 8), (0, 0), (8, 4)] if g.board[m] == 0))
    _exact(pair, Pos(g.board, (g.captures[1], g.captures[2])), 13,
           ["_search_resume"])


@pytest.mark.parametrize("parallel", [True, False])
def test_gumbel_player_move_equals_jax_with_its_uniforms(parallel):
    jp, tp = players("gomoku", 16, TableEval(SIZE, seed=7), search="gumbel",
                     gumbel_parallel=parallel)
    play_gumbel_sequence(jp, tp, parallel)


def test_player_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tab.AlphaZeroPlayer("gomoku", SIZE, n_simulations=4, model_path=None,
                            n_res_blocks=1, channels=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_player("player", "gomoku", SIZE, n_simulations=4)


def test_checkpoint_resolution_matches_jax(tmp_path, capsys):
    # an explicitly named checkpoint must exist
    for cls in (jab.AlphaZeroPlayer, tab.AlphaZeroPlayer):
        kw = {} if cls is jab.AlphaZeroPlayer else {"device": "cpu"}
        with pytest.raises(FileNotFoundError, match="does not exist"):
            cls("gomoku", SIZE, model_path=str(tmp_path / "typo.ckpt"), **kw)
    # the shipped default is 15x15: a 9x9 player takes fresh weights
    p = tab.AlphaZeroPlayer("gomoku", SIZE, n_simulations=4, device="cpu")
    assert "using fresh weights" in capsys.readouterr().out
    assert p.net.cfg.n_res_blocks == 3 and p.net.cfg.channels == 64
    assert tab._REPO_ROOT == str(ROOT)
    assert tab._resolve_checkpoint(None, "pente") == str(
        ROOT / "checkpoints" / "best_pente.ckpt")
    # at 15x15 the default resolves to the shipped net, sized from its file
    p = tab.AlphaZeroPlayer("pente", 15, n_simulations=4, device="cpu")
    assert p.net.cfg.in_channels == 5 and p.env.obs_channels == 5
    assert (p.net.cfg.n_res_blocks, p.net.cfg.channels) == (6, 128)


def test_infer_to_move_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        board = rng.choice(np.int8([0, 1, 2]), size=(SIZE, SIZE),
                           p=[0.6, 0.2, 0.2]).astype(np.int8)
        caps = tuple(int(x) for x in rng.integers(0, 3, 2))
        assert tab.infer_to_move(board, caps) == jab.infer_to_move(board,
                                                                   caps)
    jg = JaxHostPente(SIZE)
    for m in [(4, 5), (4, 4), (4, 6), (4, 7)]:
        jg.do_move(m)     # P2's (4,7) captures (4,5),(4,6)
    assert tab.infer_to_move(jg.board, (0, 1)) == 1
    assert tab.infer_to_move(jg.board, (0, 0)) == 2


def test_load_player_resolves_the_port_and_never_the_jax_package():
    """Short names load the port's players in a process without JAX."""
    code = (
        "import sys\n"
        "from alphazero_gomoku_tpu_torch.players import load_player\n"
        "p = load_player('player', 'gomoku', 9, n_simulations=4,\n"
        "                model_path=None, n_res_blocks=1, channels=8,\n"
        "                device='cpu')\n"
        "assert type(p).__module__ == "
        "'alphazero_gomoku_tpu_torch.players.player', type(p)\n"
        "for name in ('player_alpha', 'player_alpha2', 'player_mcts',\n"
        "             'player_human'):\n"
        "    q = load_player(name, 'gomoku', 9, **({} if name in\n"
        "        ('player_mcts', 'player_human') else dict(\n"
        "        n_simulations=4, model_path=None, n_res_blocks=1,\n"
        "        channels=8, device='cpu')))\n"
        "    assert type(q).__module__ == "
        "'alphazero_gomoku_tpu_torch.players.' + name\n"
        "assert not [m for m in sys.modules if m == 'jax' or\n"
        "            m.startswith('alphazero_gomoku_tpu.')\n"
        "            or m == 'alphazero_gomoku_tpu'], 'JAX imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    with pytest.raises(ValueError):
        load_player("nonexistent_player_xyz", "gomoku", SIZE)


def test_a_player_module_that_fails_to_import_raises(tmp_path,
                                                     monkeypatch):
    """Only a candidate that does not exist moves ``load_player`` on; one
    whose own import fails raises, so that no other module of the same name
    (the repo root's JAX shims) stands in for it."""
    (tmp_path / "player_broken_dep.py").write_text(
        "import a_module_that_is_not_installed\nPlayer = object\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ModuleNotFoundError,
                       match="a_module_that_is_not_installed"):
        load_player("player_broken_dep", "gomoku", SIZE)
    (tmp_path / "player_plugin_ok.py").write_text(
        "class Player:\n"
        "    def __init__(self, rules, size, **kw):\n"
        "        self.size = size\n")
    assert load_player("player_plugin_ok.py", "gomoku", SIZE).size == SIZE


def test_variant_defaults_match_jax():
    import alphazero_gomoku_tpu.players.player as j0
    import alphazero_gomoku_tpu.players.player_alpha as j1
    import alphazero_gomoku_tpu.players.player_alpha2 as j2
    import alphazero_gomoku_tpu_torch.players.player as t0
    import alphazero_gomoku_tpu_torch.players.player_alpha as t1
    import alphazero_gomoku_tpu_torch.players.player_alpha2 as t2
    import inspect
    for j, t, sims in ((j0, t0, 3000), (j1, t1, 3000), (j2, t2, 5000)):
        want = inspect.signature(j.Player.__init__).parameters
        got = inspect.signature(t.Player.__init__).parameters
        assert got["n_simulations"].default == sims
        for name in ("rules", "board_size", "n_simulations", "c_puct",
                     "model_path"):
            assert got[name].default == want[name].default
    p = t2.Player("gomoku", SIZE, model_path=None, n_res_blocks=1,
                  channels=8, device="cpu")
    assert p.cfg.reuse_budget == 5000 and p.cfg.depth_limit == 10002
    assert p.cfg.fpu_mode == "parent" and not p.cfg.add_noise
