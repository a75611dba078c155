"""Parity: the port's Pente (``games/pente.py``), its line scans and the
packed searches on Pente states, against the JAX package and the host
engine.

Games, encodings, ``from_board`` and the line scans are integer or exact
float work: equal bit for bit.  The searches run with the bit-exact
``TableEval``, which reads Pente's capture planes (a node that lost its
captures gives other priors), against the JAX package's packed searches in
Pallas interpret mode: pi, trees and the node-state stack (``captures``
included) equal, Gumbel's ``pi_target`` and ``root_q`` within 1e-5 and
PUCT's ``root_q`` within 1e-6 (sums over actions in another order, as in
``test_torch_port_gumbel.py`` and ``test_torch_port_search.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_gomoku_tpu.games.host import Pente as JaxHostPente
from alphazero_gomoku_tpu.games.pente import PenteEnv as JaxPente
from alphazero_gomoku_tpu.ops import lines as jlines
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    init_packed_carry as jax_init_carry,
    packed_advance_root as jax_advance,
    run_gumbel_packed_with_tree as jax_gumbel,
    run_mcts_packed_with_tree as jax_puct,
)
from alphazero_gomoku_tpu_torch.games import PenteEnv, PenteState, make_env
from alphazero_gomoku_tpu_torch.games.host import Pente as HostPente
from alphazero_gomoku_tpu_torch.ops import lines
from alphazero_gomoku_tpu_torch.search import (
    MCTSConfig,
    init_packed_carry,
    packed_advance_root,
)
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    run_gumbel_packed_with_tree,
    run_mcts_packed_with_tree,
)

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    assert_carry_equal,
    one_torch_thread,
    to_jax_state,
    to_torch_state,
)

TOL = 1e-5
Q_TOL = 1e-6


def assert_states_equal(jstate, tstate, msg=""):
    assert type(tstate) is PenteState
    for name, x, y in zip(PenteState._fields, jstate, tstate):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                      err_msg=f"{name} {msg}")


def sync_host(host, tstate, lane, msg=""):
    """Lane ``lane`` of the port's state equals the host engine's game."""
    np.testing.assert_array_equal(tstate.board[lane].numpy(), host.board,
                                  err_msg=msg)
    assert int(tstate.to_move[lane]) == host.current_player, msg
    assert tstate.captures[lane].tolist() == [host.captures[1],
                                              host.captures[2]], msg
    assert int(tstate.winner[lane]) == host.check_winner(), msg
    assert bool(tstate.done[lane]) == host.is_game_over(), msg


# ----------------------------------------------------------------------
# the game
# ----------------------------------------------------------------------
@pytest.mark.parametrize("size,seed,plies", [(9, 0, 150), (9, 1, 150),
                                             (9, 2, 150), (15, 3, 120)])
def test_random_games_match_jax_and_the_host_engine(size, seed, plies):
    """Random legal moves on 8 lanes: the port's ``step_safe`` equals the
    JAX ``step_safe`` vmapped, field for field, and each live lane the host
    engine's game (``games/host.py``, of both packages)."""
    batch = 8
    jenv, env = JaxPente(size), PenteEnv(size)
    js, ts = jenv.init_batch(batch), env.init_batch(batch, device="cpu")
    hosts = [HostPente(size) for _ in range(batch)]
    jhosts = [JaxHostPente(size) for _ in range(batch)]
    step = jax.jit(jax.vmap(jenv.step_safe))
    rng = np.random.default_rng(seed)
    for t in range(plies):
        legal = env.legal_mask(ts).numpy()
        np.testing.assert_array_equal(
            legal, np.asarray(jax.vmap(jenv.legal_mask)(js)))
        if not legal.any():
            break
        acts = np.array([rng.choice(np.flatnonzero(row)) if row.any() else 0
                         for row in legal], np.int32)
        for lane in np.flatnonzero(legal.any(axis=1)):
            move = divmod(int(acts[lane]), size)
            hosts[lane].do_move(move)
            jhosts[lane].do_move(move)
        js = step(js, jnp.asarray(acts))
        ts = env.step_safe(ts, torch.from_numpy(acts))
        assert_states_equal(js, ts, f"ply {t}")
        for lane in range(batch):
            sync_host(hosts[lane], ts, lane, f"ply {t} lane {lane}")
            np.testing.assert_array_equal(hosts[lane].board,
                                          jhosts[lane].board)
    caps = ts.captures.numpy()
    assert caps.sum() > 0
    if size == 9:
        assert ts.done.all() and (caps.max(axis=1) >= 2).any()


# (moves, pairs_to_win, captures of players 1 and 2 after them): the JAX
# package's tests/test_pente.py cases, then three more: a move that captures
# on three rays, and captures on the edge row and from a corner, where the
# rays that leave the board clip onto other rays' cells or onto the stone
RULE_CASES = {
    "single": ([(4, 4), (4, 5), (0, 0), (4, 6), (4, 7)], 5, [1, 0]),
    "double_direction": ([(4, 0), (4, 1), (7, 6), (4, 2), (8, 8), (5, 4),
                          (0, 0), (6, 5), (4, 3)], 5, [2, 0]),
    "moving_into_pair": ([(0, 0), (4, 4), (4, 5), (4, 7), (4, 6)], 5,
                         [0, 0]),
    "capture_win": ([(0, 0), (0, 1), (4, 4), (0, 2), (0, 3), (1, 1), (7, 7),
                     (2, 2), (3, 3)], 2, [2, 0]),
    "frees_squares": ([(4, 4), (4, 5), (0, 0), (4, 6), (4, 7)], 5, [1, 0]),
    "three_rays": ([(4, 7), (4, 5), (4, 1), (4, 6), (7, 4), (4, 3), (0, 0),
                    (4, 2), (0, 8), (5, 4), (8, 0), (6, 4), (4, 4)], 5,
                   [3, 0]),
    "edge_row": ([(0, 0), (0, 1), (8, 8), (0, 2), (0, 3)], 5, [1, 0]),
    "corner": ([(0, 3), (0, 1), (3, 0), (0, 2), (8, 8), (1, 0), (8, 7),
                (2, 0), (0, 0)], 5, [2, 0]),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_cases_match_jax(case):
    """Each move of the case on the port (a batch of one) and on the JAX
    engine: every field and the legal mask equal after every move, and the
    host engine's game where it plays to 5 pairs."""
    moves, pairs, want_caps = RULE_CASES[case]
    jenv = JaxPente(9, pairs_to_win=pairs)
    env = PenteEnv(9, pairs_to_win=pairs)
    js, ts = jenv.init(), env.init_batch(1, device="cpu")
    host = HostPente(9)
    for r, c in moves:
        a = r * 9 + c
        js = jenv.step(js, a)
        ts = env.step(ts, torch.tensor([a]))
        assert_states_equal(jax.tree_util.tree_map(lambda x: x[None], js), ts,
                            f"{case} after {(r, c)}")
        np.testing.assert_array_equal(env.legal_mask(ts)[0].numpy(),
                                      np.asarray(jenv.legal_mask(js)))
        if pairs == 5:
            host.do_move((r, c))
            sync_host(host, ts, 0, case)
    assert ts.captures[0].tolist() == want_caps
    if case == "capture_win":
        assert int(ts.winner[0]) == 1 and bool(ts.done[0])
    if case == "frees_squares":
        legal = env.legal_mask(ts)[0]
        assert legal[4 * 9 + 5] and legal[4 * 9 + 6]


def _states_with_captures(size, batch, plies, seed):
    """JAX Pente states of random-play boards with random captured pairs
    (0-4 each side, so the capture planes hold every k / 5)."""
    jenv = JaxPente(size)
    rng = np.random.default_rng(seed)
    js = jenv.init_batch(batch)
    step = jax.jit(jax.vmap(jenv.step_safe))
    for _ in range(plies):
        legal = np.asarray(jax.vmap(jenv.legal_mask)(js))
        acts = np.array([rng.choice(np.flatnonzero(row)) if row.any() else 0
                         for row in legal], np.int32)
        js = step(js, jnp.asarray(acts))
    caps = rng.integers(0, 5, (batch, 2)).astype(np.int32)
    caps[0] = (4, 0)
    caps[1] = (0, 4)
    return js._replace(captures=jnp.asarray(caps)), caps


@pytest.mark.parametrize("planes", [False, True], ids=["3planes", "5planes"])
def test_encode_matches_jax(planes):
    jenv = JaxPente(9, capture_planes=planes)
    env = make_env("pente", 9, capture_planes=planes)
    assert env.obs_channels == jenv.obs_channels == (5 if planes else 3)
    assert env.obs_plane_scales == jenv.obs_plane_scales
    js, caps = _states_with_captures(9, 24, 17, seed=3)
    want = np.asarray(jax.vmap(jenv.encode)(js))
    got = env.encode(to_torch_state(js)).numpy()
    np.testing.assert_array_equal(got, want)
    if planes:
        k = np.rint(got[:, 0, 0, 3:] * 5).astype(np.int32)
        assert set(k.ravel()) == {0, 1, 2, 3, 4}
        np.testing.assert_array_equal(
            k, np.where(np.asarray(js.to_move)[:, None] == 1, caps,
                        caps[:, ::-1]))


def _random_boards(size, batch, seed, lines_every=3):
    """Random boards, some with a planted 5-line of either colour (one in
    three), some full."""
    rng = np.random.default_rng(seed)
    boards = rng.choice([0, 1, 2], (batch, size, size),
                        p=[0.5, 0.25, 0.25]).astype(np.int8)
    for b in range(0, batch, lines_every):
        dr, dc = [(1, 0), (0, 1), (1, 1), (1, -1)][b % 4]
        r0 = int(rng.integers(0, size - 4 * abs(dr)))
        c0 = int(rng.integers(4 if dc < 0 else 0, size - 4 * max(dc, 0)))
        for k in range(5):
            boards[b, r0 + k * dr, c0 + k * dc] = 1 + (b // lines_every) % 2
    boards[-1] = rng.choice([1, 2], (size, size))
    return boards


@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_from_board_and_line_scans_match_jax(game):
    size, batch = 9, 24
    boards = _random_boards(size, batch, seed=7)
    rng = np.random.default_rng(8)
    to_move = rng.integers(1, 3, batch).astype(np.int32)
    for player in (1, 2):
        want = np.asarray(jax.vmap(lambda b: jlines.has_line(
            b, jnp.int8(player)))(jnp.asarray(boards)))
        got = lines.has_line(torch.from_numpy(boards), player).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.vmap(jlines.full_board_winner)(jnp.asarray(boards)))
    got = lines.full_board_winner(torch.from_numpy(boards))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want) == {0, 1, 2}
    if game == "gomoku":
        jenv, env = JaxGomoku(size), make_env("gomoku", size)
        js = jax.vmap(jenv.from_board)(jnp.asarray(boards),
                                       jnp.asarray(to_move))
        ts = env.from_board(torch.from_numpy(boards),
                            torch.from_numpy(to_move))
        js2 = jax.vmap(jenv.from_board)(jnp.asarray(boards),
                                        jnp.asarray(to_move),
                                        jnp.full((batch,), 3, jnp.int32))
        ts2 = env.from_board(torch.from_numpy(boards),
                             torch.from_numpy(to_move), 3)
    else:
        caps = rng.integers(0, 6, (batch, 2)).astype(np.int32)
        jenv, env = JaxPente(size), make_env("pente", size)
        js = jax.vmap(jenv.from_board)(jnp.asarray(boards),
                                       jnp.asarray(to_move),
                                       jnp.asarray(caps))
        ts = env.from_board(torch.from_numpy(boards),
                            torch.from_numpy(to_move),
                            torch.from_numpy(caps))
        js2 = jax.vmap(lambda b, t: jenv.from_board(b, t))(
            jnp.asarray(boards), jnp.asarray(to_move))
        ts2 = env.from_board(torch.from_numpy(boards),
                             torch.from_numpy(to_move))
        assert (caps == 5).any()
    for jst, tst in ((js, ts), (js2, ts2)):
        assert type(tst) is type(env.init_batch(1, device="cpu"))
        for name, x, y in zip(type(tst)._fields, jst, tst):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=name)
    assert ts.done.any() and not ts.done.all()


# ----------------------------------------------------------------------
# the packed searches on Pente states
# ----------------------------------------------------------------------
SIZE, BATCH = 7, 12


def _pente_roots(plies, seed):
    js, _ = _states_with_captures(SIZE, BATCH, plies, seed)
    return js


SEARCHES = {
    "puct": dict(n_simulations=24, cpuct=1.25, add_noise=False),
    "kleaf": dict(n_simulations=24, cpuct=1.25, add_noise=False,
                  leaves_per_sim=4),
    "gumbel": dict(n_simulations=24, search="gumbel",
                   gumbel_max_considered=8, add_noise=False),
    "gumbel_rp": dict(n_simulations=24, search="gumbel",
                      gumbel_max_considered=8, add_noise=False,
                      gumbel_round_parallel=True),
}


@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("plies", [6, 20])
def test_searches_on_pente_states_match_jax(search, plies):
    """PUCT, k-leaf, and Gumbel serial and round-parallel on Pente states
    with capture planes: pi, the packed tree and the node-state stack
    (``captures`` in every node) equal the JAX package's."""
    kw = SEARCHES[search]
    jenv = JaxPente(SIZE, capture_planes=True)
    env = PenteEnv(SIZE, capture_planes=True)
    te = TableEval(SIZE, seed=plies)
    js = _pente_roots(plies, seed=plies)
    key = jax.random.PRNGKey(plies)
    jcfg, cfg = JaxMCTSConfig(backend="pallas", **kw), MCTSConfig(**kw)
    ts = to_torch_state(js)
    assert type(ts) is PenteState
    moves = np.full((BATCH,), plies, np.int32)
    if search in ("puct", "kleaf"):
        pj, qj, jcarry = jax.jit(lambda s: jax_puct(
            jenv, jcfg, te.jax, None, jnp.asarray(moves), key,
            root_states=s, interpret=True))(js)
        pt, qt, carry = run_mcts_packed_with_tree(
            env, cfg, te.torch, None, ts, torch.from_numpy(moves))
        np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0,
                                   atol=Q_TOL)
    else:
        pj, qj, aj, jcarry = jax.jit(lambda s: jax_gumbel(
            jenv, jcfg, te.jax, None, key, root_states=s,
            interpret=True))(js)
        u = jax.random.uniform(key, (BATCH, SIZE * SIZE), jnp.float32,
                               minval=1e-12, maxval=1.0)
        pt, qt, at, carry = run_gumbel_packed_with_tree(
            env, cfg, te.torch, None, ts,
            uniforms=torch.from_numpy(np.array(u)))
        np.testing.assert_array_equal(np.asarray(aj), at.numpy())
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0,
                                   atol=TOL)
    assert type(carry.states) is PenteState
    assert carry.states.captures.numpy().any()
    assert_carry_equal(jcarry, carry, search)


def test_table_eval_reads_the_capture_planes():
    """The searches above would miss a lost ``captures`` only if the eval
    ignored the planes: the same boards with other captures give other
    priors."""
    env = PenteEnv(SIZE, capture_planes=True)
    te = TableEval(SIZE, seed=1)
    ts = to_torch_state(_pente_roots(10, seed=1))
    other = ts._replace(captures=torch.remainder(ts.captures + 1, 5))
    p1, _ = te.torch(None, env.encode(ts))
    p2, _ = te.torch(None, env.encode(other))
    assert not torch.equal(p1, p2)


@pytest.mark.parametrize("search", ["puct", "gumbel"])
def test_reuse_and_advance_root_on_pente_match_jax(search):
    """Three searches with subtree reuse, each followed by
    ``packed_advance_root`` with the played moves: every carry field equal
    after each, ``captures`` included."""
    jenv = JaxPente(SIZE, capture_planes=True)
    env = PenteEnv(SIZE, capture_planes=True)
    te = TableEval(SIZE, seed=5)
    if search == "puct":
        kw = dict(n_simulations=16, cpuct=1.25, add_noise=False,
                  reuse_budget=6)
    else:
        kw = dict(n_simulations=16, search="gumbel", gumbel_max_considered=8,
                  add_noise=False, reuse_budget=6)
    jcfg, cfg = JaxMCTSConfig(backend="pallas", **kw), MCTSConfig(**kw)
    js = _pente_roots(12, seed=5)
    jcarry = jax_init_carry(jenv, jcfg, js)
    carry = init_packed_carry(env, cfg, to_torch_state(js))
    assert_carry_equal(jcarry, carry, "init")
    step = jax.jit(jax.vmap(jenv.step_safe))
    advance = jax.jit(lambda c, x: jax_advance(jenv, jcfg, c, x))
    if search == "puct":
        jsearch = jax.jit(lambda s, c, key, m: jax_puct(
            jenv, jcfg, te.jax, None, m, key, carry=c, root_states=s,
            interpret=True))
    else:
        jsearch = jax.jit(lambda s, c, key: jax_gumbel(
            jenv, jcfg, te.jax, None, key, carry=c, root_states=s,
            interpret=True))
    for t in range(3):
        key = jax.random.PRNGKey(t)
        states = to_torch_state(js)
        if search == "puct":
            m = np.full((BATCH,), 12 + t, np.int32)
            pj, _, jcarry = jsearch(js, jcarry, key, jnp.asarray(m))
            pt, _, carry = run_mcts_packed_with_tree(
                env, cfg, te.torch, None, states, torch.from_numpy(m),
                carry=carry)
            np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
            actions = pt.numpy().argmax(axis=1)
        else:
            _, _, aj, jcarry = jsearch(js, jcarry, key)
            u = jax.random.uniform(key, (BATCH, SIZE * SIZE), jnp.float32,
                                   minval=1e-12, maxval=1.0)
            _, _, at, carry = run_gumbel_packed_with_tree(
                env, cfg, te.torch, None, states,
                uniforms=torch.from_numpy(np.array(u)), carry=carry)
            np.testing.assert_array_equal(np.asarray(aj), at.numpy())
            actions = at.numpy()
        assert_carry_equal(jcarry, carry, f"after search {t}")
        actions = np.where(np.asarray(js.done), 0, actions).astype(np.int32)
        jcarry = advance(jcarry, jnp.asarray(actions))
        carry = packed_advance_root(env, cfg, carry,
                                    torch.from_numpy(actions))
        assert_carry_equal(jcarry, carry, f"after advance {t}")
        js = step(js, jnp.asarray(actions))
    assert carry.states.captures.numpy().any()


def test_to_jax_state_round_trip():
    ts = to_torch_state(_pente_roots(8, seed=2))
    back = to_torch_state(to_jax_state(ts))
    assert type(back) is PenteState
    for x, y in zip(ts, back):
        assert torch.equal(x, y)
