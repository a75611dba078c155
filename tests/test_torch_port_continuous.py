"""Parity: the port's continuous (auto-reset) self-play against the JAX
package's, mirroring ``tests/test_continuous.py``'s seven tests.

``play_games_continuous`` runs in the port; a JAX replay then walks the
stream ply by ply with the JAX package's own pieces, on Gomoku and on Pente
with capture planes:

  - its state equals the port's records before each move (board, player,
    captures);
  - its packed search on that state (Pallas interpret mode, with the
    bit-exact ``TableEval``) gives the port's pi (PUCT exactly; Gumbel's
    improved policy within 1e-5, its move exactly).  The random numbers are
    the port's: the replay draws from a generator of the same seed in the
    port's order (module docstring of ``selfplay/runner.py``) and hands the
    Dirichlet noise and Gumbel uniforms to the JAX search, the sampling and
    opening uniforms to ``sample_actions`` and ``random_center_actions``;
  - the move those give is the port's;
  - JAX's ``step`` on it, the end test (done, or the move cap) and the
    reset to a fresh game give the port's ``ended``, ``winners`` and next
    state.

``collect_examples_continuous`` must equal the JAX function on identical
arrays.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_gomoku_tpu.games.pente import PenteEnv as JaxPente
from alphazero_gomoku_tpu.search import tree as jtree
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    run_gumbel_packed as jax_gumbel,
    run_mcts_packed as jax_puct,
)
from alphazero_gomoku_tpu.selfplay import runner as jrun
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.search.tree import symmetric_dirichlet
from alphazero_gomoku_tpu_torch.selfplay import (
    ContinuousRecords,
    SelfPlayConfig,
    center_mask,
    collect_examples_continuous,
    play_games_continuous,
    random_center_actions,
    sample_actions,
)

from test_mcts import fake_eval_jax
from torch_port_util import TableEval, one_torch_thread  # noqa: F401

SIZE = 7
A = SIZE * SIZE
TOL = 1e-5


def _envs(game):
    if game == "pente":
        return (make_env("pente", SIZE, capture_planes=True),
                JaxPente(SIZE, capture_planes=True))
    return make_env("gomoku", SIZE), JaxGomoku(SIZE)


def _stream(game, mcts, steps, batch=8, seed=0, **sp):
    env, _ = _envs(game)
    te = TableEval(SIZE, seed=seed + 40)
    cfg = SelfPlayConfig(batch_games=batch, mcts=MCTSConfig(**mcts), **sp)
    rec = play_games_continuous(env, cfg, te.torch, None,
                                torch.Generator().manual_seed(seed), steps,
                                device="cpu")
    return env, te, cfg, rec


def _replay(game, mcts, steps, batch=8, seed=0, **sp):
    """The port's stream and its JAX replay (module docstring); returns
    ``(cfg, rec)``."""
    env, te, cfg, rec = _stream(game, mcts, steps, batch, seed, **sp)
    _, jenv = _envs(game)
    gumbel = cfg.mcts.search == "gumbel"
    jfull = JaxMCTSConfig(backend="pallas", **mcts)
    jcheap = None
    if cfg.pcr_cheap_sims:
        jcheap = JaxMCTSConfig(backend="pallas", **dict(
            mcts, n_simulations=cfg.pcr_cheap_sims, add_noise=False,
            max_nodes=jfull.node_capacity))

    def jax_search(jcfg):
        def search(s, rand):
            if gumbel:
                with mock.patch.object(jax.random, "uniform",
                                       lambda *a, **k: rand):
                    pi, _, act = jax_gumbel(jenv, jcfg, te.jax, None, s,
                                            jax.random.PRNGKey(0),
                                            interpret=True)
                return pi, act
            with mock.patch.object(jtree, "symmetric_dirichlet",
                                   lambda *a, **k: rand):
                pi, _ = jax_puct(jenv, jcfg, te.jax, None, s, s.move_count,
                                 jax.random.PRNGKey(0), interpret=True)
            return pi, jnp.zeros(pi.shape[:1], jnp.int32)
        return jax.jit(search)

    searches = {True: jax_search(jfull)}
    if jcheap is not None:
        searches[False] = jax_search(jcheap)
    step = jax.jit(jax.vmap(jenv.step))
    fresh = jenv.init_batch(batch)
    max_moves = cfg.resolved_max_moves(env)
    center = center_mask(env, "cpu")
    gen = torch.Generator().manual_seed(seed)
    js = fresh
    for t in range(steps):
        msg = f"ply {t}"
        np.testing.assert_array_equal(np.asarray(js.board),
                                      rec.boards[t].numpy(), err_msg=msg)
        np.testing.assert_array_equal(np.asarray(js.to_move),
                                      rec.players[t].numpy(), err_msg=msg)
        want_caps = (np.asarray(js.captures) if game == "pente"
                     else np.zeros((batch, 2), np.int32))
        np.testing.assert_array_equal(want_caps, rec.captures[t].numpy(),
                                      err_msg=msg)
        # the port's draws, in its order
        full = True
        if jcheap is not None:
            full = bool(torch.rand((), generator=gen) < cfg.pcr_full_prob)
        rand = torch.zeros((batch, A))
        if gumbel:
            rand = torch.clamp(torch.rand((batch, A), generator=gen),
                               min=1e-12)
        elif full and mcts.get("add_noise", True):
            rand = symmetric_dirichlet(gen, cfg.mcts.dirichlet_alpha,
                                       (batch, A))
        u_sample = None if gumbel else torch.rand((batch, A), generator=gen)
        u_open = (torch.rand((batch, A), generator=gen)
                  if cfg.opening_random_moves else None)

        pi, g_act = searches[full](js, jnp.asarray(rand.numpy()))
        pi = np.array(pi)
        if not full:
            assert not rec.pis[t].any(), msg
        elif gumbel:
            np.testing.assert_allclose(rec.pis[t].numpy(), pi, rtol=0,
                                       atol=TOL, err_msg=msg)
        else:
            np.testing.assert_array_equal(rec.pis[t].numpy(), pi,
                                          err_msg=msg)
        legal = torch.from_numpy(np.array(jax.vmap(jenv.legal_mask)(js)))
        if gumbel:
            actions = torch.from_numpy(np.array(g_act)).long()
        else:
            count = torch.from_numpy(np.array(js.move_count))
            temp = torch.clamp(1.0 - count.float() / cfg.temp_threshold,
                               min=0.0)
            actions = sample_actions(torch.from_numpy(pi), temp, legal,
                                     uniforms=u_sample)
        opening = np.asarray(js.move_count) < cfg.opening_random_moves
        if u_open is not None:
            rand_act = random_center_actions(legal.float(), center,
                                             uniforms=u_open)
            actions = torch.where(torch.from_numpy(opening), rand_act,
                                  actions)
        np.testing.assert_array_equal(actions.numpy(),
                                      rec.actions[t].numpy(), err_msg=msg)
        np.testing.assert_array_equal(~opening, rec.recorded[t].numpy())

        nxt = step(js, jnp.asarray(rec.actions[t].numpy()))
        ended = np.asarray(nxt.done) | (np.asarray(nxt.move_count)
                                        >= max_moves)
        np.testing.assert_array_equal(ended, rec.ended[t].numpy(),
                                      err_msg=msg)
        np.testing.assert_array_equal(
            np.where(np.asarray(nxt.done), np.asarray(nxt.winner), 0),
            rec.winners[t].numpy(), err_msg=msg)
        js = jax.tree_util.tree_map(
            lambda f, s: jnp.where(
                jnp.asarray(ended).reshape((-1,) + (1,) * (s.ndim - 1)),
                f, s), fresh, nxt)
    return cfg, rec


def _assert_segments(rec, steps, batch, full_pis=True):
    """``tests/test_continuous.py``'s stream invariants: after each end a
    fresh board and player 1; players alternate within a segment; each
    full ply's pi sums to 1."""
    ended = rec.ended.numpy()
    boards = rec.boards.numpy()
    players = rec.players.numpy()
    pis = rec.pis.numpy()
    assert ended.shape == (steps, batch)
    assert ended.any(axis=0).all()
    for lane in range(batch):
        seg_start = 0
        for step in range(steps):
            assert players[step, lane] == (step - seg_start) % 2 + 1
            if ended[step, lane]:
                seg_start = step + 1
                if step + 1 < steps:
                    assert (boards[step + 1, lane] == 0).all()
                    assert players[step + 1, lane] == 1
    sums = pis.sum(-1)
    full = sums > 0.5
    if full_pis:
        assert full.all()
    np.testing.assert_allclose(sums[full], 1.0, atol=1e-4)


PUCT = dict(n_simulations=10, cpuct=1.25, add_noise=True,
            dirichlet_alpha=0.3, dirichlet_epsilon=0.25, dirichlet_moves=3)


@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_stream_shape_and_segments_replays_jax(game):
    """PUCT with the per-lane Dirichlet gate (its first 3 plies of each
    game) and temperature (``temp_threshold`` 5), a 12-move cap: every lane
    ends at least twice in 30 plies."""
    steps, batch = 30, 8
    _, rec = _replay(game, PUCT, steps, batch, seed=1, temp_threshold=5,
                     max_moves=12)
    _assert_segments(rec, steps, batch)
    assert (rec.ended.numpy().sum(axis=0) >= 2).all()
    if game == "pente":
        assert rec.captures.numpy().any()


def _records_of(rec, jax_side):
    """A stream's records as the JAX or the port's ``ContinuousRecords``,
    from the same numpy arrays."""
    arrays = {k: v.numpy() for k, v in rec._asdict().items()}
    if jax_side:
        del arrays["actions"]
        return jrun.ContinuousRecords(**arrays)
    return ContinuousRecords(**{k: torch.from_numpy(v)
                                for k, v in arrays.items()})


@pytest.mark.parametrize("planes", [False, True], ids=["3planes", "5planes"])
@pytest.mark.parametrize("mix", [0.0, 0.4])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "nosym"])
def test_collect_examples_continuous_equals_jax(sym, mix, planes):
    """On identical arrays (a Pente stream with captures, a random opening
    and unfinished tails): samples, pis, zs and the winner stats."""
    _, _, _, rec = _stream("pente", dict(PUCT, n_simulations=6), 32,
                           batch=6, seed=4, temp_threshold=4, max_moves=20,
                           opening_random_moves=2)
    ended = rec.ended.numpy()
    assert rec.captures.numpy().any() and not rec.recorded.numpy().all()
    assert (~ended[-3:]).all(axis=0).any()       # a game unfinished
    got = collect_examples_continuous(_records_of(rec, False), sym, mix,
                                      capture_planes=planes)
    want = jrun.collect_examples_continuous(_records_of(rec, True), sym, mix,
                                            capture_planes=planes)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    assert got[0].shape[-1] == (5 if planes else 3)
    # records up to each lane's last end, less the opening plies
    recorded = rec.recorded.numpy()
    n = sum(int(recorded[:np.flatnonzero(ended[:, lane])[-1] + 1,
                         lane].sum())
            for lane in range(ended.shape[1]))
    assert len(got[2]) == n * (8 if sym else 1)
    assert sum(got[3].values()) == int(ended.sum())


def test_move_cap_scores_draw():
    """A 6-move cap on 7x7: every game ends by the cap, a draw, at plies 6
    and 12 (no five in a row fits in 3 stones)."""
    _, rec = _replay("gomoku", PUCT, 12, batch=8, seed=3, max_moves=6)
    ended, winners = rec.ended.numpy(), rec.winners.numpy()
    assert ended[5].all() and ended[11].all()
    assert not ended[:5].any() and not ended[6:11].any()
    assert (winners == 0).all()


def test_symmetry_expansion_continuous():
    _, _, _, rec = _stream("gomoku", PUCT, 30, batch=4, seed=4,
                           max_moves=10)
    s1, p1, z1, _ = collect_examples_continuous(rec, use_symmetries=False)
    s8, p8, z8, _ = collect_examples_continuous(rec, use_symmetries=True)
    assert len(z8) == 8 * len(z1) > 0
    np.testing.assert_array_equal(z8[:len(z1)], z1)
    np.testing.assert_array_equal(s8[:len(z1)], s1)
    np.testing.assert_array_equal(p8[:len(z1)], p1)


def test_continuous_playout_cap_randomization_replays_jax():
    """PCR in the stream (and a 2-ply random opening): one full / cheap
    draw a ply for the whole batch; cheap plies record a zero pi and stay
    recorded (value samples); the cheap searches' moves replay too."""
    steps, batch = 20, 8
    cfg, rec = _replay("pente", dict(PUCT, n_simulations=12), steps, batch,
                       seed=5, temp_threshold=4, max_moves=10,
                       pcr_cheap_sims=4, pcr_full_prob=0.5,
                       opening_random_moves=2)
    sums = rec.pis.numpy().sum(axis=-1)
    full_t = (sums > 0.5).all(axis=1)
    cheap_t = (sums <= 0.5).all(axis=1)
    assert (full_t | cheap_t).all() and full_t.any() and cheap_t.any()
    _assert_segments(rec, steps, batch, full_pis=False)
    count = np.zeros(batch, np.int64)
    for t in range(steps):       # the opening: each game's first 2 plies
        np.testing.assert_array_equal(rec.recorded[t].numpy(), count >= 2)
        count = np.where(rec.ended[t].numpy(), 0, count + 1)


GUMBEL = dict(n_simulations=8, search="gumbel", gumbel_max_considered=4,
              add_noise=False)


@pytest.mark.parametrize("game", ["gomoku", "pente"])
@pytest.mark.parametrize("parallel", [False, True],
                         ids=["serial", "round_parallel"])
def test_continuous_gumbel_stream_replays_jax(game, parallel):
    """Gumbel drives the stream (its halving winner is the move): segments
    stay valid, every pi is the improved policy (sums to 1), and the replay
    holds; collection works on it."""
    steps, batch = 24, 8
    _, rec = _replay(game, dict(GUMBEL, gumbel_round_parallel=parallel),
                     steps, batch, seed=6, max_moves=9)
    _assert_segments(rec, steps, batch)
    _, _, zs, stats = collect_examples_continuous(rec, use_symmetries=False,
                                                  capture_planes=game
                                                  == "pente")
    assert len(zs) > 0 and sum(stats.values()) == int(rec.ended.sum())


def test_continuous_gumbel_round_parallel_equals_serial():
    """The round-parallel halving rounds replay the serial schedule bit for
    bit in the stream (the same generator, the same resets)."""
    a = _stream("pente", GUMBEL, 24, batch=8, seed=7, max_moves=9)[3]
    b = _stream("pente", dict(GUMBEL, gumbel_round_parallel=True), 24,
                batch=8, seed=7, max_moves=9)[3]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("search", ["puct", "gumbel"])
def test_reuse_budget_searches_a_fresh_tree_each_ply(search):
    """Continuous self-play carries no tree: with ``reuse_budget > 0`` each
    ply's search is the fresh-tree search of a larger node capacity, the
    same stream as without reuse.  So it is in the JAX package (its
    continuous runner calls ``run_mcts_with_q`` / ``run_gumbel_mcts``, which
    start a tree each call), and so in the port."""
    mcts = PUCT if search == "puct" else GUMBEL
    a = _stream("gomoku", mcts, 12, batch=8, seed=8, max_moves=8)[3]
    b = _stream("gomoku", dict(mcts, reuse_budget=6), 12, batch=8, seed=8,
                max_moves=8)[3]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    jenv = JaxGomoku(SIZE)
    recs = []
    for reuse in (0, 6):
        cfg = jrun.SelfPlayConfig(
            batch_games=8, max_moves=8,
            mcts=JaxMCTSConfig(backend="pallas", reuse_budget=reuse, **mcts))
        recs.append(jax.jit(lambda p, k, c=cfg: jrun.play_games_continuous(
            jenv, c, fake_eval_jax, p, k, 6))(None, jax.random.PRNGKey(1)))
    for x, y in zip(*recs):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
