"""Shared helpers of the player parity tests: both packages' AlphaZero
players, fed the same positions, with each search's pi recorded.

Data passes between the two players as numpy boards.
"""

import random
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

import alphazero_gomoku_tpu.players.alpha_base as jab
import alphazero_gomoku_tpu_torch.players.alpha_base as tab
from alphazero_gomoku_tpu_torch.games import make_host_game

SEARCHES = ("_search_fresh", "_search_resume", "_search")


class Pos:
    """A position as the players take it: ``.board`` and, in Pente,
    ``.captures`` (as the host engines carry them)."""

    def __init__(self, board, captures=None):
        self.board = np.array(board, dtype=np.int8)
        if captures is not None:
            self.captures = {1: int(captures[0]), 2: int(captures[1])}


class Pair:
    """The JAX player and the port's, fed the same positions; each search
    call's name, pi and (port) first argument are recorded."""

    def __init__(self, jp, tp):
        self.jp, self.tp = jp, tp
        self.jlog, self.tlog = [], []
        self.advances = []          # the port's (carry, action) advanced
        for player, log in ((jp, self.jlog), (tp, self.tlog)):
            for name in SEARCHES:
                if hasattr(player, name):
                    setattr(player, name,
                            self._recorder(getattr(player, name), name, log))
        advance = tp._advance

        def recorded_advance(carry, action):
            self.advances.append((carry, action))
            return advance(carry, action)

        tp._advance = recorded_advance

    @staticmethod
    def _recorder(fn, name, log):
        def wrapped(*args):
            out = fn(*args)
            pi = out[0] if isinstance(out, tuple) else out
            log.append((name, np.asarray(pi), args))
            return out
        return wrapped

    def play(self, pos, turn):
        """Both moves and the searches each ran; returns ``(move, kinds,
        pairs of pi)``."""
        nj, nt = len(self.jlog), len(self.tlog)
        mj = self.jp.play(pos, turn, None)
        mt = self.tp.play(pos, turn, None)
        jnew, tnew = self.jlog[nj:], self.tlog[nt:]
        kinds = [k for k, _, _ in tnew]
        assert [k for k, _, _ in jnew] == kinds
        return mj, mt, kinds, [(j, t) for (_, j, _), (_, t, _) in
                               zip(jnew, tnew)]


def players(game, sims, table=None, model_path=None, size=9, **kw):
    """The JAX player and the port's (on the CPU) with the same settings;
    with ``table``, both evaluate with it."""
    common = dict(n_simulations=sims, model_path=model_path,
                  n_res_blocks=1, channels=8, **kw)
    if table is None:
        return (jab.AlphaZeroPlayer(game, size, **common),
                tab.AlphaZeroPlayer(game, size, device="cpu", **common))
    with mock.patch.object(jab, "make_eval_fn", lambda cfg: table.jax):
        jp = jab.AlphaZeroPlayer(game, size, **common)
    with mock.patch.object(tab, "make_eval_fn", lambda: table.torch):
        tp = tab.AlphaZeroPlayer(game, size, device="cpu", **common)
    return jp, tp


def within_two_visits(pair, pos, turn, sims):
    """The real-net comparison; returns the port's move, or None where the
    two moves differ at a near tie (the games part there)."""
    mj, mt, kinds, pis = pair.play(pos, turn)
    for j, t in pis:
        cj, ct = np.rint(j * sims), np.rint(t * sims)
        assert np.abs(cj - ct).sum() / 2 <= 2, (turn, cj, ct)
    if mj != mt:
        top = np.sort(np.rint(pis[-1][0] * sims))[::-1]
        assert pis and top[0] - top[1] <= 2, (turn, mj, mt, top[:2])
        return None
    return mt


def play_real_net_sequence(pair, game, sims, size, plies=4, seed=0):
    """Plays ``plies`` moves of the player (P2) against a seeded random P1
    from the centre, holding each search within two visits."""
    rng = np.random.default_rng(seed)
    g = make_host_game(game, size)
    g.do_move((size // 2, size // 2))
    for ply in range(plies):
        caps = (g.captures[1], g.captures[2]) if game == "pente" else None
        mv = within_two_visits(pair, Pos(g.board, caps), 2 * ply + 1, sims)
        if mv is None:
            return
        assert g.do_move(mv)
        legal = np.flatnonzero(g.board.reshape(-1) == 0)
        g.do_move(divmod(int(rng.choice(legal)), size))


def jax_uniforms(turn, a):
    """The JAX Gumbel player's root uniforms ``[1, A]`` for a turn."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(turn), (1, a), jnp.float32, minval=1e-12,
        maxval=1.0)))


def play_gumbel_sequence(jp, tp, parallel, size=9, seed=1):
    """Four Gumbel moves of both players (P2) against a seeded random P1,
    the JAX player's uniforms injected into the port's: the moves equal,
    pi (the improved policy, summed in another order) within 1e-5."""
    assert not tp.tree_reuse and tp.cfg.gumbel_round_parallel == parallel
    tp._root_uniforms = lambda turn: jax_uniforms(turn, size * size)
    pair = Pair(jp, tp)
    rng = np.random.default_rng(seed)
    b = np.zeros((size, size), np.int8)
    for turn in range(1, 9, 2):
        legal = np.flatnonzero(b.reshape(-1) == 0)
        b[divmod(int(rng.choice(legal)), size)] = 1
        mj, mt, kinds, pis = pair.play(Pos(b), turn)
        assert kinds == ["_search"]
        for j, t in pis:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
        assert mt == mj
        b[mt] = 2


def seed_pure_mcts(monkeypatch, module):
    """Each ``random.Random()`` a ``pure_mcts`` module's players make is
    seeded from a counter, in the order they are made: the same in both
    packages' CLIs and engines, so their games can be compared."""
    made = iter(range(100, 10_000))
    monkeypatch.setattr(module, "random", types.SimpleNamespace(
        Random=lambda: random.Random(next(made))))
