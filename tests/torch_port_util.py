"""Shared helpers of the port's parity tests (JAX package vs PyTorch port).

Data passes between the two frameworks as numpy arrays made from a seed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.games.gomoku import GomokuState as JaxState
from alphazero_gomoku_tpu.games.pente import PenteState as JaxPenteState
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuState as TorchState
from alphazero_gomoku_tpu_torch.games.pente import (
    PenteState as TorchPenteState,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each port test on one torch thread (autouse where imported).

    The suite runs in several pytest workers at once; torch's default of a
    thread per core in every worker oversubscribed the CPU and made these
    tests 2-5x slower.  The previous count is restored after the test.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_row_fill(action, plen, rows, depth):
    """The port's path rows ([depth, L]) as the JAX lockstep walk leaves them.

    The JAX walk kernels walk their lanes in lockstep over a tile of up to
    128 lanes, write -1 for lanes that have stopped while others walk on, and
    leave the rows after the tile's last hop at their initial 0; the port's
    walks write -1 in every row at or beyond ``path_len``.
    """
    # hops each lane walked: an expanding lane records its last hop, a lane
    # that met a terminal node read it without recording it
    hops = np.where(action >= 0, plen, np.minimum(plen + 1, depth))
    out = rows.copy()
    assert rows.shape[1] <= 128   # one lane tile of the JAX kernel
    out[int(hops.max()):] = 0
    return out


def assert_walk_equal(jout, tout, depth):
    """A JAX walk kernel's five outputs equal the port's, path rows mapped."""
    leaf, action, pnodes, pacts, plen = (x.numpy() for x in tout)
    jl, ja, jpn, jpa, jpl = (np.asarray(x) for x in jout)
    np.testing.assert_array_equal(jl, leaf)
    np.testing.assert_array_equal(ja, action)
    np.testing.assert_array_equal(jpl, plen)
    np.testing.assert_array_equal(jpn, _jax_row_fill(action, plen, pnodes,
                                                     depth))
    np.testing.assert_array_equal(jpa, _jax_row_fill(action, plen, pacts,
                                                     depth))
    rows = np.arange(depth)[:, None]
    assert (pnodes[rows >= plen[None]] == -1).all()


def to_torch_state(st):
    """A JAX state as the port's (``GomokuState`` or, with its
    ``captures``, ``PenteState``)."""
    kind = TorchPenteState if len(st) == len(TorchPenteState._fields) \
        else TorchState
    return kind(*(torch.from_numpy(np.array(x)) for x in st))


def to_jax_state(st):
    """A port state as the JAX package's."""
    kind = JaxPenteState if len(st) == len(JaxPenteState._fields) \
        else JaxState
    return kind(*(jnp.asarray(x.cpu().numpy()) for x in st))


def random_jax_states(env, batch, plies, seed):
    """Advance a batch of JAX games by random legal moves (numpy-driven)."""
    states = env.init_batch(batch)
    rng = np.random.default_rng(seed)
    legal_mask = jax.jit(jax.vmap(env.legal_mask))
    step = jax.jit(jax.vmap(env.step_safe))
    for _ in range(plies):
        legal = np.asarray(legal_mask(states))
        acts = np.array([rng.choice(np.flatnonzero(row)) if row.any() else 0
                         for row in legal], dtype=np.int32)
        states = step(states, jnp.asarray(acts))
    return states


class TableEval:
    """An eval function both frameworks compute bit for bit.

    Priors and value are rows of fixed numpy tables, indexed by an integer
    feature of the position: ``sum(me * W1 + opp * W2) mod K`` over the board,
    with integer weight maps W1, W2 (exact in f32).  Nothing is summed in
    floating point in an order that could differ, so both searches see the
    same numbers and their pi must be equal.  On Pente's capture planes
    (observations of 5 planes) the feature adds ``13 * mine + 29 * theirs``,
    the captured pairs k read back from k / 5 by thresholds, so that a
    search that loses a node's captures sees other numbers.
    """

    def __init__(self, size, seed=0, k=97):
        rng = np.random.default_rng(seed)
        a = size * size
        self.k = k
        self.w1 = rng.integers(1, 50, (size, size)).astype(np.float32)
        self.w2 = rng.integers(1, 50, (size, size)).astype(np.float32)
        raw = rng.random((k, a)) ** 3 + 1e-3
        self.probs = (raw / raw.sum(1, keepdims=True)).astype(np.float32)
        self.values = rng.uniform(-0.9, 0.9, (k, 1)).astype(np.float32)

    @staticmethod
    def _pairs(plane):
        """k of a captured-pair plane holding k / 5 (its first point)."""
        v = plane[:, 0, 0]
        return sum((v > t) * 1.0 for t in (0.1, 0.3, 0.5, 0.7))

    def jax(self, params, obs):
        del params
        f = jnp.sum(obs[..., 0] * self.w1 + obs[..., 1] * self.w2, axis=(1, 2))
        if obs.shape[-1] == 5:
            f = f + 13 * self._pairs(obs[..., 3]) + 29 * self._pairs(
                obs[..., 4])
        idx = jnp.mod(f, self.k).astype(jnp.int32)
        return jnp.asarray(self.probs)[idx], jnp.asarray(self.values)[idx]

    def torch(self, params, obs):
        del params
        w1 = torch.from_numpy(self.w1).to(obs.device)
        w2 = torch.from_numpy(self.w2).to(obs.device)
        f = (obs[..., 0] * w1 + obs[..., 1] * w2).sum(dim=(1, 2))
        if obs.shape[-1] == 5:
            f = f + 13 * self._pairs(obs[..., 3]) + 29 * self._pairs(
                obs[..., 4])
        idx = torch.remainder(f, self.k).long()
        return (torch.from_numpy(self.probs).to(obs.device)[idx],
                torch.from_numpy(self.values).to(obs.device)[idx])


def carry_to_numpy(carry):
    """A ``PackedCarry`` of either package as numpy arrays
    ``(packed, states, parent, parent_action)``, boards flat ``[B, n, H*W]``
    as the JAX package stores them."""
    packed, states, parent, pact = carry
    fields = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
              for x in states]
    board = fields[0]
    fields[0] = board.reshape(board.shape[:2] + (-1,))
    return (np.asarray(packed.cpu() if isinstance(packed, torch.Tensor)
                       else packed), fields,
            *(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
              for x in (parent, pact)))


def assert_carry_equal(jcarry, carry, msg=""):
    """Every field of a JAX ``PackedCarry`` equals the port's, all lanes."""
    jp, js, jpar, jpact = carry_to_numpy(jcarry)
    tp, ts, tpar, tpact = carry_to_numpy(carry)
    np.testing.assert_array_equal(jp, tp, err_msg=f"packed {msg}")
    assert len(js) == len(ts) == len(carry.states)
    for name, x, y in zip(type(carry.states)._fields, js, ts):
        np.testing.assert_array_equal(x, y, err_msg=f"states.{name} {msg}")
    np.testing.assert_array_equal(jpar, tpar, err_msg=f"parent {msg}")
    np.testing.assert_array_equal(jpact, tpact,
                                  err_msg=f"parent_action {msg}")
