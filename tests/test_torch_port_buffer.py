"""The port's replay buffer (``selfplay/buffer.py``), symmetries
(``ops/symmetry.py``) and ``collect_examples`` (``selfplay/runner.py``)
against the JAX package's, on the same numpy inputs.

Everything here is exact: uint8 storage with one float32 multiply to
decode, ``rng.choice`` draws from the same numpy ``Generator``, array
rotations and flips, and the same host arithmetic for the value targets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu.ops import symmetry as jsym
from alphazero_gomoku_tpu.selfplay import buffer as jbuf
from alphazero_gomoku_tpu.selfplay import runner as jrun
from alphazero_gomoku_tpu_torch.models import model as pm
from alphazero_gomoku_tpu_torch.models import resnet as pr
from alphazero_gomoku_tpu_torch.ops import symmetry as psym
from alphazero_gomoku_tpu_torch.selfplay import buffer as pbuf
from alphazero_gomoku_tpu_torch.selfplay import runner as prun

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SIZE = 7
A = SIZE * SIZE


def _samples(rng, n, scales=(1, 1, 5)):
    planes = rng.integers(0, 2, (n, SIZE, SIZE, 2)).astype(np.float32)
    k = rng.integers(0, 5, (n, 1, 1, 1)).astype(np.float32) / scales[-1]
    states = np.concatenate(
        [planes, np.broadcast_to(k, (n, SIZE, SIZE, 1))], axis=-1)
    pis = rng.random((n, A)).astype(np.float32)
    pis /= pis.sum(axis=1, keepdims=True)
    zs = rng.choice([-1.0, 0.0, 1.0], size=n).astype(np.float32)
    return np.ascontiguousarray(states), pis, zs


def test_encode_and_decode_are_exact_and_jaxs():
    rng = np.random.default_rng(0)
    states, _, _ = _samples(rng, 50)
    enc = pbuf.encode_states_u8(states, (1, 1, 5))
    np.testing.assert_array_equal(enc, jbuf.encode_states_u8(states,
                                                             (1, 1, 5)))
    inv = pbuf.inv_scales_f32((1, 1, 5), 3)
    np.testing.assert_array_equal(inv, jbuf.inv_scales_f32((1, 1, 5), 3))
    np.testing.assert_array_equal(pbuf.decode_states_f32(enc, inv), states)


def _filled(mod, seed, capacity=100, adds=(40, 40, 40)):
    rng = np.random.default_rng(seed)
    buf = mod.ReplayBuffer(capacity=capacity, board_size=SIZE,
                           channel_scales=(1, 1, 5))
    for n in adds:
        buf.add(*_samples(rng, n))
    return buf


@pytest.mark.parametrize("adds", [(40, 40, 40), (30,), (250,)],
                         ids=["wrapped", "partial", "overfull"])
def test_ring_and_draws_equal_jaxs(adds):
    ours, theirs = _filled(pbuf, 1, adds=adds), _filled(jbuf, 1, adds=adds)
    assert len(ours) == len(theirs)
    for name in ("states", "pis", "zs"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    for batch in (16, 64):
        got = ours.sample(batch, np.random.default_rng(9))
        want = theirs.sample(batch, np.random.default_rng(9))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = ours.sample_many(3, 8, np.random.default_rng(2))
    want = theirs.sample_many(3, 8, np.random.default_rng(2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_npz_reads_both_ways(tmp_path, capsys):
    ours, theirs = _filled(pbuf, 3), _filled(jbuf, 3)
    p_ours, p_theirs = str(tmp_path / "ours.npz"), str(tmp_path / "j.npz")
    assert pbuf.save_replay_buffer(ours, p_ours)
    assert jbuf.save_replay_buffer(theirs, p_theirs)
    for path in (p_ours, p_theirs):
        a = pbuf.load_replay_buffer(path, capacity=100, board_size=SIZE)
        b = jbuf.load_replay_buffer(path, capacity=100, board_size=SIZE)
        assert len(a) == len(b) == 100
        for name in ("states", "pis", "zs", "channel_scales"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert pbuf.load_replay_buffer(str(tmp_path / "none.npz"), 10) is None


def test_symmetries_equal_jaxs():
    rng = np.random.default_rng(4)
    states = rng.random((5, SIZE, SIZE, 3)).astype(np.float32)
    pis = rng.random((5, A)).astype(np.float32)
    got = psym.expand_symmetries_batch_np(states, pis)
    want = jsym.expand_symmetries_batch_np(states, pis)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tgot = psym.expand_symmetries_torch(torch.from_numpy(states),
                                        torch.from_numpy(pis))
    twant = jsym.expand_symmetries_jax(jnp.asarray(states), jnp.asarray(pis))
    for g, w in zip(tgot, twant):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for (gs, gp), (ws, wp) in zip(psym.expand_symmetries_np(states[0],
                                                            pis[0]),
                                  jsym.expand_symmetries_np(states[0],
                                                            pis[0])):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)


def _trajectories(seed, t=12, b=5):
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, 3, (t, b, SIZE, SIZE)).astype(np.int8)
    players = rng.integers(1, 3, (t, b)).astype(np.int32)
    pis = rng.random((t, b, A)).astype(np.float32)
    pis[3] = 0.0                              # a PCR cheap ply
    root_qs = rng.uniform(-1, 1, (t, b)).astype(np.float32)
    active = rng.random((t, b)) < 0.7
    winners = rng.integers(0, 3, b).astype(np.int32)
    moves = active.sum(axis=0).astype(np.int32)
    jt = jrun.Trajectories(boards=boards, players=players, pis=pis,
                           root_qs=root_qs, active=active, winners=winners,
                           moves_played=moves)
    pt = prun.Trajectories(
        boards=torch.from_numpy(boards), players=torch.from_numpy(players),
        pis=torch.from_numpy(pis), root_qs=torch.from_numpy(root_qs),
        active=torch.from_numpy(active),
        actions=torch.zeros((t, b), dtype=torch.int32),
        winners=torch.from_numpy(winners),
        moves_played=torch.from_numpy(moves))
    return jt, pt


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "nosym"])
@pytest.mark.parametrize("mix", [0.0, 0.3])
def test_collect_examples_equal_jaxs(sym, mix):
    jt, pt = _trajectories(5)
    got = prun.collect_examples(pt, use_symmetries=sym, value_target_mix=mix)
    want = jrun.collect_examples(jt, use_symmetries=sym,
                                 value_target_mix=mix)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_encode_board_np_equals_jaxs_and_the_env():
    jt, _ = _trajectories(6)
    boards = jt.boards.reshape(-1, SIZE, SIZE)
    players = jt.players.reshape(-1)
    np.testing.assert_array_equal(prun.encode_board_np(boards, players),
                                  jrun.encode_board_np(boards, players))


def test_device_mirror_tracks_the_ring_and_its_epoch_equals_the_host_one():
    rng = np.random.default_rng(0)
    buf = pbuf.ReplayBuffer(capacity=100, board_size=SIZE,
                            channel_scales=(1, 1, 5))
    mirror = pbuf.DeviceBufferMirror(buf, device="cpu")
    for n in (40, 40, 40, 90):           # wraps twice
        s, p, z = _samples(rng, n)
        mirror.sync(s, p, z, buf.add(s, p, z))
    np.testing.assert_array_equal(mirror.states.numpy(), buf.states)
    np.testing.assert_array_equal(mirror.pis.numpy(), buf.pis)
    np.testing.assert_array_equal(mirror.zs.numpy(), buf.zs)

    cfg = pr.NetConfig(board_size=SIZE, action_size=A, n_res_blocks=1,
                       channels=8)
    p, s = pm.split_state(pr.params_from_jax(*pr.init_params(cfg, 0)))
    tx = pm.Optimizer()
    draws = np.random.default_rng(3)
    idx = np.stack([draws.choice(len(buf), 16, replace=False)
                    for _ in range(3)])
    host = pm.train_epoch(
        cfg, tx, p, s, tx.init(p),
        *[torch.from_numpy(a) for a in (
            pbuf.decode_states_f32(buf.states[idx], buf.inv_scales),
            buf.pis[idx], buf.zs[idx].reshape(3, 16, 1))])
    dev = pm.train_epoch_gather(cfg, tx, p, s, tx.init(p), mirror.states,
                                mirror.pis, mirror.zs, torch.from_numpy(idx),
                                mirror.inv_scales)
    for a, b in zip(host[0].values(), dev[0].values()):
        assert torch.equal(a, b)
    for k in host[3]:
        assert torch.equal(host[3][k], dev[3][k])
