"""The port's data parallelism (``parallel/``) on two gloo ranks on the CPU,
against the JAX package's sharded functions on its 8-device CPU mesh
(``tests/conftest.py``; a 2-device mesh of it here, so that shards match
ranks) and against the port's single-process functions.

One group of two ranks is spawned for the whole file
(``torch_port_ranks.spawn("parallel")``); it runs every check's port side
and saves the results, which the tests hold here:

  - self-play (lockstep, continuous, with subtree reuse): deterministic
    (no root noise, greedy moves) on a table eval indexed by the game's
    global lane, so that the games of a batch differ without a random draw.
    The gathered records equal the JAX ``make_sharded_selfplay`` (or
    ``_continuous``; with reuse on its packed search, in Pallas interpret
    mode) on every active record, bit for bit but the root values (the JAX
    searches sum them in another order: within 1e-6),
    and equal the port's unsharded ``play_games`` bit for bit there; the
    samples ``collect_examples`` takes from them are equal too.  A rank
    stops when its own games are done, so where the other shard plays on
    its rows are zero and inactive;
  - with root noise and temperature sampling, each rank's games are
    ``play_games`` on a generator seeded ``fold_in(seed, rank)`` (rank 0:
    the seed itself), and the ranks' games differ;
  - the train epoch (1x8 net, 7x7, batch 16, 2 steps) against JAX
    ``make_sharded_train_epoch`` and the port's ``train_epoch`` on the whole
    batch, with the tolerances of ``test_torch_port_train_step.py`` (5e-5;
    Adam's sign-chaotic elements 2 lr + 5e-5; statistics and losses 1e-5).
    The two ranks' slices differ in their per-channel statistics and the
    global-norm clip is active, so batch norm over a rank's slice alone, or
    a clip before the average, moves the parameters beyond those
    tolerances;
  - the gather epoch against ``train_epoch_gather``; the arena against
    ``arena_half`` on each rank's games; the buffer lengths; the ranks
    counted on one card.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu import parallel as jpar
from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.models import model as jm
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.selfplay import runner as jrun
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import model as pm
from alphazero_gomoku_tpu_torch.models import resnet as pr
from alphazero_gomoku_tpu_torch.parallel import (
    form_global_batches,
    global_buffer_len,
    initialize_distributed,
    is_primary,
    local_trajectory_shards,
    make_mesh,
    min_local_buffer_len,
)
from alphazero_gomoku_tpu_torch.parallel.distributed import choose_backend
from alphazero_gomoku_tpu_torch.parallel.mesh import fold_in
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import (
    Trajectories,
    collect_examples,
    collect_examples_continuous,
    play_games,
    play_games_continuous,
)
from alphazero_gomoku_tpu_torch.selfplay import runner as prun
from alphazero_gomoku_tpu_torch.selfplay.arena import arena_half

import torch_port_ranks as R
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

LR = pm.DEFAULT_LR
EPS = 1e-8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    results, _ = R.spawn("parallel", 2, tmp_path_factory.mktemp("ranks"))
    return results


# ----------------------------------------------------------------------
# (a) one process
# ----------------------------------------------------------------------
def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1) is False
    assert is_primary() is True
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == (1, 0, None,
                                                                "none")
    with pytest.raises(ValueError, match="one process per card"):
        make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize_distributed(auto=True, device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        initialize_distributed(coordinator_address="localhost:1",
                               num_processes=2, device="cpu")


@pytest.mark.parametrize("local_world,asked,want", [
    (None, None, "nccl"),      # an explicit rendezvous: hosts unknown
    ("8", None, "nccl"),       # torchrun, a card a rank
    ("16", None, "gloo"),      # torchrun, ranks sharing the cards
    (None, "gloo", "gloo"),    # asked for
])
def test_backend_choice(monkeypatch, local_world, asked, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    assert choose_backend(torch.device("cuda", 0), asked) == want
    assert choose_backend(torch.device("cpu")) == "gloo"


def test_fold_in_keeps_rank_zero_on_the_seed():
    assert fold_in(1234, 0) == 1234
    streams = {fold_in(1234, r) for r in range(8)}
    assert len(streams) == 8 and fold_in(1234, 1) == fold_in(1234, 1)
    assert fold_in(1234, 1) != fold_in(1235, 1)


def test_single_process_identities():
    mesh = make_mesh(device="cpu")
    assert global_buffer_len(17) == 17 and min_local_buffer_len(17) == 17
    traj = Trajectories(*(torch.zeros(2) for _ in Trajectories._fields))
    assert local_trajectory_shards(traj) is traj
    xs, pis, zs = R.train_data()
    got = form_global_batches(mesh, xs, pis, zs)
    for g, w in zip(got, (xs, pis, zs)):
        np.testing.assert_array_equal(g.numpy(), w)


# ----------------------------------------------------------------------
# (b) self-play
# ----------------------------------------------------------------------
def _jax_lane_eval(table):
    """``LaneTable`` in JAX, the shard's first lane from its mesh index."""
    def eval_fn(params, obs):
        del params
        n = obs.shape[0]
        lane = jax.lax.axis_index("data") * n + jnp.arange(n)
        f = jnp.sum(obs[..., 0] * table.w1 + obs[..., 1] * table.w2,
                    axis=(1, 2))
        idx = jnp.mod(f + R.LANE_MULT * lane, table.k).astype(jnp.int32)
        return jnp.asarray(table.probs)[idx], jnp.asarray(table.values)[idx]
    return eval_fn


def _jax_greedy(pi, temp, legal, rng):
    del temp, legal, rng
    return jnp.argmax(pi, axis=-1).astype(jnp.int32)


def _jax_sharded(name):
    sp, mc, steps = R.selfplay_cfgs()[name]
    if mc.get("reuse_budget"):  # the JAX package reuses on its packed tree
        mc = dict(mc, backend="pallas")
    cfg = jrun.SelfPlayConfig(mcts=JaxMCTSConfig(**mc), **sp)
    mesh = jpar.make_mesh(2)
    env, eval_fn = JaxEnv(R.SIZE), _jax_lane_eval(R.LaneTable())
    with mock.patch.object(jrun, "sample_actions", _jax_greedy):
        if steps is None:
            fn = jpar.make_sharded_selfplay(env, cfg, eval_fn, mesh)
        else:
            fn = jpar.make_sharded_selfplay_continuous(env, cfg, eval_fn,
                                                       mesh, steps)
        out = jpar.gather_trajectories(fn(None, jax.random.PRNGKey(0)),
                                       mesh)
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _port_unsharded(name):
    cfg, steps = R.port_selfplay_cfg(name)
    env, eval_fn = make_env("gomoku", R.SIZE), R.LaneTable().torch_fn(0)
    gen = torch.Generator().manual_seed(R.SELFPLAY_SEED)
    with mock.patch.object(prun, "sample_actions", R.greedy_actions):
        if steps is None:
            return play_games(env, cfg, eval_fn, None, gen, "cpu")
        return play_games_continuous(env, cfg, eval_fn, None, gen, steps,
                                     "cpu")


def _as_records(arrays, kind):
    return kind(**{k: torch.from_numpy(v) for k, v in arrays.items()
                   if v is not None})


LOCKSTEP_ROWS = ("boards", "players", "pis", "actions", "captures")


def _hold_lockstep(got, want, jax_side):
    active = want["active"]
    np.testing.assert_array_equal(got["active"], active)
    for k in ("winners", "moves_played"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in LOCKSTEP_ROWS:
        if k in want:
            np.testing.assert_array_equal(got[k][active], want[k][active],
                                          err_msg=k)
    if jax_side:  # the XLA search's own float32 order
        np.testing.assert_allclose(got["root_qs"][active],
                                   want["root_qs"][active], atol=1e-6)
    else:
        np.testing.assert_array_equal(got["root_qs"][active],
                                      want["root_qs"][active])


@pytest.mark.parametrize("name", ["lockstep", "reuse"])
def test_sharded_selfplay_equals_unsharded_and_jax(ranks, name):
    got = ranks[0][f"selfplay_{name}"]
    for k, v in got.items():    # every rank holds the gathered batch
        np.testing.assert_array_equal(v, ranks[1][f"selfplay_{name}"][k])
    ref = _port_unsharded(name)
    want = {k: v.numpy() for k, v in ref._asdict().items()}
    _hold_lockstep(got, want, jax_side=False)
    moves = got["moves_played"]
    half = len(moves) // 2
    # the shards end at different plies: where one plays on, the other's
    # rows are zero (the unsharded loop wrote inactive rows there)
    stops = moves[:half].max(), moves[half:].max()
    assert stops[0] != stops[1]
    short = slice(0, half) if stops[0] < stops[1] else slice(half, None)
    assert not got["active"][min(stops):, short].any()
    assert (got["boards"][min(stops):, short] == 0).all()
    assert got["pis"][min(stops):].sum() > 0
    for g, w in zip(collect_examples(_as_records(got, Trajectories))[:3],
                    collect_examples(ref)[:3]):
        np.testing.assert_array_equal(g, w)
    _hold_lockstep(got, _jax_sharded(name), jax_side=True)


def test_sharded_continuous_selfplay_equals_unsharded_and_jax(ranks):
    got = ranks[0]["selfplay_continuous"]
    ref = _port_unsharded("continuous")
    want = {k: v.numpy() for k, v in ref._asdict().items()}
    jax_want = _jax_sharded("continuous")
    for k, v in got.items():
        np.testing.assert_array_equal(v, ranks[1]["selfplay_continuous"][k])
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        if k == "root_qs":
            np.testing.assert_allclose(v, jax_want[k], atol=1e-6)
        elif k in jax_want:
            np.testing.assert_array_equal(v, jax_want[k], err_msg=k)
    assert got["ended"].sum(axis=0).min() >= 1
    records = _as_records(got, type(ref))
    for g, w in zip(collect_examples_continuous(records)[:3],
                    collect_examples_continuous(ref)[:3]):
        np.testing.assert_array_equal(g, w)


def test_sharded_selfplay_rank_streams(ranks):
    """With root noise and temperature sampling: rank r's games are
    ``play_games`` of its share on ``fold_in(seed, r)``'s generator (rank
    0's on the seed's, the unsharded loop's), and the ranks' games differ
    (``tests/test_parallel.py:45-47``)."""
    cfg, _ = R.port_selfplay_cfg("noise")
    shard = dataclasses.replace(cfg, batch_games=cfg.batch_games // 2)
    env = make_env("gomoku", R.SIZE)
    locals_ = []
    for rank in (0, 1):
        gen = torch.Generator().manual_seed(fold_in(R.SELFPLAY_SEED, rank))
        want = play_games(env, shard, R.LaneTable().torch_fn(rank, False),
                          None, gen, "cpu")
        got = ranks[rank]["selfplay_noise_local"]
        for k, v in want._asdict().items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
        gathered = ranks[rank]["selfplay_noise"]
        lanes = slice(rank * shard.batch_games,
                      (rank + 1) * shard.batch_games)
        np.testing.assert_array_equal(gathered["boards"][:, lanes],
                                      got["boards"])
        locals_.append(got)
    assert not np.array_equal(locals_[0]["boards"], locals_[1]["boards"])


# ----------------------------------------------------------------------
# (c) the train epoch, (d) the gather epoch
# ----------------------------------------------------------------------
def _port_model():
    return pm.AZModel(**R.NET, device="cpu")


def _chaotic_bound(mu_got, mu_want):
    """Elements whose Adam input g' (from a fresh state: mu / (1 - b1)) is
    within the two sides' disagreement of zero may move up to 2 lr apart."""
    a = mu_got / (1 - 0.9)
    b = mu_want / (1 - 0.9)
    return np.abs(b) <= np.abs(a - b) + 100 * EPS


def _hold_state(got, want, what):
    """Parameters within 5e-5, or 2 lr + 5e-5 where Adam's step is
    sign-chaotic; statistics, moments and losses within 1e-5."""
    for k, w in want["params"].items():
        g = got["params"][k]
        chaotic = _chaotic_bound(got["mu"][k], want["mu"][k])
        tol = np.where(chaotic, 2 * LR + 5e-5, 5e-5)
        assert (np.abs(g - w) <= tol).all(), (what, k, np.abs(g - w).max())
    for part in ("stats", "mu"):
        for k, w in want[part].items():
            if w.dtype.kind == "f":
                np.testing.assert_allclose(got[part][k], w, atol=1e-5,
                                           err_msg=f"{what} {part} {k}")
    for k, w in want["metrics"].items():
        assert abs(got["metrics"][k] - w) <= 1e-5, (what, k)
    assert got["count"] == want["count"]


def _single_train():
    m = _port_model()
    xs, pis, zs = (torch.from_numpy(a) for a in R.train_data())
    return R.state_numpy(*pm.train_epoch(m.cfg, m.tx, m.params,
                                         m.batch_stats, m.opt_state, xs,
                                         pis, zs))


def _jax_train():
    """JAX ``make_sharded_train_epoch`` from the port's initial weights."""
    m = _port_model()
    params, stats = m.jax_params()
    jmodel = jm.AZModel(board_size=R.SIZE, n_res_blocks=1, channels=8)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, stats)
    epoch = jpar.make_sharded_train_epoch(jmodel.cfg, jmodel.tx,
                                          jpar.make_mesh(2))
    xs, pis, zs = R.train_data()
    p, s, o, metrics = epoch(jp, js, jmodel.tx.init(jp), jnp.asarray(xs),
                             jnp.asarray(pis), jnp.asarray(zs))
    sd = pr.params_from_jax(jax.device_get(p), jax.device_get(s))
    params, stats = pm.split_state(sd)
    adam = o[2]
    opt = pm.AdamState(torch.tensor(int(adam.count)),
                       pr.param_tree_to_torch(jax.device_get(adam.mu)),
                       pr.param_tree_to_torch(jax.device_get(adam.nu)))
    return R.state_numpy(params, stats, opt,
                         {k: torch.tensor(float(v))
                          for k, v in metrics.items()})


def test_sharded_train_epoch_matches_jax_and_single_process(ranks):
    got = ranks[0]["train"]
    for part in ("params", "stats", "mu", "nu"):
        for k, v in got[part].items():  # replicated: bit for bit
            np.testing.assert_array_equal(v, ranks[1]["train"][part][k])
            # local=True on the rank's own slices is the same epoch
            np.testing.assert_array_equal(v, ranks[0]["train_local"][part][k])
    assert got["metrics"] == ranks[1]["train"]["metrics"]
    _hold_state(got, _single_train(), "single-process train_epoch")
    _hold_state(got, _jax_train(), "JAX make_sharded_train_epoch")


def test_train_input_exercises_global_bn_and_the_clip():
    """The input's halves differ in per-channel statistics, and the first
    step's gradient is clipped (global norm above 3) on the whole batch and
    on each half: a per-rank BN or a clip before the average is a
    different step."""
    xs, pis, zs = R.train_data()
    half = R.TRAIN_BATCH // 2
    m0, m1 = xs[0, :half].mean((0, 1, 2)), xs[0, half:].mean((0, 1, 2))
    assert (np.abs(m0 - m1) > 1.0).all()
    m = _port_model()
    for sl in (slice(None), slice(0, half), slice(half, None)):
        grads, _, _ = pm.loss_grads(
            m.cfg, m.params, m.batch_stats, torch.from_numpy(xs[0, sl]),
            torch.from_numpy(pis[0, sl]), torch.from_numpy(zs[0, sl]))
        norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        assert norm > pm.GRAD_CLIP_NORM, (sl, norm)


def test_sharded_gather_epoch_matches_train_epoch_gather(ranks):
    states, pis, zs, idx = R.ring_data()
    m = _port_model()
    want = R.state_numpy(*pm.train_epoch_gather(
        m.cfg, m.tx, m.params, m.batch_stats, m.opt_state,
        torch.from_numpy(states), torch.from_numpy(pis),
        torch.from_numpy(zs), torch.from_numpy(idx), torch.ones(3)))
    for rank in (0, 1):
        _hold_state(ranks[rank]["gather"], want, f"rank {rank}")


# ----------------------------------------------------------------------
# (e) the arena, (f) the buffer lengths
# ----------------------------------------------------------------------
def test_sharded_arena_rounds_up_and_equals_arena_half(ranks):
    env = make_env("gomoku", R.SIZE)
    cfg = MCTSConfig(n_simulations=4, add_noise=False)
    per = -(-R.ARENA_GAMES // 2)
    want = np.concatenate([
        arena_half(env, cfg, R.LaneTable().torch_fn(0), None, None, per,
                   fold_in(R.ARENA_SEED, rank), "cpu").numpy()
        for rank in (0, 1)])
    for rank in (0, 1):
        np.testing.assert_array_equal(ranks[rank]["arena"], want)
    # the JAX sharded arena plays the same count
    table = R.LaneTable()
    jfn = jpar.make_sharded_arena(JaxEnv(R.SIZE),
                                  JaxMCTSConfig(n_simulations=4,
                                                add_noise=False),
                                  _jax_lane_eval(table), jpar.make_mesh(2))
    jw = jfn(None, None, R.ARENA_GAMES, jax.random.PRNGKey(0))
    assert jw.shape == want.shape == (2 * per,)


def test_buffer_lengths_over_unequal_ranks(ranks):
    # ranks hold 10 and 17 samples
    for rank in (0, 1):
        assert ranks[rank]["buffer_len"] == (27, 10)
    assert [r["mesh"] for r in ranks] == [(2, 0, "cpu", "gloo"),
                                          (2, 1, "cpu", "gloo")]


def test_ranks_per_device(ranks):
    # both ranks on card 0 of one host, then each on a card of its own
    assert [r["ranks_per_device"] for r in ranks] == [(2, 1), (2, 1)]
