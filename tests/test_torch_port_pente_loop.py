"""The training loop and its CLI on Pente with capture planes and in
continuous self-play, on the CPU at tiny sizes, as
``tests/test_capture_planes.py`` and ``tests/test_train_loop.py`` drive the
JAX loop: one iteration in each of Pente with planes, continuous mode, and
both; the int8 calibration boards of a 5-plane run (zero capture planes
appended, as the JAX loop's ``_calib_states`` does); a Pente snapshot that
crosses to the JAX package and back; and the refusal of nets whose input
planes differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu.games.pente import PenteEnv as JaxPente
from alphazero_gomoku_tpu.models import AZModel as JaxModel
from alphazero_gomoku_tpu.models.resnet import NetConfig as JaxNetConfig
from alphazero_gomoku_tpu.ops import int8_net as jq
from alphazero_gomoku_tpu.selfplay import runner as jrun
from alphazero_gomoku_tpu_torch.cli import train as pcli
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import NetConfig
from alphazero_gomoku_tpu_torch.models.model import AZModel
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import (
    SelfPlayConfig,
    collect_examples,
    evaluate_params_detailed,
    play_games,
    train_alphazero,
)
from alphazero_gomoku_tpu_torch.selfplay import loop as ploop
from alphazero_gomoku_tpu_torch.selfplay.buffer import ReplayBuffer
from alphazero_gomoku_tpu_torch.selfplay.runner import encode_board_np

from test_torch_port_train_loop import KEYS, SIZE, _common
from torch_port_util import TableEval, one_torch_thread  # noqa: F401


def _pente(tmp_path, **kw):
    return _common(tmp_path, game_name="pente", pente_capture_planes=True,
                   **kw)


def test_pente_with_capture_planes_trains_and_snapshots(tmp_path):
    """Lockstep Pente, capture planes, int8t search: the buffer holds 5
    planes, the snapshot is a 5-plane net, and the arena plays Pente."""
    hist = train_alphazero(num_iterations=1, **_pente(
        tmp_path, inference="int8t", selfplay_max_moves=12))
    h = hist[0]
    assert KEYS <= set(h) and h["loss"] is not None and h["moves"] > 0
    assert h["arena_pairs"]["n"] == 1
    model = AZModel.from_checkpoint(h["snapshot"], device="cpu")
    assert model.cfg.in_channels == 5
    buf = np.load(str(tmp_path / "models" / "replay_buffer_latest.npz"))
    assert buf["states"].shape[-1] == 5


def test_continuous_mode_trains(tmp_path):
    """Continuous Gomoku self-play: ``selfplay_steps`` plies of every lane
    are the iteration's moves, the PCR note reads the ``recorded`` plies."""
    steps, games = 14, 4
    hist = train_alphazero(num_iterations=2, **_common(
        tmp_path, selfplay_mode="continuous", selfplay_steps=steps,
        selfplay_max_moves=6, pcr_cheap_sims=2, pcr_full_prob=0.5,
        games_per_iteration=games, batch_size=32, eval_every=2))
    assert [h["moves"] for h in hist] == [steps * games] * 2
    assert hist[0]["win_rate"] is None and hist[1]["win_rate"] is not None
    assert hist[1]["buffer_size"] > hist[0]["buffer_size"] > 0


def test_pente_continuous_int8t_trains_and_logs(tmp_path, capsys):
    """Both at once, on the int8 tower (the recipe of ``chip_smoke.py``'s
    phase 24b, cut to size); the loop's log."""
    hist = train_alphazero(num_iterations=1, **_pente(
        tmp_path, selfplay_mode="continuous", selfplay_steps=12,
        selfplay_max_moves=5, inference="int8t", mcts_search="gumbel",
        n_simulations=8, gumbel_max_considered=4, eval_every=2,
        verbose=True, batch_size=32))
    out = capsys.readouterr().out
    assert hist[0]["moves"] == 12 * 4 and hist[0]["loss"] is not None
    assert "self-play done" in out and "WARNING" not in out


def test_continuous_warns_when_no_game_finished(tmp_path, capsys):
    hist = train_alphazero(num_iterations=1, **_common(
        tmp_path, selfplay_mode="continuous", selfplay_steps=3,
        eval_every=2, verbose=True))
    out = capsys.readouterr().out
    assert "no game finished within 3 plies" in out
    assert hist[0]["buffer_size"] == 0 and hist[0]["loss"] is None


def test_calibration_boards_get_zero_capture_planes():
    """Repair of the loop's int8 calibration: while the buffer is short, the
    random-play Pente boards (3 planes) get the two capture planes as zeros,
    so the bundle's observation scales are the JAX loop's."""
    env = make_env("pente", SIZE, capture_planes=True)
    model = AZModel(board_size=SIZE, n_res_blocks=1, channels=8,
                    in_channels=5, device="cpu")
    buffer = ReplayBuffer(capacity=100, board_size=SIZE, channels=5,
                          channel_scales=env.obs_plane_scales)
    timer = ploop.PhaseTimer(torch.device("cpu"))
    _, search_bundle = ploop._search_bundles("int8", env, 0, buffer, timer,
                                             "cpu")
    q = search_bundle(model)
    jcfg = JaxNetConfig(board_size=SIZE, action_size=SIZE * SIZE,
                        n_res_blocks=1, channels=8, in_channels=5)
    obs = jq.random_play_calib_obs(jcfg, game="pente", n=256)
    np.testing.assert_array_equal(
        q8.random_play_calib_obs(model.cfg, game="pente", n=256), obs)
    obs = np.concatenate([obs, np.zeros(obs.shape[:-1] + (2,), obs.dtype)],
                         axis=-1)
    want = jq.quantize_int8(jcfg, *model.jax_params(), obs)
    np.testing.assert_array_equal(q["inv_obs"].numpy(),
                                  np.asarray(want["inv_obs"]))
    assert q["inv_obs"].shape == (5,)


def test_pente_snapshot_crosses_to_jax_and_back(tmp_path):
    hist = train_alphazero(num_iterations=1, **_pente(
        tmp_path, eval_every=2, selfplay_max_moves=8))
    snap = hist[0]["snapshot"]
    pm = AZModel.from_checkpoint(snap, device="cpu")
    jm = JaxModel.from_checkpoint(snap)
    assert jm.cfg.in_channels == 5
    params, stats = pm.jax_params()
    for got, want in ((jax.device_get(jm.params), params),
                      (jax.device_get(jm.batch_stats), stats)):
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    back = str(tmp_path / "jax.ckpt")
    jm.save(back)
    again = AZModel.from_checkpoint(back, device="cpu")
    assert again.cfg.in_channels == 5
    for k in pm.params:
        assert torch.equal(again.params[k], pm.params[k]), k


def test_nets_of_other_input_planes_are_refused(tmp_path):
    """A 3-plane Gomoku net does not load into a Pente run with capture
    planes, and an arena between a 3-plane and a 5-plane net is refused
    (P3)."""
    gomoku = AZModel(board_size=SIZE, n_res_blocks=1, channels=8,
                     device="cpu")
    path = str(tmp_path / "gomoku.ckpt")
    gomoku.save(path)
    with pytest.raises(ValueError, match="in_channels"):
        train_alphazero(num_iterations=1, **_pente(
            tmp_path, pretrained_model_path=path))
    env = make_env("pente", SIZE, capture_planes=True)
    cfgs = (NetConfig(board_size=SIZE, action_size=SIZE * SIZE,
                      in_channels=5),
            NetConfig(board_size=SIZE, action_size=SIZE * SIZE))
    with pytest.raises(ValueError, match="in_channels 5 and 3"):
        evaluate_params_detailed(env, MCTSConfig(n_simulations=4), None,
                                 None, None, 2, 0, device="cpu",
                                 net_cfgs=cfgs)


def test_cli_runs_pente_in_continuous_mode(tmp_path, capsys):
    assert pcli.main([
        "--game", "pente", "--pente-capture-planes", "--selfplay-mode",
        "continuous", "--selfplay-steps", "10", "--selfplay-max-moves", "6",
        "--board-size", str(SIZE), "--num-iterations", "1",
        "--games-per-iteration", "2", "--n-simulations", "4",
        "--batch-size", "16", "--epochs-per-iter", "1", "--eval-games", "2",
        "--eval-mcts-simulations", "4", "--n-res-blocks", "1",
        "--channels", "8", "--model-dir", str(tmp_path / "cli"),
        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "=== ITER 1/1" in out and "training complete" in out
    model = AZModel.from_checkpoint(str(tmp_path / "cli" /
                                        "best_latest.ckpt"), device="cpu")
    assert model.cfg.in_channels == 5


def test_lockstep_pente_records_captures_and_collects_as_jax():
    """Lockstep Pente self-play records the captured pairs before each move
    (JAX's ``step`` on the port's moves gives the next boards and captures),
    and ``collect_examples`` with capture planes, and ``encode_board_np``
    with captures, equal the JAX functions on the same arrays."""
    size, batch, moves = 7, 8, 40
    env = make_env("pente", size, capture_planes=True)
    jenv = JaxPente(size, capture_planes=True)
    cfg = SelfPlayConfig(batch_games=batch, max_moves=moves, temp_threshold=6,
                         mcts=MCTSConfig(n_simulations=6, add_noise=False))
    traj = play_games(env, cfg, TableEval(size, seed=9).torch, None,
                      torch.Generator().manual_seed(9), device="cpu")
    played = int(traj.moves_played.max())
    caps = traj.captures.numpy()
    assert caps.any()
    step = jax.jit(jax.vmap(jenv.step_safe))
    js = jenv.init_batch(batch)
    for t in range(played):
        np.testing.assert_array_equal(np.asarray(js.board),
                                      traj.boards[t].numpy())
        np.testing.assert_array_equal(np.asarray(js.captures), caps[t])
        js = step(js, jnp.asarray(traj.actions[t].numpy()))
    np.testing.assert_array_equal(np.asarray(js.winner),
                                  traj.winners.numpy())
    jt = jrun.Trajectories(**{k: v.numpy() for k, v in traj._asdict().items()
                              if k != "actions"})
    for sym in (False, True):
        got = collect_examples(traj, sym, 0.3, capture_planes=True)
        want = jrun.collect_examples(jt, sym, 0.3, capture_planes=True)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3] and got[0].shape[-1] == 5
    flat = (traj.boards.numpy().reshape(-1, size, size),
            traj.players.numpy().reshape(-1), caps.reshape(-1, 2))
    np.testing.assert_array_equal(encode_board_np(*flat),
                                  jrun.encode_board_np(*flat))
