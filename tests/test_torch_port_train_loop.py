"""The port's training loop (``selfplay/loop.train_alphazero``) and its CLI
(``cli/train.py``), on the CPU at tiny sizes, as
``tests/test_train_loop.py:121-163`` drives the JAX one: two iterations and
a resume, then the Gumbel-with-reuse and ``int8t`` variants, the arena
cadence, every refusal, and the CLI's flags against the JAX CLI's.

The loop's search is the packed tree whatever ``mcts_backend`` says; the
last test holds it against the JAX package's XLA search (``backend="xla"``)
on the loop's own PUCT config, with an eval function both frameworks
compute bit for bit and the JAX root noise injected: pi equal exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu.cli import train as jcli
from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree import run_mcts_with_q as jax_search
from alphazero_gomoku_tpu.search.tree import symmetric_dirichlet
from alphazero_gomoku_tpu_torch.cli import train as pcli
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.models import checkpoint as ckpt
from alphazero_gomoku_tpu_torch.models.model import AZModel
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_mcts_with_q
from alphazero_gomoku_tpu_torch.selfplay import train_alphazero
from alphazero_gomoku_tpu_torch.selfplay import loop as ploop

from torch_port_util import (  # noqa: F401  (one_torch_thread: autouse)
    TableEval,
    one_torch_thread,
    random_jax_states,
    to_torch_state,
)

SIZE = 7
KEYS = {"iteration", "winners", "moves", "selfplay_seconds", "eval_seconds",
        "train_seconds", "loss", "win_rate", "win_rate_ci95", "arena_pairs",
        "anchor", "draws", "accepted", "buffer_size", "snapshot"}


def _common(tmp_path, **kw):
    common = dict(game_name="gomoku", board_size=SIZE, games_per_iteration=4,
                  n_simulations=8, buffer_size=4000, batch_size=64,
                  epochs_per_iter=1, temp_threshold=4, eval_games=2,
                  eval_mcts_simulations=8, win_rate_threshold=0.55,
                  n_res_blocks=1, channels=8,
                  model_dir=str(tmp_path / "models"), seed=0, verbose=False,
                  device="cpu")
    common.update(kw)
    return common


def test_train_loop_end_to_end(tmp_path):
    common = _common(tmp_path)
    hist = train_alphazero(num_iterations=2, **common)
    assert len(hist) == 2
    for h in hist:
        assert KEYS <= set(h)
        assert h["moves"] > 0
        assert 0.0 <= h["win_rate"] <= 1.0
        assert h["buffer_size"] > 0
        assert os.path.exists(h["snapshot"])
        assert h["phase_seconds"]["selfplay"] > 0
    model_dir = common["model_dir"]
    assert os.path.exists(os.path.join(model_dir, "replay_buffer_latest.npz"))
    assert os.path.exists(os.path.join(model_dir, "best_latest.ckpt"))
    assert hist[-1]["loss"] is not None
    assert np.isfinite(hist[-1]["loss"]["total_loss"])
    # the snapshot is an AZTPU1 checkpoint with Adam's count of the steps
    state, meta = ckpt.load_checkpoint(hist[-1]["snapshot"])
    assert meta["channels"] == 8
    assert int(state["opt_state"]["2"]["count"]) > 0

    snap = hist[-1]["snapshot"]
    hist2 = train_alphazero(num_iterations=1, pretrained_model_path=snap,
                            candidate_model_path=snap,
                            next_iteration_continuation=3, **common)
    assert hist2[0]["iteration"] == 3
    assert hist2[0]["buffer_size"] >= hist[-1]["buffer_size"]


def test_train_loop_gumbel_reuse_int8t_track(tmp_path):
    """The shipped recipe's shape at a tiny size: Gumbel with subtree reuse
    on the int8 tower (its plain version here), track gate, every arena
    skipped but the second."""
    hist = train_alphazero(num_iterations=2, **_common(
        tmp_path, games_per_iteration=8, mcts_search="gumbel",
        gumbel_max_considered=4, mcts_reuse_budget=6, mcts_backend="pallas",
        inference="int8t", gate_mode="track", eval_every=2,
        anchor_arena_every=2, selfplay_max_moves=20,
        opening_random_moves=2))
    assert hist[0]["win_rate"] is None and hist[0]["accepted"] is False
    assert hist[0]["eval_seconds"] == 0.0
    assert hist[1]["win_rate"] is not None
    assert hist[1]["anchor"] is not None
    assert hist[1]["phase_seconds"]["quantize"] > 0
    for h in hist:
        assert h["loss"] is not None


def test_train_loop_kleaf_pcr_and_value_mix(tmp_path):
    hist = train_alphazero(num_iterations=1, **_common(
        tmp_path, mcts_leaves_per_sim=4, value_target_mix=0.5,
        inference="bf16", batch_size=32))
    assert hist[0]["loss"] is not None
    hist = train_alphazero(num_iterations=1, **_common(
        tmp_path, pcr_cheap_sims=2, pcr_full_prob=0.5, inference="int8",
        model_dir=str(tmp_path / "pcr"), gate_stat="win_rate"))
    assert hist[0]["moves"] > 0


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=object()), "DataMesh"),
    (dict(replay_sharding="per_host"), "requires a device mesh"),
    (dict(selfplay_mode="continuous", mesh=object()), "DataMesh"),
    (dict(game_name="pente", replay_sharding="per_host"),
     "requires a device mesh"),
    (dict(mesh="all"), "DataMesh"),
])
def test_train_loop_refusals_name_their_item(tmp_path, kw, match):
    """What the loop still refuses, as the JAX loop does: a mesh that is
    not one (the mesh path itself is ``tests/test_torch_port_parallel.py``
    and ``_multiprocess.py``), and per-host replay without a mesh."""
    with pytest.raises((TypeError, ValueError), match=match):
        train_alphazero(num_iterations=1, **_common(tmp_path, **kw))


@pytest.mark.parametrize("kw", [dict(gate_mode="keep"),
                                dict(gate_stat="mean"),
                                dict(pente_capture_planes=True),
                                dict(inference="int4"),
                                dict(mcts_backend="cuda"),
                                dict(anchor_search="mcts")])
def test_train_loop_rejects_unknown_settings(tmp_path, kw):
    with pytest.raises(ValueError):
        train_alphazero(num_iterations=1, **_common(tmp_path, **kw))


def test_cli_takes_the_jax_flags_and_defaults():
    ours = {a.dest: a.default for a in pcli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert set(ours) == set(theirs) | {"device"}
    for k, v in theirs.items():
        assert ours[k] == v, k
    assert ours["device"] is None


def test_cli_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    assert pcli.main([
        "--board-size", "7", "--num-iterations", "1",
        "--games-per-iteration", "2", "--n-simulations", "4",
        "--batch-size", "16", "--epochs-per-iter", "1", "--eval-games", "2",
        "--eval-mcts-simulations", "4", "--n-res-blocks", "1",
        "--channels", "8", "--model-dir", str(tmp_path / "cli"),
        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "=== ITER 1/1" in out and "training complete" in out
    assert AZModel.from_checkpoint(str(tmp_path / "cli" / "best_latest.ckpt"),
                                   device="cpu").cfg.channels == 8
    # --distributed reads torchrun's environment, and says so without it
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        pcli.main(["--distributed", "--device", "cpu"])


def test_shipped_recipe_parses():
    """``TRAINING_GUIDE.md:136-145``'s command line, as the port's CLI reads
    it (the run itself is chip_smoke.py's training phase, cut to size)."""
    args = pcli.build_parser().parse_args([
        "--n-res-blocks", "6", "--channels", "128", "--mcts-search",
        "gumbel", "--n-simulations", "64", "--gumbel-max-considered", "16",
        "--mcts-backend", "pallas", "--mcts-reuse-budget", "48",
        "--inference", "int8t", "--gate-mode", "track"])
    assert (args.n_simulations, args.mcts_reuse_budget, args.inference) == \
        (64, 48, "int8t")


def test_loop_search_equals_jax_xla_search():
    """``mcts_backend`` "xla": the loop's PUCT config (its MCTSConfig at the
    loop's defaults) through the port's packed search equals the JAX
    package's XLA array-tree search in pi."""
    size, a = 9, 81
    te = TableEval(size, seed=3)
    jenv, env = JaxEnv(size), GomokuEnv(size)
    cfg_kw = dict(n_simulations=24, cpuct=1.2, dirichlet_alpha=0.03,
                  dirichlet_epsilon=0.25, dirichlet_moves=30, add_noise=True,
                  max_depth=64, fpu_mode="zero")
    for plies in (0, 6):
        states = random_jax_states(jenv, 6, plies, seed=plies)
        moves = np.full((6,), plies, np.int32)
        key = jax.random.PRNGKey(plies)
        jcfg = JaxMCTSConfig(backend="xla", **cfg_kw)
        pj, _ = jax.jit(lambda s: jax_search(
            jenv, jcfg, te.jax, None, s, jnp.asarray(moves), key))(states)
        _, sub = jax.random.split(key)
        noise = torch.from_numpy(np.array(symmetric_dirichlet(
            sub, cfg_kw["dirichlet_alpha"], (6, a))))
        pt, _ = run_mcts_with_q(env, MCTSConfig(**cfg_kw), te.torch, None,
                                to_torch_state(states),
                                torch.from_numpy(moves), noise=noise)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_phase_timer_counts_phases():
    timer = ploop.PhaseTimer(torch.device("cpu"))
    for _ in range(2):
        with timer.phase("x"):
            pass
    assert timer.summary()["x"]["count"] == 2
