"""The port's tracing and phase timing (``utils/profiling.py``), and the
training loop's and CLI's profiler trace and multi-process flags, which
earlier slices refused.

The JAX package's hooks write an XProf trace; the port's write a
``torch.profiler`` Chrome trace (CPU activities only here: no card).
"""

import json
import time

import pytest
import torch

from alphazero_gomoku_tpu_torch.cli import train as pcli
from alphazero_gomoku_tpu_torch.parallel import distributed as pdist
from alphazero_gomoku_tpu_torch.selfplay import train_alphazero
from alphazero_gomoku_tpu_torch.selfplay import loop as ploop
from alphazero_gomoku_tpu_torch.utils import (
    PhaseTimer,
    start_profiler_trace,
    stop_profiler_trace,
    trace_annotation,
)

import torch_port_ranks as R
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

TINY = ["--board-size", "7", "--num-iterations", "1",
        "--games-per-iteration", "2", "--n-simulations", "4",
        "--batch-size", "16", "--epochs-per-iter", "1", "--eval-games", "2",
        "--eval-mcts-simulations", "4", "--n-res-blocks", "1",
        "--channels", "8", "--device", "cpu"]


def _trace_names(trace_dir):
    files = sorted(trace_dir.glob("trace_*.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e.get("name") for e in events}


def test_phase_timer_accumulates():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            time.sleep(0.01)
    with timer.phase("b"):
        pass
    assert timer.counts == {"a": 2, "b": 1}
    assert timer.totals["a"] >= 0.02 and timer.last["a"] >= 0.01
    summary = timer.summary()
    assert summary["a"]["count"] == 2
    assert summary["a"]["mean_s"] == round(timer.totals["a"] / 2, 3)
    # the loop's timer is this one (a CPU device: no synchronise)
    assert ploop.PhaseTimer is PhaseTimer
    assert PhaseTimer(torch.device("cpu")).device.type == "cpu"


def test_trace_annotation_names_a_region(tmp_path):
    start_profiler_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        start_profiler_trace(str(tmp_path))
    with trace_annotation("az_region"):
        torch.ones(4).sum()
    path = stop_profiler_trace()
    assert path.startswith(str(tmp_path))
    assert "az_region" in _trace_names(tmp_path)
    with pytest.raises(RuntimeError, match="no profiler trace"):
        stop_profiler_trace()


def test_train_loop_writes_a_trace(tmp_path):
    """One iteration: it is the one traced, its phases named regions."""
    hist = train_alphazero(board_size=7, num_iterations=1,
                           games_per_iteration=2, n_simulations=4,
                           batch_size=16, epochs_per_iter=1, eval_games=2,
                           eval_mcts_simulations=4, n_res_blocks=1,
                           channels=8, verbose=False,
                           model_dir=str(tmp_path / "m"), device="cpu",
                           profile_trace_dir=str(tmp_path / "trace"))
    assert hist[0]["loss"] is not None
    names = _trace_names(tmp_path / "trace")
    assert {"selfplay", "train", "arena"} <= names


def test_cli_takes_the_profiler_and_process_group_flags(tmp_path,
                                                        monkeypatch):
    """``--profile-trace-dir`` writes a trace; ``--coordinator-address``
    with ``--num-processes`` and ``--process-id`` joins a process group
    (of one rank here) before the loop."""
    monkeypatch.setattr(pdist, "_rank_device", None)
    try:
        assert pcli.main(TINY + [
            "--eval-every", "2",     # no arena: a shorter trace
            "--model-dir", str(tmp_path / "m"), "--profile-trace-dir",
            str(tmp_path / "trace"), "--coordinator-address",
            f"localhost:{R.free_port()}", "--num-processes", "1",
            "--process-id", "0"]) == 0
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert "selfplay" in _trace_names(tmp_path / "trace")
    assert (tmp_path / "m" / "best_latest.ckpt").exists()


# ----------------------------------------------------------------------
# the program's spans: the move loop's and the searches' az.* regions
# ----------------------------------------------------------------------
SPAN_BOARD, SPAN_LANES, SPAN_PLIES, SPAN_SIMS = 7, 8, 3, 8
SPAN_MODES = {
    "puct": dict(n_simulations=SPAN_SIMS),
    "kleaf": dict(n_simulations=SPAN_SIMS, leaves_per_sim=2),
    "gumbel": dict(n_simulations=SPAN_SIMS, search="gumbel",
                   gumbel_max_considered=4),
    "gumbel_round_parallel": dict(n_simulations=SPAN_SIMS, search="gumbel",
                                  gumbel_max_considered=4,
                                  gumbel_round_parallel=True),
    "gumbel_reuse": dict(n_simulations=SPAN_SIMS, search="gumbel",
                         gumbel_max_considered=4, reuse_budget=4),
}


def _span_setup(mode):
    from alphazero_gomoku_tpu_torch.games import make_env
    from alphazero_gomoku_tpu_torch.models import make_inference
    from alphazero_gomoku_tpu_torch.models.resnet import (
        NetConfig,
        init_params,
    )
    from alphazero_gomoku_tpu_torch.search import MCTSConfig
    from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig

    env = make_env("gomoku", SPAN_BOARD)
    net_cfg = NetConfig(board_size=SPAN_BOARD, action_size=SPAN_BOARD ** 2,
                        n_res_blocks=1, channels=8)
    eval_fn, bundle = make_inference("f32", net_cfg,
                                     *init_params(net_cfg, 3), device="cpu")
    cfg = SelfPlayConfig(batch_games=SPAN_LANES,
                         mcts=MCTSConfig(**SPAN_MODES[mode]),
                         temp_threshold=2, max_moves=SPAN_PLIES,
                         opening_random_moves=1)
    return env, cfg, eval_fn, bundle


def _play(env, cfg, eval_fn, bundle, seed=11):
    from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
    from alphazero_gomoku_tpu_torch.selfplay import play_games
    gen = torch.Generator().manual_seed(seed)
    return play_games(env, cfg, eval_fn, bundle, gen, "cpu", ops=tk.PLAIN)


def _steps_a_ply(mcts):
    """The spans a ply's search opens, by name: a step is a walk call (a
    simulation, a k-leaf leaf, a round-parallel round)."""
    from alphazero_gomoku_tpu_torch.search.gumbel import halving_schedule
    n = mcts.n_simulations
    if mcts.search == "puct":
        k = mcts.leaves_per_sim
        evals = n // k
        return {"az.root": 1, "az.walk": n, "az.expand": n,
                "az.eval": evals, "az.backup": n + (evals if k > 1 else 0),
                "az.net": 1 + evals, "az.halve": 0}
    _, phases = halving_schedule(n, mcts.gumbel_max_considered)
    steps = sum(v if mcts.gumbel_round_parallel else m_k * v
                for m_k, v in phases)
    return {"az.root": 1, "az.walk": steps, "az.expand": steps,
            "az.eval": steps, "az.backup": steps, "az.net": 1 + steps,
            "az.halve": len(phases)}


class _StepProbe:
    """The env with ``step_safe`` inside a ``probe.step`` range."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step_safe(self, states, actions):
        with torch.profiler.record_function("probe.step"):
            return self._env.step_safe(states, actions)


def test_spans_cost_no_record_function_without_a_profiler(monkeypatch):
    """(a) With no profiler running, the self-play path (both move loops,
    every search's steps) enters no ``record_function``; under one it
    does, through the same patched name."""
    from alphazero_gomoku_tpu_torch.selfplay import play_games_continuous
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for mode in ("kleaf", "gumbel_reuse"):
        _play(*_span_setup(mode))
    env, cfg, eval_fn, bundle = _span_setup("puct")
    play_games_continuous(env, cfg, eval_fn, bundle,
                          torch.Generator().manual_seed(2), 2, device="cpu")
    with trace_annotation("az.region"):
        pass
    assert calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _play(env, cfg, eval_fn, bundle)
    assert calls.count("az.head") == SPAN_PLIES
    assert "az.walk" in calls


@pytest.mark.parametrize("mode", sorted(SPAN_MODES))
def test_profiled_play_records_every_span(mode):
    """(b) Under the profiler every ply records its move-loop spans, and its
    search the spans of each of its steps; reuse re-roots once a ply inside
    ``az.advance_root``; no span encloses the env's ``step_safe``, and each
    search step's span lies inside an ``az.search``."""
    env, cfg, eval_fn, bundle = _span_setup(mode)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traj = _play(_StepProbe(env), cfg, eval_fn, bundle)
    assert int(traj.moves_played.min()) == SPAN_PLIES     # no game ended
    events = [e for e in prof.events()
              if e.name.startswith(("az.", "probe."))]
    counts = {}
    for e in events:
        counts[e.name] = counts.get(e.name, 0) + 1
    want = {name: SPAN_PLIES * n
            for name, n in _steps_a_ply(cfg.mcts).items() if n}
    reuse = cfg.mcts.reuse_budget > 0
    want.update({"az.head": SPAN_PLIES, "az.search": SPAN_PLIES,
                 "az.move": SPAN_PLIES, "probe.step": SPAN_PLIES})
    if reuse:
        want["az.advance_root"] = SPAN_PLIES
    assert counts == want

    def within(inner, outer):
        return (outer.time_range.start <= inner.time_range.start
                and inner.time_range.end <= outer.time_range.end)

    outer = [e for e in events if e.name == "az.search"]
    step_spans = [e for e in events if e.name.startswith("az.")
                  and e.name not in ("az.head", "az.search", "az.move",
                                     "az.advance_root")]
    assert all(any(within(e, o) for o in outer) for e in step_spans)
    steps = [e for e in events if e.name == "probe.step"]
    assert not any(within(s, e) for s in steps for e in events
                   if e.name.startswith("az."))


@pytest.mark.parametrize("mode", sorted(SPAN_MODES))
def test_profiler_leaves_the_games_as_they_were(mode):
    """(c) The same seed gives the same trajectories, bit for bit, with the
    profiler recording the spans and without it."""
    setup = _span_setup(mode)
    plain = _play(*setup)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _play(*setup)
    for name, a, b in zip(plain._fields, plain, traced):
        assert torch.equal(a, b), name
