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
