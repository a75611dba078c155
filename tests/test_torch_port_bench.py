"""The port's bench (``alphazero_gomoku_tpu_torch/bench.py``) against the JAX
repo's root ``bench.py``, on the CPU at tiny sizes.

The accounting is held to ``bench.py``'s: the same FLOPs a leaf evaluation,
the same keys in every result, moves counted as ``sum(min(moves_played,
measure_moves))`` and the value the best repeat.  The one difference is P2
(ROADMAP Queue C): the network's TFLOP/s count one leaf evaluation a
simulation, where ``bench.py:208`` multiplies by ``leaves_per_sim`` too.
The port's bench writes no ``BASELINE.json``.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from alphazero_gomoku_tpu_torch import bench

from torch_port_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(board_size=9, n_res_blocks=1, channels=8, batch_games=4,
            n_simulations=4, measure_moves=2, repeats=2)


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_training(monkeypatch, channels=8):
    """``bench_training_iteration``'s loop on a 7x7 board and a 1-block
    net (its sizes are config #5's, 15x15 and 6x128)."""
    import alphazero_gomoku_tpu_torch.selfplay as selfplay
    real = selfplay.train_alphazero

    def train(**kw):
        return real(**{**kw, "board_size": 7, "n_res_blocks": 1,
                       "channels": channels})

    monkeypatch.setattr(selfplay, "train_alphazero", train)


def _keys(result):
    return set(result), set(result["detail"])


@pytest.mark.parametrize("size,blocks,channels,cin", [
    (15, 6, 128, 3), (15, 6, 128, 5), (9, 2, 64, 3)])
def test_net_flops_per_eval_equals_bench_py(jax_bench, size, blocks,
                                            channels, cin):
    assert bench.net_flops_per_eval(size, blocks, channels, cin) == \
        jax_bench.net_flops_per_eval(size, blocks, channels, cin)


def test_kleaf_tflops_are_a_quarter_of_bench_pys(jax_bench):
    """P2: at k=4 ``bench.py:208`` counts four leaf evaluations a
    simulation; a k-leaf search makes n/k network calls of k leaves, one
    evaluation a simulation."""
    flops = jax_bench.net_flops_per_eval(15, 6, 128)
    value, sims, k = 137.5, 400, 4
    theirs = value * sims * k * flops / 1e12          # bench.py:208
    assert bench.nn_tflops_per_sec(value, sims, flops) == \
        pytest.approx(theirs / 4, rel=1e-12)


def test_cpu_run_bench_keys_and_counting(jax_bench, monkeypatch):
    monkeypatch.setattr(jax_bench, "_quiesce", lambda *a, **k: (0.0, 0.0))
    want = jax_bench.run_bench(**TINY)
    got = bench.run_bench(**TINY, quiesce_max_wait=0, device="cpu")
    assert _keys(got) == _keys(want)
    d = got["detail"]
    assert d["moves"] == TINY["batch_games"] * TINY["measure_moves"] == \
        want["detail"]["moves"]
    assert len(d["runs_moves_per_sec"]) == TINY["repeats"]
    assert got["value"] == max(d["runs_moves_per_sec"])
    assert got["unit"] == want["unit"] == "moves/sec"
    assert got["metric"].startswith(want["metric"].rsplit(",", 1)[0])
    # on the CPU the device metrics are not measured
    assert d["device"] == "cpu" and d["mfu_pct"] is None
    assert d["nn_tflops_per_sec"] is None


@pytest.mark.parametrize("kw", [
    dict(infer="int8t", channels=32, leaves_per_sim=2),
    dict(infer="int8t", channels=32, search="gumbel", game="pente"),
    dict(infer="bf16", search="gumbel", gumbel_parallel=True)])
def test_cpu_run_bench_other_paths(kw):
    got = bench.run_bench(**{**TINY, **kw}, quiesce_max_wait=0,
                          device="cpu")
    assert got["detail"]["moves"] == TINY["batch_games"] * \
        TINY["measure_moves"]
    assert got["detail"]["inference"] == kw["infer"]


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (bench.run_bench, bench.bench_training_iteration,
               bench.run_all):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--all"])


def test_bench_pure_mcts_has_bench_pys_keys(jax_bench):
    kw = dict(n_playout=8, board_size=9, min_seconds=0.0, min_games=1,
              max_moves_per_game=2)
    got, want = bench.bench_pure_mcts(**kw), jax_bench.bench_pure_mcts(**kw)
    assert _keys(got) == _keys(want)
    assert got["detail"]["moves"] == 2 and got["detail"]["games"] == 1


def test_bench_training_iteration_has_bench_pys_keys(jax_bench,
                                                     monkeypatch):
    """The JAX function's keys from its own code, on a history stub (its
    sizes are fixed at 15x15 6x128); the port's on a tiny real run."""
    import alphazero_gomoku_tpu.selfplay as jselfplay
    it = {"selfplay_seconds": 1.0, "train_seconds": 2.0, "eval_seconds": 3.0,
          "moves": 10, "buffer_size": 80}
    monkeypatch.setattr(jselfplay, "train_alphazero",
                        lambda **kw: [it, it])
    want = jax_bench.bench_training_iteration(games=2, n_simulations=4,
                                              eval_games=2)
    tiny_training(monkeypatch)
    got = bench.bench_training_iteration(
        games=2, n_simulations=4, eval_games=2, inference="f32",
        device="cpu")
    theirs_top, theirs_detail = _keys(want)
    mine_top, mine_detail = _keys(got)
    assert mine_top == theirs_top
    assert theirs_detail <= mine_detail
    d = got["detail"]
    assert got["value"] == pytest.approx(
        d["selfplay_seconds"] + d["train_seconds"] + d["eval_seconds"],
        abs=0.02)
    assert d["selfplay_moves"] > 0 and d["buffer_size"] > 0


def test_run_all_writes_only_out(monkeypatch, tmp_path, capsys):
    """Six lines, ``--out`` written, ``BASELINE.json`` byte for byte."""
    baseline = ROOT / "BASELINE.json"
    before = baseline.read_bytes()
    real_run, real_pure, real_train = (bench.run_bench, bench.bench_pure_mcts,
                                       bench.bench_training_iteration)

    def tiny_run(**kw):
        return real_run(**{**kw, **TINY, "batch_games": min(
            kw.get("batch_games", 4), 4), "channels": 32,
            "quiesce_max_wait": 0})

    monkeypatch.setattr(bench, "run_bench", tiny_run)
    monkeypatch.setattr(bench, "bench_pure_mcts", lambda: real_pure(
        n_playout=8, board_size=9, min_seconds=0.0, min_games=1,
        max_moves_per_game=2))
    tiny_training(monkeypatch, channels=32)
    monkeypatch.setattr(bench, "bench_training_iteration",
                        lambda device: real_train(
                            games=2, n_simulations=4, eval_games=2,
                            device=device))
    monkeypatch.chdir(ROOT)
    out = tmp_path / "results.json"
    results = bench.run_all(str(out), device="cpu")
    assert baseline.read_bytes() == before
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(results) == len(lines) == 6
    assert [r["metric"] for r in results.values()] == \
        [r["metric"] for r in lines]
    written = json.loads(out.read_text())
    assert set(written) == {"date", "device", "results"}
    assert written["device"] == "cpu" and written["results"] == results
    assert results["6_gumbel_equal_strength"]["detail"]["search"] == "gumbel"
    assert results["3_full_net_batched"]["detail"]["inference"] == "int8t"


def test_cli_prints_one_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_quiesce", lambda **kw: (0.0, 0.0))
    assert bench.main(["--batch", "2", "--sims", "4", "--moves", "2",
                       "--blocks", "1", "--channels", "32", "--kleaf", "2"],
                      device="cpu") == 0
    [line] = capsys.readouterr().out.strip().splitlines()
    r = json.loads(line)
    assert r["detail"]["inference"] == "int8t"      # the CLI's default
    assert r["detail"]["moves"] == 4 and r["detail"]["leaves_per_sim"] == 2
