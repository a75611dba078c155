"""A whole run of ``benchmark.run`` at a small size: on the CPU (the look
for a card skipped), with the timed path sound and with it broken, the
control, and the refusals.  ``-m cuda`` holds the same small run on a
card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import control, run, spec
from benchmark.spec import HERE, ROOT
from benchmark.tests import tiny

ARGS = ["--workload", "tiny", "--seed", str(2 ** 31 + 12345),
        "--seconds", "0.3", "--trace", "0"]


def _result(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


CASES = [("gomoku", "puct", 0), ("gomoku", "gumbel", 4),
         ("pente", "gumbel", 4), ("pente", "puct", 0)]


@pytest.mark.parametrize("game,search,reuse", CASES)
def test_sound_run_is_correct(tmp_path, capsys, game, search, reuse):
    root = tiny.make_root(tmp_path, game=game, search=search, reuse=reuse)
    assert run.main(ARGS, device="cpu", root=root) == 0
    out = _result(capsys)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"selfplay_moves_per_s", "setup_s"}
    assert out["metrics"]["selfplay_moves_per_s"]["value"] > 0
    assert out["attempted"] % 8 == 0
    for k, v in out["checks"].items():
        assert v["value"] <= v["limit"], k


def test_card_time_cell_is_correct_with_a_game_pool(tmp_path, capsys):
    """A cell like the Pente one: its calls come from a game pool, which
    the check seeds alike; its end-to-end metric besides set-up is read
    from the card's profile, so that on the CPU set-up alone is left."""
    root = tiny.make_root(tmp_path, game="pente", search="gumbel", reuse=4,
                          like="pente-gumbel64-reuse48-b128", game_pool=3)
    assert {m["name"] for m in spec.cell("tiny", root)["end_to_end"]} == {
        "setup_s", run.CARD_TIME}
    assert run.main(ARGS, device="cpu", root=root) == 0
    out = _result(capsys)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"setup_s"}


def test_game_pool_gives_every_seed_the_same_calls():
    tr = {"game_pool": 5}
    a = [run.call_seed(2 ** 31 + 1, i, tr) for i in range(10)]
    b = [run.call_seed(7, i, tr) for i in range(10)]
    assert sorted(a[:5]) == sorted(b[:5]) and len(set(a[:5])) == 5
    assert a[5:] == a[:5] and a != b
    assert run.call_seed(7, 3) == run.call_seed(7, 3, {}) == 7 * 1_000_003 + 3


def test_seeded_weights_run_is_correct(tmp_path, capsys):
    """A configuration whose weights are a ``weights_seed``: the program
    and the reference get the same arrays of ``nets/resnet.py``'s
    ``init``."""
    root = tiny.make_root(tmp_path, weights_seed=2 ** 31 + 7)
    assert "checkpoint" not in spec.config("tiny-net", root)
    assert run.main(ARGS, device="cpu", root=root) == 0
    out = _result(capsys)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    for k, v in out["checks"].items():
        assert v["value"] <= v["limit"], k


def _runner():
    from alphazero_gomoku_tpu_torch.selfplay import runner
    return runner


def _state_unchanged(monkeypatch):
    from alphazero_gomoku_tpu_torch.games import GomokuEnv
    monkeypatch.setattr(GomokuEnv, "step_safe", lambda self, s, a: s)


def _half_batch(monkeypatch):
    runner = _runner()
    search = runner.run_mcts_with_q

    def half(env, cfg, eval_fn, net, states, moves, gen, **kw):
        b = states.done.shape[0]
        h = b // 2
        pi, q = search(env, cfg, eval_fn, net,
                       type(states)(*(x[:h] for x in states)), moves[:h],
                       gen, **kw)
        return (torch.cat([pi, pi.mean(0, keepdim=True).expand(b - h, -1)]),
                torch.cat([q, q.mean().expand(b - h)]))
    monkeypatch.setattr(runner, "run_mcts_with_q", half)


def _move_altered(monkeypatch):
    runner = _runner()
    sample = runner.sample_actions

    def altered(pi, temp, legal, gen, **kw):
        # lane 0 plays another legal point than the one it sampled
        a = sample(pi, temp, legal, gen, **kw).clone()
        other = legal[0].clone()
        other[a[0]] = False
        a[0] = torch.argmax(other.int())
        return a
    monkeypatch.setattr(runner, "sample_actions", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _move_altered])
def test_broken_timed_path_is_not_correct(tmp_path, capsys, monkeypatch,
                                          fault):
    root = tiny.make_root(tmp_path, game="gomoku", search="puct")
    fault(monkeypatch)
    assert run.main(ARGS, device="cpu", root=root) == 0
    out = _result(capsys)
    assert out["correct"] is False


@pytest.mark.parametrize("game,search,reuse", CASES[:3])
def test_int4_control_is_not_correct(tmp_path, game, search, reuse):
    root = tiny.make_root(tmp_path, game=game, search=search, reuse=reuse,
                          lanes=16, plies=8, sims=16)
    cell = spec.cell("tiny", root)
    dev = torch.device("cpu")
    prog, game_, params, stats, calib = run.prepare(cell, dev, root)
    sound = list(control.readings(cell, prog, game_, params, stats, calib,
                                  dev, [3], control=False))
    prog.eval_fn = control.control_eval(cell, params, stats, calib, dev)
    ctl = list(control.readings(cell, prog, game_, params, stats, calib, dev,
                                [3, 4, 5], control=True))
    assert sound[0]["correct_at_limits"] is True
    assert all(r["correct_at_limits"] is False for r in ctl)


F32 = {"precision": "f32", "peak": "f32", "reference_net": {"dtype": "float32"},
       "control_net": {"dtype": "bfloat16"}}


def test_float_configuration_is_files_alone(tmp_path, capsys):
    """A float32 configuration (the program's ``f32`` inference, the
    reference's float32 net, a bfloat16 control) runs from its file."""
    limits = {"game_mismatches": 0, "pi_tv_mean": 1e-5,
              "root_q_gap_mean": 1e-5, "move_mismatch_pct": 0.0}
    root = tiny.make_root(tmp_path, lanes=16, plies=8, sims=16,
                          limits=limits, precision=F32)
    assert run.main(ARGS, device="cpu", root=root) == 0
    out = _result(capsys)
    assert out["correct"] is True, out["checks"]
    cell = spec.cell("tiny", root)
    dev = torch.device("cpu")
    prog, game_, params, stats, calib = run.prepare(cell, dev, root)
    prog.eval_fn = control.control_eval(cell, params, stats, calib, dev)
    ctl = list(control.readings(cell, prog, game_, params, stats, calib, dev,
                                [3, 4], control=True))
    assert all(r["correct_at_limits"] is False for r in ctl), ctl


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "gomoku-puct400-b128", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "gomoku-puct400-b128", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("trace,weights_seed,like", [
    ("0", None, "gomoku-puct400-b128"), ("1", None, "gomoku-puct400-b128"),
    ("0", 2 ** 31 + 7, "gomoku-puct400-b128"),
    ("0", None, "pente-gumbel64-reuse48-b128"),
    ("1", None, "pente-gumbel64-reuse48-b128")])
def test_small_run_on_the_card(tmp_path, capsys, trace, weights_seed, like):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the committed cells' limits: the kernels and the reference's library
    # exp and log may break a near tie apart (PERF.md)
    limits = spec.checks("gomoku-gumbel64-reuse48-b128")["limits"]
    root = tiny.make_root(tmp_path, game="pente", search="gumbel", reuse=4,
                          size=9, lanes=16, plies=8, sims=16, channels=32,
                          limits=limits, weights_seed=weights_seed,
                          like=like)
    args = ARGS[:-1] + [trace]
    assert run.main(args, root=root) == 0
    out = _result(capsys)
    assert out["device"]["platform"] == "gpu"
    assert out["correct"] is True
    if trace == "1":
        assert out["device"]["busy_s"] > 0
        assert "breakdown" in out
        listed = {m["name"] for m in spec.cell("tiny", root)["per_layer"]}
        assert set(out["metrics"]) <= listed
        assert "device_idle_pct." + ("card" if "pente" in like
                                     else "selfplay") in out["metrics"]
    else:
        names = {m["name"] for m in spec.cell("tiny", root)["end_to_end"]}
        assert set(out["metrics"]) == names
        assert all(v["value"] > 0 for v in out["metrics"].values())
