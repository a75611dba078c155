"""The port's arena tools (``alphazero_gomoku_tpu_torch/tools/``) against the
JAX repo's root ``tools/``, run on the CPU on a 7x7 board.

Each pair of tools gets the same openings: the JAX tool's
``jax.random.randint`` (its two calls a half: rows, then columns) is
replaced by the fixed rows and columns below while it runs, and the port's
tool takes the same actions (``openings=``); the Gumbel tools' root uniforms
are injected the same way (``jax.random.uniform``; ``uniforms=``).  Both
tools' winners are recorded game by game (the JAX halves' jitted functions,
the port's ``sides_half``) and must be equal, and so must the printed JSON
(``win_rate``, ``ci95``, ``draws``, ``pairs`` and the rest).

The search tools evaluate with ``TableEval``, which both frameworks compute
bit for bit, so their searches are equal.  ``int8_ab`` (a 1x32 net: the
int8 tower takes 32, 64 or 128 channels), ``cross_net_arena`` (1x8 against
2x8), ``compare_snapshots`` and ``harvest_run`` run real nets saved as
AZTPU1 checkpoints and read by both packages: the int8 side is bit for bit the same function in both
(``tests/test_torch_port_int8.py``), the float32 side is not (cuDNN-free CPU
convolutions sum in another order than XLA's), so a search there could
split a near tie between visit counts differently
(``tests/test_torch_port_players_net.py`` bounds such searches within two
visits).  On these nets and openings no game parts: winners and JSON are
required equal.
"""

import importlib.util
import json
import random
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alphazero_gomoku_tpu.players.alpha_base as jab
import alphazero_gomoku_tpu.search.pure_mcts as jpure
import alphazero_gomoku_tpu.selfplay.arena as jarena
import alphazero_gomoku_tpu.selfplay.loop as jloop
import alphazero_gomoku_tpu_torch.players.alpha_base as tab
import alphazero_gomoku_tpu_torch.search.pure_mcts as tpure
import alphazero_gomoku_tpu_torch.selfplay.arena as tarena
from alphazero_gomoku_tpu_torch.models import AZModel
from alphazero_gomoku_tpu_torch.tools import (
    ab_arena,
    compare_snapshots,
    cross_net_arena,
    device_parity,
    distill_net,
    gumbel_ab,
    gumbel_determinism_probe,
    gumbel_flip_probe,
    harvest_run,
    hbm_budget,
    int8_ab,
    int8_calib_sensitivity,
    int8_probe,
    kleaf_ab,
    net_microbench,
    policy_entropy_probe,
    reuse_ab,
    search_cost_split,
    strength_probe,
    tactics_probe,
    tree_kernel_microbench,
    tt_rate_probe,
)

from torch_port_util import TableEval, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SIZE = 7
A = SIZE * SIZE
ROWS = np.array([3, 2, 4, 1, 5, 3, 2, 4])
COLS = np.array([3, 4, 2, 3, 1, 5, 2, 4])
OPENINGS = torch.from_numpy(ROWS * SIZE + COLS)


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Recorded:
    """The winners of every half each package played, in order."""

    def __init__(self, monkeypatch, tool):
        self.jax, self.torch = [], []
        path = str(ROOT / "tools" / f"{tool}.py")
        real_jit = jax.jit

        def jit(fn, **kw):
            compiled = real_jit(fn, **kw)
            if getattr(fn, "__code__", None) is None or \
                    fn.__code__.co_filename != path:
                return compiled

            def call(*args, **kwargs):
                out = compiled(*args, **kwargs)
                self.jax.append(np.asarray(out))
                return out
            return call

        monkeypatch.setattr(jax, "jit", jit)
        real_half = jarena.arena_half

        def jax_half(*args):
            out = real_half(*args)
            self.jax.append(np.asarray(out))
            return out

        monkeypatch.setattr(jarena, "arena_half", jax_half)
        real_sides = tarena.sides_half

        def sides(*args, **kw):
            out = real_sides(*args, **kw)
            self.torch.append(out.numpy())
            return out

        monkeypatch.setattr(tarena, "sides_half", sides)
        monkeypatch.setattr(ab_arena, "sides_half", sides)

    def assert_equal(self, halves):
        assert len(self.jax) == len(self.torch) == halves
        for j, t in zip(self.jax, self.torch):
            np.testing.assert_array_equal(j, t)


def inject_jax_openings(monkeypatch, uniforms=None):
    """The JAX tools' openings (and Gumbel root uniforms) as fixed arrays."""
    calls = []
    real_randint, real_uniform = jax.random.randint, jax.random.uniform

    def randint(key, shape, minval, maxval, *args, **kw):
        if len(shape) != 1:
            return real_randint(key, shape, minval, maxval, *args, **kw)
        src = (ROWS, COLS)[len(calls) % 2]
        calls.append(shape)
        return jnp.asarray(src[:shape[0]], jnp.int32)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if uniforms is None or len(shape) != 2 or shape[1] != A:
            return real_uniform(key, shape, dtype, minval, maxval)
        return jnp.asarray(uniforms[:shape[0]])

    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    return calls


def run_main(main, argv, capsys, **kw):
    assert main(argv, **kw) in (0, None)
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


def save_net(path, seed, blocks=1, channels=8):
    AZModel(board_size=SIZE, n_res_blocks=blocks, channels=channels,
            seed=seed, device="cpu").save(str(path))
    return str(path)


def gumbel_uniforms(n):
    u = np.random.default_rng(5).uniform(1e-12, 1.0, (n, A))
    return u.astype(np.float32)


def test_gumbel_ab_equals_jax_tool(tmp_path, monkeypatch, capsys):
    ckpt = save_net(tmp_path / "net.ckpt", 0)
    table = TableEval(SIZE, seed=3)
    u = gumbel_uniforms(4)
    argv = [ckpt, "--games", "8", "--gumbel-sims", "8", "--puct-sims", "16",
            "--m", "4", "--size", str(SIZE)]
    rec = Recorded(monkeypatch, "gumbel_ab")
    inject_jax_openings(monkeypatch, u)
    tool = load_jax_tool("gumbel_ab")
    with mock.patch.object(jloop, "make_eval_fn", lambda cfg: table.jax):
        [want] = run_main(tool.main, argv, capsys)
    with mock.patch.object(gumbel_ab, "make_eval_fn", lambda: table.torch):
        [got] = run_main(gumbel_ab.main, argv, capsys, device="cpu",
                         openings=OPENINGS, uniforms=torch.from_numpy(u))
    rec.assert_equal(2)
    assert got == want
    assert got["games"] == 8 and sum(got["pairs"][k] for k in (
        "win_both", "loss_both", "split")) == got["pairs"]["n"] == 4


def test_reuse_ab_equals_jax_tool(tmp_path, monkeypatch, capsys):
    ckpt = save_net(tmp_path / "net.ckpt", 0)
    table = TableEval(SIZE, seed=4)
    argv = [ckpt, "--games", "8", "--sims", "16", "--budget", "12",
            "--size", str(SIZE)]
    rec = Recorded(monkeypatch, "reuse_ab")
    inject_jax_openings(monkeypatch)
    tool = load_jax_tool("reuse_ab")
    with mock.patch.object(jloop, "make_eval_fn", lambda cfg: table.jax):
        [want] = run_main(tool.main, argv, capsys)
    with mock.patch.object(reuse_ab, "make_eval_fn", lambda: table.torch):
        [got] = run_main(reuse_ab.main, argv, capsys, device="cpu",
                         openings=OPENINGS)
    rec.assert_equal(2)
    assert got == want and got["reuse_budget"] == 12


def test_kleaf_ab_equals_jax_tool(tmp_path, monkeypatch, capsys):
    ckpt = save_net(tmp_path / "net.ckpt", 0)
    table = TableEval(SIZE, seed=5)
    argv = ["--model", ckpt, "--games", "8", "--sims", "16", "--k", "4",
            "--size", str(SIZE), "--backend", "xla"]
    rec = Recorded(monkeypatch, "kleaf_ab")
    inject_jax_openings(monkeypatch)
    tool = load_jax_tool("kleaf_ab")
    with mock.patch.object(jloop, "make_eval_fn", lambda cfg: table.jax):
        [want] = run_main(tool.main, argv, capsys)
    with mock.patch.object(kleaf_ab, "make_eval_fn", lambda: table.torch):
        [got] = run_main(kleaf_ab.main, argv, capsys, device="cpu",
                         openings=OPENINGS)
    rec.assert_equal(2)
    assert got == want


@pytest.mark.parametrize("search", ["puct", "gumbel"])
def test_cross_net_arena_equals_jax_tool(tmp_path, monkeypatch, capsys,
                                         search):
    a = save_net(tmp_path / "a.ckpt", 1)
    b = save_net(tmp_path / "b.ckpt", 2, blocks=2)
    u = gumbel_uniforms(4)
    argv = [a, b, "--games", "8", "--sims", "16", "--sims-b", "8",
            "--size", str(SIZE), "--search", search, "--m", "4",
            "--backend", "xla"]
    rec = Recorded(monkeypatch, "cross_net_arena")
    inject_jax_openings(monkeypatch, u)
    [want] = run_main(load_jax_tool("cross_net_arena").main, argv, capsys)
    [got] = run_main(cross_net_arena.main, argv, capsys, device="cpu",
                     openings=OPENINGS, uniforms=torch.from_numpy(u))
    rec.assert_equal(2)
    assert got == want
    assert got["arch_a"] == "1x8" and got["arch_b"] == "2x8"


def test_cross_net_arena_refuses_other_planes(tmp_path):
    a = save_net(tmp_path / "a.ckpt", 1)
    b = tmp_path / "b.ckpt"
    AZModel(board_size=SIZE, n_res_blocks=1, channels=8, in_channels=5,
            device="cpu").save(str(b))
    with pytest.raises(SystemExit, match="in_channels 3 and 5"):
        cross_net_arena.main([a, str(b), "--size", str(SIZE)], device="cpu")


@pytest.mark.parametrize("skip", ["f32", "bf16"])
def test_int8_ab_equals_jax_tool(tmp_path, monkeypatch, capsys, skip):
    """``--skip f32`` runs the int8 tower (``int8t``); ``bf16`` runs
    ``int8`` with that skip track, and the JSON says which."""
    ckpt = AZModel(board_size=SIZE, n_res_blocks=1, channels=32, seed=6,
                   device="cpu")
    path = str(tmp_path / "net.ckpt")
    ckpt.save(path)
    argv = [path, "--games", "8", "--sims", "16", "--size", str(SIZE),
            "--calib", "64", "--skip", skip, "--backend", "xla"]
    rec = Recorded(monkeypatch, "int8_ab")
    inject_jax_openings(monkeypatch)
    [want] = run_main(load_jax_tool("int8_ab").main, argv, capsys)
    [got] = run_main(int8_ab.main, argv, capsys, device="cpu",
                     openings=OPENINGS)
    rec.assert_equal(2)
    assert got.pop("int8_inference") == ("int8t" if skip == "f32"
                                         else "int8")
    assert got.pop("skip") == skip
    assert got == want


@pytest.mark.parametrize("search", ["puct", "gumbel"])
def test_compare_snapshots_equals_jax_tool(tmp_path, monkeypatch, capsys,
                                           search):
    a = save_net(tmp_path / "a.ckpt", 1)
    b = save_net(tmp_path / "b.ckpt", 2)
    u = gumbel_uniforms(4)
    argv = [a, b, "--games", "8", "--sims", "8", "--size", str(SIZE),
            "--search", search, "--backend", "xla"]
    rec = Recorded(monkeypatch, "compare_snapshots")
    inject_jax_openings(monkeypatch, u)
    [want] = run_main(load_jax_tool("compare_snapshots").main, argv, capsys)
    with mock.patch.object(tarena, "sides_half", _with_uniforms(
            tarena.sides_half, torch.from_numpy(u))):
        [got] = run_main(compare_snapshots.main, argv, capsys, device="cpu",
                         openings=OPENINGS)
    rec.assert_equal(2)
    assert got == want


def _with_uniforms(sides_half, uniforms):
    """``sides_half`` with the Gumbel root uniforms injected: the arena of
    the training loop, which ``compare_snapshots`` runs, takes none."""
    def call(*args, **kw):
        return sides_half(*args, **kw, uniforms=uniforms)
    return call


def test_harvest_run_picks_the_jax_tools_snapshot(tmp_path, monkeypatch,
                                                  capsys):
    run = tmp_path / "run"
    run.mkdir()
    for it, seed in ((10, 11), (20, 12), (30, 13)):
        save_net(run / f"snapshot_iter{it}_x.ckpt", seed)
    argv = [str(run), "--games", "8", "--sims", "8", "--every", "10",
            "--size", str(SIZE), "--backend", "xla", "--baseline",
            str(run / "snapshot_iter10_x.ckpt")]
    rec = Recorded(monkeypatch, "harvest_run")
    inject_jax_openings(monkeypatch)
    want = run_main(load_jax_tool("harvest_run").main, argv, capsys)
    got = run_main(harvest_run.main, argv, capsys, device="cpu",
                   openings=OPENINGS)
    rec.assert_equal(6)        # two matches and the baseline, two halves
    assert len(got) == 4 and got == want
    assert got[-1]["path"].startswith(str(run))


def test_strength_probe_plays_the_jax_tools_games(tmp_path, monkeypatch,
                                                  capsys):
    """The same game lines (their seconds aside) and summary: both
    AlphaZero players evaluate with a ``TableEval``, and every pure-MCTS
    player draws from a counter-seeded ``Random``, in both packages."""
    ckpt = save_net(tmp_path / "net.ckpt", 0)
    table = TableEval(SIZE, seed=8)
    argv = ["--model", ckpt, "--sims", "16", "--playouts", "8", "--games",
            "2", "--size", str(SIZE), "--max-moves", "12"]
    outs = []
    for module, pure, player, fn, kw in (
            (load_jax_tool("strength_probe"), jpure, jab,
             lambda cfg: table.jax, {}),
            (strength_probe, tpure, tab, lambda: table.torch,
             {"device": "cpu"})):
        made = iter(range(100, 10_000))
        monkeypatch.setattr(pure, "random", types.SimpleNamespace(
            Random=lambda: random.Random(next(made))))
        with mock.patch.object(player, "make_eval_fn", fn):
            assert module.main(argv, **kw) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        outs.append([line.rsplit(", ", 1)[0] for line in lines
                     if line.startswith("game ")] + [json.loads(lines[-1])])
    assert outs[0] == outs[1]
    assert len(outs[1]) == 3 and outs[1][-1]["games"] == 2


def test_tools_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ckpt = save_net(tmp_path / "net.ckpt", 0)
    for main, argv in ((gumbel_ab.main, [ckpt]), (reuse_ab.main, [ckpt]),
                       (int8_ab.main, [ckpt]), (kleaf_ab.main, []),
                       (compare_snapshots.main, [ckpt, ckpt]),
                       (cross_net_arena.main, [ckpt, ckpt]),
                       (harvest_run.main, [str(tmp_path)]),
                       (strength_probe.main, ["--model", ckpt])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--size", str(SIZE)])
    # the probes and microbenchmarks: each resolves the card before it
    # reads a file
    missing = str(tmp_path / "missing")
    for main, argv in ((tactics_probe.main, ["--model", ckpt]),
                       (distill_net.main, [missing, "--out", missing]),
                       (policy_entropy_probe.main,
                        [ckpt, ckpt, "--buffer", missing]),
                       (int8_calib_sensitivity.main, [ckpt]),
                       (tt_rate_probe.main, ["--ckpt", ckpt]),
                       (tree_kernel_microbench.main, []),
                       (search_cost_split.main, []),
                       (hbm_budget.main, ["8", "4", "f32"]),
                       (net_microbench.main, []),
                       (int8_probe.main, []),
                       (device_parity.main, ["--quick"]),
                       (gumbel_determinism_probe.main, []),
                       (gumbel_flip_probe.main, ["--ckpt", ckpt])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
