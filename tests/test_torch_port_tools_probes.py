"""The port's probe tools (``alphazero_gomoku_tpu_torch/tools/``:
``tactics_suites``, ``tactics_probe``, ``distill_net``,
``policy_entropy_probe``, ``int8_calib_sensitivity`` and ``tt_rate_probe``)
against the JAX repo's root ``tools/``, on the CPU, on small nets saved as
AZTPU1 checkpoints that both packages read.  The JAX tools are loaded by
path (``tools/`` is not a package).

Tolerances, each stated where it is used:

  - the suites and the oracle's keys: equal;
  - the float32 forwards of the two frameworks sum in other orders (XLA's
    convolutions against PyTorch's), about 1e-6 relative; a number a tool
    prints rounded to ``k`` places may then differ by one unit of its last
    place (a rounding boundary crossed), which is each printed number's
    tolerance; counts and hits are held equal;
  - the int8 forward equals the JAX one bit for bit
    (``tests/test_torch_port_int8.py``), so top-1 agreement is held equal
    and the KL and MAE, which also read the float32 forward, within the
    float32 forward's tolerance;
  - distillation: see :func:`test_distill_net_follows_the_jax_tool`.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import alphazero_gomoku_tpu.search as jsearch
from alphazero_gomoku_tpu.models import AZModel as JaxModel
from alphazero_gomoku_tpu_torch.models import AZModel
from alphazero_gomoku_tpu_torch.selfplay.buffer import (
    ReplayBuffer,
    save_replay_buffer,
)
from alphazero_gomoku_tpu_torch.tools import (
    distill_net,
    int8_calib_sensitivity,
    policy_entropy_probe,
    tactics_probe,
    tactics_suites,
    tt_rate_probe,
)

from torch_port_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    # registered first: a dataclass looks its module up while it is made
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def run_main(main, argv, capsys, **kw):
    assert main(argv, **kw) in (0, None)
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


def save_net(path, size, seed, blocks=1, channels=8):
    AZModel(board_size=size, n_res_blocks=blocks, channels=channels,
            seed=seed, device="cpu").save(str(path))
    return str(path)


def seeded_buffer(path, size, n, seed=0):
    """A replay buffer file of ``n`` random boards (disjoint stones of the
    two sides, the ones plane), random policies and outcomes, written by
    the port's buffer."""
    rng = np.random.default_rng(seed)
    me = rng.integers(0, 2, (n, size, size))
    opp = (1 - me) * rng.integers(0, 2, (n, size, size))
    states = np.stack([me, opp, np.ones_like(me)], -1).astype(np.float32)
    pis = rng.random((n, size * size)).astype(np.float32) ** 3
    pis /= pis.sum(1, keepdims=True)
    zs = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    buf = ReplayBuffer(capacity=n, board_size=size)
    buf.add(states, pis, zs)
    assert save_replay_buffer(buf, str(path))
    return str(path)


def assert_close_rounded(got, want, places):
    """Numbers printed rounded to ``places``: within one unit of the last
    place (the frameworks' float32 sums may put them on either side of a
    rounding boundary)."""
    assert abs(got - want) <= 1.01 * 10.0 ** -places, (got, want)


# ----------------------------------------------------------------------
# tactics_suites
# ----------------------------------------------------------------------
@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_tactics_suites_equal_the_jax_suites(game):
    jax_suites = load_jax_tool("tactics_suites")
    want, got = jax_suites.suite_for(game), tactics_suites.suite_for(game)
    assert len(got) == len(want) >= 20
    for g, w in zip(got, want):
        assert (g.name, g.game, g.category, g.to_move, g.captures) == \
            (w.name, w.game, w.category, w.to_move, w.captures)
        np.testing.assert_array_equal(g.board, w.board)
        assert g.board.dtype == w.board.dtype
        assert set(g.keys) == set(w.keys)


@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_tactics_suites_validate_on_the_ports_host_engine(game):
    """Every position's authored keys equal the keys the oracle derives on
    ``alphazero_gomoku_tpu_torch/games/host.py``."""
    assert tactics_suites.validate_suite(game) >= 20


# ----------------------------------------------------------------------
# tactics_probe
# ----------------------------------------------------------------------
@pytest.mark.parametrize("game,suite", [("gomoku", "core"),
                                        ("gomoku", "full"),
                                        ("pente", "full")])
def test_tactics_probe_equals_the_jax_tool(tmp_path, monkeypatch, capsys,
                                           game, suite):
    """Each position's search pi equals the JAX tool's (its batch-1 search
    on the XLA array tree, the port's on the packed tree): a 1x8 net at
    15x15, 8 simulations.  Hits and tops are equal; ``value`` and the two
    ``*_on_keys`` sums within one unit of their third place."""
    ckpt = save_net(tmp_path / "net.ckpt", 15, seed=5)
    argv = ["--model", ckpt, "--sims", "8", "--game", game, "--suite", suite]
    pis = {"jax": [], "torch": []}
    # the JAX tool calls run_mcts eagerly, op by op: jitted once here (env,
    # config and eval function static) it runs the same search in seconds
    real_jax = jax.jit(jsearch.run_mcts, static_argnums=(0, 1, 2))

    def jax_mcts(*args):
        out = real_jax(*args)
        pis["jax"].append(np.asarray(out)[0])
        return out

    real_torch = tactics_probe.run_search

    def torch_mcts(*args, **kw):
        out = real_torch(*args, **kw)
        pis["torch"].append(out[0][0].numpy())
        return out

    monkeypatch.setattr(jsearch, "run_mcts", jax_mcts)
    monkeypatch.setattr(tactics_probe, "run_search", torch_mcts)
    want = run_main(load_jax_tool("tactics_probe").main, argv, capsys)
    got = run_main(tactics_probe.main, argv, capsys, device="cpu")
    assert len(got) == len(want) == len(pis["jax"]) + 1
    for j, t in zip(pis["jax"], pis["torch"]):
        np.testing.assert_array_equal(j, t)
    for g, w in zip(got[:-1], want[:-1]):
        for key in ("value", "prior_on_keys", "search_on_keys"):
            assert_close_rounded(g.pop(key), w.pop(key), 3)
        assert g == w
    assert got[-1] == want[-1]


# ----------------------------------------------------------------------
# distill_net
# ----------------------------------------------------------------------
def test_distill_net_follows_the_jax_tool(tmp_path, capsys):
    """2 epochs of 4 steps on a 2x16 student at 7x7, both tools on the same
    batches (the same numpy draws) from the same initial weights (the JAX
    model's, passed to the port's ``main``).

    Tolerance.  After each Adam step the two students agree within float32
    noise except on the elements whose clipped gradient is within the
    frameworks' disagreement of zero: Adam's first steps move those by
    about ``lr`` with either sign, up to ``2 lr`` apart a step
    (``tests/test_torch_port_train_step.py``).  Such an element's gradient
    is near zero, so it moves the loss at second order; over the run's
    ``S = 8`` steps the losses are held within ``2 lr S`` = 0.032
    (``lr`` = 2e-3, the tool's default) relative, and the student's outputs
    then move its hold-out losses no further than that."""
    size = 7
    buf = seeded_buffer(tmp_path / "buf.npz", size, 200)
    argv = [buf, "--blocks", "2", "--channels", "16", "--board-size",
            str(size), "--epochs", "2", "--batch", "32", "--holdout", "64"]
    jax_out, torch_out = str(tmp_path / "jax.ckpt"), str(tmp_path / "t.ckpt")
    want = run_main(load_jax_tool("distill_net").main,
                    argv + ["--out", jax_out], capsys)
    init = JaxModel(board_size=size, n_res_blocks=2, channels=16, seed=0,
                    lr=2e-3)
    init = jax.tree_util.tree_map(np.asarray,
                                  (init.params, init.batch_stats))
    got = run_main(distill_net.main, argv + ["--out", torch_out], capsys,
                   device="cpu", init=init)
    assert len(got) == len(want) == 2
    tol = 2 * 2e-3 * 8
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for key in ("train_loss", "holdout_policy_ce", "holdout_value_mse"):
            np.testing.assert_allclose(g[key], w[key], rtol=tol)

    # the student's checkpoint loads in the JAX package and predicts what
    # the port predicts (float32 forwards, 1e-5)
    student = JaxModel.from_checkpoint(torch_out)
    port = AZModel.from_checkpoint(torch_out, device="cpu")
    assert (student.cfg.n_res_blocks, student.cfg.channels) == (2, 16)
    x = np.random.default_rng(1).integers(0, 2, (8, 3, size, size))
    x = x.astype(np.float32)
    for j, t in zip(student.predict(x), port.predict(x)):
        np.testing.assert_allclose(t, j, atol=1e-5)


# ----------------------------------------------------------------------
# policy_entropy_probe and int8_calib_sensitivity
# ----------------------------------------------------------------------
def test_policy_entropy_probe_equals_the_jax_tool(tmp_path, capsys):
    """Two nets on 96 buffer positions at 9x9: each printed number within a
    unit of its last place; ``mean_actions_above_1e-3`` is a mean of
    counts, held within one action over the positions (a probability on
    the threshold's other side)."""
    size, n = 9, 96
    a = save_net(tmp_path / "a.ckpt", size, seed=1)
    b = save_net(tmp_path / "b.ckpt", size, seed=2, blocks=2)
    buf = seeded_buffer(tmp_path / "buf.npz", size, 160, seed=3)
    argv = [a, b, "--buffer", buf, "--n", str(n), "--size", str(size)]
    want = run_main(load_jax_tool("policy_entropy_probe").main, argv, capsys)
    got = run_main(policy_entropy_probe.main, argv, capsys, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got[:2], want[:2]):
        assert g.pop("ckpt") == w.pop("ckpt")
        assert g.pop("positions") == w.pop("positions") == n
        assert abs(g.pop("mean_actions_above_1e-3")
                   - w.pop("mean_actions_above_1e-3")) <= 1.0 / n + 0.01
        assert g.keys() == w.keys()
        for key in g:
            assert_close_rounded(g[key], w[key], 4)
    assert got[2]["note"] == want[2]["note"]
    # a difference of two rounded numbers: two units of the last place
    assert abs(got[2]["entropy_delta_nats"]
               - want[2]["entropy_delta_nats"]) <= 2.02e-4


def test_int8_calib_sensitivity_equals_the_jax_tool(tmp_path, capsys):
    """A 1x32 net at 15x15 quantized on three calibration sets (random play
    and two buffer draws): the ``int8`` lines (the JAX tool's route) equal
    its lines, top-1 agreement exactly and the rest within 1e-4 relative
    or 1e-5 absolute: the two float32 forwards agree within 1e-5
    (``tests/test_torch_port_train_step.py``'s forward tolerance), and a
    mean KL or value error moves by no more than the forward does;
    the ``int8t`` lines (the tower's plain version here) equal the
    ``int8`` ones."""
    ckpt = save_net(tmp_path / "net.ckpt", 15, seed=4, channels=32)
    buf = seeded_buffer(tmp_path / "buf.npz", 15, 160, seed=5)
    argv = [ckpt, "--buffer", buf, "--n", "32", "--held", "64"]
    want = run_main(load_jax_tool("int8_calib_sensitivity").main, argv,
                    capsys)
    got = run_main(int8_calib_sensitivity.main, argv, capsys, device="cpu")
    routes = [g.pop("route") for g in got]
    assert routes == ["int8", "int8t"] * 3
    assert len(want) == 3
    for w, g8, gt in zip(want, got[::2], got[1::2]):
        assert gt == g8
        assert g8.keys() == w.keys()
        for key in ("calib", "ckpt", "n_calib", "n_held", "top1_agree"):
            assert g8[key] == w[key]
        for key in ("policy_kl_mean", "policy_kl_max", "value_mae"):
            np.testing.assert_allclose(g8[key], w[key], rtol=1e-4,
                                       atol=1e-5)


# ----------------------------------------------------------------------
# tt_rate_probe
# ----------------------------------------------------------------------
def test_tt_rate_probe_equals_the_jax_tool(tmp_path, capsys):
    """A 1x8 net at 7x7, 32 simulations a move over 6 moves: the same
    expansions, ``tt_rate`` and ``reuse_rate`` (the search's scores read
    the two frameworks' float32 priors; on this net no near tie splits
    them)."""
    ckpt = save_net(tmp_path / "net.ckpt", 7, seed=6)
    argv = ["--ckpt", ckpt, "--sims", "32", "--moves", "6", "--size", "7"]
    [want] = run_main(load_jax_tool("tt_rate_probe").main, argv, capsys)
    [got] = run_main(tt_rate_probe.main, argv, capsys, device="cpu")
    assert got == want
    assert got["expansions"] > 0 and got["moves_played"] == 6
