"""Parity: the port's reference ``.pt`` importer against the JAX package's.

A torch net with the reference's module layout (``conv``/``bn`` stem,
``res_blocks.{i}`` with conv1/bn1/conv2/bn2, the 2-channel policy head and
its FC, the 1-channel value head and its MLP; as in
``tests/test_torch_import.py``) is saved as a reference-style
``{"net": state_dict, ...}`` snapshot and imported by both packages.  The
port loads the state dict directly (no layout change); the JAX package
permutes to HWIO and to its HWC flatten order.  Brought back through
``params_from_jax``, the JAX import must hold the port's tensors exactly
(the policy FC's input columns included), and the two forwards must agree
within 1e-5 (float32 convolutions summed in another order).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from alphazero_gomoku_tpu.models import AZModel as JaxModel
from alphazero_gomoku_tpu.models.torch_import import (
    import_torch_checkpoint as jax_import,
)
from alphazero_gomoku_tpu_torch.models import AZModel, params_from_jax
from alphazero_gomoku_tpu_torch.models import torch_import
from alphazero_gomoku_tpu_torch.players.alpha_base import AlphaZeroPlayer

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

BOARD = 7
ACTIONS = BOARD * BOARD
CH = 8
BLOCKS = 2
TOL = 1e-5


class _Res(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(ch)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class _RefNet(nn.Module):
    """The reference net's state-dict key layout."""

    def __init__(self, in_channels=3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, CH, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(CH)
        self.res_blocks = nn.ModuleList(_Res(CH) for _ in range(BLOCKS))
        self.policy_conv = nn.Conv2d(CH, 2, 1, bias=False)
        self.policy_bn = nn.BatchNorm2d(2)
        self.policy_fc = nn.Linear(2 * ACTIONS, ACTIONS)
        self.value_conv = nn.Conv2d(CH, 1, 1, bias=False)
        self.value_bn = nn.BatchNorm2d(1)
        self.value_fc1 = nn.Linear(ACTIONS, 64)
        self.value_fc2 = nn.Linear(64, 1)

    def forward(self, x):
        h = F.relu(self.bn(self.conv(x)))
        for b in self.res_blocks:
            h = b(h)
        p = F.relu(self.policy_bn(self.policy_conv(h))).flatten(1)
        v = F.relu(self.value_bn(self.value_conv(h))).flatten(1)
        return (self.policy_fc(p),
                torch.tanh(self.value_fc2(F.relu(self.value_fc1(v)))))


def _save_ref_snapshot(path, in_channels=3, extra=None):
    torch.manual_seed(0)
    net = _RefNet(in_channels)
    net.train()          # BN stats that are not the initial ones
    with torch.no_grad():
        for _ in range(3):
            net(torch.randn(4, in_channels, BOARD, BOARD))
    net.eval()
    sd = dict(net.state_dict(), **(extra or {}))
    torch.save({"net": sd, "opt": None, "board_size": BOARD,
                "action_size": ACTIONS}, path)
    return net


def _inputs(in_channels, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, in_channels, BOARD, BOARD)).astype(
        np.float32)


@pytest.mark.parametrize("in_channels", [3, 5])
def test_import_equals_the_jax_import(in_channels, tmp_path):
    path = str(tmp_path / "ref.pt")
    ref = _save_ref_snapshot(path, in_channels)
    port = torch_import.import_torch_checkpoint(path, device="cpu")
    jm = jax_import(path)
    assert (port.cfg.n_res_blocks, port.cfg.channels,
            port.cfg.in_channels, port.board_size) == (
        BLOCKS, CH, in_channels, BOARD)
    # the JAX import, brought back to the port's layout: the same tensors
    want = params_from_jax(jax_tree_np(jm.params),
                           jax_tree_np(jm.batch_stats))
    got = port.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(got[name].numpy(), w.numpy(),
                                      err_msg=name)
    # ... and the forwards, against each other and against the snapshot
    x = _inputs(in_channels)
    probs, values = port.predict(x)
    jprobs, jvalues = jm.predict(x)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=TOL)
    np.testing.assert_allclose(values, jvalues, rtol=0, atol=TOL)
    with torch.no_grad():
        logits, v = ref(torch.from_numpy(x))
    np.testing.assert_allclose(probs, F.softmax(logits, -1).numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(values, v.numpy(), rtol=0, atol=TOL)


def jax_tree_np(tree):
    """A JAX pytree's leaves as numpy arrays (lists kept)."""
    if isinstance(tree, dict):
        return {k: jax_tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_np(v) for v in tree]
    return np.asarray(tree)


def test_from_checkpoint_imports_pt_and_saves_for_both(tmp_path):
    path = str(tmp_path / "snapshot_iter83.pt")
    _save_ref_snapshot(path)
    model = AZModel.from_checkpoint(path, device="cpu")
    assert model.cfg.channels == CH and model.cfg.n_res_blocks == BLOCKS
    native = str(tmp_path / "imported.ckpt")
    model.save(native)
    x = _inputs(3, n=2)
    again = AZModel.from_checkpoint(native, device="cpu")
    np.testing.assert_array_equal(again.predict(x)[0], model.predict(x)[0])
    jm = JaxModel.from_checkpoint(native)
    np.testing.assert_allclose(jm.predict(x)[0], model.predict(x)[0],
                               rtol=0, atol=TOL)


def test_cli_conversion(tmp_path, capsys):
    src = str(tmp_path / "ref.pt")
    dst = str(tmp_path / "out.ckpt")
    _save_ref_snapshot(src, in_channels=5)
    torch_import.main([src, dst, "--device", "cpu"])
    assert "imported" in capsys.readouterr().out
    m = AZModel.from_checkpoint(dst, device="cpu")
    assert (m.cfg.n_res_blocks, m.cfg.in_channels) == (BLOCKS, 5)


def test_a_snapshot_that_does_not_fit_is_refused(tmp_path):
    path = str(tmp_path / "odd.pt")
    _save_ref_snapshot(path, extra={"stray.weight": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="stray"):
        torch_import.import_torch_checkpoint(path, device="cpu")
    with pytest.raises(ValueError, match="non-square"):
        bad = str(tmp_path / "bad.pt")
        net = _RefNet()
        sd = dict(net.state_dict())
        sd["policy_fc.weight"] = torch.zeros(50, 2 * ACTIONS)
        torch.save({"net": sd}, bad)
        torch_import.import_torch_checkpoint(bad, device="cpu")


def test_a_snapshot_with_objects_is_unpickled_in_full_with_a_warning(
        tmp_path, capsys):
    """Objects beyond tensors (an ``argparse.Namespace``, as older saves
    hold) are refused by the weights-only load; the importer then says that
    it unpickles the file in full, and imports the same net."""
    import argparse

    plain, full = str(tmp_path / "plain.pt"), str(tmp_path / "full.pt")
    _save_ref_snapshot(plain)
    state = torch.load(plain, weights_only=True)
    state["opt"] = argparse.Namespace(lr=1e-3)
    torch.save(state, full)
    want = torch_import.import_torch_checkpoint(plain, device="cpu")
    assert "unpickling it in full" not in capsys.readouterr().err
    got = torch_import.import_torch_checkpoint(full, device="cpu")
    assert "unpickling it in full" in capsys.readouterr().err
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k


def test_the_player_loads_a_pt_snapshot(tmp_path, capsys):
    path = str(tmp_path / "ref.pt")
    _save_ref_snapshot(path)
    p = AlphaZeroPlayer("gomoku", BOARD, n_simulations=4, model_path=path,
                        device="cpu")
    assert "loading model" in capsys.readouterr().out
    assert p.net.cfg.channels == CH
    board = np.zeros((BOARD, BOARD), np.int8)
    board[3, 3] = 1
    move = p.play(board, 1, (3, 3))
    assert move is not None and board[move] == 0
