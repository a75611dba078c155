"""The port's AZTPU1 checkpoints (``models/checkpoint.py``, ``AZModel``
save / load) against the JAX package's ``models/checkpoint.py`` and
``AZModel``.

The shipped checkpoints are read by both; arrays must be equal, and the
port's net on them must give the JAX ``apply``'s logits and values within
the port net's tolerance (float32 convolutions in two orders:
``tests/test_torch_port_net.py``).  Checkpoints written by either package
load in the other, optimizer state included.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from alphazero_gomoku_tpu.models import AZModel as JaxModel
from alphazero_gomoku_tpu.models import checkpoint as jckpt
from alphazero_gomoku_tpu.models.resnet import apply
from alphazero_gomoku_tpu_torch.models import checkpoint as ckpt
from alphazero_gomoku_tpu_torch.models.model import AZModel

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
SHIPPED = sorted((ROOT / "checkpoints").glob("*.ckpt"))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _boards(size, n, seed, cin=3):
    """NHWC boards of random cells; with ``cin`` 5, Pente's capture planes
    after them, k / 5 for k = 0..4 captured pairs of each side."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 3, (n, size, size))
    planes = [cells == 1, cells == 2, np.ones_like(cells, bool)]
    planes = [p.astype(np.float32) for p in planes]
    if cin == 5:
        k = np.arange(2 * n).reshape(n, 2) % 5
        rng.shuffle(k)
        planes += [np.broadcast_to((k[:, j] / np.float32(5)).astype(
            np.float32)[:, None, None], cells.shape) for j in (0, 1)]
    return np.stack(planes, axis=-1).astype(np.float32)


def test_the_five_shipped_checkpoints_are_there():
    assert [p.name for p in SHIPPED] == [
        "best_gomoku.ckpt", "best_pente.ckpt", "distill_3x64.ckpt",
        "distill_4x96.ckpt", "distill_4x96_ft200.ckpt"]


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: p.name)
def test_shipped_checkpoint_reads_as_flax_reads_it(path):
    blob = path.read_bytes()
    n = int.from_bytes(blob[7:15], "little")
    want = serialization.msgpack_restore(blob[15 + n:])
    got, meta = ckpt.load_checkpoint(str(path))
    _assert_trees_equal(got, want)
    assert meta == ckpt.peek_metadata(str(path))
    # the writer gives flax's bytes back
    assert ckpt.packb(got) == blob[15 + n:]
    # and the port's model loads it
    model = AZModel.from_checkpoint(str(path), device="cpu")
    assert model.cfg.channels == meta["channels"]


@pytest.mark.parametrize("name", ["best_gomoku.ckpt", "distill_3x64.ckpt",
                                  "best_pente.ckpt"])
def test_shipped_net_through_the_port_matches_apply(name):
    path = str(ROOT / "checkpoints" / name)
    jm = JaxModel.from_checkpoint(path)
    pm = AZModel.from_checkpoint(path, device="cpu")
    params, stats = pm.jax_params()
    _assert_trees_equal(params, jax.device_get(jm.params))
    _assert_trees_equal(stats, jax.device_get(jm.batch_stats))
    x = _boards(jm.board_size, 16, 0, cin=pm.cfg.in_channels)
    assert jm.cfg.in_channels == pm.cfg.in_channels
    (logits, value), _ = apply(jm.cfg, jm.params, jm.batch_stats, x)
    net = pm.eval_net()
    with torch.no_grad():
        got_l, got_v = net(torch.from_numpy(x))
    scale = float(np.abs(np.asarray(logits)).max())
    np.testing.assert_allclose(got_l.numpy(), np.asarray(logits),
                               atol=1e-5 * max(scale, 1.0))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(value), atol=1e-5)
    # the reference surface: predict on NCHW boards
    probs, values = pm.predict(x.transpose(0, 3, 1, 2))
    want_p, want_v = jm.predict(x.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(probs, want_p, atol=1e-5)
    np.testing.assert_allclose(values, want_v, atol=1e-5)


def _trained_port(tmp_path):
    m = AZModel(board_size=7, n_res_blocks=1, channels=8, seed=3,
                device="cpu")
    rng = np.random.default_rng(1)
    x = _boards(7, 8, 2).transpose(0, 3, 1, 2)
    pis = rng.random((8, 49)).astype(np.float32)
    pis /= pis.sum(axis=1, keepdims=True)
    zs = rng.choice([-1.0, 1.0], 8).astype(np.float32)
    m.train_batch(x, pis, zs, epochs=2)
    return m, x, pis, zs


def test_port_checkpoint_loads_in_jax_with_its_optimizer_state(tmp_path):
    m, x, pis, zs = _trained_port(tmp_path)
    path = str(tmp_path / "port.ckpt")
    m.save(path)
    jm = JaxModel(board_size=7, n_res_blocks=1, channels=8)
    jm.load(path)
    params, stats = m.jax_params()
    _assert_trees_equal(jax.device_get(jm.params), params)
    _assert_trees_equal(jax.device_get(jm.batch_stats), stats)
    adam = jm.opt_state[2]
    assert int(adam.count) == 2
    mu = ckpt.load_checkpoint(path)[0]["opt_state"]["2"]["mu"]
    for g, w in zip(_leaves(jax.device_get(adam.mu)), _leaves(mu)):
        np.testing.assert_array_equal(g, w)
    # both go on training from the same state to the same losses
    got = m.train_batch(x, pis, zs)
    want = jm.train_batch(x, pis, zs)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    # the port's bytes are flax's
    state = ckpt.load_checkpoint(path)[0]
    blob = Path(path).read_bytes()
    n = int.from_bytes(blob[7:15], "little")
    assert serialization.msgpack_serialize(state) == blob[15 + n:]


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jm = JaxModel(board_size=7, n_res_blocks=1, channels=8, seed=4)
    x = _boards(7, 8, 5).transpose(0, 3, 1, 2)
    pis = np.full((8, 49), 1 / 49, np.float32)
    jm.train_batch(x, pis, np.zeros(8, np.float32))
    path = str(tmp_path / "jax.ckpt")
    jm.save(path)
    pm = AZModel.from_checkpoint(path, device="cpu")
    params, stats = pm.jax_params()
    _assert_trees_equal(params, jax.device_get(jm.params))
    _assert_trees_equal(stats, jax.device_get(jm.batch_stats))
    assert int(pm.opt_state.count) == 1
    # a save of the loaded model is the same file's tree
    again = str(tmp_path / "again.ckpt")
    pm.save(again)
    _assert_trees_equal(ckpt.load_checkpoint(again)[0],
                        ckpt.load_checkpoint(path)[0])
    # the JAX package reads the port's save of it too
    jm2 = JaxModel(board_size=7, n_res_blocks=1, channels=8)
    jm2.load(again)
    _assert_trees_equal(jax.device_get(jm2.opt_state),
                        jax.device_get(jm.opt_state))


def test_save_is_atomic_and_metadata_is_peeked(tmp_path):
    m = AZModel(board_size=7, n_res_blocks=1, channels=8, device="cpu")
    path = str(tmp_path / "sub" / "m.ckpt")
    m.save(path)
    assert not os.path.exists(path + ".tmp")
    assert ckpt.peek_metadata(path) == jckpt.peek_metadata(path) == {
        "board_size": 7, "action_size": 49, "n_res_blocks": 1,
        "channels": 8, "in_channels": 3}


def test_bad_magic_and_wrong_architecture_raise(tmp_path):
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"NOTAZ1\n" + b"\0" * 32)
    with pytest.raises(ValueError, match="not an alphazero_gomoku_tpu"):
        ckpt.load_checkpoint(str(bad))
    with pytest.raises(ValueError, match="not an alphazero_gomoku_tpu"):
        ckpt.peek_metadata(str(bad))
    m = AZModel(board_size=7, n_res_blocks=1, channels=8, device="cpu")
    path = str(tmp_path / "m.ckpt")
    m.save(path)
    with pytest.raises(ValueError, match="channels=8"):
        AZModel(board_size=7, n_res_blocks=1, channels=16,
                device="cpu").load(path)


def test_torch_snapshots_are_refused_naming_their_item(tmp_path, monkeypatch,
                                                       capsys):
    """A ``.pt`` goes to the reference importer (``models/torch_import.py``,
    held against the JAX importer in ``test_torch_port_torch_import.py``),
    not to the AZTPU1 reader; a corrupt snapshot is refused there by the
    weights-only load, with no full unpickle tried after it."""
    from alphazero_gomoku_tpu_torch.models import torch_import

    read = []
    load = torch_import._load_state
    monkeypatch.setattr(torch_import, "_load_state",
                        lambda path: read.append(path) or load(path))
    pt = tmp_path / "ref.pt"
    pt.write_bytes(b"PK\x03\x04")
    with pytest.raises(RuntimeError):
        AZModel.from_checkpoint(str(pt), device="cpu")
    assert read == [str(pt)]
    assert "unpickling it in full" not in capsys.readouterr().err


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
    -2**15 - 1, -2**31 - 1, 1.5, True, False, None, "", "x" * 31, "y" * 32,
    "z" * 300, b"", b"\x01" * 70000, [1, [2, 3]], list(range(20)),
    {str(i): i for i in range(20)}, np.float32(2.5), np.int32(-7),
    np.arange(6, dtype=np.int8).reshape(2, 3), np.zeros((), np.int32),
    np.ones((3, 1), np.float64)])
def test_msgpack_subset_round_trips_as_msgpack_packs(value):
    import msgpack
    blob = ckpt.packb(value)
    if isinstance(value, (np.ndarray, np.generic)):
        want = msgpack.packb(value, default=serialization._msgpack_ext_pack,
                             strict_types=True)
    else:
        # maps are written with sorted keys, as flax's state dicts come
        sort = dict(sorted(value.items())) if isinstance(value, dict) \
            else value
        want = msgpack.packb(sort, use_bin_type=True)
    assert blob == want
    back = ckpt.unpackb(blob)
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(back, value)
        assert back.dtype == value.dtype
    elif isinstance(value, tuple):
        assert back == list(value)
    else:
        assert back == value and type(back) is type(value)
