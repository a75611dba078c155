"""The towers' padded-board tiles on the CPU: the kernels' geometry, their
activation layout and K4's K-major weights, held against the plain convs;
the build cache's hash of the shared header; the wrappers' shape limits.

``conv_tile.conv_planes_plain`` computes a conv as the two tower kernels do
(``csrc/conv_tile.cuh``: tile by tile, nine row slices of one staged padded
buffer); here it equals ``int8_tower._conv9_plain`` exactly and
``fused_net._conv3_plain`` within float32 rounding, both of which the
port's other tests hold against the JAX package.
"""

import shutil

import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu_torch.models import NetConfig, init_params
from alphazero_gomoku_tpu_torch.ops import _build, conv_tile as ct
from alphazero_gomoku_tpu_torch.ops import fused_net as fn
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8


@pytest.mark.parametrize("mt", [t8.KERNEL_TILE, fn.KERNEL_TILE])
@pytest.mark.parametrize("size,batch,c", [(9, 3, 32), (15, 2, 64),
                                          (19, 2, 32), (15, 1, 16)])
def test_tiled_conv_on_planes_equals_int8_conv(size, batch, c, mt):
    rng = np.random.default_rng(size * 100 + batch)
    x = torch.from_numpy(rng.integers(-127, 128, (batch, size, size, c),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (c + 16, 9 * c),
                                      dtype=np.int8))
    got = ct.conv_planes_plain(ct.to_planes(x, mt), w, batch, size, mt)
    assert torch.equal(got, t8._conv9_plain(x, w).double())


@pytest.mark.parametrize("size,channels", [(9, 64), (15, 128)])
def test_kmajor_weights_on_planes_equal_the_bf16_convs(size, channels):
    """K4's re-packed weights through the kernel's tiled conv: the block
    convs and the stem (its K of 27 padded to 32) within float32 rounding
    of ``_conv3_plain`` on the same bf16-rounded inputs."""
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=channels)
    folded = fn.fold_bn(cfg, *init_params(cfg, 1), device="cpu")
    stem_k, block_k = fn.kmajor_weights(folded)
    assert stem_k.shape == (channels, 32)
    assert block_k.shape == (2, 2, channels, 9 * channels)
    assert stem_k.dtype == block_k.dtype == torch.bfloat16
    rng = np.random.default_rng(size)
    x = torch.from_numpy(rng.standard_normal(
        (2, size, size, channels)).astype(np.float32))
    zero = torch.zeros(channels)
    for i, j in ((0, 0), (1, 1)):
        got = ct.conv_planes_plain(
            ct.to_planes(x.to(torch.bfloat16), fn.KERNEL_TILE),
            block_k[i, j], 2, size, fn.KERNEL_TILE)
        want = fn._conv3_plain(x, folded["block_w"][i, j], zero)
        assert float((got - want.double()).abs().max()) < 1e-5 * float(
            want.abs().max())
    obs = torch.from_numpy(rng.standard_normal(
        (2, size, size, 3)).astype(np.float32))
    # the stem as a conv of 8 planes (3 real, 5 zero): K = 9 * 8 columns
    w8 = torch.zeros((channels, 9, 8), dtype=torch.bfloat16)
    w8[:, :, :3] = stem_k[:, :27].reshape(channels, 9, 3)
    assert not stem_k[:, 27:].any()
    planes = ct.to_planes(torch.nn.functional.pad(obs.to(torch.bfloat16),
                                                  (0, 5)), fn.KERNEL_TILE)
    got = ct.conv_planes_plain(planes, w8.reshape(channels, 72), 2, size,
                               fn.KERNEL_TILE)
    want = fn._conv3_plain(obs, folded["stem_w"], zero)
    assert float((got - want.double()).abs().max()) < 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("dtype,ns", [(torch.int8, 128), (torch.int8, 32),
                                      (torch.bfloat16, 64)])
def test_tile_weights_lays_each_slice_tap_by_tap(dtype, ns):
    """The kernels' shared-memory layout of a conv's weights: per slice of
    ns output channels, per 16-byte chunk of K, the slice's rows; a tap of a
    slice is one contiguous run of K / 9 / E chunks."""
    rng = np.random.default_rng(ns)
    cout, k = 128, 9 * 64
    w = torch.from_numpy(rng.integers(-127, 128, (2, cout, k))).to(dtype)
    tiled = ct.tile_weights(w, ns)
    e = 16 // w.element_size()
    assert tiled.shape == (2, cout // ns, k // e, ns, e)
    assert tiled.is_contiguous()
    for s, chunk, n in ((0, 0, 0), (cout // ns - 1, k // e - 1, ns - 1),
                        (cout // ns // 2, 7, 5)):
        assert torch.equal(tiled[1, s, chunk, n],
                           w[1, s * ns + n, chunk * e:(chunk + 1) * e])


def test_derived_values_follow_their_tensors():
    a, b = torch.ones(4), torch.zeros(3)
    made = []

    def make(x, y):
        made.append(1)
        return x.sum() + y.sum()

    first = ct.derived("t", (a, b), make)
    assert ct.derived("t", (a, b), make) is first and len(made) == 1
    a.add_(1)                                   # in place: made again
    assert float(ct.derived("t", (a, b), make)) == 8.0 and len(made) == 2
    c = a.clone()                               # another tensor: made again
    ct.derived("t", (c, b), make)
    assert len(made) == 3


def test_kmajor_weights_are_cached_per_bundle():
    cfg = NetConfig(board_size=9, action_size=81, n_res_blocks=1,
                    channels=64)
    folded = fn.fold_bn(cfg, *init_params(cfg, 0), device="cpu")
    first = fn.kmajor_weights(folded)
    assert fn.kmajor_weights(folded) is first
    assert fn.kmajor_weights(dict(folded)) is first      # same tensors
    folded["block_w"].mul_(2)                            # in-place update
    again = fn.kmajor_weights(folded)
    assert again is not first
    assert torch.equal(again[1], first[1] * 2)


def test_to_planes_layout():
    """Pixel (y, x) of board b at row b * p^2 + (y + 1) * p + x + 1, its
    channels cut into 16-byte planes; every other row zero."""
    b, s, c = 2, 5, 16
    x = torch.arange(b * s * s * c, dtype=torch.float32).reshape(b, s, s, c)
    x = x.to(torch.bfloat16)
    planes = ct.to_planes(x, 64)
    geo = ct.geometry(b, s, 64)
    assert planes.shape == (2, geo.rows_total, 8)
    p = s + 2
    for bb, y, xx in ((0, 0, 0), (1, 4, 2), (1, 0, 4)):
        row = bb * p * p + (y + 1) * p + xx + 1
        assert torch.equal(planes[:, row].reshape(-1), x[bb, y, xx])
    assert int((planes != 0).any(dim=(0, 2)).sum()) == b * s * s


@pytest.mark.parametrize("mt,size,segs", [
    (128, 9, 1), (128, 15, 2), (128, 19, 4), (128, 21, 4),
    (64, 9, 2), (64, 15, 4), (64, 19, 7), (64, 21, 8)])
@pytest.mark.parametrize("batch", [1, 40, 256, 1024])
def test_geometry_covers_every_tile(mt, size, segs, batch):
    geo = ct.geometry(batch, size, mt)
    p = size + 2
    assert (geo.pitch, geo.board_rows, geo.segs) == (p, p * p, segs)
    assert geo.n_tiles == batch * segs
    assert geo.a_rows == mt + 2 * p + 2 <= ct.a_rows_max(mt)
    # every tile's staged rows lie in the planes, and the tiles of a board
    # cover its band
    last = (batch - 1) * p * p + (segs - 1) * mt
    assert last + geo.a_rows <= geo.rows_total
    assert geo.rows_total >= batch * p * p and geo.rows_total % 8 == 0
    assert segs * mt >= size * p > (segs - 1) * mt


def test_kernel_shape_limits():
    """The checks the wrappers make before a launch: square boards up to
    ``MAX_BOARD`` (a tile's staged rows fill a board buffer's plane), a
    batch of at least one, 32-bit indices."""
    assert ct.MAX_BOARD == 21
    for mt in (64, 128):
        assert ct.geometry(1, ct.MAX_BOARD, mt).a_rows <= ct.a_rows_max(mt)
        assert ct.geometry(1, ct.MAX_BOARD + 1, mt).a_rows > ct.a_rows_max(mt)
        for size in (9, 15, 19, 21):
            for batch in (1, 40, 1024):
                geo = ct.check_kernel_shape("t", (batch, size, size), 128, 2,
                                            mt)
                assert geo == ct.geometry(batch, size, mt)
    with pytest.raises(ValueError, match="up to 21x21"):
        ct.check_kernel_shape("t", (2, 22, 22), 128, 2, 64)
    with pytest.raises(ValueError, match="square"):
        ct.check_kernel_shape("t", (2, 15, 9), 128, 1, 128)
    with pytest.raises(ValueError, match="at least 1"):
        ct.check_kernel_shape("t", (0, 15, 15), 128, 1, 128)
    with pytest.raises(ValueError, match="32-bit"):
        ct.check_kernel_shape("t", (2 ** 16, 15, 15), 128, 2, 64)


def test_library_path_hashes_the_included_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert csrc / "conv_tile.cuh" in _build.sources("int8_tower")
    assert csrc / "conv_tile.cuh" in _build.sources("fused_net")
    assert _build.sources("tree_kernels") == [csrc / "tree_kernels.cu"]
    before = {n: _build._library_path(n) for n in ("int8_tower", "fused_net",
                                                   "tree_kernels")}
    header = csrc / "conv_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in before}
    assert after["int8_tower"] != before["int8_tower"]
    assert after["fused_net"] != before["fused_net"]
    assert after["tree_kernels"] == before["tree_kernels"]
