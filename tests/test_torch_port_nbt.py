"""KataGo's nested-bottleneck net in the port (``models/nbt.py``) against the
benchmark's plain reference of it (``benchmark/reference/katago_nbt.py``,
written apart from the port), its global pooling's plain version against
the pooling formulas, ``net_config_of`` on the configuration files, and a
self-play call with the net behind it, on the CPU."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from alphazero_gomoku_tpu_torch import models  # noqa: E402
from alphazero_gomoku_tpu_torch.games import make_env  # noqa: E402
from alphazero_gomoku_tpu_torch.models import nbt  # noqa: E402
from alphazero_gomoku_tpu_torch.ops import katago_eltwise  # noqa: E402
from alphazero_gomoku_tpu_torch.ops import katago_gpool  # noqa: E402
from alphazero_gomoku_tpu_torch.search import MCTSConfig  # noqa: E402
from alphazero_gomoku_tpu_torch.selfplay import (  # noqa: E402
    SelfPlayConfig,
    play_games,
)
from benchmark import calib as bcalib  # noqa: E402
from benchmark import spec  # noqa: E402
from benchmark.reference import replay  # noqa: E402
from benchmark.reference.games import Game  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401  (autouse)

NBT_FILE = "gomoku15-b18c384nbt-bf16"
RESNET_FILES = ("gomoku15-6x128-int8t", "pente15-6x128-cap5-int8t")
# one gpool period at a small size
SMALL = {"arch": "katago_nbt", "board_size": 15, "in_channels": 3,
         "n_blocks": 3, "trunk_channels": 32, "mid_channels": 16,
         "gpool_channels": 8, "gpool_blocks": [3], "p1_channels": 8,
         "g1_channels": 8, "v1_channels": 16, "v2_size": 24, "peak": "bf16"}
# the published widths, 3 blocks
WIDE = dict(SMALL, trunk_channels=384, mid_channels=192, gpool_channels=64,
            p1_channels=64, g1_channels=64, v1_channels=128, v2_size=144)


def _net():
    return spec.net("katago_nbt")


def _boards(n, seed=3):
    return torch.as_tensor(bcalib.random_play_boards(Game("gomoku", 15), n,
                                                     seed))


def _config_file(name):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", RESNET_FILES)
def test_net_config_of_resnet_is_the_fallback(name):
    """The shipped resnet configurations give the ``NetConfig`` that
    ``benchmark/program.py``'s fallback builds, field for field."""
    config = _config_file(name)
    size = config["board_size"]
    fallback = models.NetConfig(
        board_size=size, action_size=size * size,
        in_channels=config["in_channels"],
        **{k: config[k] for k in spec.net("resnet").KEYS})
    got = models.net_config_of(config)
    assert type(got) is models.NetConfig
    for field in ("board_size", "action_size", "in_channels", "n_res_blocks",
                  "channels", "value_hidden", "compute_dtype"):
        assert getattr(got, field) == getattr(fallback, field), field
    assert got == fallback


def test_net_config_of_katago_nbt_and_unknown():
    cfg = models.net_config_of(_config_file(NBT_FILE))
    assert cfg == models.NbtConfig()
    assert (cfg.n_blocks, cfg.trunk, cfg.mid, cfg.gpool) == (18, 384, 192,
                                                             64)
    assert cfg.gpool_blocks == (3, 6, 9, 12, 15, 18)
    with pytest.raises(ValueError, match="katago_nbt"):
        models.net_config_of(dict(SMALL, arch="transformer"))


def test_flops_of_b18c384nbt():
    """11.70 GFLOP a board: 12 plain blocks of 663.6 MFLOP, 6 gpool blocks
    of 613.8, the stem and heads about 0.06 GFLOP; 26 M weights."""
    net, c = _net(), _config_file(NBT_FILE)
    assert net.flops_per_eval(c) == pytest.approx(11.703e9, rel=1e-4)
    assert net.weight_count(c) == pytest.approx(26.22e6, rel=1e-3)
    assert net.call_least_s(256, c) == pytest.approx(3.028e-3, rel=1e-3)


def test_port_init_has_the_benchmark_layout():
    """``nbt.init_params`` (numpy's generator) and the benchmark's
    ``init`` (torch's) give the same tree of shapes, and both fill the
    float32 module."""
    cfg = models.net_config_of(SMALL)
    ours = nbt.init_params(cfg, 1)
    theirs = _net().init(SMALL, 1)

    def shapes(tree):
        return sorted((p, x.shape) for p, x in nbt._leaves(tree))

    for a, b in zip(ours, theirs):
        assert shapes(a) == shapes(b)
    nbt.bundle_of(cfg, *ours, device="cpu")
    bad = nbt.init_params(cfg, 1)
    bad[0]["stem"]["w"] = bad[0]["stem"]["w"][:3]
    with pytest.raises(ValueError, match="stem/w"):
        nbt.bundle_of(cfg, *bad, device="cpu")


def test_nbtnet_equals_reference_at_float32():
    """The port's float32 module against the reference's float32 forward,
    on seeded weights.  ``BatchNorm2d`` computes ``(x - mean) /
    sqrt(var + eps) * w + b``, the reference ``x * s + t``: a few float32
    ulps a layer, 1.4e-6 of a prior (3.8e-6 relative) at most here."""
    params, stats = _net().init(SMALL, 11)
    obs = _boards(8)
    probs_ref, value_ref = _net().make(params, stats, None, "cpu",
                                       {"dtype": "float32"})(obs)
    eval_fn, bundle = models.make_inference(
        "f32", models.net_config_of(SMALL), params, stats, device="cpu")
    probs, value = eval_fn(bundle, obs)
    assert value.shape == (8, 1)
    torch.testing.assert_close(probs, probs_ref, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(value[:, 0], value_ref, rtol=2e-5, atol=2e-6)


# The bf16 path stores every conv's output, the trunk and the pooled sums
# in bf16 (2^-9 relative a rounding), where the bfloat16 reference rounds
# only each conv's and linear's input and weight: rounding the reference's
# conv outputs alone moves its priors by up to 0.019 in total variation at
# the published widths.  TV_BF16 is over twice that; the int4 control's
# priors lie 0.23-0.34 away.
TV_BF16 = 0.05
VALUE_BF16 = 0.01
TV_CONTROL = 0.1


def _tv(a, b):
    return 0.5 * (a - b).abs().sum(dim=-1)


@pytest.mark.parametrize("config", [SMALL, WIDE], ids=["small", "wide"])
def test_bf16_path_is_near_the_bfloat16_reference(config):
    params, stats = _net().init(config, 7)
    obs = _boards(8)
    ref = _net().make(params, stats, None, "cpu", {"dtype": "bfloat16"})
    probs_ref, value_ref = ref(obs)
    eval_fn, bundle = models.make_inference(
        "bf16", models.net_config_of(config), params, stats, device="cpu")
    probs, value = eval_fn(bundle, obs)
    assert probs.dtype == value.dtype == torch.float32
    assert float(_tv(probs, probs_ref).max()) <= TV_BF16
    assert float((value[:, 0] - value_ref).abs().max()) <= VALUE_BF16
    control = _net().make(params, stats, bcalib.random_play_boards(
        Game("gomoku", 15), 32, 4), "cpu", {"qmax": 7})
    probs_q, _ = control(obs)
    assert float(_tv(probs_q, probs_ref).min()) > TV_CONTROL


def test_bf16_bundle_folds_each_norm_once():
    """A plain inner block's first conv carries its norm; a gpool block's
    first convs are one conv whose first channels are ``r``."""
    cfg = models.net_config_of(SMALL)
    params, stats = _net().init(SMALL, 2)
    bundle = nbt.fold_bf16(cfg, params, stats, device="cpu")
    plain, gp = bundle["blocks"][0]["inner"][0], bundle["blocks"][2]["inner"][0]
    assert set(plain) == {"n1", "c1", "b1", "c2"}
    assert set(gp) == {"n1", "c1", "gs", "gt", "lg", "n2", "c2"}
    assert gp["c1"].shape == (16, 16, 3, 3) and gp["lg"].shape == (24, 8)
    assert bundle["stem"].dtype == torch.bfloat16
    assert bundle["stem"].is_contiguous(memory_format=torch.channels_last)


def _pool_inputs(b, c, r, seed=0, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((b, 15, 15, c + r), generator=gen).to(dtype)
    g = g.permute(0, 3, 1, 2)          # channels_last, as a merged conv's
    scale = 1 + 0.1 * torch.randn(c, generator=gen)
    shift = 0.1 * torch.randn(c, generator=gen)
    w = (torch.randn((3 * c, r), generator=gen) / 8).to(torch.bfloat16)
    return g[:, r:], scale, shift, w, g[:, :r]


def test_plain_pooling_is_the_formulas():
    """KataGPool: ``[mean, mean * (15 - 14) / 10, max]`` of the ReLU'd
    affine, times the bf16 linear in float32, added over the board;
    the value head's: ``[mean, mean / 10, mean * (1 / 100 - 0.1)]``."""
    g, scale, shift, w, r = _pool_inputs(4, 8, 16)
    a = torch.relu(g.float() * scale[:, None, None] + shift[:, None, None])
    mean, mx = a.mean(dim=(2, 3)), a.amax(dim=(2, 3))
    value = katago_gpool.gpool(g, scale, shift)
    torch.testing.assert_close(value, torch.cat(
        [mean, mean * 0.1, mean * -0.09], dim=1), rtol=1e-6, atol=0)
    pooled = torch.cat([mean, 0.1 * mean, mx], dim=1)
    add = pooled @ w.float()
    want = (r.float() + add[:, :, None, None]).to(torch.bfloat16)
    out = katago_gpool.gpool(g, scale, shift, w, r.clone())
    torch.testing.assert_close(out.float(), want.float(), rtol=2 ** -8,
                               atol=0)
    # in place on a channel slice of the merged output
    before = g.clone()
    katago_gpool.gpool(g, scale, shift, w, r)
    assert torch.equal(r, out) and torch.equal(g, before[:, :])
    with pytest.raises(ValueError, match="together"):
        katago_gpool.gpool(g, scale, shift, w)
    assert katago_gpool.factors(15, 15) == pytest.approx((0.1, -0.09))


def test_reference_pooling_is_the_formulas():
    from benchmark.reference import katago_nbt as ref
    g, scale, shift, w, r = _pool_inputs(3, 8, 8, dtype=torch.float32)
    x = torch.relu(g * scale[:, None, None] + shift[:, None, None])
    torch.testing.assert_close(ref.kata_gpool(x), nbt.kata_gpool(x))
    torch.testing.assert_close(ref.value_gpool(x), nbt.value_pool(x))
    torch.testing.assert_close(nbt.value_pool(x),
                               katago_gpool.gpool(g, scale, shift),
                               rtol=1e-6, atol=0)


def test_seeded_heads_are_alive_at_the_published_widths():
    """3 blocks at 384/192/64 on 8 boards: the value varies and is not
    saturated, the priors are far from uniform, and zeroing any one
    block's branch (its last conv, or the linear of its pooling) moves
    the output."""
    cfg = models.net_config_of(WIDE)
    params, stats = _net().init(WIDE, 5)
    obs = _boards(8, seed=9)
    net = nbt.bundle_of(cfg, params, stats, device="cpu")
    with torch.no_grad():
        logits, value = net(obs)
    probs = torch.softmax(logits, dim=-1)
    assert float(value.abs().max()) < 0.95
    assert float(value.max() - value.min()) > 1e-3
    entropy = -(probs * torch.log(probs)).sum(dim=-1)
    assert float(entropy.max()) < np.log(225) - 0.3
    assert float(probs.max(dim=-1).values.min()) > 5.0 / 225
    for i, blk in enumerate(net.blocks):
        for name, weight in [("conv_q", blk.conv_q.weight)] + [
                (f"inner{j}.conv2", inner.conv2.weight)
                for j, inner in enumerate(blk.inner)] + [
                (f"inner{j}.linear_g", inner.linear_g.weight)
                for j, inner in enumerate(blk.inner)
                if hasattr(inner, "linear_g")]:
            kept = weight.detach().clone()
            with torch.no_grad():
                weight.zero_()
                zl, zv = net(obs)
                weight.copy_(kept)
            moved = max(float((zl - logits).abs().max()),
                        float((zv - value).abs().max()))
            assert moved > 1e-4, (i, name)


# the elementwise passes at b18c384nbt's widths: (channels of the tensor,
# channels of the pass, a slice's first channel): the trunk, the mid, a
# gpool block's 128 of 192, the policy head's 64 of 128
ELTWISE_WIDTHS = [(384, 384, 0), (192, 192, 0), (192, 128, 0), (128, 64, 0)]
ELTWISE_MODES = ["norm_relu", "add_store", "add", "bias_relu"]


def _eltwise_inputs(width, c, first, seed=0, batch=3):
    """Channels_last bf16 ``x`` and ``y`` (channel slices when ``c <
    width``), a norm's affine ``[1, C, 1, 1]`` and a bf16 bias, as the
    bundle holds them."""
    gen = torch.Generator().manual_seed(seed)

    def planes():
        t = (2 * torch.randn((batch, 15, 15, width), generator=gen)).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        return t[:, first:first + c]

    x, y = planes(), planes()
    scale = (1 + 0.3 * torch.randn(c, generator=gen)).view(1, c, 1, 1)
    shift = (0.3 * torch.randn(c, generator=gen)).view(1, c, 1, 1)
    bias = (0.3 * torch.randn(c, generator=gen)).to(torch.bfloat16)
    return x, y, (scale, shift), bias


def _old_na(x, affine):
    """The bf16 forward's norm-ReLU before the fused passes."""
    out = torch.empty_like(x, memory_format=torch.channels_last)
    return torch.addcmul(affine[1], x, affine[0], out=out).relu_()


@pytest.mark.parametrize("width,c,first", ELTWISE_WIDTHS)
@pytest.mark.parametrize("mode", ELTWISE_MODES)
def test_plain_eltwise_is_the_old_composition(mode, width, c, first):
    """``eltwise_plain`` in each mode equals the forward's former torch
    composition bit for bit: ``addcmul`` and ``relu_`` for a norm-ReLU,
    ``add_`` before it for a residual add (stored or not), and the conv
    bias's broadcast ``add_`` and ``relu_``; ``eltwise`` on CPU tensors is
    the plain version and launches nothing."""
    x, y, affine, bias = _eltwise_inputs(width, c, first, seed=c + first)
    kept = x.clone()
    launches = katago_eltwise.eltwise.launches
    if mode == "norm_relu":
        want, got = _old_na(x, affine), katago_eltwise.eltwise_plain(
            x, affine)
        x_want = kept
    elif mode in ("add_store", "add"):
        z = kept.clone()
        want = _old_na(z.add_(y), affine)
        got = katago_eltwise.eltwise_plain(x, affine, add=y,
                                           store=mode == "add_store")
        x_want = z if mode == "add_store" else kept
    else:
        want = kept.clone().add_(bias.view(1, -1, 1, 1)).relu_()
        got = katago_eltwise.eltwise_plain(x, bias=bias)
        x_want = kept
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want) and torch.equal(x, x_want)
    assert (got >= 0).all() and (got == 0).any() and (got > 0).any()
    x.copy_(kept)
    again = katago_eltwise.eltwise(x, None if mode == "bias_relu" else affine,
                                   add=y if mode.startswith("add") else None,
                                   store=mode == "add_store",
                                   bias=bias if mode == "bias_relu" else None)
    assert torch.equal(again, want) and torch.equal(x, x_want)
    assert katago_eltwise.eltwise.launches == launches


def test_plain_eltwise_in_place_and_its_modes():
    """The bias-ReLU in place (``out=x``), as the forward runs it on a
    conv's output; the modes that do not exist raise."""
    x, y, affine, bias = _eltwise_inputs(192, 192, 0, seed=5)
    want = x.clone().add_(bias.view(1, -1, 1, 1)).relu_()
    got = katago_eltwise.eltwise_plain(x, bias=bias, out=x)
    assert got is x and torch.equal(x, want)
    for kw, match in ((dict(), "one of them"),
                      (dict(affine=affine, bias=bias), "one of them"),
                      (dict(bias=bias, add=y), "not both"),
                      (dict(affine=affine, store=True), "needs add"),
                      (dict(affine=affine, add=y, store=True, out=x),
                       "into its output")):
        for fn in (katago_eltwise.eltwise_plain, katago_eltwise.eltwise):
            with pytest.raises(ValueError, match=match):
                fn(x, **kw)


def _old_bf16_apply(cfg, bundle, obs):
    """The bf16 forward as it was before the fused passes, with a conv's
    bias added as torch adds it after a cuDNN conv (a broadcast ``add_``)."""
    from alphazero_gomoku_tpu_torch.ops.fused_net import _mm_f32
    F = torch.nn.functional
    bf = torch.bfloat16
    b = obs.shape[0]
    x = F.conv2d(obs.permute(0, 3, 1, 2).to(bf), bundle["stem"], padding=2)
    for blk in bundle["blocks"]:
        z = F.conv2d(_old_na(x, blk["pre"]), blk["cp"])
        for inn in blk["inner"]:
            u = _old_na(z, inn["n1"])
            if "lg" in inn:
                rg = F.conv2d(u, inn["c1"], padding=1)
                r = rg[:, :inn["lg"].shape[1]]
                katago_gpool.gpool(rg[:, r.shape[1]:], inn["gs"], inn["gt"],
                                   inn["lg"], r)
                m = _old_na(r, inn["n2"])
            else:
                m = F.conv2d(u, inn["c1"], padding=1).add_(
                    inn["b1"].view(1, -1, 1, 1)).relu_()
            z.add_(F.conv2d(m, inn["c2"], padding=1))
        x.add_(F.conv2d(_old_na(z, blk["mid"]), blk["cq"]))
    t = _old_na(x, bundle["trunk"])
    pol = bundle["policy"]
    pg = F.conv2d(t, pol["cpg"])
    p = pg[:, :cfg.p1]
    katago_gpool.gpool(pg[:, cfg.p1:], pol["gs"], pol["gt"], pol["lg"], p)
    rows = _old_na(p, pol["n2"]).permute(0, 2, 3, 1).reshape(-1, cfg.p1)
    logits = _mm_f32(rows, pol["out"])[:, 0].reshape(b, -1)
    val = bundle["value"]
    pooled = katago_gpool.gpool(F.conv2d(t, val["c"]), val["gs"], val["gt"])
    h = torch.relu(_mm_f32(pooled.to(bf), val["w1"]) + val["b1"])
    wdl = torch.softmax(_mm_f32(h.to(bf), val["w2"])[:, :3] + val["b2"],
                        dim=-1)
    return logits, (wdl[:, 0] - wdl[:, 1])[:, None]


@pytest.mark.parametrize("n_blocks", [3, 1])
def test_fused_passes_keep_the_forward_bit_for_bit(n_blocks):
    """The forward with each add fused into the next norm-ReLU and each
    sum stored only where it is read again equals the former forward bit
    for bit (plain passes on the CPU), over a gpool block, an ordinary
    one, and a net of one block (whose end is the trunk's norm)."""
    config = dict(SMALL, n_blocks=n_blocks,
                  gpool_blocks=[3] if n_blocks == 3 else [1])
    cfg = models.net_config_of(config)
    params, stats = _net().init(config, 13)
    bundle = nbt.fold_bf16(cfg, params, stats, device="cpu")
    obs = _boards(6, seed=21)
    logits, value = nbt.bf16_apply(cfg, bundle, obs)
    want_logits, want_value = _old_bf16_apply(cfg, bundle, obs)
    assert torch.equal(logits, want_logits) and torch.equal(value, want_value)
    assert float(logits.std()) > 0.1


@pytest.mark.parametrize("mode", ["int8", "int8t", "fused", "nosuch"])
def test_make_inference_refuses_other_modes(mode):
    params, stats = _net().init(SMALL, 1)
    with pytest.raises(ValueError, match="bf16"):
        models.make_inference(mode, models.net_config_of(SMALL), params,
                              stats, device="cpu")


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_play_games_with_the_small_net(mode):
    """Two plies of four lanes with the small net behind Gumbel@8: every
    record replays by the reference's rules."""
    params, stats = _net().init(SMALL, 3)
    eval_fn, bundle = models.make_inference(
        mode, models.net_config_of(SMALL), params, stats, device="cpu")
    mcts = MCTSConfig(n_simulations=8, search="gumbel",
                      gumbel_max_considered=4, max_depth=8)
    cfg = SelfPlayConfig(batch_games=4, mcts=mcts, max_moves=2,
                         opening_random_moves=1)
    env = make_env("gomoku", 15)
    traj = play_games(env, cfg, eval_fn, bundle,
                      torch.Generator().manual_seed(4), "cpu")
    assert traj.moves_played.tolist() == [2, 2, 2, 2]
    rec = {"boards": traj.boards, "players": traj.players,
           "captures": traj.captures, "pis": traj.pis,
           "root_qs": traj.root_qs, "actions": traj.actions,
           "active": traj.active, "winners": traj.winners,
           "moves_played": traj.moves_played}
    sp = replay.SelfPlay(batch=4, plies=2, opening_random_moves=1)
    bad = replay.game_mismatches(Game("gomoku", 15), sp, rec)
    assert bad == {"records": 0, "illegal": 0, "games": 0, "lanes": 0}
    pis = traj.pis[1]
    assert torch.allclose(pis.sum(dim=-1), torch.ones(4))
