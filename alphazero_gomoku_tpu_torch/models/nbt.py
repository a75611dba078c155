"""KataGo's nested-bottleneck residual net with global pooling
(``b18c384nbt``) as a policy/value net of the port.

From KataGo (github.com/lightvector/KataGo, ``python/katago/train/
model_pytorch.py``: ``NestedBottleneckResBlock``, ``ResBlock`` with
``ConvAndGPool``, ``KataGPool``, ``PolicyHead``, ``ValueHead``; global
pooling per arXiv:1902.10565 section 3).  Every ``act`` is ReLU and every
``norm`` an eval-mode batch norm (eps 1e-5), a per-channel affine:

  - stem: a 5x5 conv from the input planes to the trunk, no bias;
  - block (``bottlenest2``): ``x + conv1x1_q(act(norm(B2(B1(conv1x1_p(
    act(norm(x))))))))``, each inner block ``Bi(z) = z + conv3x3_2(
    act(norm(conv3x3_1(act(norm(z))))))``;
  - gpool block (``bottlenest2gpool``, the blocks in ``gpool_blocks``,
    numbered from 1): its first inner block's ``conv3x3_1(u)`` is
    ``conv_r(u) + linear_g(KataGPool(act(norm(conv_g(u)))))``, the linear
    broadcast over the board; ``KataGPool`` is ``[mean, mean * (sqrt(area)
    - 14) / 10, max]`` over the board;
  - trunk end ``t = act(norm(x))``; policy ``conv_out(act(norm(conv_p(t)
    + linear_g(KataGPool(act(norm(conv_g(t))))))))``, the 225 logits (no
    pass move); value ``fc2(act(fc1(VPool(act(norm(conv(t)))))))``, win,
    loss and no-result logits, with ``VPool = [mean, mean * (sqrt(area) -
    14) / 10, mean * ((sqrt(area) - 14)^2 / 100 - 0.1)]``; the scalar
    value is ``p_win - p_loss``.

This system's input planes replace KataGo's features (no global-feature
linear), and the score, ownership and score-belief outputs are left out.

Weights are numpy arrays in a nested layout (:func:`init_params`): convs
HWIO, linears ``[in, out]`` (``b`` where they have a bias), each norm's
``scale`` / ``bias`` in the params and its running ``mean`` / ``var`` in
the batch stats, under the same path::

    stem/w [5, 5, planes, T]
    blocks/<i>/{pre_bn [T], conv_p/w [1, 1, T, M], mid_bn [M],
                conv_q/w [1, 1, M, T], inner/<j>/...}
    inner/<j>/{bn1 [M], conv1/w [3, 3, M, R], bn2 [R], conv2/w [3, 3, R, M]}
        R = M - G in a gpool block's first inner block, which also has
        conv_g/w [3, 3, M, G], bn_g [G], linear_g/w [3G, R]; else R = M
    trunk_bn [T]
    policy/{conv_p/w [1, 1, T, p1], conv_g/w [1, 1, T, g1], bn_g [g1],
            linear_g/w [3 g1, p1], bn2 [p1], conv_out/w [1, 1, p1, 1]}
    value/{conv/w [1, 1, T, v1], bn [v1], fc1 {w [3 v1, v2], b [v2]},
           fc2 {w [v2, 3], b [3]}}

Two forwards, both ``obs NHWC [B, H, W, planes] -> (logits [B, A], value
[B, 1])``: :class:`NbtNet`, float32 plain torch modules (the ``f32``
inference mode), and :func:`bf16_apply` on :func:`fold_bf16`'s bundle (the
``bf16`` mode): every norm that follows a conv folded into it, each other
norm and its ReLU, with the residual add or the conv bias before it, one
launch of ``ops/katago_eltwise.py``'s kernel (six an ordinary block),
bf16 channels_last activations, cuDNN convs with float32 sums
(``torch.backends.cudnn.benchmark`` left off, so every run picks the same
algorithms), the convs that read one input merged, and each of the eight
global poolings a call one launch of ``ops/katago_gpool.py``'s kernel.
Its spans: ``az.nbt.trunk``,
``az.nbt.gpool`` and ``az.nbt.heads`` (``utils/profiling``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.utils.profiling import trace_annotation

BN_EPS = 1e-5
INNER = 2          # inner blocks of a nested bottleneck block
STEM_K = 5
HEAD_GAIN = 4.0    # the seeded heads' last layers, over He's scale

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NbtConfig:
    """The net's shape: ``trunk``, ``mid`` and ``gpool`` channels, the
    gpool blocks (numbered from 1) and the heads' widths; by default
    ``b18c384nbt`` on 15x15 with this system's 3 planes."""

    board_size: int = 15
    action_size: int = 15 * 15
    in_channels: int = 3
    n_blocks: int = 18
    trunk: int = 384
    mid: int = 192
    gpool: int = 64
    gpool_blocks: Tuple[int, ...] = (3, 6, 9, 12, 15, 18)
    p1: int = 64
    g1: int = 64
    v1: int = 128
    v2: int = 144

    def __post_init__(self):
        object.__setattr__(self, "gpool_blocks", tuple(self.gpool_blocks))
        if not all(1 <= i <= self.n_blocks for i in self.gpool_blocks):
            raise ValueError(f"gpool_blocks {self.gpool_blocks} are not "
                             f"among blocks 1 to {self.n_blocks}")
        if not 0 < self.gpool < self.mid:
            raise ValueError(f"gpool {self.gpool} is not under mid "
                             f"{self.mid}")
        if self.action_size != self.board_size ** 2:
            raise ValueError("the policy has one logit a point, no pass")

    def inner_width(self, block: int, inner: int) -> int:
        """``R``: the first conv's output channels of inner block
        ``inner`` (from 0) of block ``block`` (from 1)."""
        if block in self.gpool_blocks and inner == 0:
            return self.mid - self.gpool
        return self.mid


def _tree(cfg: NbtConfig, take) -> Tuple[Params, Params]:
    """``(params, batch_stats)`` in the layout of the module docstring,
    each array ``take(shape, kind, gain)``: ``conv`` (He-normal times
    ``gain``), ``dense`` (``N(0, 1 / fan_in)`` times ``gain``), ``zero``,
    or a norm's ``scale``, ``bias``, ``mean`` or ``var``."""
    branch_in, branch_out = 0.5, float(1.0 / np.sqrt(cfg.n_blocks))

    def conv(k, ci, co, gain=1.0):
        return {"w": take((k, k, ci, co), "conv", gain)}

    def bn(ch):
        return ({"scale": take((ch,), "scale"), "bias": take((ch,), "bias")},
                {"mean": take((ch,), "mean"), "var": take((ch,), "var")})

    def dense(i, o, bias=True, gain=1.0):
        d = {"w": take((i, o), "dense", gain)}
        if bias:
            d["b"] = take((o,), "zero")
        return d

    t, m, gp = cfg.trunk, cfg.mid, cfg.gpool
    params = {"stem": conv(STEM_K, cfg.in_channels, t), "blocks": []}
    stats = {"blocks": []}
    for i in range(1, cfg.n_blocks + 1):
        p, s = {"inner": []}, {"inner": []}
        p["pre_bn"], s["pre_bn"] = bn(t)
        p["conv_p"] = conv(1, t, m)
        for j in range(INNER):
            r = cfg.inner_width(i, j)
            pi, si = {}, {}
            pi["bn1"], si["bn1"] = bn(m)
            pi["conv1"] = conv(3, m, r)
            if r != m:
                pi["conv_g"] = conv(3, m, gp)
                pi["bn_g"], si["bn_g"] = bn(gp)
                pi["linear_g"] = dense(3 * gp, r, bias=False)
            pi["bn2"], si["bn2"] = bn(r)
            pi["conv2"] = conv(3, r, m, branch_in)
            p["inner"].append(pi)
            s["inner"].append(si)
        p["mid_bn"], s["mid_bn"] = bn(m)
        p["conv_q"] = conv(1, m, t, branch_out)
        params["blocks"].append(p)
        stats["blocks"].append(s)
    params["trunk_bn"], stats["trunk_bn"] = bn(t)
    pol = {"conv_p": conv(1, t, cfg.p1), "conv_g": conv(1, t, cfg.g1)}
    pst = {}
    pol["bn_g"], pst["bn_g"] = bn(cfg.g1)
    pol["linear_g"] = dense(3 * cfg.g1, cfg.p1, bias=False)
    pol["bn2"], pst["bn2"] = bn(cfg.p1)
    pol["conv_out"] = conv(1, cfg.p1, 1, HEAD_GAIN)
    val = {"conv": conv(1, t, cfg.v1)}
    vst = {}
    val["bn"], vst["bn"] = bn(cfg.v1)
    val["fc1"] = dense(3 * cfg.v1, cfg.v2)
    val["fc2"] = dense(cfg.v2, 3, gain=HEAD_GAIN)
    params["policy"], stats["policy"] = pol, pst
    params["value"], stats["value"] = val, vst
    return params, stats


def init_params(cfg: NbtConfig, seed: int) -> Tuple[Params, Params]:
    """``(params, batch_stats)`` as float32 numpy arrays (numpy's
    generator).  Convs He-normal, linears ``N(0, 1 / fan_in)`` with zero
    biases; norms away from the identity (scale ``1 + 0.1 N``, bias and
    mean ``0.1 N``, variance ``1 + 0.1 U``), so that the heads of the deep
    trunk are alive; the last conv of each inner branch at 0.5 and of each
    outer branch at ``1 / sqrt(n_blocks)`` of He's scale, so that the
    trunk's variance grows by about ``e`` over the blocks while every
    branch moves it (KataGo's own init zeroes these convs, which a net
    that is run and not trained would never use); the heads' last layers
    at ``HEAD_GAIN``, so that the priors are not near uniform."""
    rng = np.random.default_rng(seed)

    def take(shape, kind, gain=1.0):
        if kind == "conv":
            fan_in = shape[0] * shape[1] * shape[2]
            x = rng.standard_normal(shape) * gain * np.sqrt(2.0 / fan_in)
        elif kind == "dense":
            x = rng.standard_normal(shape) * gain / np.sqrt(shape[0])
        elif kind == "zero":
            x = np.zeros(shape)
        elif kind == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "var":
            x = 1.0 + 0.1 * rng.random(shape)
        else:                                  # bias, mean
            x = 0.1 * rng.standard_normal(shape)
        return x.astype(np.float32)

    return _tree(cfg, take)


# ----------------------------------------------------------------------
# the float32 module
# ----------------------------------------------------------------------
def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


def kata_gpool(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, 3C]``: mean, scaled mean, max."""
    f = (x.shape[2] * x.shape[3]) ** 0.5 - 14.0
    mean = x.mean(dim=(2, 3))
    return torch.cat([mean, mean * (f / 10.0), x.amax(dim=(2, 3))], dim=1)


def value_pool(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, 3C]``: the value head's pooling."""
    f = (x.shape[2] * x.shape[3]) ** 0.5 - 14.0
    mean = x.mean(dim=(2, 3))
    return torch.cat([mean, mean * (f / 10.0),
                      mean * (f * f / 100.0 - 0.1)], dim=1)


class InnerBlock(nn.Module):
    def __init__(self, mid: int, r: int):
        super().__init__()
        self.bn1 = _bn(mid)
        self.conv1 = nn.Conv2d(mid, r, 3, padding=1, bias=False)
        if r != mid:
            self.conv_g = nn.Conv2d(mid, mid - r, 3, padding=1, bias=False)
            self.bn_g = _bn(mid - r)
            self.linear_g = nn.Linear(3 * (mid - r), r, bias=False)
        self.bn2 = _bn(r)
        self.conv2 = nn.Conv2d(r, mid, 3, padding=1, bias=False)

    def forward(self, z):
        u = F.relu(self.bn1(z))
        r = self.conv1(u)
        if hasattr(self, "conv_g"):
            g = F.relu(self.bn_g(self.conv_g(u)))
            r = r + self.linear_g(kata_gpool(g))[:, :, None, None]
        return z + self.conv2(F.relu(self.bn2(r)))


class NbtBlock(nn.Module):
    def __init__(self, cfg: NbtConfig, block: int):
        super().__init__()
        t, m = cfg.trunk, cfg.mid
        self.pre_bn = _bn(t)
        self.conv_p = nn.Conv2d(t, m, 1, bias=False)
        self.inner = nn.ModuleList(InnerBlock(m, cfg.inner_width(block, j))
                                   for j in range(INNER))
        self.mid_bn = _bn(m)
        self.conv_q = nn.Conv2d(m, t, 1, bias=False)

    def forward(self, x):
        z = self.conv_p(F.relu(self.pre_bn(x)))
        for inner in self.inner:
            z = inner(z)
        return x + self.conv_q(F.relu(self.mid_bn(z)))


class NbtNet(nn.Module):
    """The float32 net: ``forward(obs NHWC) -> (logits [B, A], value [B,
    1])``, the value ``p_win - p_loss``.  Eval mode (:func:`bundle_of`):
    its norms are the running statistics' affines."""

    def __init__(self, cfg: NbtConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.trunk
        self.stem = nn.Conv2d(cfg.in_channels, t, STEM_K,
                              padding=STEM_K // 2, bias=False)
        self.blocks = nn.ModuleList(NbtBlock(cfg, i)
                                    for i in range(1, cfg.n_blocks + 1))
        self.trunk_bn = _bn(t)
        self.policy = nn.ModuleDict({
            "conv_p": nn.Conv2d(t, cfg.p1, 1, bias=False),
            "conv_g": nn.Conv2d(t, cfg.g1, 1, bias=False),
            "bn_g": _bn(cfg.g1),
            "linear_g": nn.Linear(3 * cfg.g1, cfg.p1, bias=False),
            "bn2": _bn(cfg.p1),
            "conv_out": nn.Conv2d(cfg.p1, 1, 1, bias=False)})
        self.value = nn.ModuleDict({
            "conv": nn.Conv2d(t, cfg.v1, 1, bias=False),
            "bn": _bn(cfg.v1),
            "fc1": nn.Linear(3 * cfg.v1, cfg.v2),
            "fc2": nn.Linear(cfg.v2, 3)})

    def forward(self, obs: torch.Tensor):
        x = self.stem(obs.permute(0, 3, 1, 2))
        for blk in self.blocks:
            x = blk(x)
        t = F.relu(self.trunk_bn(x))
        pol = self.policy
        p = pol["conv_p"](t)
        g = F.relu(pol["bn_g"](pol["conv_g"](t)))
        p = p + pol["linear_g"](kata_gpool(g))[:, :, None, None]
        logits = pol["conv_out"](F.relu(pol["bn2"](p))).flatten(1)
        val = self.value
        v = value_pool(F.relu(val["bn"](val["conv"](t))))
        wdl = torch.softmax(val["fc2"](F.relu(val["fc1"](v))), dim=-1)
        return logits, (wdl[:, 0] - wdl[:, 1])[:, None]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, np.asarray(tree, np.float32)


# a leaf's name in the params or stats -> the module's tensor
_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


def bundle_of(cfg: NbtConfig, params: Params, batch_stats: Params,
              device=None) -> NbtNet:
    """An eval-mode :class:`NbtNet` on ``device`` holding the weights;
    module paths are the layout's paths."""
    net = NbtNet(cfg)
    with torch.no_grad():
        for tree in (params, batch_stats):
            for path, x in _leaves(tree):
                mod = net.get_submodule(".".join(path[:-1]))
                if isinstance(mod, nn.BatchNorm2d):
                    dst = getattr(mod, _BN_NAMES[path[-1]])
                elif isinstance(mod, nn.Conv2d):
                    dst, x = mod.weight, np.transpose(x, (3, 2, 0, 1))
                elif path[-1] == "w":
                    dst, x = mod.weight, x.T
                else:
                    dst = mod.bias
                if tuple(dst.shape) != x.shape:
                    raise ValueError(f"{'/'.join(path)}: shape {x.shape}, "
                                     f"the net's {tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(np.ascontiguousarray(x)))
    return net.to(resolve_device(device)).eval()


# ----------------------------------------------------------------------
# the folded bf16 forward
# ----------------------------------------------------------------------
def _affine(bn: Params, st: Params) -> Tuple[np.ndarray, np.ndarray]:
    """Eval-mode batch norm as ``x * s + t``, float32 (numpy's correctly
    rounded ``sqrt``, as ``ops/fused_net._fold``)."""
    f32 = np.float32
    s = np.asarray(bn["scale"], f32) / np.sqrt(
        np.asarray(st["var"], f32) + f32(BN_EPS))
    return s, np.asarray(bn["bias"], f32) - np.asarray(st["mean"], f32) * s


def fold_bf16(cfg: NbtConfig, params: Params, batch_stats: Params,
              device=None) -> Dict:
    """The bundle of :func:`bf16_apply`, on ``device`` (None: the card).

    Conv weights bf16 OIHW, channels_last; a conv followed by its norm
    (an inner block's first conv) carries the norm in its weights and a
    bf16 bias; the convs that read one input (a gpool block's ``conv1``
    and ``conv_g``, the policy's ``conv_p`` and ``conv_g``) are one conv
    whose first channels are ``r``; each other norm is a float32 affine,
    ``[1, C, 1, 1]`` for an elementwise pass (``na``) or ``[C]`` for the
    pooling kernel (``gs``, ``gt``); linears bf16 ``[in, out]`` (the
    heads' last ones padded to 8 columns), biases float32.  On the card
    the forward's two kernels are built here, at once."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from alphazero_gomoku_tpu_torch.ops import _build
        _build.build_all(["katago_gpool", "katago_eltwise"])
    bf = torch.bfloat16

    def conv(*ws, scale=None):
        w = np.concatenate([np.asarray(x, np.float32) for x in ws], axis=3)
        if scale is not None:
            w = w * scale
        w = torch.from_numpy(np.ascontiguousarray(
            np.transpose(w, (3, 2, 0, 1))))
        return w.to(dev, bf).contiguous(memory_format=torch.channels_last)

    def na(bn, st):
        return tuple(torch.from_numpy(x).to(dev).view(1, -1, 1, 1)
                     for x in _affine(bn, st))

    def vec(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    def linear(w, cols=None):
        w = np.asarray(w, np.float32)
        if cols is not None:
            w = np.pad(w, ((0, 0), (0, cols - w.shape[1])))
        return vec(w).to(bf)

    blocks = []
    for p, s in zip(params["blocks"], batch_stats["blocks"]):
        inner = []
        for pi, si in zip(p["inner"], s["inner"]):
            d = {"n1": na(pi["bn1"], si["bn1"]),
                 "c2": conv(pi["conv2"]["w"])}
            if "conv_g" in pi:
                d["c1"] = conv(pi["conv1"]["w"], pi["conv_g"]["w"])
                d["gs"], d["gt"] = (vec(x) for x in _affine(pi["bn_g"],
                                                             si["bn_g"]))
                d["lg"] = linear(pi["linear_g"]["w"])
                d["n2"] = na(pi["bn2"], si["bn2"])
            else:
                s2, t2 = _affine(pi["bn2"], si["bn2"])
                d["c1"] = conv(pi["conv1"]["w"], scale=s2)
                d["b1"] = vec(t2).to(bf)
            inner.append(d)
        blocks.append({"pre": na(p["pre_bn"], s["pre_bn"]),
                       "cp": conv(p["conv_p"]["w"]), "inner": inner,
                       "mid": na(p["mid_bn"], s["mid_bn"]),
                       "cq": conv(p["conv_q"]["w"])})
    pp, ps = params["policy"], batch_stats["policy"]
    vp, vs = params["value"], batch_stats["value"]
    gs, gt = _affine(pp["bn_g"], ps["bn_g"])
    vgs, vgt = _affine(vp["bn"], vs["bn"])
    return {
        "stem": conv(params["stem"]["w"]), "blocks": blocks,
        "trunk": na(params["trunk_bn"], batch_stats["trunk_bn"]),
        "policy": {"cpg": conv(pp["conv_p"]["w"], pp["conv_g"]["w"]),
                   "gs": vec(gs), "gt": vec(gt),
                   "lg": linear(pp["linear_g"]["w"]),
                   "n2": na(pp["bn2"], ps["bn2"]),
                   "out": linear(np.asarray(pp["conv_out"]["w"]).reshape(
                       cfg.p1, 1), 8)},
        "value": {"c": conv(vp["conv"]["w"]), "gs": vec(vgs),
                  "gt": vec(vgt), "w1": linear(vp["fc1"]["w"]),
                  "b1": vec(vp["fc1"]["b"]),
                  "w2": linear(vp["fc2"]["w"], 8),
                  "b2": vec(vp["fc2"]["b"])},
    }


def bf16_apply(cfg: NbtConfig, bundle: Dict, obs: torch.Tensor,
               eltwise=None):
    """The folded bf16 forward (module docstring): ``(logits [B, A],
    value [B, 1])``, float32.  Each norm-and-ReLU, with the residual add
    or the conv bias before it, is one pass of ``eltwise``
    (``ops/katago_eltwise.py``'s kernel on the card; its plain version,
    the torch composition, when given ``eltwise_plain``)."""
    # imported here: ops.fused_net imports models.resnet
    from alphazero_gomoku_tpu_torch.ops.fused_net import _mm_f32
    from alphazero_gomoku_tpu_torch.ops.katago_gpool import gpool
    if eltwise is None:
        from alphazero_gomoku_tpu_torch.ops.katago_eltwise import eltwise

    bf = torch.bfloat16
    b = obs.shape[0]
    blocks = bundle["blocks"]
    with torch.no_grad():
        with trace_annotation("az.nbt.trunk"):
            x = F.conv2d(obs.permute(0, 3, 1, 2).to(bf), bundle["stem"],
                         padding=STEM_K // 2)
            # h: the next norm-ReLU of the trunk, fused with the residual
            # add before it; each sum stored only where it is read again
            h = eltwise(x, blocks[0]["pre"] if blocks else bundle["trunk"])
            for i, blk in enumerate(blocks):
                z = F.conv2d(h, blk["cp"])
                inner = blk["inner"]
                u = eltwise(z, inner[0]["n1"])
                for j, inn in enumerate(inner):
                    if "lg" in inn:
                        rg = F.conv2d(u, inn["c1"], padding=1)
                        r = rg[:, :inn["lg"].shape[1]]
                        with trace_annotation("az.nbt.gpool"):
                            gpool(rg[:, r.shape[1]:], inn["gs"], inn["gt"],
                                  inn["lg"], r)
                        m = eltwise(r, inn["n2"])
                    else:
                        m = F.conv2d(u, inn["c1"], padding=1)
                        eltwise(m, bias=inn["b1"], out=m)
                    last = j + 1 == len(inner)
                    u = eltwise(z, blk["mid"] if last else inner[j + 1]["n1"],
                                add=F.conv2d(m, inn["c2"], padding=1),
                                store=not last)
                more = i + 1 < len(blocks)
                h = eltwise(x, blocks[i + 1]["pre"] if more
                            else bundle["trunk"],
                            add=F.conv2d(u, blk["cq"]), store=more)
            t = h
        with trace_annotation("az.nbt.heads"):
            pol = bundle["policy"]
            pg = F.conv2d(t, pol["cpg"])
            p = pg[:, :cfg.p1]
            with trace_annotation("az.nbt.gpool"):
                gpool(pg[:, cfg.p1:], pol["gs"], pol["gt"], pol["lg"], p)
            rows = eltwise(p, pol["n2"]).permute(0, 2, 3, 1).reshape(
                -1, cfg.p1)
            logits = _mm_f32(rows, pol["out"])[:, 0].reshape(b, -1)
            val = bundle["value"]
            with trace_annotation("az.nbt.gpool"):
                pooled = gpool(F.conv2d(t, val["c"]), val["gs"], val["gt"])
            h = torch.relu(_mm_f32(pooled.to(bf), val["w1"]) + val["b1"])
            wdl = torch.softmax(_mm_f32(h.to(bf), val["w2"])[:, :3]
                                + val["b2"], dim=-1)
            return logits, (wdl[:, 0] - wdl[:, 1])[:, None]


def make_bf16_eval_fn(cfg: NbtConfig):
    """MCTS eval function backed by :func:`bf16_apply`; the bundle is
    :func:`fold_bf16`'s."""

    def eval_fn(bundle: Dict, obs: torch.Tensor):
        logits, value = bf16_apply(cfg, bundle, obs)
        return torch.softmax(logits, dim=-1), value

    return eval_fn
