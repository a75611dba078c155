"""Eval-mode network with BatchNorm folded away: the fused bf16 tower and the
folded bf16 cuDNN forward.

Counterpart of ``alphazero_gomoku_tpu/ops/fused_net.py``:

  - :func:`fold_bn` folds eval-mode BN into each conv (``W' = W * s``,
    ``b = beta - mean * s``, ``s = gamma / sqrt(var + eps)``) and stacks the
    weights for the tower, from numpy params and batch stats in the JAX
    layout (``models/resnet.init_params``).  The JAX version pads the stem's
    input channels to the tower width, a workaround for its TPU compiler;
    here the stem keeps its ``cin`` real channels (``stem_w [9, cin, C]``),
    which computes the same function.
  - :func:`fused_tower` is the tower (stem and ``2L`` 3x3 SAME convs, bias,
    ReLU, residual) as the hand-written CUDA kernel in ``csrc/fused_net.cu``
    on a CUDA tensor, and as :func:`fused_tower_plain` on a CPU tensor.
    Precision as the TPU kernel: activations and the residual track in
    float32, each conv's input rounded to bf16, bf16 weights, float32 sums;
    bias, ReLU and the residual add in float32.  The kernel runs on
    padded-board tiles (``ops/conv_tile.py``) with K-major weights
    (:func:`kmajor_weights`, re-packed once per bundle).  The wrapper counts
    its calls that reach the kernel in ``fused_tower.launches`` (one per
    tower; a tower is 1 + 2L CUDA launches).
  - :func:`fused_predict` is the tower plus the policy and value heads as
    plain torch ops (the JAX heads are XLA outside the kernel);
    :func:`folded_apply_plain` is the same with the plain tower.
  - :func:`fold_bn_xla`, :func:`folded_xla_apply` and
    :func:`make_bf16_eval_fn`: the folded forward with bf16 activations
    between layers, as plain torch (im2col and a bf16 matmul with float32
    output on the card).  No kernel of the port: the JAX package runs it as
    XLA.  ``chip_smoke.py`` times its tower as the library yardstick of
    :func:`fused_tower`.

Layouts are the JAX package's: observations and the tower's activations
NHWC ``[B, H, W, C]``; conv weights ``[9, Cin, Cout]`` (tap ``3*dy + dx``);
the policy FC's rows in HWC flatten order.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models.resnet import BN_EPS, NetConfig, Params
from alphazero_gomoku_tpu_torch.ops import _build, conv_tile
from alphazero_gomoku_tpu_torch.ops.tree_kernels import _check

Folded = Dict[str, torch.Tensor]

KERNEL_CHANNELS = (64, 128)
KERNEL_TILE = 64        # output rows of the kernel's tiles (conv_tile.py)
KERNEL_SLICE = 64       # output channels of a kernel block
STEM_K_ALIGN = 16       # the bf16 wgmma's depth
STEM_K_MAX = 64         # the kernel's stem takes K of 16 to 64


# ----------------------------------------------------------------------
# BN folding (once per parameter update)
# ----------------------------------------------------------------------
def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _fold(conv_w, bn_p, bn_s) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv + BN(eval) -> conv' + bias, in float32.

    Computed with numpy, whose float32 ``sqrt`` is correctly rounded as the
    JAX package's is (torch's CPU ``sqrt`` is not, always), so both packages
    fold to the same bits.
    """
    f32 = np.float32
    s = np.asarray(bn_p["scale"], f32) / np.sqrt(
        np.asarray(bn_s["var"], f32) + f32(BN_EPS))
    w = np.asarray(conv_w, f32) * s
    b = np.asarray(bn_p["bias"], f32) - np.asarray(bn_s["mean"], f32) * s
    return _t(w), _t(b)


def _taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` -> ``[9, Cin, Cout]``."""
    return w.reshape(9, w.shape[2], w.shape[3])


def fold_bn(cfg: NetConfig, params: Params, batch_stats: Params,
            dtype=torch.bfloat16, device=None) -> Folded:
    """Fold eval-mode BN into the conv weights; stack them for the tower.

    Returns tensors on ``device`` (None: the CUDA card):
      stem_w [9, cin, C], stem_b [C]; block_w [L, 2, 9, C, C], block_b [L, 2, C];
      pol_w [C, 2] pol_b [2] pol_fc_w [2HW, A] pol_fc_b [A];
      val_w [C, 1] val_b [1] val_fc1_w [HW, hidden] val_fc1_b
      val_fc2_w [hidden, 1] val_fc2_b [1].
    Weights are in ``dtype``, biases float32, as in the JAX ``fold_bn``.
    """
    dev = resolve_device(device)
    stem_w, stem_b = _fold(params["stem"]["w"], params["stem_bn"],
                           batch_stats["stem_bn"])
    bw, bb = [], []
    for blk, bs in zip(params["blocks"], batch_stats["blocks"]):
        w1, b1 = _fold(blk["conv1"]["w"], blk["bn1"], bs["bn1"])
        w2, b2 = _fold(blk["conv2"]["w"], blk["bn2"], bs["bn2"])
        bw.append(torch.stack([_taps(w1), _taps(w2)]))
        bb.append(torch.stack([b1, b2]))
    pol_w, pol_b = _fold(params["policy_conv"]["w"], params["policy_bn"],
                         batch_stats["policy_bn"])
    val_w, val_b = _fold(params["value_conv"]["w"], params["value_bn"],
                         batch_stats["value_bn"])
    c = cfg.channels
    out = {
        "stem_w": _taps(stem_w).to(dtype),
        "stem_b": stem_b,
        "block_w": torch.stack(bw).to(dtype),
        "block_b": torch.stack(bb),
        "pol_w": pol_w.reshape(c, 2).to(dtype),
        "pol_b": pol_b,
        "pol_fc_w": _t(params["policy_fc"]["w"]).to(dtype),
        "pol_fc_b": _t(params["policy_fc"]["b"]),
        "val_w": val_w.reshape(c, 1).to(dtype),
        "val_b": val_b,
        "val_fc1_w": _t(params["value_fc1"]["w"]).to(dtype),
        "val_fc1_b": _t(params["value_fc1"]["b"]),
        "val_fc2_w": _t(params["value_fc2"]["w"]).to(dtype),
        "val_fc2_b": _t(params["value_fc2"]["b"]),
    }
    return {k: v.contiguous().to(dev) for k, v in out.items()}


# ----------------------------------------------------------------------
# the tower: plain version and kernel
# ----------------------------------------------------------------------
def _conv3_plain(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                 sum_dtype=torch.float32) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` as 9 shifted matmuls: the input rounded to
    bf16, products and sums in ``sum_dtype``, plus bias; the output rounded
    once to float32 (nothing to round from float32 sums)."""
    b, h, w, cin = x.shape
    xb = x.to(torch.bfloat16).to(sum_dtype)
    pad = F.pad(xb, (0, 0, 1, 1, 1, 1))
    out = None
    for k in range(9):
        dr, dc = divmod(k, 3)
        piece = pad[:, dr:dr + h, dc:dc + w, :].reshape(b * h * w, cin)
        term = piece @ taps[k].to(sum_dtype)
        out = term if out is None else out + term
    return (out + bias.to(sum_dtype)).to(torch.float32).reshape(b, h, w, -1)


def fused_tower_plain(folded: Folded, obs: torch.Tensor,
                      sum_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch tower: ``obs [B, H, W, cin]`` -> float32 ``[B, H, W, C]``.

    ``sum_dtype`` float32 is the kernel's plain version.  float64 gives the
    reference that a float32 order of summation is held against: the same
    bf16 storage points, each conv's sums exact to float64 and its output
    rounded once to float32; the residual add and ReLU stay float32.
    """
    x = torch.relu(_conv3_plain(obs.to(torch.float32), folded["stem_w"],
                                folded["stem_b"], sum_dtype))
    for i in range(folded["block_w"].shape[0]):
        r = x
        y = torch.relu(_conv3_plain(x, folded["block_w"][i, 0],
                                    folded["block_b"][i, 0], sum_dtype))
        z = _conv3_plain(y, folded["block_w"][i, 1], folded["block_b"][i, 1],
                         sum_dtype)
        x = torch.relu(z + r)
    return x


def _library() -> ctypes.CDLL:
    lib = _build.build("fused_net").lib
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_tower_launch.argtypes = [p, i, i, i, i, i, i, p, p, p, p,
                                           p, p, i, p, p]
        lib.fused_tower_launch.restype = i
        lib._argtypes_set = True
    return lib


def kmajor_weights(folded: Folded) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded weights re-packed K-contiguous, as the kernel's wgmma B
    operand wants them: ``stem [C, KS]`` (column ``(3*dy + dx)*cin + ci``,
    zero up to ``KS = 9*cin`` rounded up to 16) and ``blocks [L, 2, C,
    9*C]`` (column ``(3*dy + dx)*C + ci``).  Made once per bundle
    (``conv_tile.derived``); ``fold_bn``'s own output is left as it is."""

    def make(stem, block):
        _, cin, c = stem.shape
        ks = -(-9 * cin // STEM_K_ALIGN) * STEM_K_ALIGN
        stem_k = F.pad(stem.permute(2, 0, 1).reshape(c, 9 * cin),
                       (0, ks - 9 * cin)).contiguous()
        block_k = block.permute(0, 1, 4, 2, 3).reshape(
            block.shape[0], 2, c, 9 * c).contiguous()
        return stem_k, block_k

    return conv_tile.derived("fused_kmajor",
                             (folded["stem_w"], folded["block_w"]), make)


def fused_tower(folded: Folded, obs: torch.Tensor) -> torch.Tensor:
    """The residual tower: ``obs [B, H, W, cin]`` f32 -> f32 ``[B, H, W, C]``.

    CPU tensors take :func:`fused_tower_plain`; CUDA tensors the kernel, or
    raise: it takes ``C`` of 64 or 128 and square boards up to
    ``conv_tile.MAX_BOARD`` (21).
    """
    if obs.dim() != 4:
        raise ValueError(f"obs must be [B, H, W, cin], got {tuple(obs.shape)}")
    b, h, w, cin = obs.shape
    dev = obs.device
    l_blocks, _, _, c, _ = folded["block_w"].shape
    _check(obs, "obs", torch.float32, (b, h, w, cin), dev)
    _check(folded["stem_w"], "stem_w", torch.bfloat16, (9, cin, c), dev)
    _check(folded["stem_b"], "stem_b", torch.float32, (c,), dev)
    _check(folded["block_w"], "block_w", torch.bfloat16,
           (l_blocks, 2, 9, c, c), dev)
    _check(folded["block_b"], "block_b", torch.float32, (l_blocks, 2, c), dev)
    if dev.type == "cpu":
        return fused_tower_plain(folded, obs)
    if dev.type != "cuda":
        raise ValueError(f"fused_tower: unsupported device {dev}")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_tower's kernel takes {KERNEL_CHANNELS} "
                         f"channels, got {c}")
    if 9 * cin > STEM_K_MAX:
        raise ValueError(f"fused_tower's kernel takes a stem of at most "
                         f"{STEM_K_MAX} columns (cin <= 7), got cin {cin}")
    geo = conv_tile.check_kernel_shape("fused_tower", obs.shape, c, 2,
                                       KERNEL_TILE)
    stem_k, block_k = kmajor_weights(folded)
    stem_t, block_t = conv_tile.derived(
        "fused_tiles", (stem_k, block_k),
        lambda s, w: (conv_tile.tile_weights(s, KERNEL_SLICE),
                      conv_tile.tile_weights(w, KERNEL_SLICE)))
    lib = _library()
    act, mid = conv_tile.zeroed_planes((c // 8, geo.rows_total, 8),
                                       torch.bfloat16, dev)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_tower_launch(
            obs.data_ptr(), b, h, cin, c, l_blocks, stem_k.shape[1],
            stem_t.data_ptr(), folded["stem_b"].data_ptr(),
            block_t.data_ptr(), folded["block_b"].data_ptr(),
            act.data_ptr(), mid.data_ptr(), geo.rows_total, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tower launch failed with CUDA error {err}")
    fused_tower.launches += 1
    return out


fused_tower.launches = 0


def reset_launch_counts():
    fused_tower.launches = 0


# ----------------------------------------------------------------------
# heads and the forward
# ----------------------------------------------------------------------
def _heads(cfg: NetConfig, folded: Folded, tower: torch.Tensor):
    """Policy and value heads on the tower output (the JAX ``fused_predict``'s
    XLA heads): ``(logits [B, A], value [B, 1])``."""
    b = tower.shape[0]
    hw = cfg.board_size * cfg.board_size
    f32 = torch.float32
    rows = tower.reshape(b * hw, cfg.channels)
    pq = torch.relu(rows @ folded["pol_w"].to(f32) + folded["pol_b"])
    logits = pq.reshape(b, hw * 2) @ folded["pol_fc_w"].to(f32) \
        + folded["pol_fc_b"]
    vq = torch.relu(rows @ folded["val_w"].to(f32) + folded["val_b"])
    v = torch.relu(vq.reshape(b, hw) @ folded["val_fc1_w"].to(f32)
                   + folded["val_fc1_b"])
    v = v @ folded["val_fc2_w"].to(f32) + folded["val_fc2_b"]
    return logits, torch.tanh(v)


def fused_predict(cfg: NetConfig, folded: Folded, obs: torch.Tensor):
    """Fused eval forward: ``obs [B, H, W, cin]`` -> ``(logits [B, A],
    value [B, 1])``, the tower by :func:`fused_tower`."""
    with torch.no_grad():
        return _heads(cfg, folded, fused_tower(folded, obs.to(torch.float32)))


def folded_apply_plain(cfg: NetConfig, folded: Folded, obs: torch.Tensor,
                       sum_dtype=torch.float32):
    """:func:`fused_predict` with the plain tower on any device: the kernel's
    plain version, and the counterpart of the JAX ``folded_apply_reference``
    with each conv input rounded to bf16 as the kernel does.  With
    ``sum_dtype`` float64 the tower's sums are float64
    (:func:`fused_tower_plain`); the heads are float32 either way."""
    with torch.no_grad():
        return _heads(cfg, folded, fused_tower_plain(folded, obs, sum_dtype))


def make_fused_eval_fn(cfg: NetConfig):
    """MCTS eval function backed by :func:`fused_predict`.

    ``eval_fn(folded, obs) -> (softmax probs [B, A], value [B, 1])``; the
    bundle is the output of :func:`fold_bn` (fold once per parameter update).
    """

    def eval_fn(folded: Folded, obs: torch.Tensor):
        logits, value = fused_predict(cfg, folded, obs)
        return torch.softmax(logits, dim=-1), value

    return eval_fn


# ----------------------------------------------------------------------
# folded bf16 forward in plain torch
# ----------------------------------------------------------------------
def _im2col(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC ``x [B, H, W, C]`` -> ``[B*H*W, k]``: the nine 3x3 SAME taps in
    order ``3*dy + dx``, each ``C`` wide, zero outside the board and in the
    columns past ``9*C``."""
    b, h, w, c = x.shape
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [pad[:, dy:dy + h, dx:dx + w, :]
            for dy in range(3) for dx in range(3)]
    if k > 9 * c:
        cols.append(x.new_zeros((b, h, w, k - 9 * c)))
    return torch.cat(cols, dim=-1).reshape(b * h * w, k)


def _conv_matrix(w: torch.Tensor, dtype) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` -> ``[K, Cout]`` in ``dtype`` (row
    ``(3*dy + dx) * Cin + ci``), ``K = 9 * Cin`` padded with zero rows to a
    multiple of 8."""
    k = 9 * w.shape[2]
    return F.pad(w.reshape(k, w.shape[3]), (0, 0, 0, -k % 8)).to(dtype)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with a float32 result and float32 sums, whatever the
    storage dtype: on the card ``torch.mm(..., out_dtype=float32)`` (bf16
    tensor cores, float32 accumulation); on the CPU, which has no kernel for
    that overload, a float32 matmul of the upcast values (products of bf16
    values are exact in float32).  Float32 sums need TF32 off for matmuls,
    PyTorch's default, which the callers keep."""
    f32 = torch.float32
    if a.is_cuda and a.dtype != f32:
        return torch.mm(a, w, out_dtype=f32)
    return a.to(f32) @ w.to(f32)


def _conv_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` with a ``[K, Cout]`` matrix ``w``
    (:func:`_conv_matrix`): im2col and :func:`_mm_f32`, float32 NHWC out."""
    b, h, wd, _ = x.shape
    return _mm_f32(_im2col(x, w.shape[0]), w).reshape(b, h, wd, -1)


def fold_bn_xla(cfg: NetConfig, params: Params, batch_stats: Params,
                dtype=torch.bfloat16, device=None) -> Dict:
    """Fold eval-mode BN into the conv weights for :func:`folded_xla_apply`.

    Conv weights are ``[K, Cout]`` matrices (:func:`_conv_matrix`) in
    ``dtype`` (bf16 by default); biases and the heads float32, as in the JAX
    ``fold_bn_xla``.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    stem_w, stem_b = _fold(params["stem"]["w"], params["stem_bn"],
                           batch_stats["stem_bn"])
    blocks = []
    for blk, bs in zip(params["blocks"], batch_stats["blocks"]):
        w1, b1 = _fold(blk["conv1"]["w"], blk["bn1"], bs["bn1"])
        w2, b2 = _fold(blk["conv2"]["w"], blk["bn2"], bs["bn2"])
        blocks.append({"w1": _conv_matrix(w1, dtype).to(dev),
                       "b1": b1.to(dev),
                       "w2": _conv_matrix(w2, dtype).to(dev),
                       "b2": b2.to(dev)})
    pol_w, pol_b = _fold(params["policy_conv"]["w"], params["policy_bn"],
                         batch_stats["policy_bn"])
    val_w, val_b = _fold(params["value_conv"]["w"], params["value_bn"],
                         batch_stats["value_bn"])
    c = cfg.channels
    heads = {
        "pol_w": pol_w.reshape(c, 2), "pol_b": pol_b,
        "pol_fc_w": _t(params["policy_fc"]["w"]),
        "pol_fc_b": _t(params["policy_fc"]["b"]),
        "val_w": val_w.reshape(c, 1), "val_b": val_b,
        "val_fc1_w": _t(params["value_fc1"]["w"]),
        "val_fc1_b": _t(params["value_fc1"]["b"]),
        "val_fc2_w": _t(params["value_fc2"]["w"]),
        "val_fc2_b": _t(params["value_fc2"]["b"]),
    }
    out = {k: v.to(f32).contiguous().to(dev) for k, v in heads.items()}
    out.update(stem_w=_conv_matrix(stem_w, dtype).to(dev),
               stem_b=stem_b.to(dev), blocks=blocks)
    return out


def folded_xla_tower(folded: Dict, obs: torch.Tensor) -> torch.Tensor:
    """The tower of :func:`folded_xla_apply`: NHWC ``obs`` -> the last block's
    activations, NHWC in the storage dtype.

    Each conv keeps its float32 output and adds the bias to it before the
    activation is rounded to the storage dtype, as the JAX conv with
    ``preferred_element_type=float32`` does.
    """
    bf = folded["stem_w"].dtype
    h = torch.relu(_conv_mm(obs.to(bf), folded["stem_w"])
                   + folded["stem_b"]).to(bf)
    for blk in folded["blocks"]:
        r = h
        h = torch.relu(_conv_mm(h, blk["w1"]) + blk["b1"]).to(bf)
        h = (_conv_mm(h, blk["w2"]) + blk["b2"]).to(bf)
        h = torch.relu((h + r).to(torch.float32)).to(bf)
    return h


def folded_xla_apply(cfg: NetConfig, folded: Dict, obs: torch.Tensor):
    """Eval forward with BN folded away and activations in the storage dtype
    (bf16) between layers: ``(logits [B, A], value [B, 1])``.

    Each layer is ``conv + bias + relu``, the conv on bf16 tensors with
    float32 sums and output (im2col and a bf16 matmul on the card), the bias
    and ReLU in float32; the heads run in float32.
    """
    with torch.no_grad():
        h = folded_xla_tower(folded, obs)
        b = h.shape[0]
        hw = cfg.board_size * cfg.board_size
        rows = h.to(torch.float32).reshape(b * hw, cfg.channels)
        p = torch.relu(rows @ folded["pol_w"] + folded["pol_b"])
        logits = p.reshape(b, 2 * hw) @ folded["pol_fc_w"] + folded["pol_fc_b"]
        v = torch.relu(rows @ folded["val_w"] + folded["val_b"])
        v = torch.relu(v.reshape(b, hw) @ folded["val_fc1_w"]
                       + folded["val_fc1_b"])
        v = v @ folded["val_fc2_w"] + folded["val_fc2_b"]
        return logits, torch.tanh(v)


def make_bf16_eval_fn(cfg: NetConfig):
    """MCTS eval function backed by :func:`folded_xla_apply`; the bundle is
    the output of :func:`fold_bn_xla`."""

    def eval_fn(folded: Dict, obs: torch.Tensor):
        logits, value = folded_xla_apply(cfg, folded, obs)
        return torch.softmax(logits, dim=-1), value

    return eval_fn
