"""int8 quantized inference for the policy/value net: quantization and the
``torch._int_mm`` forward.

Counterpart of ``alphazero_gomoku_tpu/ops/int8_net.py``.  The JAX package
runs this path as XLA, so here it is plain torch and no kernel of the port;
the hand-written tower kernel over the same bundle is ``ops/int8_tower.py``.

Scheme (post-training, symmetric, per-channel on both sides), as there:

  - BN is folded into each conv in float32 (``fused_net.fold_bn_xla``,
    which folds to the JAX package's bits).
  - Activations: per-input-channel int8 scales from the max ``|x|`` at every
    conv input of the folded float32 forward over calibration boards
    (:func:`quantize_int8`); each scale vector is folded into the next conv's
    weights along K, so the requant is one multiply by a reciprocal.
  - Weights (after that fold): per-output-channel int8.
  - Each 3x3 conv is int8 x int8 -> int32 (im2col, then ``torch._int_mm``),
    then the per-Cout dequant and bias in :func:`_dequant`; the skip track
    between blocks is float32 (default), bf16 (``residual="bf16"``) or the
    int8 tensor the next conv reads (``residual="int8"``); the last
    ``f32_last_blocks`` blocks may stay float32.  The heads run in float32.
  - Optional bias correction folds each conv's mean quantization error over
    the calibration boards into its bias.

Numerics.  The integer sums are exact in any order.  :func:`_dequant`
computes ``acc * scale + bias`` with one rounding to float32 of an exact
product plus the bias, which is what XLA's fused multiply-add gives (a
separate float32 multiply and add differ from it on about a quarter of the
outputs).  Every other float op is one torch op in the JAX order: ``round``
(half to even) before ``clip``, ``relu(y + r)``, the bf16 casts of the skip
track.

The bundle (:func:`quantize_int8`, or the JAX package's via
:func:`int8_bundle_from_jax`) has the JAX bundle's keys; its conv weights are
matmul-ready ``[K, Cout]`` matrices (``K = 9 * Cin``, row ``(3*dy + dx) *
Cin + ci``: the HWIO weight reshaped; the stem's ``K`` zero-padded to a
multiple of 8, as ``_int_mm`` needs), int8 (stored column-major), or
float32 in float32 tail blocks.  ``s_obs``/``inv_obs`` are ``[cin]``; the
heads float32 as ``fused_net.fold_bn_xla`` folds them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.models.resnet import NetConfig, Params
from alphazero_gomoku_tpu_torch.ops.fused_net import (
    _conv_matrix,
    _conv_mm,
    _im2col,
    fold_bn_xla,
)

QMAX = 127.0

Bundle = Dict[str, Any]

HEAD_KEYS = ("pol_w", "pol_b", "pol_fc_w", "pol_fc_b", "val_w", "val_b",
             "val_fc1_w", "val_fc1_b", "val_fc2_w", "val_fc2_b")


# ----------------------------------------------------------------------
# the shared elementwise steps
# ----------------------------------------------------------------------
def _dequant(acc: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """Integer ``acc`` -> float32 ``acc * scale + bias``, rounded once.

    ``acc`` (int32 sums or int8 values) is first rounded to float32, as
    ``astype(f32)`` does; its product with a float32 scale is exact in
    float64, and the sum with the float32 ``bias`` is rounded once to
    float32: the fused multiply-add of XLA's epilogue.  Every int8 path of
    the port and the tower kernel's plain version dequantize here; the
    kernel does the same in float64.
    """
    f64 = torch.float64
    return (acc.to(torch.float32).to(f64) * scale.to(f64)
            + bias.to(f64)).to(torch.float32)


def _requant_inv(x: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """float32 -> int8 at per-channel scale ``1 / inv_s``: round half to
    even, then clip to +-127."""
    return torch.clamp(torch.round(x * inv_s), -QMAX, QMAX).to(torch.int8)


def _qconv(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """int8 3x3 SAME conv of NHWC ``x_q`` -> float32: im2col,
    ``torch._int_mm`` (int8 x int8 -> int32) with the ``[K, Cout]`` matrix
    ``w_q``, then :func:`_dequant`."""
    b, h, w, _ = x_q.shape
    acc = torch._int_mm(_im2col(x_q, w_q.shape[0]), w_q)
    return _dequant(acc, scale, bias).reshape(b, h, w, -1)


def _amax(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x.to(torch.float32)), dim=(0, 1, 2))


# ----------------------------------------------------------------------
# calibration and quantization (once per parameter update)
# ----------------------------------------------------------------------
def _folded_forward_ranges(folded: Bundle,
                           obs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Folded float32 forward; per-channel max ``|x|`` at each conv input.

    Keys: ``"obs"``, ``"tower_in_<i>"`` (block i conv1 input), ``"mid_<i>"``
    (block i conv2 input); each value is a ``[C]`` vector.
    """
    ranges = {"obs": _amax(obs)}
    h = torch.relu(_conv_mm(obs, folded["stem_w"]) + folded["stem_b"])
    for i, blk in enumerate(folded["blocks"]):
        ranges[f"tower_in_{i}"] = _amax(h)
        r = h
        h = torch.relu(_conv_mm(h, blk["w1"]) + blk["b1"])
        ranges[f"mid_{i}"] = _amax(h)
        h = _conv_mm(h, blk["w2"]) + blk["b2"]
        h = torch.relu(h + r)
    return ranges


def _int8_matrix(m: torch.Tensor) -> torch.Tensor:
    """An int8 ``[K, Cout]`` matrix stored column-major (the transpose of a
    contiguous ``[Cout, K]``): on the card, cuBLASLt refuses a row-major
    second operand of ``torch._int_mm`` at some shapes (CUBLAS_STATUS_NOT_
    SUPPORTED at m 891, k 32, n 32 with torch 2.11+cu128)."""
    return m.t().contiguous().t()


def qconv_weights(w: torch.Tensor, s_act: torch.Tensor):
    """Fold per-in-channel activation scales into the conv matrix ``w``;
    quantize per Cout.  ``w [K, Cout]`` float32 (row ``tap * Cin + ci``, zero
    rows past ``9 * Cin``), ``s_act [Cin]`` (``x ~ x_q * s_act``).  Returns
    (int8 ``[K, Cout]`` weights, per-Cout float32 dequant scale).
    """
    k, cin = w.shape[0], s_act.shape[0]
    rows = F.pad(s_act.repeat(9), (0, k - 9 * cin), value=1.0)
    w_eff = w * rows[:, None]
    s_w = torch.clamp(torch.amax(torch.abs(w_eff), dim=0), min=1e-12) / QMAX
    q = torch.clamp(torch.round(w_eff / s_w), -QMAX, QMAX)
    return _int8_matrix(q.to(torch.int8)), s_w.to(torch.float32)


def quantize_int8(cfg: NetConfig, params: Params, batch_stats: Params,
                  calib_obs, bias_correct: bool = True,
                  f32_last_blocks: int = 0, residual: str = "f32",
                  device=None) -> Bundle:
    """Build the int8 inference bundle from training params and calibration
    boards ``calib_obs [N, H, W, cin]`` (numpy or tensor), on ``device``
    (None: the card).

    ``residual`` picks the skip track between blocks: ``"f32"`` (exact),
    ``"bf16"`` (stored bf16), ``"int8"`` (the int8 tensor the next conv
    reads, dequantized for the add); the bundle marks the last two with a
    ``"resbf"`` or ``"res8"`` entry, as the JAX one does.  The calibration
    forward is float32 on the card only with TF32 off for matmuls, PyTorch's
    default.
    """
    if residual not in ("f32", "bf16", "int8"):
        raise ValueError(
            f"residual must be 'int8', 'bf16' or 'f32': {residual!r}")
    dev = resolve_device(device)
    obs = torch.as_tensor(np.asarray(calib_obs, np.float32)).to(dev)
    folded = fold_bn_xla(cfg, params, batch_stats, dtype=torch.float32,
                         device=dev)
    with torch.no_grad():
        return _quantize(bool(bias_correct), int(f32_last_blocks), residual,
                         folded, obs)


def _quantize(bias_correct, f32_last_blocks, residual, folded, obs):
    # floor tiny or dead channels so that the scales stay finite
    ranges = {k: torch.clamp(v, min=1e-5)
              for k, v in _folded_forward_ranges(folded, obs).items()}
    out: Bundle = {}
    s_obs = ranges["obs"] / QMAX
    out["s_obs"] = s_obs
    out["inv_obs"] = 1.0 / s_obs
    out["stem_w"], out["stem_scale"] = qconv_weights(folded["stem_w"], s_obs)
    out["stem_b"] = folded["stem_b"]

    n_blocks = len(folded["blocks"])
    blocks = []
    for i, blk in enumerate(folded["blocks"]):
        if i >= n_blocks - f32_last_blocks:
            # output-adjacent blocks kept in float32
            blocks.append({"f32": True, **blk})
            continue
        s_in = ranges[f"tower_in_{i}"] / QMAX
        s_mid = ranges[f"mid_{i}"] / QMAX
        w1q, d1 = qconv_weights(blk["w1"], s_in)
        w2q, d2 = qconv_weights(blk["w2"], s_mid)
        blocks.append({"w1": w1q, "scale1": d1, "b1": blk["b1"],
                       "w2": w2q, "scale2": d2, "b2": blk["b2"],
                       "s_in": s_in, "s_mid": s_mid,
                       "inv_in": 1.0 / s_in, "inv_mid": 1.0 / s_mid})
    out["blocks"] = blocks
    if residual == "int8":
        out["res8"] = torch.ones((), dtype=torch.int8, device=obs.device)
    elif residual == "bf16":
        out["resbf"] = torch.ones((), dtype=torch.int8, device=obs.device)
    for k in HEAD_KEYS:
        out[k] = folded[k]
    if bias_correct:
        out = _bias_correct(folded, out, obs)
    return out


def _bias_correct(folded: Bundle, q: Bundle, obs: torch.Tensor) -> Bundle:
    """Fold the mean quantization error of each conv over the calibration
    boards into its bias (Nagel et al., arXiv:1906.04721 sec. 5), layer by
    layer with the float32 activations as each layer's input, so that the
    corrections do not compound."""
    def mean_err(y_ref, y_q):
        return torch.mean(y_ref - y_q, dim=(0, 1, 2))

    res8 = "res8" in q
    errs = {}
    obs_q = _requant_inv(obs, q["inv_obs"])
    y_ref = _conv_mm(obs, folded["stem_w"]) + folded["stem_b"]
    y_q = _qconv(obs_q, q["stem_w"], q["stem_scale"], q["stem_b"])
    errs["stem"] = mean_err(y_ref, y_q)
    h = torch.relu(y_ref)
    for i, (blk_f, blk_q) in enumerate(zip(folded["blocks"], q["blocks"])):
        r = h
        y_ref = _conv_mm(h, blk_f["w1"]) + blk_f["b1"]
        if not blk_q.get("f32"):
            h_q = _requant_inv(h, blk_q["inv_in"])
            y_q = _qconv(h_q, blk_q["w1"], blk_q["scale1"], blk_q["b1"])
            errs[f"b{i}_1"] = mean_err(y_ref, y_q)
        m = torch.relu(y_ref)
        y_ref = _conv_mm(m, blk_f["w2"]) + blk_f["b2"]
        if not blk_q.get("f32"):
            y_q = _qconv(_requant_inv(m, blk_q["inv_mid"]), blk_q["w2"],
                         blk_q["scale2"], blk_q["b2"])
            errs[f"b{i}_2"] = mean_err(y_ref, y_q)
            if res8:
                # the int8 skip track adds h_q * s_in, not h
                errs[f"b{i}_2"] = errs[f"b{i}_2"] + mean_err(
                    r, h_q.to(torch.float32) * blk_q["s_in"])
        h = torch.relu(y_ref + r)

    q = dict(q)
    q["stem_b"] = q["stem_b"] + errs["stem"]
    q["blocks"] = [
        blk if blk.get("f32") else
        {**blk, "b1": blk["b1"] + errs[f"b{i}_1"],
         "b2": blk["b2"] + errs[f"b{i}_2"]}
        for i, blk in enumerate(q["blocks"])]
    return q


def int8_bundle_from_jax(q, device=None) -> Bundle:
    """The JAX package's ``quantize_int8`` output (numpy arrays in its
    pytree) as this module's bundle on ``device`` (None: the card), so that
    both packages can run identical int8 weights: HWIO conv weights become
    ``[K, Cout]`` matrices, the 1x1 head convs ``[C, out]``."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    def conv(w):
        w = t(w)
        m = _conv_matrix(w, w.dtype)
        return _int8_matrix(m) if m.dtype == torch.int8 else m

    out: Bundle = {}
    for k, v in q.items():
        if k == "stem_w":
            out[k] = conv(v)
        elif k in ("pol_w", "val_w"):
            out[k] = t(v).reshape(-1, np.shape(v)[-1])
        elif k != "blocks":
            out[k] = t(v)
    out["blocks"] = [
        {k: conv(v) if k in ("w1", "w2") else (True if k == "f32" else t(v))
         for k, v in blk.items()}
        for blk in q["blocks"]]
    return out


# ----------------------------------------------------------------------
# the int8 forward
# ----------------------------------------------------------------------
def int8_tower_mm(q: Bundle, obs: torch.Tensor) -> torch.Tensor:
    """The residual tower of :func:`int8_apply`: ``obs [B, H, W, cin]`` ->
    float32 ``[B, H, W, C]``, the last block's output."""
    f32 = torch.float32
    res8, resbf = "res8" in q, "resbf" in q
    blocks = q["blocks"]
    obs_q = _requant_inv(obs.to(f32), q["inv_obs"])
    h = torch.relu(_qconv(obs_q, q["stem_w"], q["stem_scale"], q["stem_b"]))
    # one dataflow for the three skip tracks: the carry between blocks is
    # float32, or bf16 (resbf); res8 adds the int8 tensor the block's first
    # conv reads, dequantized, in place of the carry
    for bi, blk in enumerate(blocks):
        r = h.to(f32) if resbf else h
        if blk.get("f32"):
            m = torch.relu(_conv_mm(r, blk["w1"]) + blk["b1"])
            y = _conv_mm(m, blk["w2"]) + blk["b2"]
            h = torch.relu(y + r)
        else:
            h_q = _requant_inv(r, blk["inv_in"])
            m = torch.relu(_qconv(h_q, blk["w1"], blk["scale1"], blk["b1"]))
            m_q = _requant_inv(m, blk["inv_mid"])
            y = _qconv(m_q, blk["w2"], blk["scale2"], blk["b2"])
            # res8: y + h_q * s_in rounded once, as XLA fuses the skip's
            # dequant into the add as it does the conv's
            h = torch.relu(_dequant(h_q, blk["s_in"], y) if res8 else y + r)
        # narrowed only between blocks: the last one feeds the heads
        if resbf and bi < len(blocks) - 1:
            h = h.to(torch.bfloat16)
    return h.to(f32)


def int8_heads(cfg: NetConfig, q: Bundle, tower: torch.Tensor):
    """Policy and value heads in float32 on the tower output, in the order
    of the JAX ``int8_apply``: ``(logits [B, A], value [B, 1])``."""
    b = tower.shape[0]
    c = cfg.channels
    hw = cfg.board_size * cfg.board_size
    rows = tower.reshape(b * hw, c)
    p = torch.relu(rows @ q["pol_w"].reshape(c, 2) + q["pol_b"])
    logits = p.reshape(b, 2 * hw) @ q["pol_fc_w"] + q["pol_fc_b"]
    v = torch.relu(rows @ q["val_w"].reshape(c, 1) + q["val_b"])
    v = torch.relu(v.reshape(b, hw) @ q["val_fc1_w"] + q["val_fc1_b"])
    v = v @ q["val_fc2_w"] + q["val_fc2_b"]
    return logits, torch.tanh(v)


def int8_apply(cfg: NetConfig, q: Bundle, obs: torch.Tensor):
    """Eval-mode forward on the int8 bundle: ``obs [B, H, W, cin]`` ->
    ``(logits [B, A], value [B, 1])``."""
    with torch.no_grad():
        return int8_heads(cfg, q, int8_tower_mm(q, obs))


def make_int8_eval_fn(cfg: NetConfig):
    """MCTS eval function backed by :func:`int8_apply`:
    ``eval_fn(q, obs) -> (softmax probs [B, A], value [B, 1])``; the bundle
    is :func:`quantize_int8`'s (quantize once per parameter update)."""

    def eval_fn(q: Bundle, obs: torch.Tensor):
        logits, value = int8_apply(cfg, q, obs)
        return torch.softmax(logits, dim=-1), value

    return eval_fn


# ----------------------------------------------------------------------
# calibration boards
# ----------------------------------------------------------------------
def random_play_calib_obs(cfg: NetConfig, game: str = "gomoku",
                          n: int = 256, seed: int = 0) -> np.ndarray:
    """Calibration boards from host games of random legal moves (numpy NHWC
    float32), the same numbers as the JAX package's ``random_play_calib_obs``
    (``ops/int8_net.py:411-433`` there) for the same arguments.

    Random play visits plausible stone densities and alternation patterns;
    the training loop calibrates on them while its replay buffer is still
    too small to sample.  ``game`` is ``"gomoku"`` or ``"pente"`` (the host
    engines of ``games/host.py``); the boards have the 3 base planes, and
    a caller with capture planes appends them (``selfplay/loop.py``).
    """
    from alphazero_gomoku_tpu_torch.games.host import Gomoku, Pente
    eng_cls = {"gomoku": Gomoku, "pente": Pente}[game]
    rng = np.random.default_rng(seed)
    obs = []
    while len(obs) < n:
        env = eng_cls(cfg.board_size)
        for _ in range(int(rng.integers(4, 60))):
            moves = env.get_legal_moves()
            if not moves:
                break
            env.do_move(moves[rng.integers(len(moves))])
            if env.check_winner():
                break
            obs.append(env.get_encoded_state().transpose(1, 2, 0))
    return np.stack(obs[:n]).astype(np.float32)


def random_calib_obs(cfg: NetConfig, n: int = 256, cin: int = 3,
                     seed: int = 0) -> np.ndarray:
    """Synthetic calibration boards: random disjoint stone fills (numpy).

    Planes 0/1 are disjoint stone sets, plane 2 constant 1, extra planes
    zero.  The same numbers as the JAX package's ``random_calib_obs`` for the
    same arguments.
    """
    rng = np.random.default_rng(seed)
    hw = cfg.board_size
    obs = np.zeros((n, hw, hw, cin), np.float32)
    for i in range(n):
        stones = rng.integers(0, hw * hw // 2)
        cells = rng.choice(hw * hw, size=stones, replace=False)
        own = cells[: stones // 2]
        opp = cells[stones // 2:]
        obs[i].reshape(hw * hw, cin)[own, 0] = 1.0
        obs[i].reshape(hw * hw, cin)[opp, 1] = 1.0
        obs[i, :, :, 2] = 1.0
    return obs
