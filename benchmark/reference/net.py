"""The policy/value net's quantized forward in plain PyTorch.

The net is the AlphaZero-Gomoku residual tower: a 3x3 stem conv with batch
norm and ReLU, ``L`` residual blocks of two 3x3 convs with batch norm (ReLU
after the first, ``relu(y + skip)`` after the second), a policy head (1x1
conv to 2 planes, BN, ReLU, a dense layer to the ``A`` logits) and a value
head (1x1 conv to 1 plane, BN, ReLU, dense to 64, ReLU, dense to 1, tanh).
Weights come in the AZTPU1 checkpoint's layout: convs HWIO, dense layers
``[in, out]``, batch norm's ``scale`` / ``bias`` and its running ``mean`` /
``var``.

Quantization (post-training, symmetric), written here from its description:

  - batch norm folded into each conv in float32 (numpy's correctly rounded
    ``sqrt``);
  - per-input-channel activation scales ``max|x| / qmax`` at every conv
    input of the folded float32 forward over the calibration boards (floored
    at 1e-5), folded into the next conv's weights;
  - per-output-channel weight scales ``max|w| / qmax``; values rounded half
    to even and clipped to ``+-qmax``;
  - each conv's mean quantization error over the calibration boards, layer
    by layer on float32 inputs, folded into its bias;
  - integer convs with exact sums, each dequantized as one rounding of
    ``acc * scale + bias`` to float32; a float32 skip track; float32 heads.

``qmax`` is 127 for int8 and 7 for int4.  The integer sums are exact on
either path taken here (``torch._int_mm`` on a card, float64 elsewhere), so
the two give the same numbers.  A float net (:func:`forward_float`) runs
the folded convs in a floating type and the heads in float32.

Which of them a configuration runs, and which its control runs, is data of
the configuration file (``reference_net``, ``control_net``): :func:`make`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
RANGE_FLOOR = 1e-5


def _fold(w, bn, stats):
    f32 = np.float32
    s = np.asarray(bn["scale"], f32) / np.sqrt(
        np.asarray(stats["var"], f32) + f32(BN_EPS))
    return (np.asarray(w, f32) * s,
            np.asarray(bn["bias"], f32) - np.asarray(stats["mean"], f32) * s)


def _matrix(w: np.ndarray) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` -> ``[K, Cout]``, row ``(3*dy+dx)*Cin +
    ci``, zero rows up to a multiple of 8."""
    k = 9 * w.shape[2]
    m = torch.from_numpy(np.ascontiguousarray(w.reshape(k, w.shape[3])))
    return F.pad(m, (0, 0, 0, -k % 8))


def fold(params, stats, device) -> Dict:
    """The float32 folded net on ``device``."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(device)

    stem_w, stem_b = _fold(params["stem"]["w"], params["stem_bn"],
                           stats["stem_bn"])
    blocks = []
    for blk, st in zip(params["blocks"], stats["blocks"]):
        w1, b1 = _fold(blk["conv1"]["w"], blk["bn1"], st["bn1"])
        w2, b2 = _fold(blk["conv2"]["w"], blk["bn2"], st["bn2"])
        blocks.append({"w1": _matrix(w1).to(device), "b1": t(b1),
                       "w2": _matrix(w2).to(device), "b2": t(b2)})
    pol_w, pol_b = _fold(params["policy_conv"]["w"], params["policy_bn"],
                         stats["policy_bn"])
    val_w, val_b = _fold(params["value_conv"]["w"], params["value_bn"],
                         stats["value_bn"])
    c = stem_w.shape[-1]
    return {
        "stem_w": _matrix(stem_w).to(device), "stem_b": t(stem_b),
        "blocks": blocks,
        "pol_w": t(pol_w.reshape(c, 2)), "pol_b": t(pol_b),
        "pol_fc_w": t(params["policy_fc"]["w"]),
        "pol_fc_b": t(params["policy_fc"]["b"]),
        "val_w": t(val_w.reshape(c, 1)), "val_b": t(val_b),
        "val_fc1_w": t(params["value_fc1"]["w"]),
        "val_fc1_b": t(params["value_fc1"]["b"]),
        "val_fc2_w": t(params["value_fc2"]["w"]),
        "val_fc2_b": t(params["value_fc2"]["b"]),
    }


def im2col(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B*H*W, k]``: the 3x3 SAME taps in order
    ``3*dy + dx``, zero outside the board and past ``9*C``."""
    b, h, w, c = x.shape
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [pad[:, dy:dy + h, dx:dx + w, :]
            for dy in range(3) for dx in range(3)]
    if k > 9 * c:
        cols.append(x.new_zeros((b, h, w, k - 9 * c)))
    return torch.cat(cols, dim=-1).reshape(b * h * w, k)


def conv_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, h, wd, _ = x.shape
    return (im2col(x, w.shape[0]) @ w).reshape(b, h, wd, -1)


def conv_int(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Integer 3x3 SAME conv with exact sums -> int32 ``[B, H, W, Cout]``."""
    b, h, wd, _ = x_q.shape
    cols = im2col(x_q, w_q.shape[0])
    if cols.is_cuda and cols.shape[0] > 16:
        acc = torch._int_mm(cols, w_q.t().contiguous().t())
    else:
        acc = (cols.to(torch.float64) @ w_q.to(torch.float64)).to(
            torch.int32)
    return acc.reshape(b, h, wd, -1)


def dequant(acc: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    f64 = torch.float64
    return (acc.to(torch.float32).to(f64) * scale.to(f64)
            + bias.to(f64)).to(torch.float32)


def requant(x: torch.Tensor, inv: torch.Tensor, qmax: float) -> torch.Tensor:
    return torch.clamp(torch.round(x * inv), -qmax, qmax).to(torch.int8)


def _amax(x):
    return torch.amax(torch.abs(x), dim=(0, 1, 2))


def _qweights(w: torch.Tensor, s_act: torch.Tensor, qmax: float):
    k, cin = w.shape[0], s_act.shape[0]
    rows = F.pad(s_act.repeat(9), (0, k - 9 * cin), value=1.0)
    w_eff = w * rows[:, None]
    s_w = torch.clamp(torch.amax(torch.abs(w_eff), dim=0), min=1e-12) / qmax
    q = torch.clamp(torch.round(w_eff / s_w), -qmax, qmax).to(torch.int8)
    return q, s_w


def quantize(folded: Dict, calib: torch.Tensor, qmax: float) -> Dict:
    """The quantized net from the folded one and calibration boards."""
    with torch.no_grad():
        # activation ranges of the float32 forward
        rng: Dict[str, torch.Tensor] = {"obs": _amax(calib)}
        h = torch.relu(conv_f32(calib, folded["stem_w"]) + folded["stem_b"])
        for i, blk in enumerate(folded["blocks"]):
            rng[f"in{i}"] = _amax(h)
            r = h
            h = torch.relu(conv_f32(h, blk["w1"]) + blk["b1"])
            rng[f"mid{i}"] = _amax(h)
            h = torch.relu(conv_f32(h, blk["w2"]) + blk["b2"] + r)
        rng = {k: torch.clamp(v, min=RANGE_FLOOR) for k, v in rng.items()}

        q = {"qmax": qmax}
        s_obs = rng["obs"] / qmax
        q["inv_obs"] = 1.0 / s_obs
        q["stem_w"], q["stem_scale"] = _qweights(folded["stem_w"], s_obs,
                                                 qmax)
        blocks: List[Dict] = []
        for i, blk in enumerate(folded["blocks"]):
            s_in, s_mid = rng[f"in{i}"] / qmax, rng[f"mid{i}"] / qmax
            w1, d1 = _qweights(blk["w1"], s_in, qmax)
            w2, d2 = _qweights(blk["w2"], s_mid, qmax)
            blocks.append({"w1": w1, "scale1": d1, "w2": w2, "scale2": d2,
                           "inv_in": 1.0 / s_in, "inv_mid": 1.0 / s_mid})

        # bias correction, layer by layer on the float32 activations
        def err(y_ref, y_q):
            return torch.mean(y_ref - y_q, dim=(0, 1, 2))

        y_ref = conv_f32(calib, folded["stem_w"]) + folded["stem_b"]
        y_q = dequant(conv_int(requant(calib, q["inv_obs"], qmax),
                               q["stem_w"]), q["stem_scale"],
                      folded["stem_b"])
        q["stem_b"] = folded["stem_b"] + err(y_ref, y_q)
        h = torch.relu(y_ref)
        for blk_f, blk_q in zip(folded["blocks"], blocks):
            r = h
            y_ref = conv_f32(h, blk_f["w1"]) + blk_f["b1"]
            y_q = dequant(conv_int(requant(h, blk_q["inv_in"], qmax),
                                   blk_q["w1"]), blk_q["scale1"],
                          blk_f["b1"])
            blk_q["b1"] = blk_f["b1"] + err(y_ref, y_q)
            m = torch.relu(y_ref)
            y_ref = conv_f32(m, blk_f["w2"]) + blk_f["b2"]
            y_q = dequant(conv_int(requant(m, blk_q["inv_mid"], qmax),
                                   blk_q["w2"]), blk_q["scale2"],
                          blk_f["b2"])
            blk_q["b2"] = blk_f["b2"] + err(y_ref, y_q)
            h = torch.relu(y_ref + r)
        q["blocks"] = blocks
        for k in ("pol_w", "pol_b", "pol_fc_w", "pol_fc_b", "val_w", "val_b",
                  "val_fc1_w", "val_fc1_b", "val_fc2_w", "val_fc2_b"):
            q[k] = folded[k]
        return q


def _heads(q: Dict, h: torch.Tensor):
    """The float32 policy and value heads on the tower's output."""
    b, hh, ww, c = h.shape
    rows = h.reshape(b * hh * ww, c)
    p = torch.relu(rows @ q["pol_w"] + q["pol_b"])
    logits = p.reshape(b, 2 * hh * ww) @ q["pol_fc_w"] + q["pol_fc_b"]
    v = torch.relu(rows @ q["val_w"] + q["val_b"])
    v = torch.relu(v.reshape(b, hh * ww) @ q["val_fc1_w"] + q["val_fc1_b"])
    v = torch.tanh(v @ q["val_fc2_w"] + q["val_fc2_b"])
    return torch.softmax(logits, dim=-1), v.reshape(b)


def forward(q: Dict, obs: torch.Tensor):
    """``obs [B, H, W, cin]`` -> ``(probs [B, A], value [B])``."""
    qmax = q["qmax"]
    with torch.no_grad():
        x = requant(obs.to(torch.float32), q["inv_obs"], qmax)
        h = torch.relu(dequant(conv_int(x, q["stem_w"]), q["stem_scale"],
                               q["stem_b"]))
        for blk in q["blocks"]:
            m = torch.relu(dequant(conv_int(requant(h, blk["inv_in"], qmax),
                                            blk["w1"]), blk["scale1"],
                                   blk["b1"]))
            y = dequant(conv_int(requant(m, blk["inv_mid"], qmax),
                                 blk["w2"]), blk["scale2"], blk["b2"])
            h = torch.relu(y + h)
        return _heads(q, h)


def forward_float(folded: Dict, obs: torch.Tensor,
                  dtype: torch.dtype = torch.float32):
    """The folded net with its convs' inputs and weights in ``dtype`` and
    float32 sums (TF32 as the caller set it); heads in float32."""
    def conv(x, w):
        return conv_f32(x.to(dtype), w.to(dtype)).to(torch.float32)

    with torch.no_grad():
        h = torch.relu(conv(obs.to(torch.float32), folded["stem_w"])
                       + folded["stem_b"])
        for blk in folded["blocks"]:
            m = torch.relu(conv(h, blk["w1"]) + blk["b1"])
            h = torch.relu(conv(m, blk["w2"]) + blk["b2"] + h)
        return _heads(folded, h)


def make(params, stats, calib, device, net: Dict):
    """The eval function ``obs -> (probs, value)`` of the net that ``net``
    (a configuration's ``reference_net`` or ``control_net``) states:
    ``{"qmax": q}`` quantized on the calibration boards (127 int8, 7 int4),
    or ``{"dtype": d}`` float convs in ``torch.<d>``."""
    folded = fold(params, stats, device)
    if "qmax" in net:
        q = quantize(folded, torch.as_tensor(calib).to(device),
                     float(net["qmax"]))
        return lambda obs: forward(q, obs)
    dtype = getattr(torch, net["dtype"])
    return lambda obs: forward_float(folded, obs, dtype)
