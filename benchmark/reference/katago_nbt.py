"""KataGo's nested-bottleneck residual net (``b18c384nbt``) in plain PyTorch.

Written for the benchmark from KataGo's layer equations
(github.com/lightvector/KataGo ``python/katago/train/model_pytorch.py``:
``NestedBottleneckResBlock``, ``ResBlock`` with ``ConvAndGPool``,
``KataGPool``, ``PolicyHead``, ``ValueHead``; global pooling per
arXiv:1902.10565 section 3), not from the program's net.  NCHW, float32,
every norm an eval-mode batch norm (eps 1e-5), every activation ReLU:

  - stem: a 5x5 conv, no bias, from the input planes to the trunk;
  - block: ``x + conv1x1_q(na(B2(B1(conv1x1_p(na(x))))))``, ``na`` a
    norm and ReLU; an inner block ``z + conv3x3_2(na(conv3x3_1(na(z))))``;
    in a gpool block the first inner block's ``conv3x3_1`` is
    ``conv_r(u) + linear_g(KataGPool(na(conv_g(u))))`` (``u = na(z)``),
    broadcast over the board;
  - ``KataGPool``: ``[mean, mean * (sqrt(area) - 14) / 10, max]`` over
    the board (channel groups in that order);
  - trunk end ``na``; policy ``conv_out(na(conv_p(t) + linear_g(
    KataGPool(na(conv_g(t))))))``, the 225 logits; value: ``na(conv(t))``
    pooled as ``[mean, mean * (sqrt(area) - 14) / 10, mean * ((sqrt(area)
    - 14)^2 / 100 - 0.1)]``, ``relu(fc1)``, ``fc2`` to win, loss and
    no-result logits; the value is ``p_win - p_loss``.

Weights in the layout ``benchmark/nets/katago_nbt.py`` documents (convs
HWIO, linears ``[in, out]``, batch norm's ``scale`` / ``bias`` and its
running ``mean`` / ``var``).  Every conv and linear runs through one
function, which a net spec (:func:`make`) sets: float32; ``{"dtype": d}``,
its input and weight rounded to ``torch.<d>`` and computed in float32; or
``{"qmax": q}``, fake-quantized to ``q`` levels each side: weights per
output channel (``max|w| / q``), inputs per channel at the ranges of the
float32 forward over the calibration boards (floored at 1e-5), values
rounded half to even and clipped.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
RANGE_FLOOR = 1e-5


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


def _conv_w(p: Dict, device) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1)),
              device)


def _affine(bn: Dict, st: Dict, device):
    """Eval-mode batch norm as ``x * s + t``, ``[1, C, 1, 1]`` each."""
    f32 = np.float32
    s = np.asarray(bn["scale"], f32) / np.sqrt(
        np.asarray(st["var"], f32) + f32(BN_EPS))
    t = np.asarray(bn["bias"], f32) - np.asarray(st["mean"], f32) * s
    return (_t(s, device).view(1, -1, 1, 1), _t(t, device).view(1, -1, 1, 1))


def load(params: Dict, stats: Dict, device) -> Dict:
    """The weights as float32 tensors on ``device``: convs OIHW, linears
    ``[in, out]``, each norm an affine pair."""
    def inner(p, s):
        out = {"n1": _affine(p["bn1"], s["bn1"], device),
               "c1": _conv_w(p["conv1"], device),
               "n2": _affine(p["bn2"], s["bn2"], device),
               "c2": _conv_w(p["conv2"], device)}
        if "conv_g" in p:
            out.update(cg=_conv_w(p["conv_g"], device),
                       ng=_affine(p["bn_g"], s["bn_g"], device),
                       lg=_t(p["linear_g"]["w"], device))
        return out

    blocks = []
    for p, s in zip(params["blocks"], stats["blocks"]):
        blocks.append({
            "n_pre": _affine(p["pre_bn"], s["pre_bn"], device),
            "cp": _conv_w(p["conv_p"], device),
            "inner": [inner(pi, si) for pi, si in zip(p["inner"],
                                                     s["inner"])],
            "n_mid": _affine(p["mid_bn"], s["mid_bn"], device),
            "cq": _conv_w(p["conv_q"], device)})
    pp, ps = params["policy"], stats["policy"]
    vp, vs = params["value"], stats["value"]
    return {
        "stem": _conv_w(params["stem"], device), "blocks": blocks,
        "n_trunk": _affine(params["trunk_bn"], stats["trunk_bn"], device),
        "policy": {"cp": _conv_w(pp["conv_p"], device),
                   "cg": _conv_w(pp["conv_g"], device),
                   "ng": _affine(pp["bn_g"], ps["bn_g"], device),
                   "lg": _t(pp["linear_g"]["w"], device),
                   "n2": _affine(pp["bn2"], ps["bn2"], device),
                   "out": _conv_w(pp["conv_out"], device)},
        "value": {"c": _conv_w(vp["conv"], device),
                  "n": _affine(vp["bn"], vs["bn"], device),
                  "w1": _t(vp["fc1"]["w"], device),
                  "b1": _t(vp["fc1"]["b"], device),
                  "w2": _t(vp["fc2"]["w"], device),
                  "b2": _t(vp["fc2"]["b"], device)}}


def _na(x, aff):
    return torch.relu(x * aff[0] + aff[1])


def kata_gpool(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, 3C]``: mean, scaled mean, max."""
    area = x.shape[2] * x.shape[3]
    mean = x.mean(dim=(2, 3))
    return torch.cat([mean, mean * ((area ** 0.5 - 14.0) / 10.0),
                      x.amax(dim=(2, 3))], dim=1)


def value_gpool(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, 3C]``: the value head's pooling."""
    f = (x.shape[2] * x.shape[3]) ** 0.5 - 14.0
    mean = x.mean(dim=(2, 3))
    return torch.cat([mean, mean * (f / 10.0),
                      mean * (f * f / 100.0 - 0.1)], dim=1)


class Ops:
    """Every conv and linear of a forward, at one net spec.  ``record``
    keeps each site's per-channel input range (the calibration pass);
    ``ranges`` quantizes each site's input at the range recorded there."""

    def __init__(self, dtype=None, qmax=None, ranges=None, record=False):
        self.dtype, self.qmax = dtype, qmax
        self.ranges: List[torch.Tensor] = ranges if ranges is not None \
            else []
        self.record = record
        self.site = 0

    def _in(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        i = self.site
        self.site += 1
        if self.record:
            dims = [d for d in range(x.dim()) if d != dim]
            self.ranges.append(torch.clamp(torch.amax(x.abs(), dim=dims),
                                           min=RANGE_FLOOR))
            return x
        if self.qmax is not None:
            shape = [1] * x.dim()
            shape[dim] = -1
            s = (self.ranges[i] / self.qmax).view(shape)
            return torch.clamp(torch.round(x / s), -self.qmax,
                               self.qmax) * s
        if self.dtype is not None:
            return x.to(self.dtype).to(torch.float32)
        return x

    def _w(self, w: torch.Tensor, out_dim: int) -> torch.Tensor:
        if self.qmax is not None and not self.record:
            dims = [d for d in range(w.dim()) if d != out_dim]
            s = torch.clamp(torch.amax(w.abs(), dim=dims, keepdim=True),
                            min=1e-12) / self.qmax
            return torch.clamp(torch.round(w / s), -self.qmax,
                               self.qmax) * s
        if self.dtype is not None:
            return w.to(self.dtype).to(torch.float32)
        return w

    def conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self._in(x, 1), self._w(w, 0),
                        padding=w.shape[-1] // 2)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._in(x, 1) @ self._w(w, 1)


def forward(net: Dict, obs: torch.Tensor, ops: Ops):
    """``obs [B, H, W, planes]`` -> ``(policy logits [B, H*W], value
    logits [B, 3])``."""
    ops.site = 0
    with torch.no_grad():
        x = ops.conv(obs.to(torch.float32).permute(0, 3, 1, 2), net["stem"])
        for blk in net["blocks"]:
            z = ops.conv(_na(x, blk["n_pre"]), blk["cp"])
            for inn in blk["inner"]:
                u = _na(z, inn["n1"])
                r = ops.conv(u, inn["c1"])
                if "cg" in inn:
                    g = _na(ops.conv(u, inn["cg"]), inn["ng"])
                    r = r + ops.linear(kata_gpool(g), inn["lg"])[:, :, None,
                                                                  None]
                z = z + ops.conv(_na(r, inn["n2"]), inn["c2"])
            x = x + ops.conv(_na(z, blk["n_mid"]), blk["cq"])
        t = _na(x, net["n_trunk"])
        pol = net["policy"]
        p = ops.conv(t, pol["cp"])
        g = _na(ops.conv(t, pol["cg"]), pol["ng"])
        p = p + ops.linear(kata_gpool(g), pol["lg"])[:, :, None, None]
        logits = ops.conv(_na(p, pol["n2"]), pol["out"]).flatten(1)
        val = net["value"]
        v = value_gpool(_na(ops.conv(t, val["c"]), val["n"]))
        v = torch.relu(ops.linear(v, val["w1"]) + val["b1"])
        return logits, ops.linear(v, val["w2"]) + val["b2"]


def predict(net: Dict, obs: torch.Tensor, ops: Ops):
    """``(probs [B, A], value [B])``: the policy's softmax and ``p_win -
    p_loss``."""
    logits, vlogits = forward(net, obs, ops)
    wdl = torch.softmax(vlogits, dim=-1)
    return torch.softmax(logits, dim=-1), wdl[:, 0] - wdl[:, 1]


def make(params, stats, calib, device, spec: Dict):
    """The eval function ``obs -> (probs, value)`` at a configuration's
    ``reference_net`` or ``control_net`` ``spec``: ``{"dtype": d}`` or
    ``{"qmax": q}`` (module docstring)."""
    net = load(params, stats, device)
    if "qmax" in spec:
        rec = Ops(record=True)
        forward(net, torch.as_tensor(np.asarray(calib, np.float32)).to(
            device), rec)
        ops = Ops(qmax=float(spec["qmax"]), ranges=rec.ranges)
    else:
        dtype = getattr(torch, spec["dtype"])
        ops = Ops(dtype=None if dtype == torch.float32 else dtype)
    return lambda obs: predict(net, obs, ops)
