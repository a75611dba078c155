"""The int8 residual tower as a hand-written CUDA kernel, with its plain
version, and the int8 forward and eval function that run it.

Counterpart of ``alphazero_gomoku_tpu/ops/int8_tower.py``:

  - :func:`pack_tower_bundle` lays an ``ops/int8_net.quantize_int8`` bundle
    out for the kernel.  Like the JAX packer it takes only the default
    scheme: the float32 skip track and no float32 tail blocks.
  - :func:`int8_tower` is the tower (stem and ``2L`` int8 3x3 SAME convs,
    int8 x int8 -> int32 sums, dequant, bias, ReLU, requant, float32 skip
    track) as the CUDA kernel in ``csrc/int8_tower.cu`` on a CUDA tensor, and
    as :func:`int8_tower_plain` on a CPU tensor.  The kernel runs on
    padded-board tiles (``ops/conv_tile.py``); the wrapper re-lays the
    bundle's weights for it once per bundle (``conv_tile.tile_weights``) and
    keeps its zeroed activation planes.  The wrapper counts its
    calls that reach the kernel in ``int8_tower.launches`` (one per tower; a
    tower is ``1 + 2L`` CUDA launches).
  - :func:`int8_tower_apply` is the tower plus the float32 heads of
    ``int8_net.int8_apply``; :func:`make_int8_tower_eval_fn` wraps it for
    the search.

Numerics as the TPU kernel: equal bit for bit to ``int8_net.int8_apply`` on
the float32 skip track.  The observation's requant, every dequant
(``int8_net._dequant``: ``acc * scale + bias`` rounded once), ReLU, the skip
add and every requant (round half to even, clip to +-127) are the same
float operations in the same order; the integer sums are exact in any order.

Packed layout (``C`` channels, ``L`` blocks, ``cin`` observation planes):
``stem_w [C, KS]`` int8 with ``KS = 9*cin`` rounded up to 32 (row ``co``,
column ``(3*dy + dx)*cin + ci``, zero past ``9*cin``); ``block_w [L, 2, C,
9*C]`` int8 (row ``co``, column ``(3*dy + dx)*C + ci``), so that a tap's
weights are the column-major B operand of the int8 MMA; ``stem_scale``,
``stem_b``, ``inv_first [C]``; ``block_scale``, ``block_b [L, 2, C]``;
``inv_mid``, ``inv_next [L, C]`` (the next block's input scale; ones after
the last); ``inv_obs [cin]``; the heads as in the bundle.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from alphazero_gomoku_tpu_torch.models.resnet import NetConfig
from alphazero_gomoku_tpu_torch.ops import _build, conv_tile
from alphazero_gomoku_tpu_torch.ops.int8_net import (
    HEAD_KEYS,
    Bundle,
    _dequant,
    _requant_inv,
    int8_heads,
)
from alphazero_gomoku_tpu_torch.ops.tree_kernels import _check

Packed = Dict[str, torch.Tensor]

# the kernel's tile of output channels is the whole width (csrc/int8_tower.cu)
KERNEL_CHANNELS = (32, 64, 128)
STEM_K_ALIGN = 32       # the int8 MMA's depth
STEM_K_MAX = 128        # the kernel's stem takes K of 32 to 128
KERNEL_TILE = 64        # output rows of the kernel's tiles (conv_tile.py)


# ----------------------------------------------------------------------
# bundle packing (once per parameter update)
# ----------------------------------------------------------------------
def pack_tower_bundle(cfg: NetConfig, q: Bundle) -> Packed:
    """Re-lay an ``int8_net`` bundle out for :func:`int8_tower`.

    Refuses what the JAX packer refuses: the bf16 and int8 skip tracks
    (``residual="f32"`` only) and float32 tail blocks.  The heads' weights
    pass through.
    """
    if "res8" in q or "resbf" in q:
        raise ValueError("int8 tower kernel implements the f32 skip track "
                         "only (quantize with residual='f32')")
    if any(blk.get("f32") for blk in q["blocks"]):
        raise ValueError("int8 tower kernel does not support "
                         "f32_last_blocks > 0")
    c = cfg.channels
    cin = q["inv_obs"].shape[0]
    blocks = q["blocks"]
    n = len(blocks)
    ks = -(-9 * cin // STEM_K_ALIGN) * STEM_K_ALIGN
    stem = q["stem_w"].t()[:, :9 * cin]                 # [C, 9*cin]
    ones = torch.ones((c,), dtype=torch.float32, device=stem.device)
    out = {
        "stem_w": F.pad(stem, (0, ks - 9 * cin)).contiguous(),
        "stem_scale": q["stem_scale"],
        "stem_b": q["stem_b"],
        "block_w": torch.stack([torch.stack([b["w1"].t(), b["w2"].t()])
                                for b in blocks]),
        "block_scale": torch.stack([torch.stack([b["scale1"], b["scale2"]])
                                    for b in blocks]),
        "block_b": torch.stack([torch.stack([b["b1"], b["b2"]])
                                for b in blocks]),
        "inv_mid": torch.stack([b["inv_mid"] for b in blocks]),
        "inv_next": torch.stack([blocks[i + 1]["inv_in"] if i + 1 < n
                                 else ones for i in range(n)]),
        "inv_first": blocks[0]["inv_in"],
        "inv_obs": q["inv_obs"],
    }
    out = {k: v.to(torch.float32).contiguous() if v.is_floating_point()
           else v.contiguous() for k, v in out.items()}
    for k in HEAD_KEYS:
        out[k] = q[k]
    return out


# ----------------------------------------------------------------------
# the tower: plain version and kernel
# ----------------------------------------------------------------------
def _conv9_plain(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 3x3 SAME conv as nine shifted matmuls on the integer values in
    float64 (exact: every partial sum is an integer below 2^53):
    ``x_q [B, H, W, Cin]``, ``w [Cout, 9*Cin]`` -> int32 ``[B, H, W, Cout]``."""
    b, h, wd, cin = x_q.shape
    f64 = torch.float64
    pad = F.pad(x_q.to(f64), (0, 0, 1, 1, 1, 1))
    wt = w.to(f64)
    acc = None
    for k in range(9):
        dy, dx = divmod(k, 3)
        piece = pad[:, dy:dy + h, dx:dx + wd, :].reshape(b * h * wd, cin)
        term = piece @ wt[:, k * cin:(k + 1) * cin].t()
        acc = term if acc is None else acc + term
    return acc.to(torch.int32).reshape(b, h, wd, -1)


def int8_tower_plain(packed: Packed, obs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch tower: ``obs [B, H, W, cin]`` f32 -> f32 ``[B, H, W, C]``,
    the kernel's arithmetic step by step."""
    cin = obs.shape[-1]
    obs_q = _requant_inv(obs.to(torch.float32), packed["inv_obs"])
    h = torch.relu(_dequant(
        _conv9_plain(obs_q, packed["stem_w"][:, :9 * cin]),
        packed["stem_scale"], packed["stem_b"]))
    act_q = _requant_inv(h, packed["inv_first"])
    for i in range(packed["block_w"].shape[0]):
        m = torch.relu(_dequant(_conv9_plain(act_q, packed["block_w"][i, 0]),
                                packed["block_scale"][i, 0],
                                packed["block_b"][i, 0]))
        mid_q = _requant_inv(m, packed["inv_mid"][i])
        y = _dequant(_conv9_plain(mid_q, packed["block_w"][i, 1]),
                     packed["block_scale"][i, 1], packed["block_b"][i, 1])
        h = torch.relu(y + h)
        if i + 1 < packed["block_w"].shape[0]:
            act_q = _requant_inv(h, packed["inv_next"][i])
    return h


def _library() -> ctypes.CDLL:
    lib = _build.build("int8_tower").lib
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_tower_launch.argtypes = [p, i, i, i, i, i, i,
                                          p, p, p, p, p, p, p, p, p, p,
                                          p, p, i, p, p]
        lib.int8_tower_launch.restype = i
        lib._argtypes_set = True
    return lib


def int8_tower(packed: Packed, obs: torch.Tensor) -> torch.Tensor:
    """The int8 residual tower: ``obs [B, H, W, cin]`` f32 -> f32
    ``[B, H, W, C]``.

    CPU tensors take :func:`int8_tower_plain`; CUDA tensors the kernel, or
    raise: it takes ``C`` of 32, 64 or 128 and square boards up to
    ``conv_tile.MAX_BOARD`` (21).
    """
    if obs.dim() != 4:
        raise ValueError(f"obs must be [B, H, W, cin], got {tuple(obs.shape)}")
    b, h, w, cin = obs.shape
    dev = obs.device
    l_blocks, _, c, k = packed["block_w"].shape
    ks = packed["stem_w"].shape[-1]
    f32, i8 = torch.float32, torch.int8
    _check(obs, "obs", f32, (b, h, w, cin), dev)
    _check(packed["stem_w"], "stem_w", i8, (c, ks), dev)
    _check(packed["block_w"], "block_w", i8, (l_blocks, 2, c, 9 * c), dev)
    for name, shape in (("stem_scale", (c,)), ("stem_b", (c,)),
                        ("inv_first", (c,)), ("inv_obs", (cin,)),
                        ("block_scale", (l_blocks, 2, c)),
                        ("block_b", (l_blocks, 2, c)),
                        ("inv_mid", (l_blocks, c)),
                        ("inv_next", (l_blocks, c))):
        _check(packed[name], name, f32, shape, dev)
    if ks % STEM_K_ALIGN or ks < 9 * cin:
        raise ValueError(f"stem_w has {ks} columns; the kernel takes 9*cin "
                         f"= {9 * cin} rounded up to {STEM_K_ALIGN}")
    if dev.type == "cpu":
        return int8_tower_plain(packed, obs)
    if dev.type != "cuda":
        raise ValueError(f"int8_tower: unsupported device {dev}")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"int8_tower's kernel takes {KERNEL_CHANNELS} "
                         f"channels, got {c}")
    if ks > STEM_K_MAX:
        raise ValueError(f"int8_tower's kernel takes a stem of at most "
                         f"{STEM_K_MAX} columns (cin <= 14), got {ks}")
    geo = conv_tile.check_kernel_shape("int8_tower", obs.shape, c, 1,
                                       KERNEL_TILE)
    stem_t, block_t = conv_tile.derived(
        "int8_tiles", (packed["stem_w"], packed["block_w"]),
        lambda s, w: (conv_tile.tile_weights(s, c),
                      conv_tile.tile_weights(w, c)))
    lib = _library()
    act_q, mid_q = conv_tile.zeroed_planes((c // 16, geo.rows_total, 16),
                                           i8, dev)
    out = torch.empty((b, h, w, c), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.int8_tower_launch(
            obs.data_ptr(), b, h, cin, c, l_blocks, ks,
            stem_t.data_ptr(), packed["stem_scale"].data_ptr(),
            packed["stem_b"].data_ptr(), packed["inv_obs"].data_ptr(),
            packed["inv_first"].data_ptr(), block_t.data_ptr(),
            packed["block_scale"].data_ptr(), packed["block_b"].data_ptr(),
            packed["inv_mid"].data_ptr(), packed["inv_next"].data_ptr(),
            act_q.data_ptr(), mid_q.data_ptr(), geo.rows_total,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_tower launch failed with CUDA error {err}")
    int8_tower.launches += 1
    return out


int8_tower.launches = 0


def reset_launch_counts():
    int8_tower.launches = 0


# ----------------------------------------------------------------------
# the forward and the eval function
# ----------------------------------------------------------------------
def int8_tower_apply(cfg: NetConfig, packed: Packed, obs: torch.Tensor):
    """int8 forward with the tower by :func:`int8_tower`: ``obs [B, H, W,
    cin]`` -> ``(logits [B, A], value [B, 1])``, the heads as in
    ``int8_net.int8_apply``."""
    with torch.no_grad():
        return int8_heads(cfg, packed,
                          int8_tower(packed, obs.to(torch.float32)))


def make_int8_tower_eval_fn(cfg: NetConfig):
    """MCTS eval function backed by :func:`int8_tower_apply`; the bundle is
    :func:`pack_tower_bundle`'s (pack once per parameter update)."""

    def eval_fn(packed: Packed, obs: torch.Tensor):
        logits, value = int8_tower_apply(cfg, packed, obs)
        return torch.softmax(logits, dim=-1), value

    return eval_fn
