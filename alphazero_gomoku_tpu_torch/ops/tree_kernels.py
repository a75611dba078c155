"""The packed search tree and its kernels: ``select_walk``, ``gumbel_select_walk``
and ``backup_paths``.

Counterpart of ``alphazero_gomoku_tpu/ops/tree_kernels.py``.  The tree of B
games is one f32 tensor ``[B, n_nodes * GROUP, seg]`` in the JAX package's
layout: node ``k`` of lane ``b`` owns rows ``[k*GROUP, (k+1)*GROUP)`` of
``packed[b]``, one row per field (``seg`` = ``num_actions`` rounded up to 128):

  row 0  N     per-action visit counts
  row 1  W     per-action total values
  row 2  P     signed priors (illegal = -1; columns >= A padded -1)
  row 3  C     child node indices as small-int f32 (-1 = unexpanded)
  row 4  meta  col 0 = done flag, col 1 = node value estimate
  rows 5-7     unused (the TPU's 8-sublane tile; kept so layouts match)

Each kernel has three parts here:

  - ``*_plain``: the function in plain PyTorch, batched over lanes.  The CPU
    tests hold it against the JAX package, and ``chip_smoke.py`` holds the
    kernel against it on the card.
  - ``select_walk`` / ``gumbel_select_walk`` / ``backup_paths``: the
    wrappers with the JAX signatures.
    A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
    hand-written kernel in ``csrc/tree_kernels.cu`` or raises.  Each wrapper
    counts its kernel launches in its ``launches`` attribute.

``backup_paths`` has the JAX kernel's three modes: ``"backup"`` (one
simulation's backup), and ``"vl"`` / ``"finalize"``, the two halves of a
k-leaf simulation (virtual loss on select, its replacement by the value
after the network call).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from alphazero_gomoku_tpu_torch.ops import _build

NEG_INF = -1e9
GROUP = 8  # rows per node tile (the TPU's f32 sublane tile)

# row indices within a node tile (see module docstring)
SL_N, SL_W, SL_P, SL_C, SL_META = 0, 1, 2, 3, 4

# action index when no score equals the maximum (only with NaN scores); the
# JAX kernel's sentinel
NO_ACTION = 1 << 30
# the walk kernels keep a lane's columns t + 32 j in registers of its
# threads t: at most 16 (csrc/tree_kernels.cu, MAX_COLS)
PUCT_MAX_ACTIONS = 16 * 32
GUMBEL_MAX_ACTIONS = 16 * 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PackedLayout(NamedTuple):
    """Shape constants of the packed node-tile array.

    The tree is ``[B, n_nodes * GROUP, seg]`` f32; node ``k`` owns rows
    ``[k*GROUP, (k+1)*GROUP)``.  ``seg`` is ``num_actions`` rounded up to 128.
    """

    num_actions: int   # A
    seg: int           # row width
    n_nodes: int       # node capacity (dim 1 is n_nodes * GROUP)


def packed_layout(num_actions: int, n_nodes: int) -> PackedLayout:
    return PackedLayout(num_actions=num_actions,
                        seg=_round_up(num_actions, 128),
                        n_nodes=int(n_nodes))


def init_packed(batch: int, layout: PackedLayout, device) -> torch.Tensor:
    """Fresh packed tree: zero stats, children -1 (``tree_pallas._init_packed``)."""
    packed = torch.zeros((batch, layout.n_nodes * GROUP, layout.seg),
                         dtype=torch.float32, device=device)
    packed[:, SL_C::GROUP, :] = -1.0
    return packed


def node_tiles(packed: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """A ``[B, n_nodes, GROUP, seg]`` view of the packed tree (no copy)."""
    return packed.view(packed.shape[0], layout.n_nodes, GROUP, layout.seg)


def _butterfly_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of ``x [B, A]`` in the CUDA kernel's order (``warp_sum``).

    Thread ``t`` of a warp adds columns ``t, t+32, ...`` from 0, then the
    threads combine with xor offsets 16, 8, 4, 2, 1.  Floating-point sums
    depend on their order; this one makes the plain version equal the kernel.
    """
    b, a = x.shape
    k = (a + 31) // 32
    cols = torch.zeros((b, k * 32), dtype=x.dtype, device=x.device)
    cols[:, :a] = x
    cols = cols.view(b, k, 32)
    part = torch.zeros((b, 32), dtype=x.dtype, device=x.device)
    for j in range(k):  # padding columns add exact zeros
        part = part + cols[:, j]
    t = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, t ^ off]
    return part[:, 0]


def _lowest_argmax(scores: torch.Tensor) -> torch.Tensor:
    """Lowest index of each row's maximum (``NO_ACTION`` if none equals it,
    as with NaN scores), written out rather than left to ``argmax``."""
    iota = torch.arange(scores.shape[1], device=scores.device,
                        dtype=torch.int32)
    mx = scores.max(dim=1, keepdim=True).values
    return torch.where(scores == mx, iota, NO_ACTION).min(dim=1).values


def _walk_plain(packed: torch.Tensor, layout: PackedLayout, depth_limit: int,
                fan: int, choose):
    """The hop loop of the plain walks, all lanes per hop.

    Lane ``l`` walks tree ``l // fan`` from its root.  Per hop
    ``choose(tile [L, GROUP, seg], h)`` gives each lane's action; a lane
    stops on a terminal node (recording nothing), on an unexpanded edge (the
    leaf to expand) or at the depth cap (leaf = the node reached, action -1).
    Path rows at and beyond a lane's ``path_len`` are -1.
    """
    b = packed.shape[0] * fan
    a = layout.num_actions
    dev = packed.device
    tiles = node_tiles(packed, layout)
    n_max = layout.n_nodes - 1
    lanes = torch.arange(b, device=dev)
    trees = lanes // fan

    nodes = torch.zeros(b, dtype=torch.int32, device=dev)
    walking = torch.ones(b, dtype=torch.bool, device=dev)
    leaf = torch.zeros(b, dtype=torch.int32, device=dev)
    action = torch.full((b,), -1, dtype=torch.int32, device=dev)
    plen = torch.zeros(b, dtype=torch.int32, device=dev)
    pnodes = torch.full((depth_limit, b), -1, dtype=torch.int32, device=dev)
    pacts = torch.full((depth_limit, b), -1, dtype=torch.int32, device=dev)

    for h in range(depth_limit):
        if not bool(walking.any()):
            break
        tile = tiles[trees, nodes.long().clamp(0, n_max)]      # [L, GROUP, seg]
        done = tile[:, SL_META, 0] > 0.5
        best = choose(tile, h)
        # JAX reads the child through a one-hot sum, which gives 0 for an
        # action outside [0, A)
        in_range = (best >= 0) & (best < a)
        child = tile[lanes, SL_C, best.long().clamp(0, a - 1)].to(torch.int32)
        child = torch.where(in_range, child, 0)

        stop_done = walking & done
        rec = walking & ~done
        pnodes[h] = torch.where(rec, nodes, -1)
        pacts[h] = torch.where(rec, best, -1)
        plen = plen + rec.int()
        stop_expand = rec & (child < 0)
        stop_now = stop_done | stop_expand
        action = torch.where(stop_expand, best, action)
        leaf = torch.where(stop_now, nodes, leaf)
        nodes = torch.where(rec & (child >= 0), child, nodes)
        walking = walking & ~stop_now

    # lanes still walking hit the depth cap: leaf = the node reached, action -1
    leaf = torch.where(walking, nodes, leaf)
    return leaf, action, pnodes, pacts, plen


# ----------------------------------------------------------------------
# select_walk
# ----------------------------------------------------------------------
def select_walk_plain(packed: torch.Tensor, layout: PackedLayout,
                      cpuct: float, depth_limit: int,
                      fpu_parent: bool = False):
    """Plain PyTorch PUCT walk over B packed trees (all lanes per hop).

    Same outputs as :func:`select_walk`.  Path rows at and beyond a lane's
    ``path_len`` are -1.
    """
    a = layout.num_actions
    cpuct_t = torch.tensor(cpuct, dtype=torch.float32, device=packed.device)

    def choose(tile, h):
        n = tile[:, SL_N, :a]
        w = tile[:, SL_W, :a]
        p = tile[:, SL_P, :a]
        sum_n = n.sum(dim=1, keepdim=True)  # integer-valued: exact in any order
        if fpu_parent:
            parent_q = _butterfly_sum(w)[:, None] / torch.clamp(sum_n, min=1.0)
            q = torch.where(n > 0.0, w / torch.clamp(n, min=1.0), parent_q)
        else:
            q = w / (1.0 + n)
        sqrt_sum = torch.sqrt(sum_n)
        scores = q + cpuct_t * torch.clamp(p, min=0.0) * sqrt_sum / (1.0 + n)
        return _lowest_argmax(torch.where(p >= 0.0, scores, NEG_INF))

    return _walk_plain(packed, layout, depth_limit, 1, choose)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    # every wrapper call checks each input: the passing case in one test
    if (t.dtype == dtype and t.shape == tuple(shape) and t.device == device
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_packed(packed: torch.Tensor, layout: PackedLayout):
    b = packed.shape[0] if packed.dim() == 3 else -1
    _check(packed, "packed", torch.float32,
           (b, layout.n_nodes * GROUP, layout.seg), packed.device)
    if b < 1:
        raise ValueError("packed needs at least one lane")
    if not 0 < layout.num_actions <= layout.seg:
        raise ValueError(f"bad layout {layout}")
    return b


_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.build("tree_kernels").lib
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.select_walk_launch.argtypes = [p, i, i, i, i, f, i, i, p, p]
        lib.select_walk_launch.restype = i
        lib.backup_paths_launch.argtypes = [p, i, i, i, i, i, p, p, p, p, p,
                                            p, p, i, i, p]
        lib.backup_paths_launch.restype = i
        lib.gumbel_select_walk_launch.argtypes = [p, p, i, i, i, i, i, f, f,
                                                  i, p, p]
        lib.gumbel_select_walk_launch.restype = i
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _launch(dev: torch.device, launch, *args) -> int:
    """``launch(*args, stream)`` on ``dev``'s current stream, read on every
    call (as a CUDA graph's capture needs) by the raw-pointer query that
    PyTorch's own generated kernels use: ``torch.cuda.current_stream(dev)``
    builds a ``Stream`` object, a few microseconds a call.  The runtime
    launches on the current device, so ``dev`` is entered only when it is
    not that one."""
    if dev.index == torch.cuda.current_device():
        return launch(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return launch(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def select_walk(packed: torch.Tensor, layout: PackedLayout, cpuct: float,
                depth_limit: int, fpu_parent: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """Lockstep PUCT select over B packed trees.

    Args:
        packed: f32 ``[B, n_nodes * GROUP, seg]`` packed node tiles.
    Returns:
        ``leaf [B]`` i32, the node each lane stopped on; ``action [B]`` i32,
        the edge to expand (-1 when the lane stopped on a terminal or
        depth-capped node); ``path_nodes`` / ``path_actions`` ``[depth, B]``
        i32 (-1 at and beyond ``path_len``) and ``path_len [B]`` i32 for the
        backup.

    CPU tensors take :func:`select_walk_plain`; CUDA tensors the kernel
    (at most ``PUCT_MAX_ACTIONS`` actions), whose five outputs are views of
    one new int32 buffer, the rows of ``[3 + 2 * depth, B]``: leaf, action,
    path_len, path_nodes, path_actions.
    """
    b = _check_packed(packed, layout)
    if depth_limit < 1:
        raise ValueError(f"depth_limit={depth_limit} < 1")
    dev = packed.device
    if dev.type == "cpu":
        return select_walk_plain(packed, layout, cpuct, depth_limit,
                                 fpu_parent)
    if dev.type != "cuda":
        raise ValueError(f"select_walk: unsupported device {dev}")
    if layout.num_actions > PUCT_MAX_ACTIONS:
        raise ValueError(f"select_walk takes at most {PUCT_MAX_ACTIONS} "
                         f"actions, got {layout.num_actions}")
    lib = _library()
    rows = depth_limit * b
    out = torch.empty(3 * b + 2 * rows, dtype=torch.int32, device=dev)
    err = _launch(dev, lib.select_walk_launch, packed.data_ptr(), b,
                  layout.n_nodes, layout.seg, layout.num_actions,
                  float(cpuct), depth_limit, int(fpu_parent), out.data_ptr())
    _raise_on(err, "select_walk")
    select_walk.launches += 1
    # one split is cheaper on the host than a view per output
    leaf, action, plen, pnodes, pacts = out.split_with_sizes(
        (b, b, b, rows, rows))
    return (leaf, action, pnodes.view(depth_limit, b),
            pacts.view(depth_limit, b), plen)


select_walk.launches = 0


# ----------------------------------------------------------------------
# gumbel_select_walk
# ----------------------------------------------------------------------
# exp and log as fixed sequences of IEEE-rounded float32 operations (no
# library call), written the same way in csrc/tree_kernels.cu: the walk's
# argmax must come out the same in the kernel and here, and library exp/log
# may differ in the last bit between CUDA, the CPU and nvcc's flags.  Both
# are within 1.5 ulp of the true value.  Constants are exact float32 values.
_F = float.fromhex
_LOG2E = _F("0x1.715476p+0")
_EXP_LN2_HI = _F("0x1.62e400p-1")     # low bits zero: k * hi is exact
_EXP_LN2_LO = _F("0x1.7f7d1cp-20")
# Taylor coefficients of exp(r), |r| <= ln2 / 2, degree 7 first
_EXP_C = tuple(_F(x) for x in (
    "0x1.a01a02p-13", "0x1.6c16c2p-10", "0x1.111112p-7", "0x1.555556p-5",
    "0x1.555556p-3", "0x1.000000p-1", "0x1.000000p+0", "0x1.000000p+0"))
_SQRT2 = _F("0x1.6a09e6p+0")
_LOG_LN2_HI = _F("0x1.62e300p-1")
_LOG_LN2_LO = _F("0x1.2fefa2p-17")
# log(1+f) = f - hfsq + s*(hfsq + R(s^2)),  s = f/(2+f)  (as in fdlibm logf)
_LOG_C = tuple(_F(x) for x in (
    "0x1.f13c4cp-3", "0x1.23d3dcp-2", "0x1.99c27p-2", "0x1.555554p-1"))


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2**k as float32 for int32 ``k`` in [-126, 127], from its bits."""
    return ((k + 127) << 23).view(torch.float32)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 ``x`` (clamped to [-104, 88]), the kernel's ``exp_f32``."""
    x = torch.clamp(x, min=-104.0, max=88.0)
    k = torch.round(x * _LOG2E)                       # half to even, as rintf
    r = x - k * _EXP_LN2_HI
    r = r - k * _EXP_LN2_LO
    p = torch.full_like(r, _EXP_C[0])
    for c in _EXP_C[1:]:
        p = p * r + c
    ki = k.to(torch.int32)
    k1 = torch.clamp(ki, min=-125)
    # two exact scalings; only the second can round (into a subnormal)
    return p * _pow2(k1) * _pow2(ki - k1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """log of positive normal float32 ``x``, the kernel's ``log_f32``."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xff) - 127
    m = ((bits & 0x7fffff) | 0x3f800000).view(torch.float32)   # [1, 2)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int32)
    f = m - 1.0
    s = f / (f + 2.0)
    z = s * s
    r = torch.full_like(z, _LOG_C[0])
    for c in _LOG_C[1:]:
        r = r * z + c
    r = r * z
    hfsq = (f * 0.5) * f
    ef = e.to(torch.float32)
    return ef * _LOG_LN2_HI - ((hfsq - (s * (hfsq + r) + ef * _LOG_LN2_LO))
                               - f)


def gumbel_select_walk_plain(packed: torch.Tensor, root_actions: torch.Tensor,
                             layout: PackedLayout, depth_limit: int,
                             c_visit: float, c_scale: float, fan: int = 1):
    """Plain PyTorch Gumbel walk (all lanes per hop).

    Same outputs as :func:`gumbel_select_walk`.  Each f32 sum over actions is
    taken in the kernel's order (:func:`_butterfly_sum`), and exp and log
    are :func:`exp_f32` and :func:`log_f32`, so the two agree exactly.
    """
    a = layout.num_actions

    def choose(tile, h):
        if h == 0:
            return root_actions
        n = tile[:, SL_N, :a]
        w = tile[:, SL_W, :a]
        p_signed = tile[:, SL_P, :a]
        v_node = tile[:, SL_META, 1]
        legal = p_signed >= 0.0
        p = torch.clamp(p_signed, min=0.0)
        sum_n = n.sum(dim=1)                # integer-valued: exact in any order
        q = w / torch.clamp(n, min=1.0)
        visited = n > 0.0
        p_vis = _butterfly_sum(torch.where(visited, p, 0.0))
        w_q = _butterfly_sum(torch.where(visited, p * q, 0.0)) \
            / torch.clamp(p_vis, min=1e-8)
        v_mix = (v_node + sum_n * w_q) / (1.0 + sum_n)
        v_mix = torch.where(p_vis > 1e-8, v_mix, v_node)
        comp_q = torch.where(visited, q, v_mix[:, None])

        logits = log_f32(torch.clamp(p, min=1e-30))
        coef = (n.max(dim=1).values + c_visit) * c_scale
        sm_in = torch.where(legal, logits + coef[:, None] * comp_q, NEG_INF)
        sm_max = sm_in.max(dim=1, keepdim=True).values
        e = torch.where(legal, exp_f32(sm_in - sm_max), 0.0)
        pi_prime = e / torch.clamp(_butterfly_sum(e), min=1e-30)[:, None]
        scores = torch.where(legal, pi_prime - n / (1.0 + sum_n)[:, None],
                             NEG_INF)
        return _lowest_argmax(scores)

    return _walk_plain(packed, layout, depth_limit, fan, choose)


def gumbel_select_walk(packed: torch.Tensor, root_actions: torch.Tensor,
                       layout: PackedLayout, depth_limit: int,
                       c_visit: float, c_scale: float, fan: int = 1
                       ) -> Tuple[torch.Tensor, ...]:
    """Gumbel walk over B packed trees with per-lane forced root actions.

    The hop at depth 0 takes the lane's ``root_actions`` entry; deeper hops
    take ``argmax(pi' - N / (1 + sum N))``, lowest index on ties, with
    ``pi' = softmax(log max(P, 1e-30) + (c_visit + max N) * c_scale * Q)``
    over legal actions and the completed Q: ``W / N`` where visited, else
    the node's value (meta column 1) mixed with the prior-weighted mean Q of
    the visited actions.  Stops and path records as in :func:`select_walk`.

    ``root_actions`` is i32 ``[B * fan]``: lane ``l`` walks tree ``l // fan``
    (read-only, several walks per tree: the round-parallel search) and every
    output is sized ``[B * fan]`` / ``[depth, B * fan]``.

    CPU tensors take :func:`gumbel_select_walk_plain`; CUDA tensors the
    kernel (at most ``GUMBEL_MAX_ACTIONS`` actions), whose outputs are views
    of one new int32 buffer, as :func:`select_walk`'s.
    """
    b = _check_packed(packed, layout)
    if depth_limit < 1:
        raise ValueError(f"depth_limit={depth_limit} < 1")
    if fan < 1:
        raise ValueError(f"fan={fan} < 1")
    lanes = b * fan
    _check(root_actions, "root_actions", torch.int32, (lanes,), packed.device)
    if packed.device.type == "cpu":
        return gumbel_select_walk_plain(packed, root_actions, layout,
                                        depth_limit, c_visit, c_scale, fan)
    if packed.device.type != "cuda":
        raise ValueError(
            f"gumbel_select_walk: unsupported device {packed.device}")
    if layout.num_actions > GUMBEL_MAX_ACTIONS:
        raise ValueError(f"gumbel_select_walk takes at most "
                         f"{GUMBEL_MAX_ACTIONS} actions, got "
                         f"{layout.num_actions}")
    lib = _library()
    dev = packed.device
    rows = depth_limit * lanes
    out = torch.empty(3 * lanes + 2 * rows, dtype=torch.int32, device=dev)
    err = _launch(dev, lib.gumbel_select_walk_launch, packed.data_ptr(),
                  root_actions.data_ptr(), b, fan, layout.n_nodes,
                  layout.seg, layout.num_actions, float(c_visit),
                  float(c_scale), depth_limit, out.data_ptr())
    _raise_on(err, "gumbel_select_walk")
    gumbel_select_walk.launches += 1
    leaf, action, plen, pnodes, pacts = out.split_with_sizes(
        (lanes, lanes, lanes, rows, rows))
    return (leaf, action, pnodes.view(depth_limit, lanes),
            pacts.view(depth_limit, lanes), plen)


gumbel_select_walk.launches = 0


# ----------------------------------------------------------------------
# backup_paths
# ----------------------------------------------------------------------
BACKUP_MODES = ("backup", "vl", "finalize")   # csrc/tree_kernels.cu, by index


def backup_paths_plain(packed: torch.Tensor, path_nodes: torch.Tensor,
                       path_actions: torch.Tensor, path_len: torch.Tensor,
                       values: torch.Tensor, expanding: torch.Tensor,
                       slot: int, layout: PackedLayout,
                       signed_priors: torch.Tensor,
                       done: torch.Tensor, mode: str = "backup"
                       ) -> torch.Tensor:
    """Plain PyTorch slot-tile write and path backup, IN PLACE on ``packed``.

    Same semantics as :func:`backup_paths` in each mode; returns ``packed``.
    """
    if mode not in BACKUP_MODES:
        raise ValueError(f"unknown backup mode: {mode!r}")
    b = packed.shape[0]
    a = layout.num_actions
    dev = packed.device
    tiles = node_tiles(packed, layout)
    n_max = layout.n_nodes - 1
    lanes = torch.arange(b, device=dev)
    slot_idx = min(max(slot, 0), n_max)

    if mode == "finalize":
        # later "vl" passes of the macro step may have visited or linked the
        # slot node: every row but P and meta is kept
        tile = tiles[:, slot_idx].clone()
        tile[:, SL_META, :] = 0.0
    else:
        tile = torch.zeros((b, GROUP, layout.seg), dtype=torch.float32,
                           device=dev)
        tile[:, SL_C, :] = -1.0
    tile[:, SL_P, :] = -1.0
    tile[:, SL_P, :a] = signed_priors
    tile[:, SL_META, 0] = done.to(torch.float32)
    tile[:, SL_META, 1] = values
    tiles[:, slot_idx] = tile

    plen = path_len.long()
    expanding = expanding.bool()
    hops = min(int(plen.max()), path_nodes.shape[0])
    for i in range(hops):
        act = path_actions[i].long()
        active = (i < plen) & (act >= 0) & (act < layout.seg)
        node = path_nodes[i].long().clamp(0, n_max)
        col = act.clamp(0, layout.seg - 1)
        v = torch.where((plen - i) % 2 == 1, -values, values)
        # inactive lanes rewrite the entry they read: each lane owns its tree,
        # so no two lanes' entries coincide
        n_old = tiles[lanes, node, SL_N, col]
        w_old = tiles[lanes, node, SL_W, col]
        if mode == "backup":        # N + 1, W + v
            n_new, w_new = n_old + 1.0, w_old + v
        elif mode == "vl":          # virtual loss: N + 1, W - 1, no flip
            n_new, w_new = n_old + 1.0, w_old + -1.0
        else:                       # finalize: W + (v + 1), N as it is
            n_new, w_new = n_old, w_old + (v + 1.0)
        tiles[lanes, node, SL_N, col] = torch.where(active, n_new, n_old)
        tiles[lanes, node, SL_W, col] = torch.where(active, w_new, w_old)
        link = active & expanding & (i == plen - 1)
        c_old = tiles[lanes, node, SL_C, col]
        tiles[lanes, node, SL_C, col] = torch.where(link, float(slot), c_old)
    return packed


def backup_paths(packed: torch.Tensor, path_nodes: torch.Tensor,
                 path_actions: torch.Tensor, path_len: torch.Tensor,
                 values: torch.Tensor, expanding: torch.Tensor, slot: int,
                 layout: PackedLayout, signed_priors: torch.Tensor,
                 done: torch.Tensor, mode: str = "backup") -> torch.Tensor:
    """Write the slot tile, then apply one simulation's path update.

    IN PLACE on ``packed``, which is returned.  ``slot`` (a Python int, the
    same for every lane) is the node expanded this simulation; its tile gets
    ``signed_priors`` ``[B, A]`` (padded to ``seg`` with -1) and a meta row
    of ``(done, values, 0, ...)``.  Then each lane's recorded path is
    updated, and on lanes with ``expanding`` set the last edge is linked to
    ``slot``.  ``expanding`` and ``done`` may be bool or int (nonzero = set).
    ``mode`` (the JAX kernel's):

      - ``"backup"``: the slot tile is fresh (N = W = 0, children -1); per
        edge N += 1 and W += ±value, the sign flipping at every hop up from
        the leaf.
      - ``"vl"``: virtual loss, the select half of a k-leaf simulation; the
        slot tile is fresh (the priors are a placeholder, ``values`` the
        zeros the search passes); per edge N += 1 and W -= 1, no flip.
      - ``"finalize"``: the slot tile's P and meta rows are replaced and its
        other rows kept (later ``"vl"`` passes may have visited or linked
        the node); per edge W += ±value + 1, cancelling the virtual loss,
        and N as it is.

    CPU tensors take :func:`backup_paths_plain`; CUDA tensors the kernel.
    ``backup_paths.launches`` counts the kernel's launches, and
    ``backup_paths.mode_launches`` each mode's.
    """
    if mode not in BACKUP_MODES:
        raise ValueError(f"unknown backup mode: {mode!r}")
    b = _check_packed(packed, layout)
    dev = packed.device
    d = path_nodes.shape[0] if path_nodes.dim() == 2 else -1
    if d < 1:
        raise ValueError("path_nodes must be [depth, B] with depth >= 1")
    _check(path_nodes, "path_nodes", torch.int32, (d, b), dev)
    _check(path_actions, "path_actions", torch.int32, (d, b), dev)
    _check(path_len, "path_len", torch.int32, (b,), dev)
    _check(values, "values", torch.float32, (b,), dev)
    _check(signed_priors, "signed_priors", torch.float32,
           (b, layout.num_actions), dev)
    expanding = expanding if expanding.dtype == torch.bool else expanding != 0
    done = done if done.dtype == torch.bool else done != 0
    _check(expanding, "expanding", torch.bool, (b,), dev)
    _check(done, "done", torch.bool, (b,), dev)
    slot = int(slot)
    if dev.type == "cpu":
        return backup_paths_plain(packed, path_nodes, path_actions, path_len,
                                  values, expanding, slot, layout,
                                  signed_priors, done, mode)
    if dev.type != "cuda":
        raise ValueError(f"backup_paths: unsupported device {dev}")
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (the slot tile is "
                         "written in 16-byte stores)")
    lib = _library()
    err = _launch(dev, lib.backup_paths_launch, packed.data_ptr(), b,
                  layout.n_nodes, layout.seg, layout.num_actions, d,
                  path_nodes.data_ptr(), path_actions.data_ptr(),
                  path_len.data_ptr(), values.data_ptr(),
                  expanding.data_ptr(), signed_priors.data_ptr(),
                  done.data_ptr(), slot, BACKUP_MODES.index(mode))
    _raise_on(err, "backup_paths")
    backup_paths.launches += 1
    backup_paths.mode_launches[mode] += 1
    return packed


backup_paths.launches = 0
backup_paths.mode_launches = dict.fromkeys(BACKUP_MODES, 0)


def reset_launch_counts():
    select_walk.launches = 0
    gumbel_select_walk.launches = 0
    backup_paths.launches = 0
    backup_paths.mode_launches = dict.fromkeys(BACKUP_MODES, 0)


class TreeOps(NamedTuple):
    """The tree functions a search runs: the wrappers, or the plain ones."""

    select_walk: object
    backup_paths: object
    gumbel_select_walk: object


KERNELS = TreeOps(select_walk, backup_paths, gumbel_select_walk)
# the plain versions on any device: chip_smoke.py runs a search with these on
# the card to hold the kernel path's pi against them
PLAIN = TreeOps(select_walk_plain, backup_paths_plain,
                gumbel_select_walk_plain)
