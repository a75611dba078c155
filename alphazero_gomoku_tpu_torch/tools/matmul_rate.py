"""Tensor-core rate probe per dtype at the towers' GEMM shape, on the card.

Counterpart of ``tools/mosaic_matmul_rate.py``.  The function of its
``pallas_rate``: for ``x [M + reps, k]`` and ``w [k, N]``, ``steps`` times
over, ``out [M, N] = sum_{r < reps} x[r:r+M] @ w`` from zero; the last
step's sum is returned.  int8 x int8 -> int32, or bf16 x bf16 -> float32.

  - :func:`matmul_rate` runs it as the CUDA kernel in
    ``csrc/matmul_rate.cu`` on CUDA tensors (``wgmma``, in the towers' own
    forms: int8 m64n128k32 and bf16 m64n64k16, both operands from shared
    memory), and as :func:`matmul_rate_plain` on CPU tensors.  It counts its
    kernel launches in ``matmul_rate.launches`` and per dtype in
    ``matmul_rate.dtype_launches``.
  - :func:`rate_planes` lays ``x`` and ``w`` out as the kernel reads them,
    in 16-byte chunk planes, before each launch;
    :func:`matmul_rate_planes_plain` is the product over those planes.
  - :func:`library_sum` is the control, the JAX tool's ``xla_rate``: one
    step through one PyTorch call per dot (``torch._int_mm``, whose second
    operand must be column-major on the card, or ``torch.mm(...,
    out_dtype=torch.float32)``); :func:`library_runner` replays one step's
    calls as a CUDA graph.  A yardstick only: no path of the port calls it.
  - :func:`time_rate` keeps the JAX tool's construct (``time_fn``): the rate
    is taken from the difference between ``HI`` and ``LO`` steps, best of
    two runs each, here by CUDA events.  It raises if the time does not grow
    with the step count (steps elided).
  - :func:`measure` runs every mode at both row counts: ``M_PARITY``, the
    JAX tool's shape, and ``M_CARD``, the towers' GEMM at batch 256 on this
    card.  The rate at ``M_CARD``, ``k = 128`` stands beside the towers'.

    python -m alphazero_gomoku_tpu_torch.tools.matmul_rate

prints one ``{"mode": ..., "tflops": ...}`` line per mode (modes named as
the JAX tool's, with the row count: ``cuda_int8_k128_m57600``,
``torch_bf16_k1152_m2040``), then ``{"summary": ..., "m": ..., "n": ...,
"construct": ...}``.  It needs the card; a mode that fails to build,
launch or grow with the step count exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import Callable, Dict, Tuple

import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.ops import _build
from alphazero_gomoku_tpu_torch.ops.tree_kernels import _check, _raise_on

M_PARITY = 2040     # the JAX tool's M: the TPU tower kernel's block of rows
M_CARD = 57600      # 256 boards x 225 pixels: the towers' GEMM at batch 256
ROW_COUNTS = (M_PARITY, M_CARD)
K, N = 128, 128
# (k, reps): the towers' per-tap GEMM (K = 128, 9 taps) and the im2col
# shape (K = 1152, as the JAX tool, 4 dots a step)
SHAPES = ((K, 9), (9 * K, 4))
HI, LO = 400, 50    # the JAX tool's step counts
# run(steps) calls per time_rate: a warm-up, then two at LO and two at HI
CALLS_PER_RATE = 1 + 2 + 2
CONSTRUCT = "delta of in-kernel step counts (CUDA events, best of 2)"
# a spin of about 2 ms before each timed run (torch.cuda._sleep): at M 2040
# a kernel step takes 0.3 us, less than the host takes to enqueue the
# wrapper's layout and launch, which the events would otherwise time
SLEEP_CYCLES = 4_000_000

# dtype name -> (input dtype, accumulator dtype, elements of K an
# instruction takes: 32 bytes)
DTYPES = {"int8": (torch.int8, torch.int32, 32),
          "bf16": (torch.bfloat16, torch.float32, 16)}
# dense tensor-core peaks of an H100 SXM (NVIDIA data sheet), TOP/s and
# TFLOP/s; a rate above 1.25x its peak means steps were elided
PEAK_TFLOPS = {"int8": 1979.0, "bf16": 989.0}
BLOCK_N = 128       # the kernel's tile of output columns
TILE_M = 128        # the kernel's tile of output rows (64 a warpgroup)
# the bf16 kernel against its plain version: two float32 sums of the same
# exact products in different orders.  Their difference is about 2^-23 of
# sum |x * w| per element (one rounding per add, at most k * reps adds);
# held within 2^-16 of it
BF16_REL_TOL = 2.0 ** -16


def _dtype_name(t: torch.Tensor) -> str:
    for name, (dtype, _, _) in DTYPES.items():
        if t.dtype == dtype:
            return name
    raise TypeError(f"matmul_rate takes int8 or bfloat16 inputs, got "
                    f"{t.dtype}")


def _check_args(x, w, reps, steps) -> Tuple[str, int, int, int]:
    name = _dtype_name(x)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x must be [M + reps, k] and w [k, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    rows, k = x.shape
    n = w.shape[1]
    m = rows - int(reps)
    if reps < 1 or steps < 1 or m < 1:
        raise ValueError(f"need reps >= 1, steps >= 1 and M >= 1; got reps "
                         f"{reps}, steps {steps}, x rows {rows}")
    _check(x, "x", DTYPES[name][0], (rows, k), x.device)
    _check(w, "w", DTYPES[name][0], (k, n), x.device)
    return name, m, k, n


def matmul_rate_plain(x: torch.Tensor, w: torch.Tensor, reps: int,
                      steps: int) -> torch.Tensor:
    """Plain PyTorch version: ``steps`` times ``sum_r x[r:r+M] @ w`` from
    zero, the last returned.  int8 sums in float64 and cast to int32, exact
    while ``|sum| < 2^53`` (``k * reps * 128^2`` is below 2^31 wherever the
    kernel runs); bf16 sums in float32 from float32 copies."""
    name, m, _, n = _check_args(x, w, reps, steps)
    wide = torch.float64 if name == "int8" else torch.float32
    xw, ww = x.to(wide), w.to(wide)
    for _ in range(steps):
        acc = torch.zeros((m, n), dtype=wide, device=x.device)
        for r in range(reps):
            acc = acc + xw[r:r + m] @ ww
    return acc.to(DTYPES[name][1])


def plane_rows(m: int, reps: int) -> int:
    """Rows of ``x``'s chunk planes: the tiles' ``TILE_M`` rows each, plus
    the ``reps - 1`` rows that a tile's shifts read past its end, rounded up
    to 8 (``a_rows`` of ``csrc/matmul_rate.cu``)."""
    return -(-m // TILE_M) * TILE_M + -(-(reps - 1) // 8) * 8


def rate_planes(x: torch.Tensor, w: torch.Tensor,
                reps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [M + reps, k]`` and ``w [k, N]`` in the kernel's chunk planes,
    ``E = 16 / itemsize`` elements (16 bytes) of K a chunk:

      - ``xp [k / E, plane_rows(M, reps), E]``: plane ``c`` holds elements
        ``c*E .. c*E + E - 1`` of every row, rows past ``x``'s zero;
      - ``wp [N / 128, k / E, 128, E]``: per slice of 128 columns, per chunk
        of K, the slice's columns (``w`` transposed).

    A row shift ``r`` of ``x`` is then rows ``r .. r + M`` of every plane:
    the kernel moves a descriptor's start by ``r * 16`` bytes."""
    m = x.shape[0] - reps
    k, n = w.shape
    e = 16 // x.element_size()
    rows = plane_rows(m, reps)
    flat = x.new_zeros((rows, k))
    take = min(x.shape[0], rows)
    flat[:take] = x[:take]
    xp = flat.reshape(rows, k // e, e).transpose(0, 1).contiguous()
    wp = w.t().reshape(n // BLOCK_N, BLOCK_N, k // e, e).transpose(1, 2) \
        .contiguous()
    return xp, wp


def matmul_rate_planes_plain(xp: torch.Tensor, wp: torch.Tensor, m: int,
                             reps: int, steps: int) -> torch.Tensor:
    """:func:`matmul_rate_plain` on the operands as the kernel reads them
    (:func:`rate_planes`): row shift ``r`` is rows ``r .. r + m`` of every
    chunk plane of ``xp``, ``w`` the columns of ``wp``'s slices."""
    kc, rows, e = xp.shape
    x = xp.transpose(0, 1).reshape(rows, kc * e)
    w = wp.transpose(1, 2).reshape(-1, kc * e).t()
    return matmul_rate_plain(x[:m + reps].contiguous(), w.contiguous(), reps,
                             steps)


def _library() -> ctypes.CDLL:
    lib = _build.build("matmul_rate").lib
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.matmul_rate_launch.argtypes = [i, p, p, p, i, i, i, i, i, i, p]
        lib.matmul_rate_launch.restype = i
        lib._argtypes_set = True
    return lib


def matmul_rate(x: torch.Tensor, w: torch.Tensor, reps: int,
                steps: int) -> torch.Tensor:
    """``steps`` times ``sum_{r < reps} x[r:r+M] @ w`` from zero, for
    ``x [M + reps, k]`` and ``w [k, N]``; the last step's ``[M, N]`` sum.

    CPU tensors take :func:`matmul_rate_plain`; CUDA tensors the kernel
    (``k`` a multiple of the instruction's depth, 32 int8 or 16 bf16, ``N``
    of 128) on the operands laid out by :func:`rate_planes`, or raise.
    """
    name, m, k, n = _check_args(x, w, reps, steps)
    dev = x.device
    if dev.type == "cpu":
        return matmul_rate_plain(x, w, reps, steps)
    if dev.type != "cuda":
        raise ValueError(f"matmul_rate: unsupported device {dev}")
    _, acc_dtype, depth = DTYPES[name]
    if k % depth or n % BLOCK_N:
        raise ValueError(f"matmul_rate's {name} kernel takes k a multiple of "
                         f"{depth} and N of {BLOCK_N}, got k {k}, N {n}")
    if name == "int8" and k * reps * 128 * 128 >= 2 ** 31:
        raise ValueError(f"k * reps = {k * reps}: int32 sums could overflow")
    lib = _library()
    xp, wp = rate_planes(x, w, reps)
    out = torch.empty((m, n), dtype=acc_dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.matmul_rate_launch(
            list(DTYPES).index(name), xp.data_ptr(), wp.data_ptr(),
            out.data_ptr(), m, k, n, int(reps), int(steps), xp.shape[1],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "matmul_rate")
    matmul_rate.launches += 1
    matmul_rate.dtype_launches[name] += 1
    return out


matmul_rate.launches = 0
matmul_rate.dtype_launches = dict.fromkeys(DTYPES, 0)


def reset_launch_counts():
    matmul_rate.launches = 0
    matmul_rate.dtype_launches = dict.fromkeys(DTYPES, 0)


def bf16_bound(x: torch.Tensor, w: torch.Tensor, reps: int) -> torch.Tensor:
    """Per element of the output, ``BF16_REL_TOL * sum_r |x[r:r+M]| @
    |w|`` (float64): how far two float32 orders of the same sum may part."""
    m = x.shape[0] - reps
    xa, wa = x.double().abs(), w.double().abs()
    return BF16_REL_TOL * sum(xa[r:r + m] @ wa for r in range(reps))


# ----------------------------------------------------------------------
# the library control and the timing construct
# ----------------------------------------------------------------------
def library_sum(x: torch.Tensor, w_lib: torch.Tensor,
                reps: int) -> torch.Tensor:
    """One step, one PyTorch call per dot: ``torch._int_mm`` (int8; on the
    card ``w_lib`` column-major, see :func:`library_runner`) or
    ``torch.mm(..., out_dtype=torch.float32)`` (bf16, card only), the sums
    added in place."""
    m = x.shape[0] - reps
    acc = None
    for r in range(reps):
        if x.dtype == torch.int8:
            dot = torch._int_mm(x[r:r + m], w_lib)
        else:
            dot = torch.mm(x[r:r + m], w_lib, out_dtype=torch.float32)
        acc = dot if acc is None else acc.add_(dot)
    return acc


def library_runner(x: torch.Tensor, w: torch.Tensor,
                   reps: int) -> Callable[[int], torch.Tensor]:
    """``run(steps)`` for the library control on the card: one step's calls
    captured in a CUDA graph, replayed ``steps`` times (a Python loop of
    eager calls would measure the host's launches at M = 2040)."""
    if x.device.type != "cuda":
        raise ValueError("the library control is timed on the card")
    # cuBLASLt takes _int_mm's second operand column-major only
    w_lib = w.t().contiguous().t() if x.dtype == torch.int8 else w
    library_sum(x, w_lib, reps)     # cuBLAS handles and workspaces first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = library_sum(x, w_lib, reps)

    def run(steps: int) -> torch.Tensor:
        for _ in range(steps):
            graph.replay()
        return out

    return run


def time_rate(run: Callable[[int], torch.Tensor], ops_per_step: float,
              name: str) -> Tuple[float, float]:
    """``(TFLOP/s, ms per step)`` of ``run(steps)`` from the difference
    between ``HI`` and ``LO`` steps, best of two CUDA-event timings each
    after a warm-up at ``HI``, each queued behind a spin of the card
    (``SLEEP_CYCLES``).  Raises if the time does not grow with the
    step count, or the rate passes 1.25x the card's peak: steps elided."""
    run(HI)
    torch.cuda.synchronize()

    def t(steps: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the card busy first, so that the timed work is queued by the time
        # it starts and the host's enqueueing is not timed with it
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        run(steps)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    d_lo = min(t(LO), t(LO))
    d_hi = min(t(HI), t(HI))
    if not d_hi > d_lo:
        raise RuntimeError(f"{HI} steps took {d_hi} ms, {LO} steps {d_lo} "
                           f"ms: the time did not grow with the step count")
    ms = (d_hi - d_lo) / (HI - LO)
    tflops = ops_per_step / ms / 1e9
    if tflops > 1.25 * PEAK_TFLOPS[name]:
        raise RuntimeError(f"{tflops:.1f} T/s is above the card's {name} "
                           f"peak: steps were elided")
    return tflops, ms


def make_inputs(m: int, k: int, reps: int, generator: torch.Generator,
                device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The JAX tool's inputs, drawn on ``device``: int8 integers in [-3, 3],
    bf16 from a standard normal; ``x [m + reps, k]``, ``w [k, N]``."""
    def ints(shape):
        return torch.randint(-3, 4, shape, generator=generator,
                             device=device, dtype=torch.int8)

    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=device).to(torch.bfloat16)

    return {"int8": (ints((m + reps, k)), ints((k, N))),
            "bf16": (normal((m + reps, k)), normal((k, N)))}


def measure(device=None) -> Dict[str, Dict[str, float]]:
    """Every mode's rate, printed as the JAX tool prints it, the summary
    last: ``{mode: {"tflops", "ms_per_step", "m", "k", "reps"}}``.  The
    inputs are drawn from seed 0, as the JAX tool's."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("rates are taken on the card; the CPU runs the "
                           "plain version through the tests")
    generator = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for m in ROW_COUNTS:
        for k, reps in SHAPES:
            inputs = make_inputs(m, k, reps, generator, dev)
            ops = 2.0 * m * k * N * reps
            for route in ("cuda", "torch"):
                for name, (x, w) in inputs.items():
                    if route == "cuda":
                        def run(steps, x=x, w=w, reps=reps):
                            return matmul_rate(x, w, reps, steps)
                    else:
                        run = library_runner(x, w, reps)
                    mode = f"{route}_{name}_k{k}_m{m}"
                    tflops, ms = time_rate(run, ops, name)
                    results[mode] = dict(tflops=tflops, ms_per_step=ms, m=m,
                                         k=k, reps=reps)
                    print(json.dumps({"mode": mode, "tflops": round(tflops, 1),
                                      "ms_per_step": ms}), flush=True)
            del inputs
    print(json.dumps({
        "summary": {mode: round(r["tflops"], 1)
                    for mode, r in results.items()},
        "m": list(ROW_COUNTS), "n": N, "construct": CONSTRUCT,
        "device": torch.cuda.get_device_name(dev)}), flush=True)
    return results


def main() -> int:
    measure()
    return 0


if __name__ == "__main__":
    sys.exit(main())
