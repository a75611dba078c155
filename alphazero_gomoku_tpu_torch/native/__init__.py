"""Native (C) scans for host-side hot loops, loaded via ctypes.

Counterpart of ``alphazero_gomoku_tpu/native/__init__.py``, with its own
copy of ``puremcts.c``.  The package ships the C source (no prebuilt
binary); the first call of :func:`load_puremcts` compiles it with the
system compiler into ``alphazero_gomoku_tpu_torch/build/`` (listed in
``.gitignore``, beside the CUDA kernels' builds) and memoizes the handle.
Everything here is optional: callers treat a ``None`` return from
:func:`load_puremcts` as "use the NumPy fallback", so the port keeps
working on machines without a toolchain (``AZG_NO_NATIVE=1`` forces the
fallback, e.g. for the differential tests).

These are *host* scans (the heuristic pure-MCTS baseline and the
AlphaZero player's tactical guard), where the arrays are 225 elements and
NumPy's per-op dispatch (~3 us) exceeds the arithmetic by ~100x; the card
never runs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from alphazero_gomoku_tpu_torch.ops._build import BUILD_DIR

_SRC_DIR = Path(__file__).resolve().parent
_lock = threading.Lock()
_cache: dict = {}


def _build(name: str, sources: list[str]) -> Optional[Path]:
    """Compile ``sources`` into a shared library in ``BUILD_DIR``,
    content-addressed so source edits trigger a rebuild; returns the .so
    path or None."""
    blobs = []
    for s in sources:
        try:
            blobs.append((_SRC_DIR / s).read_bytes())
        except OSError:
            return None
    digest = hashlib.sha256(b"\0".join(blobs)).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", "-o", str(tmp)]
                    + [str(_SRC_DIR / s) for s in sources],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)  # atomic vs concurrent builders
                return out
            except (OSError, subprocess.SubprocessError):
                continue
    except OSError:
        pass
    return None


def load_puremcts() -> Optional[ctypes.CDLL]:
    """ctypes handle to the pure-MCTS heuristic scans, or None."""
    if os.environ.get("AZG_NO_NATIVE"):
        return None
    with _lock:
        if "puremcts" in _cache:
            return _cache["puremcts"]
        lib = None
        path = _build("puremcts", ["puremcts.c"])
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
                i8p = ctypes.POINTER(ctypes.c_int8)
                i32 = ctypes.c_int32
                f32p = ctypes.POINTER(ctypes.c_float)
                i32p = ctypes.POINTER(ctypes.c_int32)
                u8p = ctypes.POINTER(ctypes.c_uint8)
                lib.az_threat_scores.argtypes = [i8p, i32, i32, i32, f32p]
                lib.az_capture_potential.argtypes = [i8p, i32, i32, i32p]
                lib.az_capture_count_all.argtypes = [i8p, i32, i32, i32p]
                lib.az_winning_cells.argtypes = [i8p, i32, i32, i32, u8p]
                lib.az_policy_scores.argtypes = [i8p, i32, i32, i32, f32p]
                for fn in (lib.az_threat_scores, lib.az_capture_potential,
                           lib.az_capture_count_all, lib.az_winning_cells,
                           lib.az_policy_scores):
                    fn.restype = None
            except OSError:
                lib = None
        _cache["puremcts"] = lib
        return lib
