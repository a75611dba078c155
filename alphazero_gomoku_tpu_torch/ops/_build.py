"""Build of the port's CUDA kernels: ``nvcc`` into a shared library, ``ctypes``.

Each source in ``csrc/`` is compiled at first use, on the machine with the
card, into ``alphazero_gomoku_tpu_torch/build/`` (listed in ``.gitignore``)
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so <src>

No PyTorch headers are included, so a build takes seconds.  The library name
carries a hash of the source and the flags, so an edit rebuilds.  Paths are
resolved from this file, not from the working directory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class BuiltLibrary:
    """A loaded kernel library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float        # nvcc's wall time for this library
    ptxas: List[str]      # nvcc's -Xptxas -v lines (registers, spills)
    reused: bool          # loaded from an earlier build in BUILD_DIR


_LOADED: Dict[str, BuiltLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on the machine with the card")


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per process and per content) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    # nvcc's seconds and ptxas lines, kept beside the library for reuse
    report = out.with_suffix(".json")
    reused = out.exists() and report.exists()
    if not reused:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if "ptxas" in ln]
        # atomic renames: a concurrent build never sees a half-written file
        tmp_report = report.with_name(f"{report.name}.{os.getpid()}.tmp")
        tmp_report.write_text(json.dumps({"seconds": seconds,
                                          "ptxas": ptxas}))
        os.replace(tmp, out)
        os.replace(tmp_report, report)
    info = json.loads(report.read_text())
    built = BuiltLibrary(ctypes.CDLL(str(out)), out, info["seconds"],
                         info["ptxas"], reused)
    _LOADED[name] = built
    return built
