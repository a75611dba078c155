"""Build of the port's CUDA kernels: ``nvcc`` into a shared library, ``ctypes``.

Each source in ``csrc/`` is compiled at first use, on the machine with the
card, into ``alphazero_gomoku_tpu_torch/build/`` (listed in ``.gitignore``)
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -shared -Xcompiler -fPIC -Xptxas -v <SOURCE_FLAGS[name]>
         -o build/<name>-<hash>.so <src>

``SOURCE_FLAGS`` adds flags per source: the tree kernels and the int8
tower build with ``--fmad=false``, so that no multiply and add are
contracted into an FMA and they round as their plain versions do; the bf16
tower, the rate probe (only tensor-core sums), the slice write (its one
multiply and add rounded apart by intrinsics), the latency probes (no
arithmetic), the game step (one IEEE division, no multiply and add) and
the global pooling and the elementwise passes (their arithmetic rounded
by intrinsics) build without it; no source takes a fast-math flag.  No PyTorch
headers are included, so a build takes seconds.  The two towers include
``csrc/conv_tile.cuh``, their shared core, found beside the source.
:func:`build_all` starts one ``nvcc`` per source at once.  The library name
carries a hash of the source, the headers it includes and the flags, so an
edit to any of them rebuilds.  Paths are
resolved from this file, not from the working directory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCE_FLAGS = {
    "tree_kernels": ("--fmad=false",),
    "fused_net": (),
    "int8_tower": ("--fmad=false",),
    "matmul_rate": (),
    "width1_slice": (),
    "latency_floor": (),
    "game_step": (),
    "katago_gpool": (),
    "katago_eltwise": (),
}


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


def _flags(name: str):
    if name not in SOURCE_FLAGS:
        raise ValueError(f"no kernel source named {name!r}")
    return NVCC_FLAGS + SOURCE_FLAGS[name]


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes, followed
    recursively (``conv_tile.cuh``, the towers' shared core)."""
    found, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (path.parent / inc).exists():
                todo.append(path.parent / inc)
    return found


def _library_path(name: str) -> Path:
    """The library's path: a hash of the source, the headers it includes and
    the flags, so an edit to any of them rebuilds."""
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, BuiltLibrary]:
    """Compile ``csrc/<name>.cu`` for each name (once per process and per
    content), all ``nvcc`` processes running at once, and load them."""
    names = list(dict.fromkeys(names))
    # nvcc's seconds and ptxas lines are kept beside each library for reuse
    todo = [n for n in names if n not in _LOADED
            and not (_library_path(n).exists()
                     and _library_path(n).with_suffix(".json").exists())]
    running = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        out = _library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name), "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in running.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu (exit "
                          f"{proc.returncode}):\n{output}")
            continue
        out = _library_path(name)
        report = out.with_suffix(".json")
        # ptxas's own lines and its "bytes spill stores" lines under them
        ptxas = [ln.strip() for ln in output.splitlines()
                 if "ptxas" in ln or "spill" in ln]
        # atomic renames: a concurrent build never sees a half-written file
        tmp_report = report.with_name(f"{report.name}.{os.getpid()}.tmp")
        tmp_report.write_text(json.dumps({"seconds": seconds,
                                          "ptxas": ptxas}))
        os.replace(tmp, out)
        os.replace(tmp_report, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name in _LOADED:
            continue
        out = _library_path(name)
        info = json.loads(out.with_suffix(".json").read_text())
        _LOADED[name] = BuiltLibrary(ctypes.CDLL(str(out)), out,
                                     info["seconds"], info["ptxas"],
                                     reused=name not in running)
    return {name: _LOADED[name] for name in names}


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per process and per content) and load it."""
    return build_all([name])[name]
