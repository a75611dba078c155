"""Tracing and phase timing.

Counterpart of ``alphazero_gomoku_tpu/utils/profiling.py``: ``PhaseTimer``
collects wall seconds per named phase (the training loop's log lines and
its history's ``phase_seconds``); ``trace_annotation`` names a region in a
profile (``torch.profiler.record_function``, for ``jax.profiler``'s
``TraceAnnotation``); ``start_profiler_trace`` / ``stop_profiler_trace``
bracket a ``torch.profiler`` trace of the CPU and, where there is a card,
its CUDA kernels (the kernels launched through ``ctypes`` among them, by
their names), written as a Chrome trace (``chrome://tracing``, Perfetto)
into the directory given.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Wall seconds per named phase, across iterations; on a CUDA
    ``device`` a phase ends with a synchronise, so that its seconds hold
    its device work."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": round(self.totals[name], 3),
                       "count": self.counts[name],
                       "mean_s": round(self.totals[name]
                                       / max(self.counts[name], 1), 3)}
                for name in self.totals}


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named region in a profile (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


# the running trace: one at a time in a process, as jax.profiler's
_trace: Optional[tuple] = None


def start_profiler_trace(log_dir: str = "az_trace") -> str:
    """Begin a trace of the CPU and, with a card, its CUDA kernels; it is
    written into ``log_dir`` by :func:`stop_profiler_trace`."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a profiler trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace = (prof, log_dir)
    return log_dir


def stop_profiler_trace() -> str:
    """End the trace and write it into its directory as
    ``trace_<pid>.json`` (a Chrome trace); its path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no profiler trace is running")
    prof, log_dir = _trace
    _trace = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
