"""Utilities: phase timing and the profiler hooks."""

from alphazero_gomoku_tpu_torch.utils.profiling import (  # noqa: F401
    PhaseTimer,
    start_profiler_trace,
    stop_profiler_trace,
    trace_annotation,
)
