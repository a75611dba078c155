"""The profiled slice: its device work, attributed to the harness's ranges.

The harness opens a ``record_function`` range around each call it makes
into a layer of the program (``bench.net``, ``bench.tree``, ``bench.game``)
and one around the whole slice (``bench.slice``).  A device operation
(kernel, copy or set) belongs to the layer whose range was open on the host
when it was launched: the launch is the CUDA runtime or driver call with
the operation's correlation id, so a kernel launched through ``ctypes``
counts as well as one launched by a torch op, and a kernel renamed or fused
by a later change still counts where its launch sits.  Operations launched
outside every layer's range belong to the search driver and the move loop
(``glue``).

:func:`from_profiler` reads a stopped ``torch.profiler.profile`` in memory
(no trace file is written); everything else works on the plain
:class:`Slice` it returns, which the tests build by hand.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.yardstick import busy_ns, gaps

PREFIX = "bench."
SLICE = "bench.slice"
LAYERS = ("net", "tree", "game")
GLUE = "glue"
TOP = 10


@dataclasses.dataclass
class Slice:
    start_ns: float
    end_ns: float
    # (layer, start_ns, end_ns): the harness's ranges, not nested
    ranges: List[Tuple[str, float, float]]
    # correlation id -> host time of the launching runtime or driver call
    launches: Dict[int, float]
    # (name, start_ns, end_ns, correlation id) of each device operation
    device: List[Tuple[str, float, float, int]]
    _layer_of: Optional[List[str]] = None

    @property
    def wall_ns(self) -> float:
        return self.end_ns - self.start_ns

    def _host_layer(self, t: Optional[float]) -> str:
        if t is None:
            return GLUE
        starts = self._starts
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and self.ranges[i][2] >= t:
            return self.ranges[i][0]
        return GLUE

    def layer_of(self) -> List[str]:
        """The layer of each device operation, in ``device`` order."""
        if self._layer_of is None:
            self.ranges.sort(key=lambda r: r[1])
            self._starts = [r[1] for r in self.ranges]
            self._layer_of = [self._host_layer(self.launches.get(corr))
                              for _, _, _, corr in self.device]
        return self._layer_of

    def unmatched(self) -> int:
        """Device operations whose launch the trace does not hold."""
        return sum(1 for d in self.device if d[3] not in self.launches)

    def busy_ns(self, layer: Optional[str] = None) -> float:
        """Union of the device intervals (of one layer's operations)."""
        if layer is None:
            return busy_ns((s, e) for _, s, e, _ in self.device)
        return busy_ns((d[1], d[2]) for d, lay in
                       zip(self.device, self.layer_of()) if lay == layer)

    def count(self, layer: Optional[str] = None) -> int:
        if layer is None:
            return len(self.device)
        return sum(1 for lay in self.layer_of() if lay == layer)

    def top_names(self, layer: str, k: int = 3) -> List[str]:
        """The ``k`` device operations of a layer that took most time."""
        by_name: Dict[str, float] = defaultdict(float)
        for (name, s, e, _), lay in zip(self.device, self.layer_of()):
            if lay == layer:
                by_name[name[:60]] += e - s
        return sorted(by_name, key=lambda n: -by_name[n])[:k]

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time (summed by name), and
        the device's idle time summed by what the host was doing at the
        middle of each gap, in seconds."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device:
            by_name[name[:120]] += e - s
        idle: Dict[str, float] = defaultdict(float)
        self.layer_of()
        spans = [(s, e) for _, s, e, _ in self.device]
        for s, e in gaps(spans, self.start_ns, self.end_ns):
            idle["host in " + self._host_layer((s + e) / 2)] += e - s

        def top(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def card_profiler():
    """A profiler of the card's operations alone (no host events), for a
    whole window."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def card_busy_ns(prof) -> Tuple[float, int]:
    """The union of the intervals of every device operation (kernel, copy
    or set) a stopped profiler recorded, in ns, and their number."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and not ev.is_user_annotation():
            s = ev.start_ns()
            spans.append((s, s + ev.duration_ns()))
    return busy_ns(spans), len(spans)


def from_profiler(prof) -> Slice:
    """The slice a stopped ``torch.profiler.profile`` recorded."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges, launches, device = [], {}, []
    start = end = None
    for ev in events:
        name = ev.name()
        s = float(ev.start_ns())
        e = s + float(ev.duration_ns())
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device.append((name, s, e, int(ev.correlation_id())))
            continue
        if ev.is_user_annotation() or name.startswith(PREFIX):
            if name == SLICE:
                start, end = s, e
            elif name.startswith(PREFIX):
                ranges.append((name[len(PREFIX):], s, e))
            continue
        # the CUDA runtime's and driver's calls (cudaLaunchKernel,
        # cuLaunchKernelEx, cudaMemcpyAsync, ...) carry the correlation id
        # of the device operation they start
        if name.startswith("cu"):
            corr = int(ev.correlation_id())
            if corr > 0:
                launches.setdefault(corr, s)
    if start is None:
        raise RuntimeError("the profiler holds no bench.slice range")
    device = [d for d in device if start <= d[1] <= end]
    return Slice(start, end, ranges, launches, device)
