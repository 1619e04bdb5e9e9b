"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read.

``Trace`` holds, for a profiled sub-window of ``steps`` training steps:
the device's operations as (name, start, end) intervals, the host's
operators as (name, start, end), and the device time the profiler gives
each host operator (its own kernels, and with its children).  It is built
from the profiler's events in ``from_profile``, or directly in the tests.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[str, float, float]   # name, start and end in seconds

NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10
NAMED_GAPS = 500


@dataclasses.dataclass
class OpTime:
    count: int
    device_s: float        # its kernels and its children's
    self_device_s: float   # its own kernels only


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    device: List[Interval]
    host: List[Interval]
    ops: Dict[str, OpTime]

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for _, a, b in self.device])

    @property
    def kernels(self) -> int:
        return sum(1 for name, _, _ in self.device
                   if not name.startswith(NOT_KERNELS))

    def device_ops(self) -> List[List]:
        """The device operations that took most time: [name, seconds]."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            by_name[name] += b - a
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """The device's idle time between its operations, summed by what
        the host was running when the gap began (the innermost host
        operator then open, ``python`` outside any); the gaps past the
        ``NAMED_GAPS`` longest are summed as ``short gaps``:
        [name, seconds]."""
        import numpy as np

        by_name: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda e: e[1])
        starts = np.array([e[1] for e in host])
        ends = np.array([e[2] for e in host])
        found = sorted(gaps([(a, b) for _, a, b in self.device]),
                       key=lambda g: -g[1])
        for start, length in found[:NAMED_GAPS]:
            open_at = np.nonzero((starts <= start) & (ends > start))[0]
            name = host[open_at[-1]][0] if len(open_at) else "python"
            by_name[name] += length
        if len(found) > NAMED_GAPS:
            by_name["short gaps"] += sum(g[1] for g in found[NAMED_GAPS:])
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:TOP]]


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: Sequence[Tuple[float, float]]
         ) -> List[Tuple[float, float]]:
    """(start, length) of each gap between the union's pieces."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a - end))
        end = b if end is None else max(end, b)
    return out


def from_profile(prof, steps: int, window_s: float) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        (device if e.device_type == cuda else host).append(span)
    ops = {}
    for e in prof.key_averages():
        if e.device_type != cuda:
            ops[e.key] = OpTime(e.count, e.device_time_total / 1e6,
                                e.self_device_time_total / 1e6)
    return Trace(steps, window_s, device, host, ops)
