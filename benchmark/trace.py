"""Read a torch.profiler trace of the window into what the per-layer metrics need.

The device timeline is every operation the profiler saw on the card (kernels, copies,
fills) with its start and end. From it: the seconds in which something ran (the union
of the intervals), the time by operation name, and the gaps in which nothing ran,
each named by the innermost host operation that was running at its middle (or
"host: no operation", Python between calls). Autograd's share is the device time of
the kernels launched under `autograd::engine::evaluate_function` ranges, which
torch links to their kernels by correlation id.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

AUTOGRAD_RANGE = "autograd::engine::evaluate_function"
TOP = 10


@dataclass
class Trace:
    window_s: float                               # the traced window, host clock
    device: list = field(default_factory=list)    # (name, start_us, end_us)
    busy_s: float = 0.0
    autograd_device_s: float = 0.0
    gaps: list = field(default_factory=list)      # (label, seconds)

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name `match(name)` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) * 1e-6

    def top_ops(self):
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n] += (e - s) * 1e-6
        return sorted(([n[:120], v] for n, v in by.items()), key=lambda x: -x[1])[:TOP]

    def top_gaps(self):
        by = defaultdict(float)
        for label, sec in self.gaps:
            by[label] += sec
        return sorted(([n[:120], v] for n, v in by.items()), key=lambda x: -x[1])[:TOP]


def _is_device(evt) -> bool:
    return evt.device_type != torch.autograd.DeviceType.CPU


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(cpu, starts, t):
    """The latest-starting host operation that covers time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 200, -1), -1):
        name, s, e = cpu[j]
        if e >= t:
            return name
    return None


def summarize(prof, window_s: float) -> Trace:
    events = prof.events()
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events if _is_device(e)]
    cpu = sorted(((e.name, e.time_range.start, e.time_range.end) for e in events
                  if not _is_device(e)), key=lambda x: x[1])
    tr = Trace(window_s=window_s, device=device)
    merged = _union((s, e) for _, s, e in device)
    tr.busy_s = sum(e - s for s, e in merged) * 1e-6
    starts = [s for _, s, _ in cpu]
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        label = _innermost(cpu, starts, 0.5 * (e0 + s1)) or "host: no operation"
        tr.gaps.append((label, (s1 - e0) * 1e-6))
    for e in events:
        if _is_device(e) or not e.name.startswith(AUTOGRAD_RANGE):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(AUTOGRAD_RANGE):
            parent = parent.cpu_parent
        if parent is None:
            tr.autograd_device_s += e.device_time_total * 1e-6
    return tr


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
