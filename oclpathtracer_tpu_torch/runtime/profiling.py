"""Profiling — wall-clock stopwatch, synchronized launch timing and device traces.

Counterpart of `oclpathtracer_tpu.runtime.profiling`, for the reference's three
mechanisms (SURVEY.md §5.1):
  * StopwatchHost (Host/AdlStopwatchHost.inl:26-107)        → Stopwatch (perf_counter,
    split slots)
  * Launcher host-side launch timing (AdlKernelUtilsCL.cpp:470-499) → timed()
    (synchronizes on the result like the reference's forced waitForCompletion)
  * clGetEventProfilingInfo device ns (AdlCL.cpp:508-517)   → torch.profiler traces
    (trace() context manager below)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree

SUMMARY_ROWS = 12


class Stopwatch:
    """Wall-clock timer with split recording (≡ StopwatchHost's 64 split slots)."""

    def __init__(self):
        self._t0 = 0.0
        self._splits: list[float] = []

    def start(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        self._splits = []
        return self

    def split(self) -> float:
        t = time.perf_counter() - self._t0
        self._splits.append(t)
        return t

    @property
    def splits(self) -> list[float]:
        return list(self._splits)

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


def timed(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """Run fn and wait until its outputs are ready; returns (result, seconds).

    Synchronizes every CUDA device that holds a tensor of the result (tuples, lists,
    dicts and NamedTuples are searched), as the reference's PROFILE_RETURN_TIME
    launch path host-times each launch around a forced waitForCompletion
    (AdlKernelUtilsCL.cpp:470-486). A result on the CPU is ready when fn returns.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for device in {x.device for x in _pytree.tree_leaves(out)
                   if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool | None = None):
    """torch.profiler over the block — per-op device timing like the reference's
    clGetEventProfilingInfo path, but for the whole program. Yields the profiler;
    on exit writes `log_dir/trace.json` (a chrome trace) and `log_dir/summary.txt`
    (the per-op table, its top rows by self device time where CUDA is traced, else by
    self CPU time). `cuda`: trace the CUDA activity too (default: where a card is)."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    with open(os.path.join(log_dir, "summary.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=SUMMARY_ROWS))
