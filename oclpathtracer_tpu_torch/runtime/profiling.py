"""Profiling — wall-clock stopwatch, synchronized launch timing, device traces, and
the program's own spans and counters.

Counterpart of `oclpathtracer_tpu.runtime.profiling`, for the reference's three
mechanisms (SURVEY.md §5.1):
  * StopwatchHost (Host/AdlStopwatchHost.inl:26-107)        → Stopwatch (perf_counter,
    split slots)
  * Launcher host-side launch timing (AdlKernelUtilsCL.cpp:470-499) → timed()
    (synchronizes on the result like the reference's forced waitForCompletion)
  * clGetEventProfilingInfo device ns (AdlCL.cpp:508-517)   → torch.profiler traces
    (trace() context manager below)

Spans (`span`, `spanned`) name the program's host code at its layer boundaries
(`driver.*`, `sorted.*`, `kernel.*`, `train.*`, `build.*`). They follow the
profiler's state: with no profiler running a span costs one check of it and does
nothing else; under a profiler it is a range on the profiler's own timeline (the
clock of the device events) and adds its calls, total and self seconds to a table in
memory (`span_stats`), which holds the latest profiler session: it starts afresh at
the first span under a profiler after a span that ran without one (a benchmark's
warm-up before its traced window), and where `trace` starts. Counters (`count`,
`counts`: kernel launches `launch.<kernel>`, builds `build.<compiler>`) are plain
host integers and always on.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Tuple

import torch
from torch.utils import _pytree

SUMMARY_ROWS = 12

_profiler_on = torch._C._autograd._profiler_enabled
# A range on the profiler's timeline: the fast one, else record_function's.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function

_spans: dict = {}      # name -> [calls, total_s, self_s] of the latest profiler session
_open: list = []       # the open spans, innermost last
_counts: dict = {}     # name -> count
_stale = True          # a span saw no profiler since the table's last span: start afresh


class _Off:
    """The span of a run without a profiler: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "range", "t0", "child_s")

    def __init__(self, name: str):
        self.name = name
        self.range = _Range(name)

    def __enter__(self):
        global _stale
        if _stale:
            _spans.clear()
            _stale = False
        self.range.__enter__()
        _open.append(self)
        self.child_s = 0.0
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        _open.pop()
        if _open:
            _open[-1].child_s += dt
        row = _spans.setdefault(self.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.child_s
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager over one piece of the program's host code, named
    `<layer>.<piece>`. Without a profiler: the shared no-op (no allocation, no clock).
    Under one: a range on the profiler's timeline whose calls, seconds and self
    seconds (less its child spans') go into `span_stats`."""
    global _stale
    if not _profiler_on():
        _stale = True
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole call of the function is `span(name)` (without a profiler,
    one check of it and the call)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            global _stale
            if not _profiler_on():
                _stale = True
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def span_stats() -> dict:
    """{name: (calls, total_s, self_s)} of the spans of the latest profiler session."""
    return {k: tuple(v) for k, v in _spans.items()}


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (always on)."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """{name: count} of every counter since the process started."""
    return dict(_counts)


def _table() -> str:
    """The span table, by self time, and the counters: the lines `trace` appends to
    its summary."""
    lines = [f"{'span':<24} {'calls':>8} {'total ms':>12} {'self ms':>12}"]
    for name, (calls, total, self_s) in sorted(_spans.items(), key=lambda kv: -kv[1][2]):
        lines.append(f"{name:<24} {calls:>8} {total * 1e3:>12.3f} {self_s * 1e3:>12.3f}")
    lines.append(f"{'counter':<24} {'count':>8}")
    lines += [f"{name:<24} {n:>8}" for name, n in sorted(_counts.items())]
    return "\n".join(lines) + "\n"


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
    on exit writes `log_dir/trace.json` (a chrome trace, the program's spans on it)
    and `log_dir/summary.txt` (the per-op table, its top rows by self device time
    where CUDA is traced, else by self CPU time; then the block's span table by self
    time and the counters). `cuda`: trace the CUDA activity too (default: where a
    card is)."""
    global _stale
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _stale = True
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    with open(os.path.join(log_dir, "summary.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=SUMMARY_ROWS))
        f.write("\n" + _table())
