"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration and a traffic mix
(`spec.py` finds their files). The mix's entry builds the program's objects from the
seed and warms every shape the cell uses: that is set-up (`setup_s`, counted from the
process's start). Then one closed loop of the mix's units runs for `--seconds`
(`loop.py`), under the profiler with `--trace 1` for at most the mix's
`trace_seconds`. After the window: the peak device memory, the program's segment
counts, its compared answers, then the reference's check (`compare.py`), each number
beside its limit (the cell's `workloads/<cell>.json`).

The last line of standard output is one JSON object: `correct`, `attempted` (units in
the window), `failed` (compared numbers over their limit), `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`. The checks are also the last lines of standard error.
Without a CUDA device, or with fewer than the cell's chips, or when JAX or the JAX
package was loaded, it prints no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

_IMPORTED = time.perf_counter()

import torch  # noqa: E402

from benchmark import loop, spec, trace  # noqa: E402
from benchmark.reference import scene as rs  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "oclpathtracer_tpu"}


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    window: loop.Window
    counts: dict
    trace: trace.Trace | None
    n_tris: int
    n_classes: int
    memory_peak_bytes: int = 0


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, clock=process_age) -> dict:
    """One run of `cell`; returns the result's fields (without `device`'s name)."""
    entry = spec.load_module("entries", cell.traffic["entry"], cell.here).Entry(cell, seed,
                                                                               device)
    setup_s = clock()
    first = getattr(entry, "first_steps", 0)
    tr = None
    if traced:
        with trace.profiler() as prof:
            window = loop.closed_loop(entry.unit, min(seconds, cell.traffic["trace_seconds"]),
                                      entry.wait_each, device, first)
        tr = trace.summarize(prof, window.seconds)
    else:
        window = loop.closed_loop(entry.unit, seconds, entry.wait_each, device, first)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counts = entry.counts(window.units)
    numbers = entry.numbers(entry.outputs(window.units))
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    failed = sum(not (c["value"] <= c["limit"]) for c in checks.values())

    sd = rs.scene_data(cell)
    run = Run(cell, setup_s, window, counts, tr, int(sd.p1.shape[0]),
              int(rs.material_classes(sd).max()) + 1, peak)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_module("metrics", m["name"], cell.here).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": failed == 0, "attempted": window.units, "failed": failed,
           "metrics": metrics, "memory_peak_bytes": peak}
    if tr is not None:
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    out["checks"] = checks
    return out


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    checks = res.pop("checks")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": res.pop("memory_peak_bytes")}
    if args.trace:
        dev["busy_s"], dev["window_s"] = res.pop("busy_s"), res.pop("window_s")
        print(f"card, power limit: {_power_limit()}", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": dev}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
