"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 ... [--control-seeds ...]
        [--faults half altered --fault-seeds ...] [--seconds S] [--out FILE]

For each of `--seeds`: the program's set-up and a short window (`--seconds`) as a run
makes them, then its numbers against the reference: the sound readings. For each of
`--control-seeds`: the same program outputs replaced by the reference's in bfloat16,
the nearest precision below the configuration's float32: the control's readings.
For each of `--faults` on each of `--fault-seeds`: the program with that fault planted
(`faults.py`). One JSON line each, on standard output and appended to `--out`.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark import common, faults, loop, spec


def readings(cell, seed: int, seconds: float, device, variant: str = "program",
             units: int | None = None) -> dict:
    """One reading: {"variant", "seed", numbers...}. variant: "program", "control" or a
    fault's name. With `units` the window is that many units instead of `seconds`."""
    name = cell.traffic["entry"]
    planted = (faults.planted(name, variant, cell.here) if variant in faults.FAULTS
               else contextlib.nullcontext())
    with planted:
        entry = spec.load_module("entries", name, cell.here).Entry(cell, seed, device)
        first = getattr(entry, "first_steps", 0)
        if units is None:
            units = loop.closed_loop(entry.unit, seconds, entry.wait_each, device, first).units
        else:
            for i in range(first, first + units):
                entry.unit(i)
        out = entry.outputs(units)
    if variant == "control":
        out = entry.control_outputs(out)
    numbers = entry.numbers(out)
    del entry
    common.free(device)
    return {"variant": variant, "seed": seed, "units": units, **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings of a cell's correctness numbers.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    jobs = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, f) for f in args.faults for s in args.fault_seeds])
    for seed, variant in jobs:
        line = json.dumps({"workload": cell.name, **readings(cell, seed, args.seconds, device,
                                                              variant)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
