#!/usr/bin/env python3
"""Time the path-regeneration and 8-wide BVH kernels of two trees on one card.

    python3 pair_times.py PARENT_DIR   # PARENT_DIR, this tree, this tree, PARENT_DIR
    python3 pair_times.py --tree DIR   # one tree: one JSON line

PARENT_DIR is an unpacked checkout of another commit (for example
`git archive HEAD | tar -x -C .scratch/parent`). Each tree runs in its own
process, with its own `oclpathtracer_tpu_torch` first on `sys.path`, its kernels
built from its own sources, and is timed at chip_smoke.py phase 5's shapes through
its own `kernels/selfcheck.run`: the wavefront kernel (tp, Cornell 512², 16
bounces, 64 spp in one launch from sample 64) and the 8-wide BVH kernel (fast,
512², 16 bounces, 64 spp from sample 64, on sphere_field() at leaf 32 and on
sphere_field(80, 3) at leaf 64). A time is device time: CUDA events around the
launch, queued behind a 0.1 s spin kernel, median of 5 after a warm-up. Each
line also carries the segment counts and the tree's ptxas lines (registers, stack,
spills of every kernel), and the paired run says which kernels of both trees have
the same lines. The paired order cancels drift of the card's clocks; compare the
two trees only within one call.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = (("wavefront tp cornell", "wavefront", "tp", "cornell", 32),
         ("widebvh fast spheres5k leaf 32", "widebvh", "fast", "spheres5k", 32),
         ("widebvh fast spheres102k leaf 64", "widebvh", "fast", "spheres102k", 64))
SPIN_CYCLES = 200_000_000  # about 0.1 s at the H100's boost clock


def time_tree(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from oclpathtracer_tpu_torch.kernels import cuda_build, selfcheck

    if not torch.cuda.is_available():
        sys.exit("pair_times: needs a CUDA device")
    _, info = cuda_build.load_library()
    tables = selfcheck.Tables("cuda")
    out = {"tree": tree, "device": torch.cuda.get_device_name(0),
           "ptxas": [ln.strip() for ln in info.log.splitlines()
                     if "Compiling entry" in ln or "registers" in ln or "spill" in ln],
           "ms": {}, "segments": {}}
    for label, kernel, scan, scene, leaf in CASES:
        case = selfcheck.Case(kernel, scan, 512, 512, 16, scene=scene, leaf=leaf)

        def call(case=case):
            return selfcheck.run(case, tables, start=64, n=64)

        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            _, segs = call()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out["ms"][label] = statistics.median(times)
        out["segments"][label] = int(segs)
    return out


def by_kernel(ptxas: list) -> dict:
    """ptxas lines grouped by the entry function they follow: mangled name → lines."""
    out, cur = {}, None
    for line in ptxas:
        if "Compiling entry function" in line:
            cur = out.setdefault(line.split("'")[1], [])
        elif cur is not None:
            cur.append(line)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        print(json.dumps(time_tree(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    for label, tree in (("parent", sys.argv[1]), ("change", ROOT), ("change", ROOT),
                        ("parent", sys.argv[1])):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree],
                             capture_output=True, text=True, check=True, cwd=ROOT)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((label, row))
        print(f"[pair] {label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in row["ms"].items()),
              flush=True)
    for label, _, _, _, _ in CASES:
        seg = {lab: row["segments"][label] for lab, row in runs}
        print(f"[pair] {label}: parent, change, change, parent = "
              f"{[round(row['ms'][label], 3) for _, row in runs]} ms; segments {seg}", flush=True)
    parent, change = (by_kernel(runs[i][1]["ptxas"]) for i in (0, 1))
    both = sorted(set(parent) & set(change))
    print(f"[pair] ptxas lines of the {len(both)} kernels in both trees: the same for "
          f"{[k for k in both if parent[k] == change[k]]}, not for "
          f"{[k for k in both if parent[k] != change[k]]}", flush=True)
    print(json.dumps({"runs": [{"label": lab, **row} for lab, row in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
