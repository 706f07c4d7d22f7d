#!/usr/bin/env python3
"""Time the kernels of two trees on one card, parent against change.

    python3 pair_times.py PARENT_DIR [WORD ...]   # PARENT_DIR, this tree, this tree, PARENT_DIR
    python3 pair_times.py --tree DIR [WORD ...]   # one tree: one JSON line

With WORDs, only the cases whose label holds one of them are timed.

PARENT_DIR is an unpacked checkout of another commit (for example
`git archive HEAD | tar -x -C .scratch/parent`). Each tree runs in its own
process, with its own `oclpathtracer_tpu_torch` first on `sys.path`, its kernels
built from its own sources, and is timed through its own `kernels/selfcheck`, at
chip_smoke.py phase 5's shapes: the wavefront kernel (tp, Cornell 512², 16
bounces, 64 spp in one launch from sample 64); the 8-wide BVH kernel (fast, 512²,
16 bounces, 64 spp from sample 64, on sphere_field() at leaf 32 and on
sphere_field(80, 3) at leaf 64, both also at the driver's leaf 6, sphere_field(80, 3)
at leaf 6 also in its counted form, under a profiler that records host events only;
and tp on the Cornell box at leaf 32, an explicit backend="widebvh"'s); the megakernel (tp with the tp0 peel, parity and
fast, Cornell 512², 4 bounces, 64 spp from sample 64; and parity at the vertex
recovery's launch, 64², 2 bounces, 8 spp from sample 16); and trace_rays (parity,
the rim probes' 1,572,864 rows, 3 bounces, 2 spp; and the row counts, bounces and
samples of the vertex recovery step's launches, 5,184 rows at 2 bounces and 4 spp
and 98,304 rows at 1 bounce and 2 spp; rows from selfcheck.probe_rays); the
skip-link BVH kernel (fast, 512², 16 bounces, 64 spp from sample 64, on
sphere_field() at leaf 32 and on sphere_field(80, 3) at leaf 64); the sorted
wavefront at render_sorted's shape (parity, leaf 32, 512², 16 bounces, 8 spp from
sample 64): its 16 bounce launches with the sort off on sphere_field() and on the
Cornell box, the bounce launches' own device time in a call with the sort on and
off on the Cornell box (events around each launch, summed: the sort's torch ops
between launches left out), and a whole render_samples_sorted_stats call on
sphere_field() with the sort off on the host clock, not queued behind a spin (the
host's launch work is part of it; median of 7); the AO and direct-NEE kernels at
the CLI's shape (Cornell 512², 64 spp in one launch from sample 64,
selfcheck.run_fast); and the adjoint kernel, with gradients and forward only
(Cornell, the interior class point, selfcheck.grad_weight, 8 spp from sample 0, at
bench_train.py's 256² with 4 bounces and at the vertex recovery's 64² with 2
bounces); and the kernel train step (diff/fast.make_kernel_train_step at those
256² shapes, 4 adjoint-kernel launches a step). Each kernel runs at its tree's
defaults. A kernel's time is device time: CUDA events around the launch, queued
behind a 0.1 s spin kernel, median of 5 after a warm-up. The train step's is wall
time, as chip_smoke.py phase 5 takes it: the host clock around a step and a
synchronize, median of 7 after a warm-up (the host's launch work is part of it).
Each line also carries the segment counts, a digest of each image's bits (where the
case returns one) and the tree's ptxas lines (registers,
stack, spills of every kernel), and the paired run says which
kernels of both trees have the same lines. The paired order cancels drift of the
card's clocks; compare the two trees only within one call.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))


class Timed(NamedTuple):
    label: str
    kernel: str
    scan: str
    scene: str
    leaf: int
    size: int       # the image (or, for trace_rays, probe_rays' camera) is size²
    bounces: int
    start: int      # first sample (trace_rays: selfcheck.PROBE_START)
    n: int          # samples
    rows: int = 0   # trace_rays only: rays from selfcheck.probe_rays
    profiled: bool = False  # under a profiler of host events: the kernel's counted form


CASES = (Timed("wavefront tp cornell", "wavefront", "tp", "cornell", 32, 512, 16, 64, 64),
         Timed("widebvh fast spheres5k leaf 32", "widebvh", "fast", "spheres5k", 32, 512, 16, 64,
               64),
         Timed("widebvh fast spheres102k leaf 64", "widebvh", "fast", "spheres102k", 64, 512, 16,
               64, 64),
         # the driver's leaves: render/driver.wide_leaf (6 past 900 triangles; an explicit
         # backend="widebvh" takes 32 on the Cornell box)
         Timed("widebvh fast spheres5k leaf 6", "widebvh", "fast", "spheres5k", 6, 512, 16, 64,
               64),
         Timed("widebvh fast spheres102k leaf 6", "widebvh", "fast", "spheres102k", 6, 512, 16,
               64, 64),
         Timed("widebvh fast spheres102k leaf 6 counted", "widebvh", "fast", "spheres102k", 6,
               512, 16, 64, 64, profiled=True),
         Timed("widebvh tp cornell leaf 32", "widebvh", "tp", "cornell", 32, 512, 16, 64, 64),
         Timed("megakernel tp cornell 512 b4", "megakernel", "tp", "cornell", 32, 512, 4, 64, 64),
         Timed("megakernel parity cornell 512 b4", "megakernel", "parity", "cornell", 32, 512, 4,
               64, 64),
         Timed("megakernel fast cornell 512 b4", "megakernel", "fast", "cornell", 32, 512, 4, 64,
               64),
         Timed("megakernel parity cornell 64 b2 8spp", "megakernel", "parity", "cornell", 32, 64,
               2, 16, 8),
         # chip_smoke.py phase 5: 256² / 4 prefix pixels x 3 edges x 2 tris x 16
         Timed("trace_rays parity rim 1572864 rows b3 2spp", "trace_rays", "parity", "cornell",
               32, 256, 3, 0, 2, rows=1_572_864),
         # the row counts of the vertex recovery step's launches (64², 2 bounces, 8 spp)
         Timed("trace_rays parity 5184 rows b2 4spp", "trace_rays", "parity", "cornell", 32, 64,
               2, 0, 4, rows=5_184),
         Timed("trace_rays parity 98304 rows b1 2spp", "trace_rays", "parity", "cornell", 32, 64,
               1, 0, 2, rows=98_304),
         Timed("bvh fast spheres5k leaf 32", "bvh", "fast", "spheres5k", 32, 512, 16, 64, 64),
         Timed("bvh fast spheres102k leaf 64", "bvh", "fast", "spheres102k", 64, 512, 16, 64,
               64),
         Timed("sorted bounce x16 parity spheres5k leaf 32 8spp", "sorted", "parity",
               "spheres5k", 32, 512, 16, 64, 8),
         Timed("sorted bounce x16 parity cornell leaf 32 8spp", "sorted", "parity", "cornell",
               32, 512, 16, 64, 8),
         Timed("sorted bounce kernels sort off parity cornell leaf 32 8spp", "sorted_kernels",
               "parity", "cornell", 32, 512, 16, 64, 8),
         Timed("sorted bounce kernels sort on parity cornell leaf 32 8spp",
               "sorted_kernels_sort_on", "parity", "cornell", 32, 512, 16, 64, 8),
         # host clock, not queued: the call's launch work on the host is part of it
         Timed("sorted call host clock sort off parity spheres5k leaf 32 8spp", "sorted_call",
               "parity", "spheres5k", 32, 512, 16, 64, 8),
         Timed("ao cornell 512 64spp", "ao", "parity", "cornell", 32, 512, 16, 64, 64),
         Timed("direct cornell 512 64spp", "direct", "parity", "cornell", 32, 512, 16, 64, 64),
         Timed("adjoint cornell 256 b4 8spp", "adjoint", "tp", "cornell", 32, 256, 4, 0, 8),
         Timed("forward cornell 256 b4 8spp", "forward", "tp", "cornell", 32, 256, 4, 0, 8),
         Timed("adjoint cornell 64 b2 8spp", "adjoint", "tp", "cornell", 32, 64, 2, 0, 8),
         Timed("forward cornell 64 b2 8spp", "forward", "tp", "cornell", 32, 64, 2, 0, 8),
         # chip_smoke.py phase 5's kernel train step (host clock: it waits on the host)
         Timed("kernel train step cornell 256 b4 8spp", "train", "tp", "cornell", 32, 256, 4, 0,
               8))
TRAIN_REPS = 7
SPIN_CYCLES = 200_000_000  # about 0.1 s at the H100's boost clock


def time_tree(tree: str, words=()) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast
    from oclpathtracer_tpu_torch.kernels import cuda_build, selfcheck
    from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw

    if not torch.cuda.is_available():
        sys.exit("pair_times: needs a CUDA device")
    _, info = cuda_build.load_library()
    tables = selfcheck.Tables("cuda")
    out = {"tree": tree, "device": torch.cuda.get_device_name(0),
           "ptxas": [ln.strip() for ln in info.log.splitlines()
                     if "Compiling entry" in ln or "registers" in ln or "spill" in ln],
           "ms": {}, "segments": {}, "bits": {}}
    for label, kernel, scan, scene, leaf, size, bounces, start, n, rows, profiled in CASES:
        if words and not any(w in label for w in words):
            continue
        case = selfcheck.Case(kernel, scan, size, size, bounces, scene=scene, leaf=leaf)
        if kernel == "trace_rays":
            o, d = selfcheck.probe_rays(tables.scene(scene), rows, case.cfg, seed=1)

            def call(o=o, d=d, case=case, n=n):
                return selfcheck.run_trace_rays(tables, scan, o, d, case.cfg, n)
        elif kernel == "sorted":  # the 16 bounce launches of one render_sorted call
            tb, nf, ni, _, _ = tables.bvh(scene, scan, leaf)

            def call(tb=tb, nf=nf, ni=ni, case=case, start=start, n=n):
                return sw._trace_sorted(sw._bounce_step, tb, nf, ni, case.cfg, start, n, False)
        elif kernel.startswith("sorted_kernels"):  # (events around each launch, segments)
            tb, nf, ni, _, _ = tables.bvh(scene, scan, leaf)

            def call(tb=tb, nf=nf, ni=ni, case=case, start=start, n=n,
                     sort=kernel.endswith("sort_on")):
                marks = []

                def step(*args):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    sw._bounce_step(*args)
                    b.record()
                    marks.append((a, b))

                segs = sw._trace_sorted(step, tb, nf, ni, case.cfg, start, n, sort)[-1]
                torch.cuda.synchronize()
                return sum(a.elapsed_time(b) for a, b in marks), segs
        elif kernel == "sorted_call":
            tb, nf, ni, _, _ = tables.bvh(scene, scan, leaf)

            def call(tb=tb, nf=nf, ni=ni, case=case, start=start, n=n, leaf=leaf):
                return sw.render_samples_sorted_stats(tb, nf, ni, case.cfg, start, n,
                                                      max_leaf=leaf)
        elif kernel in ("ao", "direct"):
            def call(kernel=kernel, case=case, start=start, n=n):
                return selfcheck.run_fast(kernel, tables, case.cfg, start, n), 0
        elif kernel in ("adjoint", "forward"):
            cfg = RenderConfig(size, size, bounces=bounces)
            ct = selfcheck.grad_points(tables)["interior"]
            w = selfcheck.grad_weight(cfg.n_pixels, "cuda") if kernel == "adjoint" else None

            def call(cfg=cfg, ct=ct, w=w, start=start, n=n):
                return selfcheck.run_grad(tables, cfg, ct, w, start=start, n=n)
        elif kernel == "train":
            cornell = tables.scene(scene)
            cfg = RenderConfig(size, size, bounces=bounces)
            step = fast.make_kernel_train_step(cornell, cfg, n, lr=1e-3)
            params = fast.extract_class_params(cornell)
            target = torch.zeros((cfg.n_pixels, 3), device="cuda")

            def call(step=step, params=params, target=target, start=start):
                return step(params, target, start)
        else:
            def call(case=case, start=start, n=n):
                return selfcheck.run(case, tables, start=start, n=n)

        host_events = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=host_events) if profiled \
                else contextlib.nullcontext():
            times, segs, got = time_case(kernel, call)
        out["ms"][label] = statistics.median(times)
        out["segments"][label] = int(segs)
        if isinstance(got[0], torch.Tensor):
            out["bits"][label] = hashlib.sha256(got[0].cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def time_case(kernel: str, call):
    """(times in ms, segments, the last result) of one case, after a warm-up."""
    import torch

    call()
    torch.cuda.synchronize()
    times, segs = [], 0  # a train step's segments are its adjoint launches'
    if kernel in ("train", "sorted_call"):
        for _ in range(TRAIN_REPS):
            t0 = time.perf_counter()
            got = call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            segs = got[-1] if kernel == "sorted_call" else 0
    else:
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            got = call()
            b.record()
            torch.cuda.synchronize()
            segs = got[-1]
            times.append(got[0] if kernel.startswith("sorted_kernels") else a.elapsed_time(b))
    return times, segs, got


def by_kernel(ptxas: list) -> dict:
    """ptxas lines grouped by the entry function they follow: mangled name → the set
    of its compilations' lines (a kernel that several sources compile, such as
    split.cuh's sample_sum, appears once a source)."""
    out, name, cur = {}, None, None
    for line in ptxas + ["Compiling entry function ''"]:
        if "Compiling entry function" in line:
            if name is not None:
                out.setdefault(name, set()).add(tuple(cur))
            name, cur = line.split("'")[1], []
        elif cur is not None:
            cur.append(line)
    out.pop("", None)
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--tree":
        print(json.dumps(time_tree(sys.argv[2], sys.argv[3:])), flush=True)
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    parent = os.path.abspath(sys.argv[1])  # the tree processes run from ROOT
    for label, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree,
                              *sys.argv[2:]],
                             capture_output=True, text=True, check=True, cwd=ROOT)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((label, row))
        print(f"[pair] {label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in row["ms"].items()),
              flush=True)
    for label in runs[0][1]["ms"]:
        seg = {lab: row["segments"][label] for lab, row in runs}
        bits = {row.get("bits", {}).get(label) for _, row in runs}
        print(f"[pair] {label}: parent, change, change, parent = "
              f"{[round(row['ms'][label], 3) for _, row in runs]} ms; segments {seg}; "
              f"image digests {sorted(map(str, bits))}", flush=True)
    parent, change = (by_kernel(runs[i][1]["ptxas"]) for i in (0, 1))
    both = sorted(set(parent) & set(change))
    print(f"[pair] ptxas lines of the {len(both)} kernels in both trees: the same for "
          f"{[k for k in both if parent[k] == change[k]]}, not for "
          f"{[k for k in both if parent[k] != change[k]]}", flush=True)
    print(json.dumps({"runs": [{"label": lab, **row} for lab, row in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
