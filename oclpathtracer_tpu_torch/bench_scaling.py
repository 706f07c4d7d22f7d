"""Multi-device scaling benchmark — Mrays/s efficiency from 1 to N devices.

    python -m oclpathtracer_tpu_torch.bench_scaling [--width 512] [--height 512]
        [--spp 32] [--bounces 4] [--device cuda]

Counterpart of the root `bench_scaling.py`. It times the sharded megakernel step
(`parallel/sharded_pallas.make_sharded_kernel_step`, scan `auto`, Cornell box) on
meshes of 1, 2, 4, ... of the REAL devices, one entry per device, and prints one JSON
line per mesh size:

  {"devices": n, "mrays_per_s": x, "efficiency_vs_1": r}

x = traced segments (the kernels' own tally) / the host clock around one call of
frames spp .. 2·spp − 1, after a warm-up call that builds the kernels; the clock stops
when every device of the mesh has finished. r = x / (n × the 1-device rate). On one
card this is the 1-device row. Without a card it exits 2; `--device cpu` times the
plain versions on the host (one row).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels.megakernel import prepare_scan
from oclpathtracer_tpu_torch.parallel.mesh import default_mesh
from oclpathtracer_tpu_torch.parallel.sharded_pallas import make_sharded_kernel_step
from oclpathtracer_tpu_torch.runtime.devices import get_devices
from oclpathtracer_tpu_torch.scene import load_cornell_box

MESH_SIZES = (1, 2, 4, 8, 16, 32)


def _sync(mesh) -> None:
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (every card) or cpu")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda":
        devs = get_devices()
        if not devs:
            print("bench_scaling: no CUDA device (pass --device cpu for the plain "
                  "versions)", file=sys.stderr)
            return 2
    else:
        devs = [torch.device(args.device)]
    cfg = RenderConfig(width=args.width, height=args.height, bounces=args.bounces)
    scene = load_cornell_box(device=devs[0])
    scan, table, emi, classes = prepare_scan(scene, "auto")

    base = None
    for n in [n for n in MESH_SIZES if n <= len(devs)]:
        mesh = default_mesh(devs, n=n)
        step = make_sharded_kernel_step(cfg, mesh, args.spp, scan=scan, emi_const=emi,
                                        classes=classes)
        step(table, 0)  # builds the kernels, copies the table to each device
        _sync(mesh)
        t0 = time.perf_counter()
        _, segs = step(table, args.spp)
        _sync(mesh)
        segs = int(segs)
        mrays = segs / (time.perf_counter() - t0) / 1e6
        base = mrays if base is None else base
        print(json.dumps({"devices": n, "mrays_per_s": mrays,
                          "efficiency_vs_1": mrays / (base * n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
